"""V-trace and IMPALA losses: the PyTorch port against the JAX package.

Inputs are made with numpy from fixed seeds and fed to both. On the CPU
the port runs the plain version of its CUDA kernel; the JAX side runs its
Pallas kernel in interpret mode and its `lax.scan` reference. Tolerances
are the JAX package's own kernel tolerances (`tests/test_pallas.py`,
numpy's default rtol 1e-7 included): atol 2e-6 on vs (a T-step float32
recursion summed in another order), 1e-7 on the clipped rhos (one exp
and one min; an unclipped rho above 1 may differ by one ulp).

The CUDA kernel itself is held against the plain version on the card in
`tests/test_torch_kernels_gpu.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from distributed_reinforcement_learning_tpu.ops import vtrace as jvt
from distributed_reinforcement_learning_tpu.ops.pallas.vtrace import vtrace_pallas
from distributed_reinforcement_learning_tpu_torch.ops import vtrace as tvt
from distributed_reinforcement_learning_tpu_torch.ops.kernels import _build, on_cuda
from distributed_reinforcement_learning_tpu_torch.ops.kernels import vtrace as kvt


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # One thread for torch and for numpy's BLAS pool, as the parity files
    # pin them: several test workers share the cores.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)

SHAPES = [(18, 32), (10, 16), (5, 256), (20, 384)]


def _inputs(T, B, seed=0):
    rng = np.random.RandomState(seed)
    log_rhos = (rng.randn(T, B) * 0.3).astype(np.float32)
    discounts = ((rng.rand(T, B) > 0.1) * 0.99).astype(np.float32)
    rewards = rng.randn(T, B).astype(np.float32)
    values = rng.randn(T, B).astype(np.float32)
    boot = rng.randn(B).astype(np.float32)
    return log_rhos, discounts, rewards, values, boot


@pytest.mark.parametrize("clip_rho", [1.0, None])
@pytest.mark.parametrize("T,B", SHAPES)
def test_vtrace_matches_jax_kernel_and_reference(T, B, clip_rho):
    args = _inputs(T, B)
    port = tvt.from_importance_weights(*map(torch.from_numpy, args),
                                       clip_rho_threshold=clip_rho)
    vs, rhos = vtrace_pallas(*args, clip_rho_threshold=clip_rho, interpret=True)
    ref = jvt.from_importance_weights(*map(jnp.asarray, args),
                                      clip_rho_threshold=clip_rho, backend="reference")
    for want_vs, want_rhos in ((vs, rhos), (ref.vs, ref.clipped_rhos)):
        np.testing.assert_allclose(port.vs.numpy(), np.asarray(want_vs), atol=2e-6)
        np.testing.assert_allclose(port.clipped_rhos.numpy(), np.asarray(want_rhos),
                                   atol=1e-7)


@pytest.mark.parametrize("clip_rho", [1.0, None])
def test_vtrace_propagates_nan_and_inf_as_jax_kernel(clip_rho):
    """NaN, +inf and -inf log-rhos: the port's `vtrace` (its plain version
    on the CPU) gives what the Pallas kernel gives, NaN where it gives NaN.
    A clip must propagate a NaN rho (`jnp.minimum`, `torch.clamp`), not
    drop it as C's `fminf` does."""
    T, B = 6, 8
    args = _inputs(T, B, seed=4)
    log_rhos = args[0].copy()
    log_rhos[3, 1] = np.nan
    log_rhos[2, 4] = np.inf
    log_rhos[4, 6] = -np.inf
    args = (log_rhos, *args[1:])
    vs, rhos = kvt.vtrace(*map(torch.from_numpy, args), clip_rho_threshold=clip_rho)
    want_vs, want_rhos = vtrace_pallas(*args, clip_rho_threshold=clip_rho, interpret=True)
    np.testing.assert_allclose(vs.numpy(), np.asarray(want_vs), atol=2e-6, equal_nan=True)
    np.testing.assert_allclose(rhos.numpy(), np.asarray(want_rhos), atol=1e-7, equal_nan=True)
    assert np.isnan(rhos[3, 1].item()) and np.isnan(vs[:4, 1].numpy()).all()
    assert np.isfinite(vs[4:, 1].numpy()).all()
    assert rhos[4, 6].item() == 0.0
    assert rhos[2, 4].item() == (np.inf if clip_rho is None else clip_rho)


def test_vtrace_cuts_the_graph():
    """Outputs carry no gradient and the inputs are cut from the tape, as
    the reference's `back_prop=False`."""
    args = [torch.from_numpy(a).requires_grad_(True) for a in _inputs(6, 4)]
    out = tvt.from_importance_weights(*args)
    assert not out.vs.requires_grad and not out.clipped_rhos.requires_grad


def _softmax_inputs(B=4, T=7, A=5, seed=1):
    rng = np.random.RandomState(seed)

    def probs():
        logits = rng.randn(B, T, A).astype(np.float32)
        e = np.exp(logits - logits.max(-1, keepdims=True))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)

    return dict(
        behavior_policy=probs(), target_policy=probs(),
        actions=rng.randint(0, A, (B, T)).astype(np.int32),
        discounts=((rng.rand(B, T) > 0.2) * 0.99).astype(np.float32),
        rewards=rng.randn(B, T).astype(np.float32),
        values=rng.randn(B, T).astype(np.float32),
        next_values=rng.randn(B, T).astype(np.float32),
    )


def test_from_softmax_and_losses_match_jax():
    d = _softmax_inputs()
    port = tvt.from_softmax(**{k: torch.from_numpy(v) for k, v in d.items()})
    ref = jvt.from_softmax(**{k: jnp.asarray(v) for k, v in d.items()}, backend="reference")
    np.testing.assert_allclose(port.vs.numpy(), np.asarray(ref.vs), atol=2e-6)
    np.testing.assert_allclose(port.clipped_rhos.numpy(), np.asarray(ref.clipped_rhos),
                               atol=1e-7)

    p, a, adv = d["target_policy"], d["actions"], d["rewards"]
    pairs = [
        (tvt.policy_gradient_loss(torch.from_numpy(p), torch.from_numpy(a), torch.from_numpy(adv)),
         jvt.policy_gradient_loss(jnp.asarray(p), jnp.asarray(a), jnp.asarray(adv))),
        (tvt.baseline_loss(torch.from_numpy(d["values"]), torch.from_numpy(d["next_values"])),
         jvt.baseline_loss(jnp.asarray(d["values"]), jnp.asarray(d["next_values"]))),
        (tvt.entropy_loss(torch.from_numpy(p)), jvt.entropy_loss(jnp.asarray(p))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    split = tvt.split_data(torch.arange(10).reshape(2, 5))
    assert [tuple(x.shape) for x in split] == [(2, 3)] * 3
    assert split[2][0].tolist() == [2, 3, 4]


def test_entropy_loss_is_nan_safe_at_zero_probability():
    p = torch.tensor([[0.0, 0.25, 0.75], [1.0, 0.0, 0.0]], requires_grad=True)
    loss = tvt.entropy_loss(p)
    loss.backward()
    want = 0.25 * np.log(0.25) + 0.75 * np.log(0.75)
    np.testing.assert_allclose(loss.item(), want, rtol=1e-6)
    assert torch.isfinite(p.grad).all()
    np.testing.assert_allclose(loss.item(), float(jvt.entropy_loss(jnp.asarray(p.detach().numpy()))),
                               rtol=1e-6)


def test_kernel_dispatch_follows_the_device():
    args = [torch.from_numpy(a) for a in _inputs(5, 8)]
    assert on_cuda(*args) is False
    with pytest.raises(ValueError, match="CUDA tensors"):
        kvt.vtrace_cuda(*args)
    with pytest.raises(ValueError, match="no kernel"):
        kvt.vtrace(*[a.to("meta") for a in args])
    with pytest.raises(TypeError, match="float32"):
        kvt.vtrace(*[a.double() for a in args])
    with pytest.raises(ValueError, match="bootstrap_value"):
        kvt.vtrace(*args[:4], args[4][:3])


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """A missing compiler is an error, never a quiet switch to the plain
    version."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("vtrace", lambda lib: None)
