"""The port's synthetic batches (`utils/synthetic.py`) against the JAX
package's `utils/synthetic.py`.

- Each of the five constructors, at several seeds and shapes (uint8 and
  float observations, uniform and Dirichlet or softmax behaviour): every
  field, and the IS weights where there are some, equal to JAX's bit for
  bit at the same dtype, in the port's own batch NamedTuple with JAX's
  field names.
- `device=`: tensors on that device with the numpy values.
- One IMPALA and one R2D2 learn step on a port-built batch, at a small
  width, against JAX's step on JAX's batch from the same converted
  parameters: the reference's learn-step tolerance, rtol 1e-4.
"""

import jax
import numpy as np
import pytest
import torch

from distributed_reinforcement_learning_tpu.agents.impala import ImpalaAgent as JaxImpala
from distributed_reinforcement_learning_tpu.agents.impala import ImpalaConfig as JaxImpalaConfig
from distributed_reinforcement_learning_tpu.agents.r2d2 import R2D2Agent as JaxR2D2
from distributed_reinforcement_learning_tpu.agents.r2d2 import R2D2Config as JaxR2D2Config
from distributed_reinforcement_learning_tpu.utils import synthetic as jax_synthetic
from distributed_reinforcement_learning_tpu_torch.agents.impala import ImpalaAgent, ImpalaConfig
from distributed_reinforcement_learning_tpu_torch.agents.r2d2 import R2D2Agent, R2D2Config
from distributed_reinforcement_learning_tpu_torch.models.convert import (
    impala_params_from_jax, r2d2_params_from_jax)
from distributed_reinforcement_learning_tpu_torch.utils import synthetic

CASES = {
    "impala_uint8_uniform": ("synthetic_impala_batch",
                             dict(B=2, T=3, obs_shape=(8, 8, 4), num_actions=4, lstm_size=8,
                                  seed=0)),
    "impala_float_dirichlet": ("synthetic_impala_batch",
                               dict(B=3, T=4, obs_shape=(4,), num_actions=3, lstm_size=16,
                                    seed=1, obs_dtype=np.float32, uniform_behavior=False)),
    "impala_uint8_dirichlet": ("synthetic_impala_batch",
                               dict(B=2, T=5, obs_shape=(6, 6, 2), num_actions=6, lstm_size=4,
                                    seed=2, uniform_behavior=False)),
    "apex_float": ("synthetic_apex_batch", dict(B=5, obs_shape=(4,), num_actions=2, seed=0)),
    "apex_uint8": ("synthetic_apex_batch",
                   dict(B=3, obs_shape=(8, 8, 4), num_actions=4, seed=3, obs_dtype=np.uint8)),
    "r2d2_vector": ("synthetic_r2d2_batch",
                    dict(B=4, T=10, obs_shape=(2,), num_actions=2, lstm_size=8, seed=0)),
    "r2d2_pixels": ("synthetic_r2d2_batch",
                    dict(B=2, T=3, obs_shape=(8, 8, 4), num_actions=4, lstm_size=4, seed=5)),
    "xformer_vector": ("synthetic_xformer_batch",
                       dict(B=4, T=10, obs_shape=(2,), num_actions=2, seed=0)),
    "xformer_wide": ("synthetic_xformer_batch",
                     dict(B=2, T=6, obs_shape=(4,), num_actions=3, seed=7)),
    "ximpala_uniform": ("synthetic_ximpala_batch",
                        dict(B=3, T=8, obs_shape=(4,), num_actions=2, seed=0)),
    "ximpala_softmax": ("synthetic_ximpala_batch",
                        dict(B=2, T=5, obs_shape=(4,), num_actions=3, seed=2,
                             uniform_behavior=False)),
}


def _split(out):
    """-> (batch, IS weights or None)."""
    return (out, None) if hasattr(out, "_fields") else out


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_field_equals_jax_bit_for_bit(case):
    name, kw = CASES[case]
    got, got_w = _split(getattr(synthetic, name)(**kw))
    want, want_w = _split(getattr(jax_synthetic, name)(**kw))
    assert type(got).__module__.startswith("distributed_reinforcement_learning_tpu_torch.agents")
    assert type(got).__name__ == type(want).__name__
    assert got._fields == want._fields
    for field in want._fields:
        a, b = getattr(got, field), getattr(want, field)
        assert isinstance(a, np.ndarray), field
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert np.array_equal(a, b), field
    if want_w is not None:
        assert got_w.dtype == want_w.dtype and np.array_equal(got_w, want_w)


def test_device_keyword_places_tensors():
    batch, weights = synthetic.synthetic_r2d2_batch(2, 3, (2,), 2, 4, seed=1, device="cpu")
    ref, ref_w = synthetic.synthetic_r2d2_batch(2, 3, (2,), 2, 4, seed=1)
    for field in ref._fields:
        t = getattr(batch, field)
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu", field
        assert np.array_equal(t.numpy(), getattr(ref, field)), field
    assert batch.action.dtype == torch.int64  # the index type the agents gather with
    assert np.array_equal(weights.numpy(), ref_w)
    single = synthetic.synthetic_ximpala_batch(2, 3, (4,), 2, device="cpu")
    assert all(isinstance(t, torch.Tensor) for t in single)


def test_impala_learn_step_on_a_synthetic_batch_matches_jax():
    kw = dict(obs_shape=(4,), num_actions=3, lstm_size=16, trajectory=5)
    jagent = JaxImpala(JaxImpalaConfig(**kw))
    jstate = jax.jit(jagent.init_state)(jax.random.PRNGKey(0))
    agent = ImpalaAgent(ImpalaConfig(**kw), device="cpu")
    state = agent.state_from_params(impala_params_from_jax(jax.tree.map(np.asarray, jstate.params)))
    shape = dict(B=3, T=5, obs_shape=(4,), num_actions=3, lstm_size=16, seed=4,
                 obs_dtype=np.float32, uniform_behavior=False)
    jstate, want = jax.jit(jagent._learn)(jstate, jax_synthetic.synthetic_impala_batch(**shape))
    state, got = agent.learn(state, synthetic.synthetic_impala_batch(**shape))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, err_msg=k)
    for k, w in impala_params_from_jax(jax.tree.map(np.asarray, jstate.params)).items():
        np.testing.assert_allclose(state.params[k].detach().numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-8, err_msg=k)


def test_r2d2_learn_step_on_a_synthetic_batch_matches_jax():
    kw = dict(obs_shape=(2,), num_actions=2, seq_len=10, burn_in=5, lstm_size=16,
              learning_rate=1e-3)
    jagent = JaxR2D2(JaxR2D2Config(**kw))
    jstate = jax.jit(jagent.init_state)(jax.random.PRNGKey(0))
    agent = R2D2Agent(R2D2Config(**kw), device="cpu")
    state = agent.state_from_params(r2d2_params_from_jax(jax.tree.map(np.asarray, jstate.params)))
    shape = dict(B=4, T=10, obs_shape=(2,), num_actions=2, lstm_size=16, seed=6)
    jbatch, jweights = jax_synthetic.synthetic_r2d2_batch(**shape)
    jstate, want_prio, want = jax.jit(jagent._learn)(jstate, jbatch, jweights)
    state, prio, got = agent.learn(state, *synthetic.synthetic_r2d2_batch(**shape))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(prio.numpy(), np.asarray(want_prio), rtol=1e-4, atol=1e-7)
    for k, w in r2d2_params_from_jax(jax.tree.map(np.asarray, jstate.params)).items():
        np.testing.assert_allclose(state.params[k].detach().numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
