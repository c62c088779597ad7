"""The port's last seven scripts against the JAX package's, on the CPU.

`stability_probe`, `r2d2_cycle_probe`, `return_curves`, `diag_imitation`,
`profile_learn_decomp`, `profile_nature_learn` and `actor_scale_demo` at
the port package's root are the counterparts of `scripts/<same name>.py`:

- argv: the five argparse modules parse their JAX script's own argv to
  the same fields (`device` for `platform`), and the profilers their
  positional `B`; no module's default output lies under `benchmarks/`;
- the statistics bit for bit: `cycle_stats`, the stability probe's JSON
  line (both `main`s over canned returns), `return_curves._summary`, the
  families' names and overrides, and the curve files' format;
- `diag_imitation`: the expert's rollout fed JAX's launch draws (the
  tracker's actions and the observation/next-action pairs bit for bit),
  the cross-entropy and accuracy on converted parameters, and one Adam
  step against `optax.adam`, each against the JAX script's own functions
  (taken from its `main` as it runs);
- the profilers: each variant's first-iteration value (loss, gradients,
  updated parameters) against the JAX variant's function at B = 2 in
  float32 (learn-step rtol 1e-4; V-trace 2e-6);
- the actor-scale demo on the CPU: every actor's `[actor k] stats {...}`
  line with the JAX actor's keys (and the port client's
  `weight_bytes_received`), the learner's `[transport]` series and the
  JAX summary's keys.
"""

import json
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from threadpoolctl import threadpool_limits

from distributed_reinforcement_learning_tpu.agents import impala as jax_impala
from distributed_reinforcement_learning_tpu.runtime import launch as jax_launch
from distributed_reinforcement_learning_tpu.runtime.transport import (
    TransportClient as JaxClient)
from distributed_reinforcement_learning_tpu_torch import (
    actor_scale_demo, diag_imitation, profile_learn_decomp, profile_nature_learn,
    r2d2_cycle_probe, return_curves, stability_probe)
from distributed_reinforcement_learning_tpu_torch.agents.impala import ImpalaAgent, ImpalaConfig
from distributed_reinforcement_learning_tpu_torch.models.convert import impala_params_from_jax
from distributed_reinforcement_learning_tpu_torch.runtime import launch as port_launch
from distributed_reinforcement_learning_tpu_torch.utils.synthetic import synthetic_impala_batch
from test_torch_drivers import REPO, _jax_script, _namespace


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


class _Stop(Exception):
    pass


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _from_script(name: str) -> bool:
    """Whether the caller's caller is `scripts/<name>.py` (a spy on a jax
    function intercepts the script's own calls, not the package's)."""
    return sys._getframe(2).f_code.co_filename.endswith(f"scripts/{name}.py")


# -- argv -------------------------------------------------------------------------

ARGV = {
    "stability_probe": [
        "--section", "xformer", "--updates", "7", "--seed", "3", "--priority-eta", "0.5",
        "--adam-clip", "10", "--epsilon-floor", "0.1", "--timeout-nonterminal",
        "--target-sync", "20", "--replay-capacity", "500", "--threshold", "50"],
    "r2d2_cycle_probe": [
        "--out", "o", "--updates", "9", "--seeds", "2", "3", "--recent-fraction", "0.5",
        "--recent-window", "64", "--baseline"],
    "return_curves": [
        "--families", "impala_cartpole,apex_cartpole", "--updates-scale", "0.5", "--seed", "2"],
    "diag_imitation": [
        "--platform", "cpu", "--steps", "5", "--envs", "4", "--rollout", "8", "--batch", "16",
        "--lr", "3e-4"],
    "actor_scale_demo": [
        "--out", "o", "--actors", "3", "--minutes", "0.5", "--section", "impala",
        "--stats-interval", "2"],
}
OUT_FLAG = ("r2d2_cycle_probe", "actor_scale_demo")
PORT = {"stability_probe": stability_probe, "r2d2_cycle_probe": r2d2_cycle_probe,
        "return_curves": return_curves, "diag_imitation": diag_imitation,
        "actor_scale_demo": actor_scale_demo}


@pytest.mark.parametrize("name", sorted(ARGV))
def test_each_script_parses_the_jax_argv_to_the_same_fields(name, monkeypatch):
    for argv in (ARGV[name], []):
        want = _namespace(_jax_script(name).main, argv, monkeypatch)
        got = _namespace(PORT[name].main, argv, monkeypatch)
        assert got.pop("device") == want.pop("platform", None)
        if not argv and name in OUT_FLAG:  # the JAX default lies under benchmarks/
            assert want.pop("out").startswith("benchmarks/")
            assert not got.pop("out").startswith("benchmarks")
        assert got == want
    spelled = [("--device" if a == "--platform" else a) for a in ARGV[name]]
    if "--device" not in spelled:
        spelled += ["--device", "cpu"]
    assert PORT[name].parse_args(spelled).device == "cpu"


def _jax_profiler_b(name: str, argv: list[str], monkeypatch) -> int:
    """The batch size the JAX profiler takes from `argv`: its main stops at
    the synthetic batch, before any parameter is built."""
    from distributed_reinforcement_learning_tpu.utils import synthetic as jax_synthetic

    def stop(B, *a, **k):
        raise _Stop(B)

    stub = lambda cfg: types.SimpleNamespace(init_state=lambda key: None)  # noqa: E731
    mod = _jax_script(name)
    with monkeypatch.context() as m:
        m.setattr(sys, "argv", ["script", *argv])
        m.setattr(jax_synthetic, "synthetic_impala_batch", stop)
        m.setattr(jax_impala, "ImpalaAgent", stub)
        for attr, val in (("synthetic_impala_batch", stop), ("ImpalaAgent", stub)):
            if hasattr(mod, attr):
                m.setattr(mod, attr, val)
        with pytest.raises(_Stop) as got:
            mod.main()
    return got.value.args[0]


@pytest.mark.parametrize("name, port", [("profile_learn_decomp", profile_learn_decomp),
                                        ("profile_nature_learn", profile_nature_learn)])
def test_each_profiler_parses_the_jax_batch_size(name, port, monkeypatch):
    for argv in (["5"], []):
        assert port.parse_args(argv).B == _jax_profiler_b(name, argv, monkeypatch)
    assert port.parse_args(["7", "--platform", "cpu"]).device == "cpu"


def test_no_default_output_lies_under_benchmarks():
    outs = [r2d2_cycle_probe.parse_args([]).out, actor_scale_demo.parse_args([]).out,
            return_curves.OUT_DIR, str(profile_nature_learn.OUT_DIR)]
    assert outs == ["runs/r2d2_recent", "runs/actor_scale", "runs/curves",
                    "runs/nature_cnn_profile"]


# -- the statistics -----------------------------------------------------------------

def _returns(n: int, seed: int) -> list[float]:
    """Episode returns with a rise, a collapse and a recovery around 100."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    curve = 100 + 90 * np.sin(t / max(n / 6, 1)) + rng.normal(0, 25, n)
    return [float(x) for x in np.clip(curve, 8, 200).round(1)]


CANNED = {"short": _returns(12, 1), "under50": _returns(37, 2), "long": _returns(640, 3)}


@pytest.mark.parametrize("case", sorted(CANNED))
def test_cycle_stats_match_jax_bit_for_bit(case):
    want = _jax_script("r2d2_cycle_probe").cycle_stats(CANNED[case])
    assert r2d2_cycle_probe.cycle_stats(CANNED[case]) == want


def _canned_build(returns):
    return lambda *a, **k: (None, None, lambda learner, actors, n: {"episode_returns": returns})


@pytest.mark.parametrize("case", sorted(CANNED))
def test_stability_probe_prints_the_jax_line(case, monkeypatch, capsys):
    argv = ["--updates", "11", "--priority-eta", "0.9", "--target-sync", "40",
            "--threshold", "120"]
    monkeypatch.chdir(REPO)
    monkeypatch.setattr(jax_launch, "build_local", _canned_build(CANNED[case]))
    monkeypatch.setattr(port_launch, "build_local", _canned_build(CANNED[case]))
    monkeypatch.setattr(sys, "argv", ["script", *argv])
    _jax_script("stability_probe").main()
    want = capsys.readouterr().out
    got = stability_probe.main(argv + ["--device", "cpu"])
    assert capsys.readouterr().out == want
    assert got == json.loads(want)
    assert got["knobs"] == {"priority_eta": 0.9, "timeout_nonterminal": False,
                            "target_sync_interval": 40}


@pytest.mark.parametrize("case", sorted(CANNED))
def test_curve_summary_matches_jax_bit_for_bit(case):
    want = _jax_script("return_curves")._summary(CANNED[case])
    assert return_curves._summary(CANNED[case]) == want
    assert return_curves._summary([]) == {"episodes": 0}


def test_families_and_their_overrides_match_jax(monkeypatch):
    jax_mod = _jax_script("return_curves")
    assert list(return_curves.FAMILIES) == list(jax_mod.FAMILIES)

    def recorder(calls):
        def family(section, updates, seed=0, device=None, agent_overrides=None, **rt):
            calls.append((section, updates, seed, agent_overrides, rt))
            return {}, []

        def apex(updates, seed=0, device=None):
            calls.append(("apex_cartpole(direct)", updates, seed, None, {}))
            return {}, []
        return family, apex

    got, want = [], []
    for mod, calls in ((return_curves, got), (jax_mod, want)):
        family, apex = recorder(calls)
        monkeypatch.setattr(mod, "_config_family", family)
        monkeypatch.setattr(mod, "run_apex_cartpole", apex)
        for name in mod.FAMILIES:
            mod.FAMILIES[name](0.37, seed=5)
    assert got == want


def test_curve_file_is_written_as_jax_writes_it(tmp_path, monkeypatch):
    jax_mod = _jax_script("return_curves")
    meta = {"section": "impala_cartpole", "updates": 5, "seed": 0, "overrides": {},
            "wall_s": 1.5}
    for mod, sub in ((jax_mod, "jax"), (return_curves, "port")):
        monkeypatch.setattr(mod, "OUT_DIR", str(tmp_path / sub))
        mod._write_curve("c", meta, CANNED["under50"])
    assert (tmp_path / "port" / "c.jsonl").read_bytes() == (tmp_path / "jax" / "c.jsonl").read_bytes()


def test_one_family_runs_and_a_failed_family_exits_nonzero(tmp_path, monkeypatch):
    """impala_cartpole at 5 updates writes the JAX meta and JSONL lines;
    a family that raises is recorded, the next still runs, and the run
    exits 1 (the JAX script exits 0: a divergence by design)."""
    monkeypatch.setattr(return_curves, "OUT_DIR", str(tmp_path))
    got = return_curves.main(["--families", "impala_cartpole", "--updates-scale", "0.002",
                              "--device", "cpu"])
    lines = (tmp_path / "impala_cartpole_smoke.jsonl").read_text().splitlines()
    meta = json.loads(lines[0])["meta"]
    assert set(meta) == {"section", "updates", "seed", "overrides", "wall_s", "episodes",
                         "early20_mean", "late20_mean", "best20_mean", "overall_mean"}
    assert meta["updates"] == 5 and meta["episodes"] == len(lines) - 1 > 0
    assert [set(json.loads(line)) for line in lines[1:]] == [{"episode", "return"}] * (
        len(lines) - 1)
    assert got == {"impala_cartpole_smoke": meta}
    assert not (tmp_path / "summary.json").exists()  # a smoke run leaves the table alone

    def broken(s, seed=0, device=None):
        raise RuntimeError("boom")

    monkeypatch.setitem(return_curves.FAMILIES, "apex_cartpole", broken)
    monkeypatch.setitem(return_curves.FAMILIES, "ximpala_cartpole",
                        lambda s, seed=0, device=None: ({"section": "x"}, [1.0, 2.0]))
    with pytest.raises(SystemExit) as e:
        return_curves.main(["--families", "apex_cartpole,ximpala_cartpole", "--device", "cpu"])
    assert e.value.code == 1
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert summary["apex_cartpole"] == {"error": "RuntimeError: boom"}
    assert summary["ximpala_cartpole"]["episodes"] == 2


# -- diag_imitation -------------------------------------------------------------

ENVS, ROLLOUT, BATCH, LR = 4, 8, 8, 1e-3


def _jax_diag(monkeypatch) -> dict:
    """Run the JAX script's main until its first train step: its expert
    rollout's outputs, its agent and initial state, and its loss
    function."""
    seen: dict = {}
    real_scan = jax.lax.scan

    def scan(f, init, xs, length=None, **k):
        out = real_scan(f, init, xs, length=length, **k)
        if _from_script("diag_imitation"):
            seen.setdefault("rollout", out[1][:2])
        return out

    init_state = jax_impala.ImpalaAgent.init_state

    def record_init(self, key):
        seen["agent"], seen["state"] = self, init_state(self, key)
        return seen["state"]

    def value_and_grad(fn, **k):
        seen["loss_fn"] = fn
        raise _Stop

    with monkeypatch.context() as m:
        m.setattr(jax.lax, "scan", scan)
        m.setattr(jax_impala.ImpalaAgent, "init_state", record_init)
        m.setattr(jax, "value_and_grad", value_and_grad)
        m.setattr(sys, "argv", ["script", "--envs", str(ENVS), "--rollout", str(ROLLOUT),
                                "--batch", str(BATCH), "--lr", str(LR), "--steps", "1"])
        with pytest.raises(_Stop):
            _jax_script("diag_imitation").main()
    return seen


@pytest.fixture(scope="module")
def jax_diag():
    mp = pytest.MonkeyPatch()
    try:
        yield _jax_diag(mp)
    finally:
        mp.undo()


def _jax_draws(n_steps: int):
    """Step t's launch draws as the JAX script makes them: `rng, k =
    split(rng)` from PRNGKey(0), then `breakout_jax.step`'s randint."""
    rng, out = jax.random.PRNGKey(0), []
    for _ in range(n_steps):
        rng, k = jax.random.split(rng)
        out.append(torch.from_numpy(np.array(jax.random.randint(k, (4, ENVS), 0, 4))))
    return out


def test_expert_rollout_matches_jax_with_its_draws(jax_diag):
    obs_t, act_t = jax_diag["rollout"]
    draws = _jax_draws(ROLLOUT)
    got_obs, got_act = diag_imitation.expert_rollout(
        ENVS, ROLLOUT, torch.Generator().manual_seed(0), draws=lambda t: draws[t])
    np.testing.assert_array_equal(got_act.numpy(), np.asarray(act_t))  # the tracker's actions
    assert set(np.unique(np.asarray(act_t))) >= {1, 2, 3}  # fire and steer both ways
    X, Y = diag_imitation.expert_pairs(got_obs, got_act)
    np.testing.assert_array_equal(X.numpy(), np.asarray(obs_t[:-1]).reshape(-1, 84, 84, 4))
    np.testing.assert_array_equal(Y.numpy(), np.asarray(act_t[1:]).reshape(-1))


def _minibatch(jax_diag):
    obs_t, act_t = jax_diag["rollout"]
    X = np.asarray(obs_t[:-1]).reshape(-1, 84, 84, 4)
    Y = np.asarray(act_t[1:]).reshape(-1)
    idx = np.random.default_rng(0).integers(0, len(X), BATCH)
    return X[idx], Y[idx]


def test_cross_entropy_and_adam_step_match_jax(jax_diag):
    xb, yb = _minibatch(jax_diag)
    params = _np_tree(jax_diag["state"].params)
    agent = diag_imitation.make_agent("cpu")
    for field in ("obs_shape", "num_actions", "trajectory", "lstm_size", "fold_normalize"):
        assert getattr(agent.cfg, field) == getattr(jax_diag["agent"].cfg, field), field
    tx, opt = diag_imitation.adam_state(impala_params_from_jax(params), LR)
    xt, yt = torch.from_numpy(xb), torch.from_numpy(yb).long()

    (want_ce, want_acc), grads = jax.jit(jax.value_and_grad(jax_diag["loss_fn"], has_aux=True))(
        params, jnp.asarray(xb), jnp.asarray(yb))
    ce, acc = diag_imitation.ce_and_accuracy(agent, opt.params, xt, yt)
    np.testing.assert_allclose(float(ce.detach()), float(want_ce), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(acc), float(want_acc), rtol=1e-5, atol=1e-5)

    jtx = optax.adam(LR)
    updates, _ = jtx.update(grads, jtx.init(params), params)
    want = impala_params_from_jax(_np_tree(optax.apply_updates(params, updates)))
    ce2, acc2 = diag_imitation.train_step(agent, tx, opt, xt, yt)
    assert float(ce2) == float(ce.detach()) and float(acc2) == float(acc)
    assert set(want) == set(opt.params) and opt.step == 1
    for k, w in want.items():
        np.testing.assert_allclose(opt.params[k].detach().numpy(), w.numpy(), rtol=1e-4,
                                   atol=0.01 * LR, err_msg=k)


# -- the profilers ----------------------------------------------------------------

class _Float32Numpy(types.ModuleType):
    """`jax.numpy` with `bfloat16` read as float32: the JAX profile at the
    parity tests' dtype."""

    def __getattr__(self, name):
        return getattr(jnp, name)


def _close(got: torch.Tensor, want, rtol: float, what: str, atol: float | None = None) -> None:
    """rtol plus an atol of 1e-5 of the tensor's largest (chip_smoke's
    learn-step bar) unless given, for elements at float32's noise floor."""
    want = np.asarray(want, np.float32)
    atol = 1e-5 * float(np.abs(want).max()) if atol is None else atol
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=rtol, atol=atol,
                               err_msg=what)


def _close_tree(got: dict, want_tree, what: str, grads: bool = False) -> None:
    """Leaf by leaf at rtol 1e-4. Gradients take their atol from the
    largest element of the whole tree: a leaf whose exact gradient is zero
    (the policy head under a sum of softmax probabilities) holds only
    float32 noise, which its own scale cannot bound."""
    want = impala_params_from_jax(_np_tree(want_tree))
    assert set(got) == set(want), what
    atol = 1e-5 * max(float(w.abs().max()) for w in want.values()) if grads else None
    for k, w in want.items():
        _close(got[k], w.numpy(), 1e-4, f"{what} {k}", atol)


def _port_profile(jstate_params, cparams, B: int = 2):
    cfg = ImpalaConfig(dtype=torch.float32)
    agent = ImpalaAgent(cfg, device="cpu")
    state = agent.state_from_params(impala_params_from_jax(jstate_params))
    batch = synthetic_impala_batch(B, cfg.trajectory, cfg.obs_shape, cfg.num_actions,
                                   cfg.lstm_size, uniform_behavior=False, device="cpu")
    conv, _ = profile_learn_decomp.nature_conv(torch.float32, "cpu", seed=0)
    conv_params = {k: v.requires_grad_(True) for k, v in impala_params_from_jax(cparams).items()}
    return agent, state, batch, conv, conv_params


def test_learn_decomp_variants_match_jax(monkeypatch):
    mod = _jax_script("profile_learn_decomp")
    taken = []
    proxy = _Float32Numpy("jnp")
    proxy.bfloat16 = jnp.float32
    monkeypatch.setattr(mod, "jnp", proxy)
    monkeypatch.setattr(mod, "timeit", lambda step, carry0, label: taken.append(
        (label, step, carry0)) or 1.0)
    monkeypatch.setattr(sys, "argv", ["script", "2"])
    mod.main()
    steps = {label[0]: (step, carry0) for label, step, carry0 in taken}
    assert sorted(steps) == list("ABCDEFGHI")
    jparams = _np_tree(steps["A"][1][0].params)  # before A's step donates the state
    cparams = _np_tree(steps["G"][1][0])
    agent, state, batch, conv, conv_params = _port_profile(jparams, cparams)
    np.testing.assert_array_equal(batch.state.numpy(), np.asarray(steps["A"][1][1]))
    port = {v.label[0]: v for v in profile_learn_decomp.variants(agent, state, batch, conv,
                                                                  conv_params)}
    assert sorted(port) == sorted(steps)
    for key in "BCDEFGHIA":  # A last: its step donates the state the others read
        step, carry0 = steps[key]
        want = jax.jit(step)(carry0)[0]  # one iteration of the script's scan body
        v = port[key]
        got = v.step(v.init())
        if key == "A":
            _close_tree(got, want.params, "A")
        elif key in "BEG":
            _close_tree(got, want, key, grads=True)
        elif key == "I":
            np.testing.assert_allclose(float(got[1].sum()), float(want), rtol=2e-6, atol=2e-6)
        else:
            np.testing.assert_allclose(float(got), float(want), rtol=1e-4, err_msg=key)


def test_nature_parts_match_jax(tmp_path, monkeypatch):
    """The JAX script's parts, taken from its scans as it builds them, each
    at the value it keeps for its first iteration; the learn step's
    parameters in full."""
    bodies, seen = [], {}
    real_scan = jax.lax.scan

    def scan(f, init, xs, length=None, **k):
        if not _from_script("profile_nature_learn"):
            return real_scan(f, init, xs, length=length, **k)
        bodies.append(f)
        if len(bodies) == 13:  # the learn scan: the six parts are taken
            raise _Stop
        return init, None

    init_state = jax_impala.ImpalaAgent.init_state

    def record_init(self, key):
        seen["agent"], seen["state"] = self, init_state(self, key)
        return seen["state"]

    real_config = jax_impala.ImpalaConfig
    monkeypatch.chdir(tmp_path)
    with monkeypatch.context() as m:
        m.setattr(jax.lax, "scan", scan)
        m.setattr(jax_impala.ImpalaAgent, "init_state", record_init)
        m.setattr(jax_impala, "ImpalaConfig",
                  lambda dtype=None, **k: real_config(dtype=jnp.float32, **k))
        m.setattr(sys, "argv", ["script", "2"])
        with pytest.raises(_Stop):
            _jax_script("profile_nature_learn").main()
    assert not (tmp_path / "benchmarks").exists()
    jagent, jstate = seen["agent"], seen["state"]
    jparams = _np_tree(jstate.params)
    names = ["conv", "fwd", "post", "loss", "grad", "opt"]
    body = {name: bodies[2 * i] for i, name in enumerate(names)}
    body["learn"] = bodies[12]
    c0 = jnp.float32(profile_nature_learn.C0)

    from distributed_reinforcement_learning_tpu.models.torso import NatureConv as JaxConv
    from distributed_reinforcement_learning_tpu.utils.synthetic import (
        synthetic_impala_batch as jax_batch)
    B, cfg = 2, jagent.cfg
    jb = jax.tree.map(jnp.asarray, jax_batch(B, cfg.trajectory, cfg.obs_shape,
                                             cfg.num_actions, cfg.lstm_size,
                                             uniform_behavior=False))
    flat = (jb.state.astype(jnp.float32) / 255.0).reshape((-1,) + tuple(cfg.obs_shape))
    cparams = _np_tree(JaxConv(dtype=cfg.dtype).init(jax.random.PRNGKey(1), flat[:1]))
    agent, state, batch, conv, conv_params = _port_profile(jparams, cparams)
    conv_params = {k: v.detach() for k, v in conv_params.items()}
    port = {v.label: v for v in profile_nature_learn.parts(agent, state, batch, conv,
                                                           conv_params)}
    assert sorted(port) == sorted(body)

    parts = [name for name in body if name != "learn"]
    first = jax.jit(lambda c: [body[name](c, None)[0] for name in parts])(c0)
    first = dict(zip(parts, first))
    for name in ("conv", "fwd", "loss"):
        np.testing.assert_allclose(float(port[name].step(None)), float(first[name]),
                                   rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(float(port["post"].step(None)), float(first["post"]),
                               rtol=2e-6, atol=2e-6)
    # The JAX parts keep the mean of the first leaf of the gradient and of
    # the RMSProp update; the port's, of the same parameter (variant B of
    # the learn-step profile holds the whole gradient, part learn below
    # the whole update).
    leaves, treedef = jax.tree.flatten(jparams)
    marked = impala_params_from_jax(jax.tree.unflatten(
        treedef, [np.ones_like(leaves[0])] + [np.zeros_like(x) for x in leaves[1:]]))
    (leaf0,) = [k for k, v in marked.items() if v.any()]
    grad = port["grad"].step(None)[leaf0]
    np.testing.assert_allclose(float(grad.mean()), float(first["grad"]), rtol=1e-4,
                               atol=1e-5 * float(grad.abs().max()))
    opt = port["opt"]
    before = state.params[leaf0].detach().clone()
    update = opt.step(opt.init())[leaf0].detach() - before
    np.testing.assert_allclose(float(update.mean()), float(first["opt"]), rtol=1e-4,
                               atol=1e-5 * float(update.abs().max()))

    want = jax.jit(body["learn"])(jstate, None)[0].params
    _close_tree(port["learn"].step(port["learn"].init()), want, "learn")


def test_nature_main_writes_its_results(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(profile_nature_learn, "K", 1)
    monkeypatch.setattr(profile_nature_learn, "REPS", 1)
    got = profile_nature_learn.main(["2", "--device", "cpu"])
    assert json.loads((tmp_path / "runs" / "nature_cnn_profile" / "RESULTS.json").read_text()) == got
    want = {"B", "K", "dtype", "conv_ms", "fwd_ms", "post_ms", "loss_ms", "grad_ms", "opt_ms",
            "learn_ms", "bwd_ms_derived", "sum_grad_opt_ms", "sum_over_learn",
            "fwd_minus_conv_ms", "loss_minus_fwd_ms"}
    assert want <= set(got) and got["B"] == 2 and got["dtype"] == "bfloat16"
    assert got["learn_device_ms"] is None  # the CPU: no device time
    assert got["launches"]["vtrace"] == 0  # CPU tensors take the plain version


# -- the actor-scale demo -----------------------------------------------------------

JAX_SUMMARY_KEYS = {  # scripts/actor_scale_demo.py:163-191
    "actors", "wall_s", "learner_updates", "updates_per_s", "unrolls_accepted",
    "busy_replies", "partial_accepts", "weight_sends", "queue_depth", "per_actor_unrolls",
    "fairness", "weight_versions"}


def test_actor_scale_demo_reads_every_actors_stats_line(tmp_path, monkeypatch):
    monkeypatch.setattr(JaxClient, "_connect_locked", lambda self: None)
    want_keys = set(JaxClient("127.0.0.1", 1).snapshot_stats()) | {"frames", "weight_version"}
    lines = []
    parse = actor_scale_demo.actor_stats_of
    monkeypatch.setattr(actor_scale_demo, "actor_stats_of",
                        lambda k, line: lines.append((k, parse(k, line))) or lines[-1][1])
    out = tmp_path / "demo"
    got = actor_scale_demo.main(["--out", str(out), "--actors", "2", "--minutes", "0.4",
                                 "--stats-interval", "1", "--device", "cpu"])
    stats = [(k, s) for k, s in lines if s is not None]
    assert {k for k, _ in stats} == {0, 1}
    # JAX's keys, and the port client's one more counter.
    assert all(set(s) - want_keys == {"weight_bytes_received"} for _, s in stats)
    assert all(want_keys <= set(s) for _, s in stats)
    assert set(got) == JAX_SUMMARY_KEYS
    assert json.loads(json.dumps(got)) == json.loads((out / "summary.json").read_text())
    assert set(got["per_actor_unrolls"]) == {0, 1} and min(got["per_actor_unrolls"].values()) > 0
    assert got["learner_updates"] > 0 and got["queue_depth"]["series_points"] > 0
    series = [json.loads(line) for line in (out / "depth_series.jsonl").read_text().splitlines()]
    assert series[-1]["unrolls"] == got["unrolls_accepted"] > 0
    tail = (out / "learner_tail.log").read_text().splitlines()
    assert json.loads(tail[-1])["train_steps"] >= got["learner_updates"]
