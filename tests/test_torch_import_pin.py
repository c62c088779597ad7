"""The PyTorch port stands alone: no jax, flax, optax or JAX package.

A subprocess blocks those imports with a `sys.meta_path` finder and then
imports every module of the port and `chip_smoke`; a source scan finds no
such import statement either (an import inside a function that no test
reaches would escape the first check).
"""

import ast
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "distributed_reinforcement_learning_tpu_torch"
BLOCKED = ("jax", "jaxlib", "flax", "optax", "distributed_reinforcement_learning_tpu")


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _module_names():
    names = []
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(REPO).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names + ["chip_smoke"]


_SCRIPT = """
import importlib, importlib.abc, sys
BLOCKED = {blocked!r}

def blocked(name):
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)

for name in [m for m in sys.modules if blocked(m)]:
    del sys.modules[name]

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError("blocked import: " + name)
        return None

sys.meta_path.insert(0, Block())
for mod in {modules!r}:
    importlib.import_module(mod)
print("imported", len({modules!r}))
"""


def test_port_imports_with_jax_blocked():
    modules = _module_names()
    for name in ("ops.kernels.vtrace", "ops.kernels.lstm", "agents.r2d2", "data.replay",
                 "runtime.r2d2_runner", "train_r2d2", "ops.attention",
                 "ops.kernels.attention", "models.transformer_net", "agents.xformer",
                 "agents.ximpala", "runtime.ximpala_runner", "train_ximpala", "agents.apex",
                 "models.apex_net", "data.native", "runtime.replay_train",
                 "runtime.apex_runner", "train_apex", "data.replay_service",
                 "data.replay_spill", "data.admission", "data.device_path",
                 "runtime.replay_shard", "ops.moe", "runtime.xformer_runner",
                 "train_xformer", "envs.pong_sim", "envs.invaders_sim",
                 "envs.gymnasium_env", "runtime.inference", "runtime.serving",
                 "parallel.sequence", "parallel.pipeline"):
        assert f"distributed_reinforcement_learning_tpu_torch.{name}" in modules
    script = _SCRIPT.format(blocked=BLOCKED, modules=modules)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"imported {len(modules)}" in proc.stdout


def test_port_sources_name_no_jax_import():
    offenders = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in BLOCKED:
                    offenders.append(f"{path.relative_to(REPO)}:{node.lineno} {name}")
    assert offenders == []
