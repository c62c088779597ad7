"""Checkpoint/resume: parameters + optimizer state + step.

Counterpart of the JAX package's `utils/checkpoint.py`, with `torch.save`
in place of flax's msgpack:

- the unit is the learner's whole train state (`agents/common.py`
  `TrainState` or `TargetTrainState`: every field, as a dict of
  tensors or an int), plus a JSON sidecar of host-side counters and
  named auxiliary blobs (the replay learners' replay snapshot);
- writes are atomic (temp file, fsync, `os.replace`); the payload
  `ckpt_{step:010d}.pt` is written last and is the commit marker; the
  newest `retain` checkpoints are kept;
- `restore` loads with `torch.load(map_location=<the template's
  device>, weights_only=True)` and copies the values into the
  template's tensors in place, so a learner keeps its own leaf tensors;
- a learner over a model axis (`sharded=`) saves its state gathered
  whole and restores a whole checkpoint to its slices, so a checkpoint
  has the same tensors whatever mesh wrote or reads it.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import pickle
import re
import sys
import tempfile
from pathlib import Path
from typing import Any

import torch

_CKPT_RE = re.compile(r"^ckpt_(\d{10})\.pt$")


def encode_replay_snapshot(replay) -> bytes | None:
    """Pickle a replay buffer's `snapshot()` for checkpointing, or None:
    disabled with `DRL_CKPT_REPLAY=0`, skipped (with a log line) above
    `DRL_CKPT_REPLAY_MAX_MB` (default 512; a full Atari replay at
    capacity 1e5 is ~5.6 GB). Takes every backend's snapshot: the list
    backends' `items` and the array backend's `stacked` payload, each
    with its priorities and, where kept, the whole sum tree, and the
    sharded service's merged shard state. A backend that prices its
    snapshot (`approx_snapshot_nbytes`) is refused before the snapshot
    is copied.

    Items decoded from the wire are namedtuples that `codec.decode`
    rebuilt by name, classes no module holds, so plain pickle refuses
    them; they are pickled by name and fields instead
    (`_rebuild_namedtuple`), and unpickle as the codec's own classes."""
    if os.environ.get("DRL_CKPT_REPLAY", "1") == "0":
        return None
    cap_mb = float(os.environ.get("DRL_CKPT_REPLAY_MAX_MB", "512"))

    def over_cap(nbytes: int) -> bool:
        if nbytes > cap_mb * 1e6:
            print(f"[checkpoint] replay snapshot {nbytes / 1e6:.0f} MB exceeds "
                  f"DRL_CKPT_REPLAY_MAX_MB={cap_mb:.0f}; skipping (set higher to keep it)",
                  file=sys.stderr)
            return True
        return False

    estimate = getattr(replay, "approx_snapshot_nbytes", None)
    if estimate is not None and over_cap(estimate()):
        return None
    snap = replay.snapshot()
    nbytes = sum(x.nbytes for key in ("items", "stacked", "tree", "priorities")
                 for x in _iter_array_leaves(snap.get(key)))
    if over_cap(nbytes):
        return None
    buf = io.BytesIO()
    _SnapshotPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(snap)
    return buf.getvalue()


def _rebuild_namedtuple(name: str, fields: tuple, values: tuple):
    from distributed_reinforcement_learning_tpu_torch.data.codec import _namedtuple_cls

    return _namedtuple_cls(name, fields)(*values)


class _SnapshotPickler(pickle.Pickler):
    """Pickles a namedtuple whose class no module holds (a codec-rebuilt
    one) by name, fields and values."""

    def reducer_override(self, obj):
        cls = type(obj)
        if isinstance(obj, tuple) and hasattr(cls, "_fields"):
            module = sys.modules.get(cls.__module__)
            if getattr(module, cls.__qualname__, None) is not cls:
                return _rebuild_namedtuple, (cls.__name__, tuple(cls._fields), tuple(obj))
        return NotImplemented


def decode_replay_snapshot(data: bytes) -> dict:
    """Inverse of `encode_replay_snapshot`. Unpickles: only for blobs this
    program wrote into its own checkpoint directory."""
    return pickle.loads(data)


def _iter_array_leaves(tree):
    if hasattr(tree, "nbytes"):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _iter_array_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _iter_array_leaves(v)


def _atomic_write(path: Path, write) -> None:
    """`write(file)` into a temp file beside `path`, fsync, rename."""
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=path.name, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        dirfd = os.open(path.parent, os.O_RDONLY)
        try:
            os.fsync(dirfd)
        finally:
            os.close(dirfd)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def state_to_dict(state: Any) -> dict:
    """A train-state dataclass -> {field: dict of detached tensors or int}."""
    return {f.name: ({k: v.detach() for k, v in val.items()} if isinstance(val, dict) else val)
            for f in dataclasses.fields(state) for val in [getattr(state, f.name)]}


def load_state_into(state: Any, saved: dict) -> Any:
    """Copy `saved` (from `state_to_dict`) into `state`'s tensors in place;
    -> `state`. Raises on a missing or extra field or tensor name."""
    names = {f.name for f in dataclasses.fields(state)}
    if set(saved) != names:
        raise ValueError(f"checkpoint fields {sorted(saved)} != train state's {sorted(names)}")
    with torch.no_grad():
        for name in names:
            cur, new = getattr(state, name), saved[name]
            if isinstance(cur, dict):
                if set(cur) != set(new):
                    raise ValueError(f"checkpoint {name} names differ from the train state's")
                for k, t in cur.items():
                    t.copy_(new[k])
            else:
                setattr(state, name, new)
    return state


class Checkpointer:
    """Step-numbered, atomic, retain-N checkpoint store on a directory.

    Layout: `ckpt_{step:010d}.pt` (the train state, written last = commit
    marker), `ckpt_{step:010d}.extra.json` (host counters) and
    `ckpt_{step:010d}.blob.<name>` (auxiliary blobs), both written first.
    """

    def __init__(self, directory: str | Path, retain: int = 3, writes: bool = True):
        """`writes` False: `save` joins a sharded state's gather (every
        rank of its axes must) and writes nothing; the group's other
        ranks hold such a store."""
        self.writes = writes
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.retain = retain
        # Temp files and sidecars orphaned by a hard kill between writes.
        for stale in self.directory.glob("*.tmp"):
            stale.unlink(missing_ok=True)
        for side in list(self.directory.glob("ckpt_*.extra.json")) + list(
                self.directory.glob("ckpt_*.blob.*")):
            m = re.match(r"^ckpt_(\d{10})\.", side.name)
            if m and not self._payload_path(int(m.group(1))).exists():
                side.unlink(missing_ok=True)

    def _payload_path(self, step: int) -> Path:
        return self.directory / f"ckpt_{step:010d}.pt"

    def _extra_path(self, step: int) -> Path:
        return self.directory / f"ckpt_{step:010d}.extra.json"

    def _blob_path(self, step: int, name: str) -> Path:
        return self.directory / f"ckpt_{step:010d}.blob.{name}"

    def steps(self) -> list[int]:
        """Committed checkpoint steps, ascending."""
        return sorted(int(m.group(1)) for p in self.directory.iterdir()
                      for m in [_CKPT_RE.match(p.name)] if m)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any, extra: dict | None = None,
             blobs: dict[str, bytes] | None = None, sharded=None) -> Path:
        """Persist `state` (+ host `extra`, + named `blobs`) as checkpoint
        `step`. Sidecars first; the payload is the commit marker.

        `sharded` (a `parallel/learner.ShardedLearner`): `state` is one
        rank's, which over a model axis holds slices; the whole state is
        saved (`gather_state`, a collective along `model`, so every rank
        of the axis saves at the same step)."""
        if sharded is not None:
            state = sharded.gather_state(state)
        if not self.writes:
            return self._payload_path(step)
        body = json.dumps(extra or {}).encode()
        _atomic_write(self._extra_path(step), lambda f: f.write(body))
        for name, data in (blobs or {}).items():
            _atomic_write(self._blob_path(step, name), lambda f, d=data: f.write(d))
        path = self._payload_path(step)
        saved = state_to_dict(state)
        _atomic_write(path, lambda f: torch.save(saved, f))
        self._prune()
        return path

    def load_blob(self, step: int, name: str) -> bytes | None:
        path = self._blob_path(step, name)
        return path.read_bytes() if path.exists() else None

    def restore(self, template: Any, step: int | None = None,
                sharded=None) -> tuple[Any, dict, int] | None:
        """-> (state, extra, step) for `step` (default latest), or None.
        The values land in `template`'s own tensors (see the module
        docstring).

        `sharded` (a `parallel/learner.ShardedLearner`): `template` is one
        rank's state; the whole checkpoint loads into its gathered twin
        and the rank keeps its slices (`place_state`). Both are
        collectives along `model`: every rank of the axis restores."""
        if sharded is not None:
            got = self.restore(sharded.gather_state(template), step)
            return None if got is None else (sharded.place_state(got[0]), *got[1:])
        if step is None:
            step = self.latest_step()
            if step is None:
                return None
        payload = self._payload_path(step)
        if not payload.exists():
            return None
        device = next(iter(template.params.values())).device
        saved = torch.load(payload, map_location=device, weights_only=True)
        try:
            state = load_state_into(template, saved)
        except ValueError as e:
            # Layout migration, as in the JAX package: a state saved with
            # the old NatureConv nesting (`torso.Conv_{i}.weight`) retries
            # through the upgrade map, chained to the first error so a
            # corrupt checkpoint shows both failures.
            from distributed_reinforcement_learning_tpu_torch.models.convert import (
                upgrade_nature_conv_names)

            try:
                state = load_state_into(template, {
                    k: upgrade_nature_conv_names(v) if isinstance(v, dict) else v
                    for k, v in saved.items()})
            except Exception as retry_err:
                raise retry_err from e
        extra_path = self._extra_path(step)
        extra = json.loads(extra_path.read_text()) if extra_path.exists() else {}
        return state, extra, step

    def _prune(self) -> None:
        for step in self.steps()[: -self.retain]:
            for p in (self._payload_path(step), self._extra_path(step),
                      *self.directory.glob(f"ckpt_{step:010d}.blob.*")):
                p.unlink(missing_ok=True)
