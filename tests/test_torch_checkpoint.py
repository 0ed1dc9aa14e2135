"""The port's checkpoints (horovod_tpu_torch/checkpoint.py) against the
JAX package's contract (horovod_tpu/checkpoint.py): the same sidecar
digest over the same step directory (exact: the same hex string), the
same fallback and refusal on a corrupted step, retention, ``like=``
restores, the rank-0 discipline, and the elastic State's durable tier
and grace files. Tolerance: exact (bitwise round trips).
"""

import json
import os
import types

import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu import checkpoint as jckpt
from horovod_tpu_torch import checkpoint as ckpt
from horovod_tpu_torch.exceptions import CheckpointCorruptError


@pytest.fixture(autouse=True)
def _fresh_runtime():
    yield
    hvd.shutdown()


def _state(v=1.0):
    return {"w": torch.arange(6.0).reshape(2, 3) * v, "step": 7,
            "opt": [torch.ones(2, dtype=torch.float64) * v,
                    {"m": torch.zeros(3, dtype=torch.bfloat16)}]}


def _equal(a, b):
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_equal, a, b))
    return a == b


def _flip_one_byte(path, at=200):
    with open(path, "r+b") as f:
        f.seek(at)
        b = f.read(1)
        f.seek(at)
        f.write(bytes([b[0] ^ 0x01]))


def test_save_restore_roundtrip(tmp_path):
    ckpt.save(str(tmp_path / "one"), _state())
    assert _equal(ckpt.restore(str(tmp_path / "one")), _state())
    with pytest.raises(FileExistsError):
        ckpt.save(str(tmp_path / "one"), _state())
    ckpt.save(str(tmp_path / "one"), _state(2.0), force=True)
    assert _equal(ckpt.restore(str(tmp_path / "one")), _state(2.0))


def test_restore_like_takes_its_dtypes_and_structure(tmp_path):
    ckpt.save(str(tmp_path / "s"), {"a": torch.ones(3), "b": 5})
    like = {"a": torch.zeros(3, dtype=torch.float64), "b": 0}
    back = ckpt.restore(str(tmp_path / "s"), like=like)
    assert back["a"].dtype == torch.float64 and back["b"] == 5
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(str(tmp_path / "s"), like={"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path / "s"),
                     like={"a": torch.zeros(4), "b": 0})


def test_manager_versioning_and_retention(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path / "m"), max_to_keep=2)
    for step in (1, 2, 3):
        assert mgr.save(step, _state(step))
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    assert sorted(os.listdir(tmp_path / "m")) == [
        "2", "2.digest.json", "3", "3.digest.json"]
    assert not mgr.save(3, _state())          # exists, no force
    assert _equal(mgr.restore(), _state(3))
    assert _equal(mgr.restore(2), _state(2))
    every = ckpt.CheckpointManager(str(tmp_path / "e"),
                                   save_interval_steps=2)
    assert not every.save(1, _state()) and every.save(2, _state())
    with pytest.raises(FileNotFoundError):
        ckpt.CheckpointManager(str(tmp_path / "empty")).restore()


@pytest.mark.parametrize("steps", [(1,), (1, 5, 9)])
def test_sidecar_digest_matches_the_reference(tmp_path, steps):
    """The sidecar's sha256 is the JAX package's ``_step_digest`` over
    the same directory (sorted relpaths mixed in), file count included."""
    mgr = ckpt.CheckpointManager(str(tmp_path / "d"))
    for s in steps:
        mgr.save(s, _state(s))
        os.makedirs(tmp_path / "d" / str(s) / "nested", exist_ok=True)
        (tmp_path / "d" / str(s) / "nested" / "extra.bin").write_bytes(
            b"\x00\x01" * s)
        mgr._write_sidecar(s)
    fake = types.SimpleNamespace(_directory=str(tmp_path / "d"))
    for s in steps:
        want = jckpt.CheckpointManager._step_digest(fake, s)
        assert mgr._step_digest(s) == want
        side = json.loads((tmp_path / "d" / f"{s}.digest.json").read_text())
        assert (side["sha256"], side["files"], side["step"]) == (*want, s)
        assert mgr.verify_step(s)


def test_corrupt_step_falls_back_and_refuses_explicit(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path / "mgr"))
    for step in (1, 2):
        mgr.save(step, _state(step))
    _flip_one_byte(tmp_path / "mgr" / "2" / "state-0.pt")
    fails = hvd.metrics.CHECKPOINT_INTEGRITY_FAILURES.value()
    assert not mgr.verify_step(2)
    assert hvd.metrics.CHECKPOINT_INTEGRITY_FAILURES.value() > fails
    assert mgr.latest_valid_step() == 1
    assert _equal(mgr.restore(), _state(1))
    with pytest.raises(CheckpointCorruptError):
        mgr.restore(step=2)
    os.remove(mgr._sidecar_path(2))       # sidecar-less: accepted
    assert mgr.verify_step(2)


def test_rank0_broadcast_helper(tmp_path):
    hvd.init(device="cpu")
    assert ckpt.save_for_rank0_broadcast(str(tmp_path / "r0"), _state(),
                                         rank=0)
    assert not ckpt.save_for_rank0_broadcast(str(tmp_path / "r1"),
                                             _state(), rank=1)
    assert _equal(ckpt.restore(str(tmp_path / "r0")), _state())
    assert not (tmp_path / "r1").exists()


def test_state_durable_commit_and_fresh_process_restore(tmp_path):
    """Every durable_interval-th commit lands a checkpoint; a fresh State
    (a restarted worker) restores the newest valid one in place and
    resumes the commit count above it."""
    model = torch.nn.Linear(3, 2)
    mgr = ckpt.CheckpointManager(str(tmp_path / "dur"))
    st = hvd.elastic.State(model=model, step=0, manager=mgr,
                           durable_interval=2)
    for i in range(4):
        with torch.no_grad():
            model.weight.add_(1.0)
        st.step = i + 1
        st.commit()
    assert mgr.all_steps() == [2, 4]
    want = {k: v.clone() for k, v in model.state_dict().items()}
    fresh_model = torch.nn.Linear(3, 2)
    ptr = fresh_model.weight.data_ptr()
    fresh = hvd.elastic.State(model=fresh_model, step=0, manager=mgr,
                              durable_interval=2)
    fresh.restore()
    assert fresh.step == 4 and fresh.commits == 4
    assert fresh_model.weight.data_ptr() == ptr
    for k, v in fresh_model.state_dict().items():
        assert torch.equal(v, want[k])
    fresh.suspend_durable("shrunk")
    fresh.commit()
    fresh.commit()
    assert mgr.all_steps() == [2, 4]


def test_grace_file_digest_skips_corruption(tmp_path, monkeypatch):
    monkeypatch.setenv("HOROVOD_ELASTIC_GRACE_DIR", str(tmp_path))
    older = hvd.elastic.State(w=torch.tensor([1.0, 2.0]))
    older.save_grace(path=str(tmp_path / "grace-0.pt"))
    newer = hvd.elastic.State(w=torch.tensor([5.0, 6.0]))
    newer.commit()
    newer.save_grace(path=str(tmp_path / "grace-1.pt"))
    wrapped = torch.load(tmp_path / "grace-1.pt", weights_only=False)
    blob = wrapped["blob"]
    wrapped["blob"] = blob[:-1] + bytes([blob[-1] ^ 0x01])
    torch.save(wrapped, tmp_path / "grace-1.pt")
    fails = hvd.metrics.CHECKPOINT_INTEGRITY_FAILURES.value()
    fresh = hvd.elastic.State(w=torch.zeros(2))
    fresh.restore()
    assert torch.equal(fresh.w, torch.tensor([1.0, 2.0]))
    assert hvd.metrics.CHECKPOINT_INTEGRITY_FAILURES.value() == fails + 1
