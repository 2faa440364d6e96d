"""The port's data pipeline and checkpoint store against the JAX
reference's, on the CPU.

``pack_documents`` and ``DataLoader`` batches are byte-equal to the
reference's (a restart at a step included).  ``CheckpointStore`` writes
the reference's format: for the same tree (decoder parameters and the
AdamW state) the manifest's ``leaves`` (file names, keys, shapes, dtypes,
sha256 prefixes) are equal, a checkpoint written by either package
restores in the other with equal arrays, a changed file raises and GC
keeps the last ``keep`` steps.  Everything here is exact.
"""

import dataclasses
import json
import time

import jax
import jax.experimental

# jax 0.9 dropped jax.experimental.enable_x64, which repro.core's
# graph_sim imports; alias it before the first repro import
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np
import pytest
import torch

import repro.models as jm
from repro.checkpoint.store import CheckpointStore as RefStore
from repro.configs import ARCHS as REF_ARCHS, smoke_config as ref_smoke
from repro.data import pipeline as jdata
from repro.optim.adamw import adamw_init
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.convert import adamw_state_from_jax, decoder_params_from_jax
from repro_torch.data import pipeline as tdata
from repro_torch.tree import tree_leaves


def _batches_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
                b[k].tobytes(), k
        else:
            assert a[k] == b[k], k


def test_pack_documents_matches_reference():
    rng = np.random.default_rng(0)
    for rows, seq, n in ((4, 64, 9), (8, 128, 40), (3, 32, 1)):
        docs = [rng.integers(2, 500, rng.integers(1, 3 * seq)).astype(
            np.int32) for _ in range(n)]
        got, pad = tdata.pack_documents([d.copy() for d in docs], seq, rows)
        want, rpad = jdata.pack_documents([d.copy() for d in docs], seq, rows)
        assert got.tobytes() == want.tobytes() and pad == rpad


def test_data_loader_batches_byte_equal_with_restart():
    """Five batches from step 0, then a loader restarted at step 3, with
    and without a modality prefix."""
    for kw in (dict(vocab_size=256, seq_len=64, global_batch=4,
                    mean_doc_len=76.8),
               dict(vocab_size=1000, seq_len=32, global_batch=3, seed=7,
                    prefix_len=4, d_model=16, mean_doc_len=38.4)):
        ours = tdata.DataLoader(tdata.DataConfig(**kw))
        ref = jdata.DataLoader(jdata.DataConfig(**kw))
        try:
            first = []
            for _ in range(5):
                a, b = next(ours), next(ref)
                _batches_equal(a, b)
                first.append(a)
        finally:
            ours.close()
            ref.close()
        again = tdata.DataLoader(tdata.DataConfig(**kw), start_step=3)
        try:
            for want in first[3:]:
                _batches_equal(next(again), want)
        finally:
            again.close()
        assert tdata.SyntheticCorpus(tdata.DataConfig(**kw)).doc(11).tobytes() \
            == jdata.SyntheticCorpus(jdata.DataConfig(**kw)).doc(11).tobytes()


def _state(arch="recurrentgemma-2b"):
    """The reference's (params, AdamW state) as numpy trees, and the
    port's as tensors; a model with groups, a remainder and qk-norm-free
    recurrent leaves."""
    cfg = dataclasses.replace(ref_smoke(REF_ARCHS[arch]), num_layers=4)
    params, _ = jm.init_decoder(jax.random.key(0), cfg)
    opt = adamw_init(params)
    rng = np.random.default_rng(0)
    opt = opt._replace(step=np.asarray(7, np.int32), mu=jax.tree.map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), opt.mu))
    ref = jax.tree.map(np.asarray, (params, opt))
    ours = (decoder_params_from_jax(ref[0], device="cpu"),
            adamw_state_from_jax(ref[1], device="cpu"))
    return ref, ours


def _manifest(store, step):
    return json.loads((store.dir / f"step_{step:08d}" /
                       "manifest.json").read_text())


def test_manifest_leaves_match_reference(tmp_path):
    ref_tree, tree = _state()
    RefStore(str(tmp_path / "ref"), async_write=False).save(
        3, ref_tree, {"next_step": 3})
    ours = CheckpointStore(str(tmp_path / "port"))
    ours.save(3, tree, {"next_step": 3})
    ours.wait()
    a, b = _manifest(ours, 3), _manifest(RefStore(str(tmp_path / "ref")), 3)
    assert a["leaves"] == b["leaves"] and len(a["leaves"]) > 20
    assert (a["step"], a["extra"]) == (b["step"], b["extra"])
    assert any(leaf["key"] == "1___step" for leaf in a["leaves"])


def test_checkpoints_restore_across_packages(tmp_path):
    """The reference's checkpoint restores in the port (tensors, on the
    like tree's device), and the port's in the reference."""
    ref_tree, tree = _state()
    RefStore(str(tmp_path / "ref"), async_write=False).save(5, ref_tree,
                                                            {"k": 1})
    got, extra = CheckpointStore(str(tmp_path / "ref")).restore(5, tree)
    assert extra == {"k": 1}
    assert type(got[1]).__name__ == "AdamWState"
    for a, b in zip(tree_leaves(got), jax.tree.leaves(ref_tree)):
        assert torch.is_tensor(a) and a.numpy().tobytes() == b.tobytes()
    CheckpointStore(str(tmp_path / "port"), async_write=False).save(6, tree)
    back, _ = RefStore(str(tmp_path / "port")).restore(6, ref_tree)
    for a, b in zip(jax.tree.leaves(back), tree_leaves(tree)):
        assert np.asarray(a).tobytes() == b.numpy().tobytes()


def test_checksum_mismatch_raises_and_gc_keeps_k(tmp_path):
    _, tree = _state()
    store = CheckpointStore(str(tmp_path), keep=2)
    for step in (1, 2, 3, 4):
        store.save(step, tree, {"next_step": step})
    store.wait()
    assert store.steps() == [3, 4] and store.latest_step() == 4
    # a later in-place update does not reach a snapshot already taken
    before = tree_leaves(tree)[0].clone()
    store.save(5, tree)
    tree_leaves(tree)[0].add_(1.0)
    store.wait()
    restored, _ = store.restore(5, tree)
    assert torch.equal(tree_leaves(restored)[0], before)
    leaf = _manifest(store, 4)["leaves"][0]["file"]
    path = tmp_path / "step_00000004" / leaf
    raw = bytearray(path.read_bytes())
    raw[-1] ^= 0xFF
    path.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="checksum"):
        store.restore(4, tree)
    store.restore(4, tree, validate=False)
    # a shardings tree must hold one sharding a leaf (the sharded restore
    # itself: test_torch_compression.py)
    with pytest.raises(ValueError, match="shardings for"):
        store.restore(5, tree, shardings=object())


def test_latest_step_and_restore_see_a_pending_write(tmp_path, monkeypatch):
    """A step whose asynchronous write is still running counts: the
    Trainer's recovery calls ``latest_step`` right after a failure, which
    may come before the last checkpoint's writer thread has committed."""
    _, tree = _state()
    real = CheckpointStore._write

    def slow_write(self, *args):
        time.sleep(0.5)
        real(self, *args)

    monkeypatch.setattr(CheckpointStore, "_write", slow_write)
    store = CheckpointStore(str(tmp_path))
    store.save(4, tree, {"next_step": 4})
    assert store.latest_step() == 4
    store.save(8, tree, {"next_step": 8})
    restored, extra = store.restore(8, tree)
    assert extra == {"next_step": 8}
    for a, b in zip(tree_leaves(restored), tree_leaves(tree)):
        assert torch.equal(a, b)
