"""The port's multi-pod dry run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``) on the CPU.

The reference's side runs in one subprocess of its own: its module sets
``XLA_FLAGS`` for 512 host devices when it is imported, which this
process must not do.  Under jax 0.9 ``jax.make_mesh`` makes Explicit axes,
on which the reference's ``with_sharding_constraint`` raises, so that
process alone wraps ``jax.make_mesh`` to make Auto axes (and aliases
``jax.experimental.enable_x64``); ``src/repro`` is not touched.

Compared, all exactly:

  * ``variant_config`` / ``variant_rules`` / ``variant_mesh`` for every
    variant the reference names (and two compositions and an unknown
    name), on every arch;
  * ``wire_bytes`` / ``summarize_collectives`` against
    ``parse_collectives`` on one synthetic HLO line of each kind;
  * every arch x shape x mesh record's static fields: ``params``,
    ``active_params``, ``tokens``, ``kind``, ``chips`` and the skip
    reasons;
  * per-device ``argument_size_in_bytes`` and ``output_size_in_bytes``
    against the reference's compiled ``memory_analysis()`` at the smoke
    configs of qwen3-4b and qwen3-moe-30b-a3b (``ragged``), train,
    prefill and decode at 32 x 256, on the 16 x 16 and 2 x 16 x 16
    meshes, and of qwen3-4b's train step under every other variant, at
    the microbatch count ``run_cell`` uses.  The arguments are equal leaf
    for leaf (the local shard of every parameter, moment, input and cache
    leaf).  The outputs differ by one term, the same in every cell: where
    the step returns a tuple (train: parameters, moments and 3 or 6 fp32
    metrics; decode: the next tokens and the cache), XLA's output buffer
    is that tuple, whose index table holds one 8-byte pointer per leaf;
    the port's outputs are the leaves themselves.  So the reference's
    bytes are the port's plus 8 x the port's output leaves; the prefill
    step returns one array and the two are equal;
  * full-width meta cells through ``run_cell``: qwen3-4b decode_32k and
    internvl2-1b prefill_32k (``seq: model``) on the 16 x 16 mesh.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, SHAPES, get_arch, smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.sharding import DEFAULT_RULES, shard_as, use_rules

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 600

VARIANTS = ["baseline", "ragged", "remat_dots", "remat_none", "kv8",
            "wgather", "zero3", "tp8", "tp4", "tp2", "remat_dots+kv8",
            "zero3+tp4", "nope"]
MEMORY_CELLS = ([("qwen3-4b", "baseline", kind, mp)
                 for kind in ("train", "prefill", "decode")
                 for mp in (False, True)]
                + [("qwen3-moe-30b-a3b", "ragged", kind, mp)
                   for kind in ("train", "prefill", "decode")
                   for mp in (False, True)]
                + [("qwen3-4b", v, "train", False)
                   for v in ("remat_dots", "remat_none", "kv8", "wgather",
                             "zero3", "tp8", "tp4", "tp2")])
SMOKE_SEQ, SMOKE_BATCH = 256, 32
# (kind, HLO line, result bytes, group size): one line per kind
HLO = [
    ("all-gather", "%ag = f32[64,128]{1,0} all-gather(f32[16,128]{1,0} %p), "
     "channel_id=1, replica_groups={{0,1,2,3}}, dimensions={0}",
     64 * 128 * 4, 4),
    ("all-reduce", "%ar = bf16[32,256]{1,0} all-reduce-start(bf16[32,256]{1,0}"
     " %p), channel_id=2, replica_groups=[2,8]<=[16], to_apply=%add",
     32 * 256 * 2, 8),
    ("reduce-scatter", "%rs = f32[8,128]{1,0} reduce-scatter(f32[128,128]{1,0}"
     " %p), channel_id=3, replica_groups={{0,1,2,3,4,5,6,7,8,9,10,11,12,13,"
     "14,15}}, dimensions={0}, to_apply=%add", 8 * 128 * 4, 16),
    ("all-to-all", "%aa = s32[4,64]{1,0} all-to-all(s32[4,64]{1,0} %p), "
     "channel_id=4, replica_groups={{0,1,2,3}}, dimensions={0}",
     4 * 64 * 4, 4),
    ("collective-permute", "%cp = f32[100]{0} collective-permute(f32[100]{0} "
     "%p), channel_id=5, source_target_pairs={{0,1},{1,0}}", 100 * 4, 2),
]

REFERENCE = """
import json, sys, dataclasses
import jax, jax.experimental
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64
from jax.sharding import AxisType
_make_mesh = jax.make_mesh
def make_mesh(shape, axes, **kw):
    kw.setdefault("axis_types", (AxisType.Auto,) * len(shape))
    return _make_mesh(shape, axes, **kw)
jax.make_mesh = make_mesh
from repro.launch import dryrun as D
from repro.configs import ARCHS, SHAPES, get_arch, shape_applicable, smoke_config
from repro.configs.base import ShapeConfig
from repro.launch.mesh import make_production_mesh, production_rules
args = json.loads(open(sys.argv[1]).read())
out = {"variants": {}, "hlo": {}, "static": {}, "memory": {}}
for v in args["variants"]:
    row = {"rules": D.variant_rules(v), "mesh": D.variant_mesh(v), "cfg": {}}
    for arch in ARCHS:
        try:
            row["cfg"][arch] = repr(D.variant_config(get_arch(arch), v))
        except Exception as e:
            row["cfg"][arch] = "raises " + type(e).__name__
    out["variants"][v] = row
for kind, line, _, _ in args["hlo"]:
    out["hlo"][kind] = D.parse_collectives(line)
out["hlo"]["all"] = D.parse_collectives(
    "\\n".join(l for _, l, _, _ in args["hlo"])
    + "\\n%done = bf16[32,256]{1,0} all-reduce-done(%ar)")
for arch in ARCHS:
    for shape in SHAPES:
        for mp in (False, True):
            cfg = get_arch(arch)
            if shape_applicable(cfg, SHAPES[shape])[0]:
                # run_cell's fields before it compiles, and its mesh's size
                rec = dict(params=cfg.param_count(),
                           active_params=cfg.active_param_count(),
                           tokens=SHAPES[shape].tokens,
                           kind=SHAPES[shape].kind, status="ok",
                           chips=make_production_mesh(multi_pod=mp).size)
            else:       # returns before compiling
                rec = D.run_cell(arch, shape, multi_pod=mp, save=False)
            out["static"][f"{arch}|{shape}|{mp}"] = {
                k: rec.get(k) for k in ("params", "active_params", "tokens",
                                        "kind", "chips", "status", "reason")}
for arch, variant, kind, mp in args["memory"]:
    cfg = D.variant_config(smoke_config(get_arch(arch)), variant)
    shape = ShapeConfig("smoke", args["seq"], args["batch"], kind)
    mesh = make_production_mesh(multi_pod=mp, dm_shape=D.variant_mesh(variant))
    merged = dict(cfg.sharding_overrides)
    merged.update(D.variant_rules(variant))
    rules = production_rules(mesh, merged or None)
    mb = cfg.train_microbatches if kind == "train" else 1
    data = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
    while mb > 1 and (shape.global_batch % mb
                      or (shape.global_batch // mb) % data):
        mb //= 2
    m = D._memory_dict(D._lower_compile(cfg, shape, mesh, rules,
                                        num_microbatches=mb))
    out["memory"][f"{arch}|{variant}|{kind}|{mp}"] = dict(
        microbatches=mb, argument=m["argument_size_in_bytes"],
        output=m["output_size_in_bytes"])
open(sys.argv[2], "w").write(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """A callable returning the reference's results; its subprocess
    starts here and runs while the port's tests compute."""
    tmp = tmp_path_factory.mktemp("dryrun_ref")
    (tmp / "args.json").write_text(json.dumps(dict(
        variants=VARIANTS, hlo=HLO, memory=MEMORY_CELLS, seq=SMOKE_SEQ,
        batch=SMOKE_BATCH)))
    (tmp / "reference.py").write_text(REFERENCE)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    proc = subprocess.Popen(
        [sys.executable, str(tmp / "reference.py"), str(tmp / "args.json"),
         str(tmp / "out.json")], env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    box = {}

    def get():
        if "out" not in box:
            try:
                _, err = proc.communicate(timeout=TIMEOUT_S)
            finally:
                if proc.poll() is None:
                    proc.kill()
            assert proc.returncode == 0, err[-4000:]
            box["out"] = json.loads((tmp / "out.json").read_text())
        return box["out"]

    yield get
    if proc.poll() is None:
        proc.kill()


def _jsonable(x):
    return json.loads(json.dumps(x))


def test_variant_functions_equal_reference(reference):
    got = {}
    for v in VARIANTS:
        row = {"rules": dryrun.variant_rules(v),
               "mesh": dryrun.variant_mesh(v), "cfg": {}}
        for arch in ARCHS:
            try:
                # the two ModelConfig dataclasses print alike field by field
                row["cfg"][arch] = repr(dryrun.variant_config(get_arch(arch),
                                                              v))
            except Exception as e:
                row["cfg"][arch] = "raises " + type(e).__name__
        got[v] = _jsonable(row)
    assert got == reference()["variants"]
    assert dryrun.VARIANT_MESH == {"tp8": (32, 8), "tp4": (64, 4),
                                   "tp2": (128, 2)}


def test_wire_model_equals_parse_collectives(reference):
    want = reference()["hlo"]
    for kind, _, nbytes, n in HLO:
        got = dryrun.summarize_collectives([(kind, nbytes, n)])
        assert got == want[kind], kind
        assert got["ops"][kind]["wire_bytes"] == dryrun.wire_bytes(
            kind, nbytes, n)
    # all five together, an -done line counted once
    both = dryrun.summarize_collectives([(k, b, n) for k, _, b, n in HLO])
    assert both == want["all"]
    # a one-rank group and an empty result are dropped, as the parser does
    assert dryrun.summarize_collectives(
        [("all-reduce", 64, 1), ("all-gather", 0, 4)])["n_ops"] == 0


def test_static_fields_equal_reference(reference):
    want = reference()["static"]
    assert len(want) == len(ARCHS) * len(SHAPES) * 2
    tally = {"ok": 0, "skipped": 0}
    for key, ref in want.items():
        arch, shape, mp = key.split("|")
        rec = dryrun.static_record(arch, shape, multi_pod=mp == "True")
        got = {k: rec.get(k) for k in ref}
        got["status"] = rec.get("status")
        ref_status = ref["status"] if ref["status"] == "skipped" else None
        assert got == dict(ref, status=ref_status), key
        tally["skipped" if ref_status else "ok"] += 1
    assert tally == {"ok": 64, "skipped": 16}


def _memory(arch, variant, kind, mp):
    cfg = dryrun.variant_config(smoke_config(get_arch(arch)), variant)
    shape = ShapeConfig("smoke", SMOKE_SEQ, SMOKE_BATCH, kind)
    return dryrun.measure(cfg, shape, multi_pod=mp, variant=variant)


def _check_memory(reference, cells):
    want = reference()["memory"]
    for arch, variant, kind, mp in cells:
        key = f"{arch}|{variant}|{kind}|{mp}"
        m = _memory(arch, variant, kind, mp)
        table = 0 if kind == "prefill" else 8 * m["output_leaves"]
        got = dict(microbatches=m["microbatches"],
                   argument=m["memory"]["argument_size_in_bytes"],
                   output=m["memory"]["output_size_in_bytes"] + table)
        assert got == want[key], key
        assert m["memory"]["peak_memory_in_bytes"] >= got["argument"]
        assert m["flops"] > 0 and m["collectives"]["n_ops"] > 0, key


def test_memory_equals_reference_qwen3_4b(reference):
    _check_memory(reference, MEMORY_CELLS[:6])


def test_memory_equals_reference_moe_ragged(reference):
    _check_memory(reference, MEMORY_CELLS[6:12])


def test_every_variant_at_smoke_on_qwen3_4b_train(reference):
    _check_memory(reference, MEMORY_CELLS[12:])


def test_full_width_meta_cells():
    """qwen3-4b decode_32k and internvl2-1b prefill_32k (sequence-sharded
    on ``model``, its flash attention gathered first) on the 16 x 16
    mesh at full width."""
    for arch, shape in (("qwen3-4b", "decode_32k"),
                        ("internvl2-1b", "prefill_32k")):
        rec = dryrun.run_cell(arch, shape, save=False)
        assert rec["status"] == "ok", rec.get("trace")
        assert rec["chips"] == 256 and rec["kind"] == SHAPES[shape].kind
        assert rec["collectives"]["extrapolated"] is False
        assert rec["cost"]["flops"] > 0
        mem = rec["memory"]
        assert 0 < mem["argument_size_in_bytes"] <= mem["peak_memory_in_bytes"]
        # per device, the fp32 parameters are 1/256 of the tree or more
        # (a dim the mesh does not divide is replicated), and a cell fits
        # the 85.0 GB that torch.cuda reports on an H100 80GB HBM3
        assert mem["argument_size_in_bytes"] >= 4 * get_arch(
            arch).param_count() / 256
        assert mem["peak_memory_in_bytes"] < 85.0e9
    # the flash kernel's stand-in ran on the sequence-gathered shards
    ops = rec["collectives"]["ops"]
    assert ops["all-gather"]["count"] > 0


def test_shard_as_is_the_identity_without_a_mesh():
    x = torch.arange(6.0).reshape(2, 3)
    assert shard_as(x, "batch", "embed") is x
    with use_rules(DEFAULT_RULES):            # rules without a mesh
        assert shard_as(x, "batch", "embed") is x
    assert math.isclose(dryrun.wire_bytes("all-reduce", 100, 4), 150.0)


def _gather_peak(device: str) -> int:
    """The probe's peak over x, its all-gather along dim 1 over 4 fake
    ranks (gathered along dim 0, then chunked and concatenated, as DTensor
    gathers a shard of an inner dim), and a product of the result."""
    from torch.distributed import _functional_collectives as funcol
    probe = dryrun._Probe()
    with dryrun._world(4), probe:
        x = torch.empty((10, 100), device=device)
        y = funcol.all_gather_tensor(x, 1, dist.group.WORLD)
        z = y * 2
        del x, y, z
    assert probe.live == 0
    return probe.peak


def test_probe_counts_a_meta_collective_wrapper_as_its_input():
    """A functional collective's result is wrapped (``_wrap_tensor_autograd``)
    before use: on a device the wrapper holds the result's storage, on
    meta its fake kernel makes a new tensor.  The probe tracks the same
    peak on both: x and two tensors of 4 x (the gathered rows and their
    concatenation, or the concatenation and the product), in fp32."""
    assert _gather_peak("meta") == _gather_peak("cpu") == (1 + 4 + 4) * 4000


def test_planning_raises_without_its_targets(monkeypatch):
    """A torch that lacks one of the planning patches' targets would plan,
    and record, another program: the dry run stops, and patches nothing."""
    from torch.distributed.tensor import placement_types
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    propagate = ShardingPropagator.propagate_op_sharding_non_cached
    monkeypatch.delattr(placement_types, "shard_dim_alltoall")
    with pytest.raises(RuntimeError, match="shard_dim_alltoall"):
        with dryrun._planning():
            pass
    assert ShardingPropagator.propagate_op_sharding_non_cached is propagate
