"""The port's model on DTensors against the reference's under GSPMD, both
on a (data 2, model 2) mesh with the same weights, on the CPU.

The reference runs on 4 host devices in a subprocess of its own
(``XLA_FLAGS`` set in its environment only; ``jax.make_mesh`` wrapped to
make Auto axes, as ``tests/test_torch_dryrun.py`` explains), its prefill
and train steps jitted with ``param_shardings`` / the batch shardings of
the dry run.  It writes its initial parameters, which the port reads
through ``repro_torch.convert``.  The port runs in a 4-rank ``gloo``
world (a ``FileStore`` in the tmp dir), every parameter, moment and input
a DTensor placed by the same rules, under ``use_rules``: its ``shard_as``
annotations redistribute, and flash attention (``flash_threshold`` 16,
below the 32 positions) and the MoE run on local shards under
``local_map``.

Three archs at their smoke configs in fp32: qwen3-4b (GQA, its kv heads
split with its q heads), qwen3-moe-30b-a3b with the ragged dispatch (the
expert-parallel combine, the router's statistics over the batch shards)
and recurrentgemma-2b (``seq: model``, MQA, the RG-LRU scan, the window).
Tolerances are ``tests/test_torch_train.py``'s: prefill logits within
1e-4; loss within 1e-5; the updated first moment (0.1 x the gradient)
within 1e-4 of each leaf's largest |reference| entry; updated parameters
at least 99.9% of each leaf's entries within 1e-6 and all within lr / 40,
over the entries whose gradient is at least 1e-6.  AdamW's first step
moves an entry by lr g / (|g| + 1e-8): where |g| is near 1e-8 the step
turns on the gradient's absolute error (``test_torch_train.py``'s
note), and recurrentgemma-2b's smoke gradients put 0.1-0.25% of some
leaves' entries there, where the mesh's other summation order moves the
step by up to 5e-4; the moments hold those gradients.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT_S = 600
ARCH_CASES = (("qwen3-4b", "baseline"), ("qwen3-moe-30b-a3b", "ragged"),
              ("recurrentgemma-2b", "baseline"))
B, S, LR = 4, 32, 1e-2
LOGITS_ATOL, LOSS_ATOL, PARAM_ATOL, PARAM_SHARE = 1e-4, 1e-5, 1e-6, 0.999
MOMENT_RTOL, G_FLOOR = 1e-4, 1e-6

COMMON = """
import dataclasses, pickle, sys
import numpy as np
tmp = sys.argv[1]
CASES = {cases!r}
B, S, LR = {b}, {s}, {lr}


def smoke(configs, arch, variant):
    cfg = configs.smoke_config(configs.ARCHS[arch])
    cfg = dataclasses.replace(cfg, compute_dtype="float32", flash_threshold=16)
    if variant == "ragged":
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch="ragged"))
    return cfg


def batch(cfg):
    rng = np.random.default_rng(5)
    return {{"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}}
"""

REFERENCE = """
import jax, jax.experimental
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64
from jax.sharding import AxisType, NamedSharding
_make_mesh = jax.make_mesh
def make_mesh(shape, axes, **kw):
    kw.setdefault("axis_types", (AxisType.Auto,) * len(shape))
    return _make_mesh(shape, axes, **kw)
jax.make_mesh = make_mesh
import jax.numpy as jnp
from repro import configs
from repro.launch.mesh import production_rules
from repro.models import init_decoder
from repro.optim.adamw import OptimizerConfig, adamw_init, adamw_state_axes
from repro.sharding import logical_to_spec, param_shardings, use_rules
from repro.train.steps import make_prefill_step, make_train_step
mesh = jax.make_mesh((2, 2), ("data", "model"))
out = {}
for arch, variant in CASES:
    cfg = smoke(configs, arch, variant)
    rules = production_rules(mesh, dict(cfg.sharding_overrides) or None)
    params, axes = init_decoder(jax.random.PRNGKey(0), cfg)
    host = jax.tree.map(np.asarray, params)
    ins = {k: jnp.asarray(v) for k, v in batch(cfg).items()}
    p_sh = param_shardings(rules, params, axes)
    in_sh = {k: NamedSharding(mesh, logical_to_spec(rules, ("batch", "seq"),
                                                     v.shape))
             for k, v in ins.items()}
    with use_rules(rules), mesh:
        logits = jax.jit(make_prefill_step(cfg),
                         in_shardings=(p_sh, {"tokens": in_sh["tokens"]}))(
            params, {"tokens": ins["tokens"]})
        opt = adamw_init(params)
        o_sh = param_shardings(rules, opt, adamw_state_axes(axes))
        step = make_train_step(cfg, OptimizerConfig(learning_rate=LR,
                                                    warmup_steps=0))
        new_p, new_o, met = jax.jit(step, in_shardings=(p_sh, o_sh, in_sh))(
            params, opt, ins)
    out[arch] = dict(params=host, logits=np.asarray(logits),
                     loss=float(met["loss"]),
                     new_params=jax.tree.map(np.asarray, new_p),
                     mu=jax.tree.map(np.asarray, new_o.mu))
with open(f"{tmp}/ref.pkl", "wb") as f:
    pickle.dump(out, f)
"""

WORKER = """
import os
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch import configs
from repro_torch.convert import decoder_params_from_jax
from repro_torch.launch.dryrun import _batch_shardings
from repro_torch.launch.mesh import production_rules
from repro_torch.models import init_decoder_axes
from repro_torch.optim.adamw import OptimizerConfig, adamw_init
from repro_torch.sharding import mesh_placements, param_shardings, use_rules
from repro_torch.train.steps import make_prefill_step, make_train_step
from repro_torch.tree import tree_map
rank = int(sys.argv[2])
dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                        world_size=4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
with open(f"{tmp}/ref.pkl", "rb") as f:
    ref = pickle.load(f)
out = {}


def place(tree, shardings):
    return tree_map(lambda t, sh: distribute_tensor(
        t, mesh, mesh_placements(mesh, sh.spec)), tree, shardings)


def full(tree):
    return tree_map(lambda t: (t.full_tensor() if isinstance(t, DTensor)
                               else t).numpy(), tree)


for arch, variant in CASES:
    cfg = smoke(configs, arch, variant)
    rules = production_rules(mesh, dict(cfg.sharding_overrides) or None)
    host = decoder_params_from_jax(ref[arch]["params"], device="cpu")
    axes = init_decoder_axes(cfg)
    p_sh = param_shardings(rules, host, axes)
    ins = {k: torch.from_numpy(v) for k, v in batch(cfg).items()}
    in_sh = _batch_shardings(rules, ins)
    dins = {k: distribute_tensor(v, mesh, mesh_placements(mesh,
                                                          in_sh[k].spec))
            for k, v in ins.items()}
    with use_rules(rules), implicit_replication():
        params = place(host, p_sh)
        logits = make_prefill_step(cfg)(params, {"tokens": dins["tokens"]})
        sharded = sum(isinstance(p, DTensor) for p in
                      torch.utils._pytree.tree_leaves(params))
        opt = adamw_init(params)
        step = make_train_step(cfg, OptimizerConfig(learning_rate=LR,
                                                    warmup_steps=0))
        new_p, new_o, met = step(params, opt, dins)
        out[arch] = dict(logits=full(logits), loss=float(full(met["loss"])),
                         new_params=full(new_p), mu=full(new_o.mu),
                         sharded=sharded)
if rank == 0:
    with open(f"{tmp}/port.pkl", "wb") as f:
        pickle.dump(out, f)
dist.destroy_process_group()
"""


def _env(**extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **extra)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    return env


def _run(cmds, timeout):
    procs = [subprocess.Popen(c, env=e, stderr=subprocess.PIPE, text=True)
             for c, e in cmds]
    try:
        errs = [p.communicate(timeout=timeout)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-4000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's steps on 4 host devices, then the port's in a
    4-rank gloo world on the reference's initial parameters."""
    tmp = tmp_path_factory.mktemp("mesh")
    common = COMMON.format(cases=ARCH_CASES, b=B, s=S, lr=LR)
    (tmp / "reference.py").write_text(common + REFERENCE)
    (tmp / "worker.py").write_text(common + WORKER)
    _run([([sys.executable, str(tmp / "reference.py"), str(tmp)],
           _env(XLA_FLAGS="--xla_force_host_platform_device_count=4"))],
         TIMEOUT_S)
    _run([([sys.executable, str(tmp / "worker.py"), str(tmp), str(r)], _env())
          for r in range(WORLD)], TIMEOUT_S)
    with open(tmp / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    with open(tmp / "port.pkl", "rb") as f:
        port = pickle.load(f)
    return ref, port


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, np.asarray(tree)


@pytest.mark.parametrize("arch", [a for a, _ in ARCH_CASES])
def test_sharded_prefill_matches_reference(runs, arch):
    ref, port = runs
    assert port[arch]["sharded"] > 0          # the parameters were DTensors
    got, want = port[arch]["logits"], ref[arch]["logits"]
    assert got.shape == want.shape == (B, want.shape[1])
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGITS_ATOL)


@pytest.mark.parametrize("arch", [a for a, _ in ARCH_CASES])
def test_sharded_train_step_matches_reference(runs, arch):
    ref, port = runs
    assert abs(port[arch]["loss"] - ref[arch]["loss"]) <= LOSS_ATOL
    mu_got = dict(_leaves(port[arch]["mu"]))
    mu_want = dict(_leaves(ref[arch]["mu"]))
    got = dict(_leaves(port[arch]["new_params"]))
    want = dict(_leaves(ref[arch]["new_params"]))
    assert got.keys() == want.keys() == mu_want.keys() == mu_got.keys()
    for key, w in want.items():
        m = mu_want[key]
        tol = MOMENT_RTOL * max(float(np.abs(m).max()), 1e-30)
        assert np.abs(mu_got[key] - m).max() <= tol, (arch, key)
        live = np.abs(m) >= (1 - 0.9) * G_FLOOR     # mu = (1 - b1) g
        err = np.abs(got[key] - w)[live]
        if err.size:
            assert err.max() <= LR / 40, (arch, key, float(err.max()))
            assert (err <= PARAM_ATOL).mean() >= PARAM_SHARE, (arch, key)
