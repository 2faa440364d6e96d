"""The port's ``compressed_psum``, ``wire_bytes_saved``, sharded checkpoint
restore and technique reference generator against the reference's, on the
CPU.  Everything compared is exact:

  * ``compressed_psum`` over 4 ``gloo`` processes (a ``FileStore`` under
    the test's tmp dir) is bit-equal, on every rank, to the reference's
    over 4 host devices under ``shard_map``; the reference runs in a
    subprocess of its own, since its 4 devices need ``XLA_FLAGS`` set
    before JAX starts, which this process must not do;
  * ``restore(shardings=...)`` on a (2, 2) CPU mesh of the same 4
    processes: every leaf a DTensor whose local shard has
    ``NamedSharding.shard_shape`` and whose full tensor equals the saved
    leaf bit for bit;
  * ``python -m repro_torch.core.schedule --out FILE`` writes the
    reference generator's text byte for byte.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.experimental

# jax 0.9 dropped jax.experimental.enable_x64, which repro.core's
# graph_sim imports; alias it before the first repro import
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compression as jcomp
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.models import init_decoder
from repro_torch.optim import compression as tcomp

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
# rows of 5000 (not a multiple of the 2048-element block) at scales from
# 0.01 to 100, so that each rank's block scales differ and the MAX matters
ROWS, COLS = WORLD, 5000
TIMEOUT_S = 300

_ALIAS = ("import jax, jax.experimental\n"
          "if not hasattr(jax.experimental, 'enable_x64'):\n"
          "    jax.experimental.enable_x64 = jax.enable_x64\n")

REFERENCE = _ALIAS + """
import sys
import numpy as np
from jax.sharding import PartitionSpec as P
from repro.optim.compression import compressed_psum
tmp = sys.argv[1]
mesh = jax.make_mesh((4,), ("pod",))
x = np.load(f"{tmp}/x.npy")
run = jax.jit(jax.shard_map(lambda v: compressed_psum(v[0], "pod"),
                            mesh=mesh, in_specs=P("pod"), out_specs=P()))
np.save(f"{tmp}/ref.npy", np.asarray(run(x)))
"""

WORKER = """
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Shard
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.launch.mesh import production_rules
from repro_torch.models import init_decoder
from repro_torch.optim.compression import compressed_psum
from repro_torch.sharding import param_shardings
from repro_torch.tree import tree_flatten_with_path, tree_leaves

rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/store", world),
                        rank=rank, world_size=world)
x = np.load(f"{tmp}/x.npy")
np.save(f"{tmp}/psum_{rank}.npy",
        compressed_psum(torch.from_numpy(x[rank])).numpy())

params, axes = init_decoder(0, smoke_config(ARCHS["qwen3-4b"]), device="cpu")
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
shardings = param_shardings(production_rules(mesh), params, axes)
tree, _ = CheckpointStore(f"{tmp}/ckpt").restore(3, params,
                                                  shardings=shardings)
leaves = sharded = 0
for got, want, sh in zip(tree_leaves(tree), tree_leaves(params),
                         tree_leaves(shardings)):
    assert isinstance(got, DTensor) and got.device_mesh is mesh
    assert tuple(got.placements) == sh.placements
    assert tuple(got.to_local().shape) == sh.shard_shape(want.shape)
    assert torch.equal(got.full_tensor(), want)
    leaves += 1
    sharded += any(isinstance(p, Shard) for p in sh.placements)
with open(f"{tmp}/restore_{rank}.json", "w") as f:
    json.dump({"leaves": leaves, "sharded": sharded}, f)
dist.destroy_process_group()
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's compressed_psum on 4 host devices, and the port's
    4-rank gloo world (compressed_psum, then the sharded restore of a
    checkpoint saved here), all started together."""
    tmp = tmp_path_factory.mktemp("gloo")
    rng = np.random.default_rng(2)
    scales = 10.0 ** rng.uniform(-2, 2, (ROWS, 1))
    x = (rng.standard_normal((ROWS, COLS)) * scales).astype(np.float32)
    np.save(tmp / "x.npy", x)
    params, _ = init_decoder(0, smoke_config(ARCHS["qwen3-4b"]), device="cpu")
    CheckpointStore(str(tmp / "ckpt"), async_write=False).save(3, params)
    (tmp / "reference.py").write_text(REFERENCE)
    (tmp / "worker.py").write_text(WORKER)
    ref_env = dict(_env(), XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, str(tmp / "reference.py"),
                               str(tmp)], env=ref_env)]
    procs += [subprocess.Popen([sys.executable, str(tmp / "worker.py"),
                                str(r), str(WORLD), str(tmp)], env=_env())
              for r in range(WORLD)]
    try:
        codes = [p.wait(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert codes == [0] * (WORLD + 1), codes
    return tmp, x


def test_compressed_psum_bit_equal_to_reference(runs):
    tmp, x = runs
    want = np.load(tmp / "ref.npy")
    assert want.shape == (COLS,) and want.dtype == np.float32
    for rank in range(WORLD):
        np.testing.assert_array_equal(np.load(tmp / f"psum_{rank}.npy"),
                                      want, err_msg=f"rank {rank}")
    exact = x.sum(axis=0)
    assert np.abs(want - exact).max() / np.abs(exact).max() < 2e-2


def test_sharded_restore_bit_equal(runs):
    tmp, _ = runs
    seen = [json.loads((tmp / f"restore_{r}.json").read_text())
            for r in range(WORLD)]
    assert all(s == seen[0] for s in seen)
    assert seen[0]["leaves"] > 0 and seen[0]["sharded"] > 0


def test_wire_bytes_saved_matches_reference():
    for shapes in (((1024, 1024), (777,)), ((5,),), ((2048,), (3, 4096))):
        jgrads = {f"g{i}": jnp.zeros(s) for i, s in enumerate(shapes)}
        tgrads = {f"g{i}": torch.zeros(s) for i, s in enumerate(shapes)}
        assert (tcomp.wire_bytes_saved(tgrads)
                == jcomp.wire_bytes_saved(jgrads)), shapes


def test_techniques_doc_byte_equal_to_reference(tmp_path):
    out = tmp_path / "techniques.md"
    subprocess.run([sys.executable, "-m", "repro_torch.core.schedule",
                    "--out", str(out)], check=True, env=_env(),
                   cwd=tmp_path, timeout=TIMEOUT_S, capture_output=True)
    ref = subprocess.run(
        [sys.executable, "-c", _ALIAS + (
            "import sys, repro.core\n"
            "from repro.core.schedule import REGISTRY, "
            "generate_techniques_doc\n"
            "sys.stdout.write(generate_techniques_doc(REGISTRY))\n")],
        check=True, env=_env(), cwd=tmp_path, timeout=TIMEOUT_S,
        capture_output=True).stdout
    assert out.read_bytes() == ref
    assert sorted(p.name for p in tmp_path.iterdir()) == ["techniques.md"]
    check = [sys.executable, "-m", "repro_torch.core.schedule", "--check",
             str(out)]
    assert subprocess.run(check, env=_env(), cwd=tmp_path,
                          timeout=TIMEOUT_S, capture_output=True
                          ).returncode == 0
    out.write_bytes(ref + b"\n")
    assert subprocess.run(check, env=_env(), cwd=tmp_path,
                          timeout=TIMEOUT_S, capture_output=True
                          ).returncode == 1
