"""The model example twins against the originals, on the CPU, with the
reference's parameters carried across (``repro_torch.convert``):

  * ``torch_serve_demo``: every sampled token of the 4 x 32 decode (and
    the random first column) equals the reference's for the same keys, and
    the original's printed token line is the twin's;
  * ``torch_moe_balance_demo``: with the reference's parameters and token
    stream, the per-step expert loads, the DLS tile plan and both grouped
    products equal the reference's, and the printed lines (all but the
    last, which names the kernel that ran) are the original's.

Each test prints how many tokens, loads and lines it compared.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_examples_util import load, run_main

import repro.models as jm
from repro.balance.moe import MoEBalancer as RefBalancer
from repro.configs import ARCHS as REF_ARCHS, smoke_config as ref_smoke
from repro.kernels.grouped_matmul.ops import grouped_matmul as ref_gmm
from repro.models.moe import _route as ref_route, init_moe as ref_init_moe
from repro.train import steps as jsteps
from repro_torch.convert import decoder_params_from_jax


def test_serve_demo_sampled_tokens_match_reference():
    """The original's decode loop (jit of the sampled serve step, keys 0, 1
    and 2) against ``decode`` of the twin on the same parameters."""
    cfg = ref_smoke(REF_ARCHS["qwen3-4b"])
    params, _ = jm.init_decoder(jax.random.key(0), cfg)
    b, steps = 4, 32
    state = jm.init_decode_state(cfg, b, max_len=64)
    serve = jax.jit(jsteps.make_serve_step(cfg, sample=True, temperature=1.0))
    toks = jax.random.randint(jax.random.key(1), (b, 1), 0, cfg.vocab_size)
    rng = jax.random.key(2)
    out = [toks]
    for _ in range(steps):
        rng, sub = jax.random.split(rng)
        toks, state = serve(params, state, toks, sub)
        out.append(toks)
    want = np.asarray(jnp.concatenate(out, axis=1))

    mod = load("torch_serve_demo")
    got, _ = mod.decode("cpu", decoder_params_from_jax(
        jax.tree.map(np.asarray, params), device="cpu"), b=b, steps=steps)
    assert got.shape == want.shape == (b, steps + 1)
    assert np.array_equal(got.numpy(), want), int((got.numpy() != want).sum())
    printed = [x for x in run_main(load("serve_demo"))
               if x.startswith("sample token ids:")]
    assert printed == [f"sample token ids: {got[0, :16].numpy()}"]
    print(f"compared {want.size} tokens")


def test_moe_balance_demo_loads_and_plan_match_reference():
    cfg = dataclasses.replace(ref_smoke(REF_ARCHS["qwen3-moe-30b-a3b"]),
                              compute_dtype="float32")
    params, _ = ref_init_moe(jax.random.key(0), cfg)
    e = cfg.moe.num_experts
    hot = jax.random.normal(jax.random.key(99), (1, 1, cfg.d_model))

    def jstream(step):
        base = jax.random.normal(jax.random.fold_in(jax.random.key(1), step),
                                 (4, 64, cfg.d_model))
        return base + 1.5 * hot

    # the original's balancer loop, load by load
    bal = RefBalancer(num_experts=e, bias_strength=0.05,
                      kernel_schedule="fac2")
    p = dict(params)
    p["router_bias"] = jnp.zeros((e,), jnp.float32)
    want_loads = []
    for step in range(15):
        step_load = np.asarray(ref_route(p, cfg, jstream(step))[3])
        want_loads.append(step_load)
        p["router_bias"] = jnp.asarray(bal.update(step_load), jnp.float32)
    rows = np.asarray(step_load / step_load.sum() * 256, dtype=int)
    cap = max(8, int(np.ceil(rows.max() / 8)) * 8)
    want_order, _ = bal.plan_kernel_tiles(rows, block_rows=8, p=8,
                                          capacity_rows=cap)
    want_out = np.asarray(ref_gmm(
        jnp.ones((e, cap, cfg.d_model), jnp.float32),
        jnp.ones((e, cfg.d_model, cfg.moe.d_ff), jnp.float32),
        tile_order=jnp.asarray(want_order), block_rows=8, interpret=True))

    mod = load("torch_moe_balance_demo")
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    res = mod.run("cpu", params=tparams,
                  stream=lambda step: torch.from_numpy(
                      np.array(jstream(step))))
    assert len(res["loads"]) == len(want_loads)
    for got, want in zip(res["loads"], want_loads):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(res["rows"], rows)
    np.testing.assert_array_equal(res["order"], want_order)
    np.testing.assert_array_equal(res["out"].numpy(), want_out)
    assert torch.equal(res["out"], res["out2"])

    want_lines = run_main(load("moe_balance_demo"))
    got_lines = "\n".join(mod.report(res, torch.device("cpu"))).splitlines()
    assert got_lines[:-1] == want_lines[:-1]
    assert got_lines[-1].startswith(
        f"grouped matmul out: {tuple(want_out.shape)} (plain version on CPU)")
    print(f"compared {sum(x.size for x in want_loads)} loads over "
          f"{len(want_loads)} steps, {len(want_order)} tile ids, "
          f"{len(want_lines) - 1} lines")
