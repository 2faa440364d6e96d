"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips without a GPU.  On a
machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

The file imports only torch, numpy and ``repro_torch`` so that it runs
where JAX is not installed.  Tolerance for bf16 outputs:
|kernel - plain| <= 2^-7 + 2^-7 * |plain| (about two bf16 rounding steps;
the kernels sum in another order than the fp32 plain versions before the
final rounding).  Across schedules and ``sched_p`` the outputs must be
bit-identical.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import REGISTRY
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.grouped_matmul import grouped_matmul as gm
from repro_torch.kernels.grouped_matmul.ops import grouped_matmul

TOL = 2.0 ** -7
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(dev, *shape, seed=0, scale=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(*shape, generator=g, device=dev) * scale).to(
        torch.bfloat16)


def _assert_close(got, want):
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= TOL + TOL * want.float().abs()).all()), float(diff.max())


@pytest.mark.parametrize("case", [
    # groups of (b, s, h, kvh, hd, block, window, causal, kv_lens, strided);
    # kv_lens None draws them from the seed s
    ((2, 300, 4, 2, 128, 128, 0, True, None, False),
     (2, 129, 4, 2, 128, 128, 0, True, None, False),    # one row past a tile
     (2, 300, 4, 2, 128, 64, 0, True, None, False),     # 64-blocks, ragged s
     # hd 256 (64-column kv tiles): one row past a q tile, ragged lens
     (2, 129, 4, 2, 256, 128, 0, True, None, False)),
    ((3, 200, 2, 1, 64, 64, 70, True, None, False),
     (2, 300, 4, 2, 128, 64, 0, True, None, False),     # a tile spans 2 blocks
     (2, 300, 4, 1, 128, 128, 32, True, None, False),   # window < a tile
     (2, 300, 4, 1, 80, 64, 40, True, None, False)),    # hd 80, MQA, window
    ((1, 96, 2, 2, 128, 512, 0, False, None, False),
     (3, 300, 4, 2, 128, 128, 0, True, [0, 300, 77], False),   # kv_len 0
     (2, 300, 2, 2, 64, 64, 40, False, [0, 129], False),
     (3, 200, 4, 2, 32, 64, 0, True, [0, 200, 77], False)),    # hd 32
    ((2, 1024, 8, 2, 128, 512, 0, True, None, False),
     (2, 300, 4, 2, 128, 128, 0, True, None, True),     # strided heads
     (2, 300, 4, 2, 64, 64, 32, True, None, True),
     (2, 333, 10, 1, 256, 128, 100, True, None, False),  # hd 256 MQA, window
     (2, 300, 4, 2, 80, 128, 0, True, None, True)),     # hd 80, strided
])
def test_flash_sched_matches_plain_and_is_schedule_free(dev, case):
    """Each case against the plain version, then bit-identical for all 27
    techniques at sched_p 1 (one CTA wraps the stage ring across every
    unit), 8 and the SM count; head dims 64 and 128, and 32 (padded to
    64), 80 (its exact width) and 256 (64-column kv tiles in 2 stages).

    The edge cases share the four items instead of being items of their
    own only while the reference's order-dependent
    ``test_shard_as_applies_constraint`` stays unfixed (ROADMAP.md,
    faults): more items here move this file in pytest-xdist's loadfile
    queue, and that reference test then fails.
    """
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for b, s, h, kvh, hd, blk, window, causal, lens, strided in case:
        if strided:
            # q, k and v as views of one (b, s, 3, h, hd) buffer
            buf = _randn(dev, b, s, 3, h, hd, seed=5)
            q, k, v = buf[:, :, 0], buf[:, :, 1, :kvh], buf[:, :, 2, :kvh]
        else:
            q, k, v = (_randn(dev, b, s, n, hd, seed=i)
                       for i, n in enumerate((h, kvh, kvh)))
        lens = (np.random.default_rng(s).integers(1, s + 1, size=b)
                if lens is None else np.asarray(lens))
        kw = dict(causal=causal, window=window, block_q=blk, block_k=blk,
                  kv_lens=lens)
        before = fa.FLASH_SCHED.launches
        out = flash_attention(q, k, v, schedule="static", sched_p=5, **kw)
        assert fa.FLASH_SCHED.launches == before + 1
        qf, kf, vf = fa.broadcast_flatten(q, k, v)
        want = fa.flash_attention_sched_plain(
            qf, kf, vf, kv_lens=np.repeat(lens, h), causal=causal,
            window=window)
        _assert_close(out, want.reshape(b, h, s, hd).permute(0, 2, 1, 3))
        for tech in REGISTRY:
            for p in (1, 8, n_sm):
                assert torch.equal(flash_attention(
                    q, k, v, schedule=tech, sched_p=p, **kw), out), (tech, p)


def test_flash_bhsd_entry_and_errors(dev):
    q = _randn(dev, 4, 256, 64)
    out = fa.flash_attention_sched_bhsd(q, q, q, schedule="gss", block_q=128,
                                        block_k=128)
    _assert_close(out, fa.flash_attention_sched_plain(q, q, q))
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention(*(q[:, :, None].float(),) * 3, schedule="fac2")
    # any head dim that is a multiple of 8 up to 256 runs (32: padded to 64)
    x = _randn(dev, 2, 200, 32)
    before = fa.FLASH_SCHED.launches
    _assert_close(fa.flash_attention_sched_bhsd(x, x, x, schedule="fac2"),
                  fa.flash_attention_sched_plain(x, x, x))
    assert fa.FLASH_SCHED.launches == before + 1
    # others raise, with no route to the plain version
    for hd in (20, 264):
        with pytest.raises(ValueError, match="head_dim"):
            y = _randn(dev, 1, 64, 1, hd)
            flash_attention(y, y, y, schedule="fac2")
    assert fa.FLASH_SCHED.launches == before + 1


@pytest.mark.parametrize("case", [
    # b, s, h, kvh, hd, window, causal
    (1, 300, 4, 2, 128, 0, True),      # GQA, s not a multiple of the tile
    (2, 200, 2, 1, 64, 32, True),      # MQA, window narrower than a tile
    (1, 520, 4, 4, 128, 200, True),    # MHA, window 200
    (1, 96, 2, 2, 128, 0, False),      # non-causal, one partial tile
    (2, 257, 6, 3, 64, 0, False),      # non-causal GQA, ragged tail
    (1, 1000, 8, 2, 128, 70, False),   # non-causal window
    (1, 2560, 8, 2, 128, 0, True),     # the 2-layer prefill's length
])
def test_flash_dense_matches_plain(dev, case):
    _check_flash_dense(dev, case)


def test_flash_dense_tile_edges(dev):
    """The edges of the kernel's 128 x 128 tiles, and the head dims that
    are padded inside the kernel: 80 (stablelm-3b, tiles of 128, products
    at its exact width) and 256
    (recurrentgemma-2b, 64-column K / V tiles in 2 stages), causal, windowed
    MQA, non-causal, a window of 2048 and windows narrower than a tile.

    The cases share one test instead of being parametrize items only while
    the reference's order-dependent ``test_shard_as_applies_constraint``
    stays unfixed (ROADMAP.md, faults): more items here move this file in
    pytest-xdist's loadfile queue, and that reference test then fails.
    """
    for case in ((1, 128, 2, 1, 128, 0, True),     # one q tile, one kv tile
                 (1, 129, 4, 2, 64, 0, True),      # one row past a tile
                 (1, 300, 4, 2, 128, 1, True),     # window 1: the row itself
                 (2, 400, 4, 1, 64, 127, True),    # window 127, a tile - 1
                 (1, 300, 4, 2, 80, 0, True),      # hd 80, GQA, ragged s
                 (2, 333, 4, 1, 80, 100, True),    # hd 80, windowed MQA
                 (1, 200, 4, 4, 80, 0, False),     # hd 80, non-causal
                 (2, 333, 10, 1, 256, 100, True),  # hd 256, windowed MQA
                 (1, 2100, 10, 1, 256, 2048, True),  # recurrentgemma's window
                 (1, 129, 2, 1, 256, 1, True),     # hd 256, window 1
                 (1, 300, 2, 2, 256, 63, True),    # window 63 < a kv tile
                 (1, 200, 2, 2, 256, 0, False)):   # hd 256, non-causal
        _check_flash_dense(dev, case)


def _check_flash_dense(dev, case):
    b, s, h, kvh, hd, window, causal = case
    q, k, v = (_randn(dev, b, s, n, hd, seed=i)
               for i, n in enumerate((h, kvh, kvh)))
    before = fa.FLASH_DENSE.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    assert fa.FLASH_DENSE.launches == before + 1
    want = fa.flash_attention_dense_plain(*fa.broadcast_flatten(q, k, v),
                                          causal=causal, window=window)
    _assert_close(out, want.reshape(b, h, s, hd).permute(0, 2, 1, 3))
    # block sizes name the TPU's blocking; the kernel's result ignores them
    assert torch.equal(flash_attention(q, k, v, causal=causal, window=window,
                                       block_q=128, block_k=64), out)


def test_flash_dense_reads_strided_heads(dev):
    """q, k and v as views of one (b, s, 3, h, hd) buffer: the heads are
    not contiguous rows, and the kernel reads them in place (hd 64, 128,
    and the padded 80 and 256).

    The cases share one test instead of being parametrize items only while
    the reference's order-dependent ``test_shard_as_applies_constraint``
    stays unfixed (ROADMAP.md, faults): more items here move this file in
    pytest-xdist's loadfile queue, and that reference test then fails.
    """
    b, s, h, kvh = 2, 300, 4, 2
    for hd in (64, 128, 80, 256):
        buf = _randn(dev, b, s, 3, h, hd, seed=5)
        q, k, v = buf[:, :, 0], buf[:, :, 1, :kvh], buf[:, :, 2, :kvh]
        assert not q.is_contiguous()
        out = flash_attention(q, k, v, causal=True)
        want = fa.flash_attention_dense_plain(*fa.broadcast_flatten(q, k, v),
                                              causal=True)
        _assert_close(out, want.reshape(b, h, s, hd).permute(0, 2, 1, 3))
        assert torch.equal(flash_attention(q.contiguous(), k.contiguous(),
                                           v.contiguous(), causal=True), out)


def test_flash_dense_bhsd_entry_and_errors(dev):
    q = _randn(dev, 3, 384, 128)
    out = fa.flash_attention_bhsd(q, q, q, window=100)
    _assert_close(out, fa.flash_attention_dense_plain(q, q, q, window=100))
    x = q[:, :, None]
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention(*(x.float(),) * 3)
    # any head dim that is a multiple of 8 up to 256 (72: padded to 128)
    y = _randn(dev, 2, 200, 72)
    _assert_close(fa.flash_attention_bhsd(y, y, y),
                  fa.flash_attention_dense_plain(y, y, y))
    for hd in (264, 84):
        with pytest.raises(ValueError, match="head_dim"):
            y = _randn(dev, 1, 64, 1, hd)
            flash_attention(y, y, y)
    with pytest.raises(ValueError, match="different devices"):
        flash_attention(x, x.cpu(), x)
    with pytest.raises(ValueError, match="GQA layout"):
        flash_attention(_randn(dev, 1, 64, 3, 64), *(_randn(dev, 1, 64, 2, 64),) * 2)


@pytest.mark.parametrize("shape", [(4, 256, 96, 256, 128), (6, 384, 64, 128, 128),
                                   (3, 256, 128, 128, 256)])
def test_gmm_matches_plain_and_is_schedule_free(dev, shape):
    _check_gmm(dev, shape)


def _check_gmm(dev, shape):
    e, c, d, f, bm = shape
    x = _randn(dev, e, c, d, seed=1)
    w = _randn(dev, e, d, f, seed=2, scale=d ** -0.5)
    rows = np.random.default_rng(e).integers(0, c + 1, size=e)
    before = gm.GMM.launches
    out = grouped_matmul(x, w, block_rows=bm, schedule="fac2",
                         expert_rows=rows, sched_p=3)
    assert gm.GMM.launches == before + 1
    t = e * (c // bm)
    te = torch.arange(t, device=dev) // (c // bm)
    want = gm.grouped_matmul_tiles_plain(x.reshape(t, bm, d), w, te)
    _assert_close(out, want.reshape(e, c, f))
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for tech in REGISTRY:
        for p in (8, n_sm):
            assert torch.equal(grouped_matmul(x, w, block_rows=bm, schedule=tech,
                                              expert_rows=rows, sched_p=p), out)
    assert torch.equal(grouped_matmul(x, w, block_rows=bm), out)
    perm = np.random.default_rng(0).permutation(t)
    assert torch.equal(grouped_matmul(x, w, tile_order=perm, block_rows=bm), out)


def _moe_case(dev, **kw):
    """(cfg, params, x) of a small MoE FFN: 8 experts, d 256, expert d_ff
    256, top-2, ragged dispatch, bf16; 2 x 300 tokens in 2 groups give
    ``cap`` 96 and 192 rows an expert, padded to 256 for the kernel."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.moe import init_moe

    base = get_arch("qwen3-moe-30b-a3b")
    cfg = dataclasses.replace(
        base, d_model=256, compute_dtype="bfloat16", moe=dataclasses.replace(
            base.moe, num_experts=8, top_k=2, d_ff=256, dispatch="ragged"))
    cfg = dataclasses.replace(cfg, **kw)
    params, _ = init_moe(torch.Generator(device=dev).manual_seed(0), cfg)
    return cfg, params, _randn(dev, 2, 300, cfg.d_model, seed=6)


def _plain_grouped_matmul(xe, w, *, block_rows, **_):
    """``grouped_matmul``'s identity-order product on the plain version."""
    e, r, d = xe.shape
    tiles = r // block_rows
    te = torch.arange(e * tiles, device=xe.device) // tiles
    return gm.grouped_matmul_tiles_plain(
        xe.reshape(e * tiles, block_rows, d), w, te).reshape(e, r, -1)


def _check_moe_ragged(dev, monkeypatch):
    """``moe_ragged`` on CUDA tensors: one ``gmm`` launch per projection,
    each with one CTA per SM, against the same call with the plain version
    in place of ``grouped_matmul``; two runs bit-identical."""
    from repro_torch.kernels.grouped_matmul import ops
    from repro_torch.models import moe as tmoe

    cfg, params, x = _moe_case(dev)
    assert tmoe._capacity(cfg, 300) % 128
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    ctas = []
    real = ops.gmm_cuda

    def spy(x_tiles, w, te, order, bounds, n_span):
        ctas.append(len(bounds) - 1)
        return real(x_tiles, w, te, order, bounds, n_span)

    monkeypatch.setattr(ops, "gmm_cuda", spy)
    before = gm.GMM.launches
    y, _, load = tmoe.moe_ragged(params, cfg, x)
    assert gm.GMM.launches == before + 3 and ctas == [n_sm] * 3
    assert torch.equal(tmoe.moe_ragged(params, cfg, x)[0], y)
    monkeypatch.setattr(tmoe, "grouped_matmul", _plain_grouped_matmul)
    want, _, want_load = tmoe.moe_ragged(params, cfg, x)
    assert gm.GMM.launches == before + 6
    _assert_close(y, want)
    assert torch.equal(load, want_load)


def test_gmm_tails_and_one_cta_ring(dev, monkeypatch):
    """The d tail, the 128-column tail and a single tile, then sched_p = 1:
    one CTA walks every unit, so its stage ring wraps many times and its
    phase bits carry on across units and tiles.  Last, the MoE model's
    ragged dispatch, whose expert rows are padded to the 128-row tile.

    The cases share one test instead of being parametrize items only while
    the reference's order-dependent ``test_shard_as_applies_constraint``
    stays unfixed (ROADMAP.md, faults): more items here move this file in
    pytest-xdist's loadfile queue, and that reference test then fails.
    """
    # the last 64-deep box runs past d = 160; f = 384 is a 256 block and a
    # 128 tail
    _check_gmm(dev, (2, 256, 160, 384, 128))
    _check_gmm(dev, (1, 128, 64, 128, 128))   # one expert, a single tile
    e, c, d, f, bm = 4, 512, 256, 512, 128
    x = _randn(dev, e, c, d, seed=3)
    w = _randn(dev, e, d, f, seed=4, scale=d ** -0.5)
    out = grouped_matmul(x, w, block_rows=bm, sched_p=1)
    t = e * (c // bm)
    te = torch.arange(t, device=dev) // (c // bm)
    want = gm.grouped_matmul_tiles_plain(x.reshape(t, bm, d), w, te)
    _assert_close(out, want.reshape(e, c, f))
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    assert torch.equal(grouped_matmul(x, w, block_rows=bm, sched_p=n_sm), out)
    rows = np.array([512, 3, 0, 200])
    assert torch.equal(grouped_matmul(x, w, block_rows=bm, schedule="fac2",
                                      expert_rows=rows, sched_p=1), out)
    _check_moe_ragged(dev, monkeypatch)


def test_gmm_rejects_what_the_kernel_does_not_take(dev):
    """Also through the MoE model's ragged dispatch: fp32 tensors and an
    expert d_ff that is not a multiple of 128 raise; nothing falls back to
    the einsum."""
    import dataclasses

    from repro_torch.models.moe import moe_ragged

    x = _randn(dev, 2, 128, 64)
    with pytest.raises(ValueError, match="f %"):
        grouped_matmul(x, _randn(dev, 2, 64, 96), block_rows=128)
    with pytest.raises(TypeError, match="bfloat16"):
        grouped_matmul(x.float(), _randn(dev, 2, 64, 128).float(),
                       block_rows=128)
    cfg, params, xm = _moe_case(dev)
    with pytest.raises(TypeError, match="bfloat16"):
        moe_ragged(params, cfg, xm.float())
    cfg96 = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                             d_ff=96))
    params96 = {k: (v[..., :96] if k in ("wi", "wg") else
                    v[:, :96] if k == "wo" else v) for k, v in params.items()}
    with pytest.raises(ValueError, match="f %"):
        moe_ragged(params96, cfg96, xm)


def test_build_is_cached_and_counted(dev):
    libs = _build.build_all()
    assert set(libs) == {"flash_dense", "flash_dense_bwd", "flash_sched", "gmm"}
    assert all(p.is_file() for p in libs.values())
    _build.reset_launches()
    assert all(k.launches == 0 for k in _build.KERNELS.values())


def test_forward_launches_flash_dense_once_per_layer(dev):
    """A 2-layer full-width qwen3-4b prefill above the flash threshold goes
    through the dense kernel once per layer."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import forward, init_decoder

    cfg = dataclasses.replace(get_arch("qwen3-4b"), num_layers=2)
    params, _ = init_decoder(0, cfg, device=dev)
    s = cfg.flash_threshold + 52
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, s))).to(dev)
    before = fa.FLASH_DENSE.launches
    logits, _ = forward(params, cfg, tokens)
    torch.cuda.synchronize()
    assert fa.FLASH_DENSE.launches == before + cfg.num_layers
    assert logits.shape == (1, s, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all())
