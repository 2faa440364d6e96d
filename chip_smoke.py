#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's kernel paths, prefill, serving and
training on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one card

It imports only ``repro_torch``, ``torch`` and numpy, builds the CUDA
kernels from ``src/repro_torch/kernels/csrc`` on first use (into
``build/repro_torch``), and prints one JSON line per phase:

  env          the card, torch / CUDA versions, SM count, build seconds and
               each kernel's registers / spills from ``ptxas -v``
  main_path    launch counts set to 0, then the path a user calls at the
               full layer width of qwen3-moe-30b-a3b: ``ops.flash_attention``
               (32 q heads, 4 KV heads, head_dim 128, 8 ragged lanes of
               4096, causal, schedule fac2, sched_p = SM count and 8) and
               the expert FFN through ``ops.grouped_matmul`` (128 experts,
               C 512, wi (128, 2048, 768), wo (128, 768, 2048), fac2); the
               counts are read right after
  small        both kernels against the plain oracles at small, ragged
               shapes (partial blocks, 64-column kv blocks inside a
               128-column tile, windows narrower than a tile, a lane of
               kv_len 0, strided heads, dead tiles; flash_sched at head
               dims 32, 64, 80, 128 and 256)
  flash_sched  the kernel against its plain version at the main path's
               shapes, bit-identity across schedules and sched_p, timing
               (single calls and back to back) and the host planning of a
               call split into its pieces (``plan_split_ms``); per head dim
               80 and 256 (``by_head_dim``) the same ragged lanes at 32 / 8
               heads, fac2, sched_p = SM count: the kernel against its
               plain version, its times, the bound and
               ``scaled_dot_product_attention``'s with the same boolean
               mask
  gmm          the same for the grouped matmul (wi and wo shapes), and
               back-to-back times of the fac2 order, the identity order and
               the identity order with every tile on expert 0
  flash_dense  the dense kernel against its plain version at the prefill's
               shape (qwen3-4b: 1 x 4096, 32 q heads, 8 KV heads,
               head_dim 128, causal), at the full attention shapes of
               stablelm-3b (1 x 4096, 32 / 32 heads, head_dim 80 at its
               exact width, causal) and recurrentgemma-2b (1 x 4096, 10 / 1
               heads, head_dim 256, window 2048), and at small ragged
               shapes (s not a multiple of the tile, MQA, head_dims 64, 80
               and 256, windows from 1 to 2048); per full shape
               (``by_head_dim``) its time (single calls and back to back),
               the plain version's, and ``scaled_dot_product_attention``'s
               with the same mask on the same tensors as a yardstick (the
               port never calls it), and ``digest``: a hash of its outputs
               (head dims 128 and 64) on inputs of a seed of their own,
               equal across builds that compute the same bits
  prefill      launch counts set to 0, then ``models.forward`` of full-width,
               full-depth qwen3-4b (36 layers, random fp32 weights from seed
               0, bf16 compute) on 1 x 4096 tokens from numpy seed 0; the
               counts are read right after (flash_dense: 36).  Wall time,
               tokens/s, a device profile of a second run, and at 2 layers
               ``forward`` against ``decode_step`` fed the same 2560 tokens
               one by one
  serve        ``DecodeEngine`` through ``launch.serve``'s code path on
               full-width qwen3-4b: 8 requests drawn as the launcher draws
               them, 4 slots, max_len 256, fac2; again with the int8 KV
               cache; a device profile of a short run
  moe_prefill  launch counts set to 0, then ``models.forward`` of
               full-width qwen3-moe-30b-a3b cut to 8 of 48 layers (random
               fp32 weights from seed 0, bf16 compute, dispatch "ragged")
               on 1 x 4096 tokens; the counts are read right after (gmm:
               3 a layer, flash_dense: 1 a layer).  Wall time, tokens/s, a
               device profile, a second run bit-identical to the first,
               the share of (token, k) slots dropped at capacity factor
               1.25; one layer's ragged FFN against the same call with the
               plain grouped matmul in place of ``grouped_matmul``; at
               capacity factor E / top_k (16: no expert can overflow) every
               layer's FFN under the ragged and the dense dispatch on the
               input that layer had in the run (routed alike by
               construction), then the ragged logits of 2 layers against
               the dense dispatch's; gmm timed alone at the model path's
               shapes
  moe_serve    ``DecodeEngine`` through ``launch.serve``'s code path on the
               same model: 8 requests, 4 slots, max_len 256, fac2, bf16 KV;
               a device profile of a short run
  cluster      ``launch.serve.run_cluster`` (the two-level node / thread
               schedule, replicas one after another on the card, one
               shared copy of the weights) at the launcher's defaults:
               16 requests, 4 replicas x 4 slots, max_len 128, thread
               technique fac2, on full-width qwen3-4b under node techniques
               awf_b and static, then on 1 replica (its qwen3-4b runs
               execute right after serve, on that model's weights); the
               MoE model of moe_prefill (ragged dispatch) with 8 requests
               on 2 replicas, awf_b / fac2, counts from 0 around it (gmm
               on the ``cluster_moe`` path); every layer's MoE input of
               one decode step of that run (captured on the way, x of
               4 x 1 tokens) goes through ``moe_ragged`` again, with gmm
               and with the plain grouped matmul, held at the stated
               tolerance after the counts are read.  Each run: every request
               completes with its tokens, in vocabulary; the router's
               replica_steps, replica_requests and node_chunks equal
               run_cluster's on the CPU at smoke_config of the arch;
               cross-node c.o.v. and p.i., wall time, tokens/s, step ms
               median and p90, peak allocated memory, which for 4 replicas
               stays under 1 GB above 1 replica's.  Then the 20 golden trial
               digests through ``repro_torch.trials`` against
               ``tests/data/pr8_trial_digests.json``, and a
               ``ResilienceConfig()`` trial of the thermal scenario
  sample       the sampler (``repro_torch.random``, ``jax.random``'s
               threefry bits) on the card against the same calls on the
               CPU: ``split`` and ``bits`` for keys 0, 1 and 42 at odd and
               large shapes, ``uniform`` at (4, 151936) (qwen3-4b's and
               qwen3-moe-30b-a3b's padded vocabulary), bit for bit; the
               Gumbel noise within 4 ulp of max(|g|, 1); ``categorical``
               on CUDA logits against the CPU on the same logits, every
               token equal (counted); the time, kernel count and device
               time of one decode step's sampling (a split and a
               categorical at 4 x 151936)
  moe_serve_sampled
               the MoE model of moe_serve (8 layers, fp32) saved with
               ``CheckpointStore`` under the temporary directory, restored
               with ``shardings=`` (``param_shardings`` under
               ``launch.mesh.production_rules``) onto a (1, 1) CUDA
               ``DeviceMesh`` over a 1-rank ``nccl`` group, every leaf a
               DTensor equal bit for bit to the saved one; then
               ``DecodeEngine(greedy=False, seed=3)`` on the restored
               leaves: 8 requests, 4 slots, max_len 256, fac2, the counts
               from 0 around the run (gmm: 3 a layer and step), tokens/s,
               step ms median and p90; then 4 requests at max_len 64 with
               seed 3 (profiled: the device idle share), again with seed
               3 (identical tokens) and with seed 4 (other tokens)
  recurrent    xlstm-1.3b and recurrentgemma-2b at full width and depth:
               a 4096-token prefill (launch counts from 0; recurrentgemma's
               8 ``local_attn`` layers launch flash_dense at head_dim 256,
               window 2048, once each) and a device profile of it where it
               launches flash_dense.  Then a device
               profile of a 512-token prefill (below flash_threshold, the
               einsum attention of every arch), ``forward`` against
               ``decode_step`` on one block-pattern period (8 and 3 layers)
               fed the same tokens, and ``DecodeEngine`` with 4 requests on
               2 slots, so that lanes are reset and reused
  archs        one line each for internvl2-1b (14 / 2 heads, hd 64, a
               256-row prefix, tied embeddings), musicgen-medium (24 / 24,
               hd 64, a 64-row prefix), codeqwen1.5-7b (32 / 32, hd 128)
               and granite-20b (MQA 48 / 1, hd 128), in that order, each
               at full width from ``init_decoder(0, ...)`` (fp32 weights,
               bf16 compute) and at all of its layers, or at the largest
               depth whose fp32 tree and the serving engine's bf16 copy
               leave ARCHS_FREE_BYTES free (granite-20b; the line's
               ``cut`` and ``memory`` say so); each tree freed before the
               next.  The prefill: launch counts set to 0, then
               ``models.forward`` on 4096 positions (4096 - prefix_len
               tokens from numpy seed 0 after a (1, prefix_len, d_model)
               standard normal prefix from seed 1), the counts read right
               after (flash_dense: one a layer, no other kernel); logits
               (1, 4096, padded_vocab) and finite; a warm run's wall time,
               tokens/s and device profile.  The first 2 layers on the
               same positions with the kernels against plain attention
               swapped in for ``ops.flash_attention`` (the logits
               tolerance below).  ``DecodeEngine`` through
               ``launch.serve``'s code path: 4 requests, 4 slots, max_len
               128, fac2, bf16 KV (token prompts, no prefix), peak memory.
               The loss and every gradient of 2 layers on 2 x 4096
               positions (a (2, prefix_len, d_model) prefix from seed 2
               and the DataLoader's tokens cut to 4096 - prefix_len) with
               the kernels against plain attention, one launch of each
               backward kernel a layer.  Then ``flash_dense`` at (1, 4096)
               and ``flash_dense_bwd`` at (2, 4096) at the arch's heads,
               as the flash_dense and train phases time them (granite-20b's
               backward also pass by pass, ``split_ms``)
  prefill_80   launch counts set to 0, then ``models.forward`` of
               full-width, full-depth stablelm-3b (32 layers, head_dim 80,
               random fp32 weights from seed 0, ~11 GB, bf16 compute) on
               1 x 4096 tokens; the counts are read right after
               (flash_dense: 32).  Wall time, tokens/s, a device profile
  campaign     the port's campaign engine (``core.graph_sim``) on the card
               at the paper's Table 1 size: 352.nab (N 44,794) on
               miniHPC-Broadwell (p 20) and miniHPC-KNL (p 64), the
               campaign's 9 adaptive techniques at every Table 1 chunk
               parameter, 5 repetitions (folded into one lane each: the
               simulator is deterministic), 3 of 352.nab's 1,002
               time-steps, held against the host ``batch_sim`` (rtol 1e-9
               at p >= 8, BOLD's log-ulp tolerance the same); lanes,
               rounds, host syncs and wall time, and a device profile of
               one technique's lane group; then
               ``auto_simulate(engine="graph")`` on the card against
               ``engine="batch"`` (the same arms) and
               ``plan_schedule(backend="graph")`` on the card against the
               host plan for every plannable technique at p 20 and 64
  train        the training slice.  ``flash_dense_bwd`` (delta, dkdv, dq)
               against its plain version (``torch.autograd.grad`` through
               the fp32 plain forward) at qwen3-4b's attention shape (2 x
               4096, 32 / 8 heads, hd 128), granite-moe-1b-a400m's (16 /
               8 heads, hd 64), stablelm-3b's (32 / 32, hd 80) and
               recurrentgemma-2b's (10 / 1, hd 256, window 2048), causal:
               dQ, dK, dV within 2^-6 of max |plain| each, two runs
               bit-identical, times of the backward and of forward +
               backward (single calls and back to back), the plain
               backward's and SDPA's backward and forward + backward
               (``is_causal`` or the window as a boolean mask,
               ``enable_gqa``; a yardstick); after each of the last two
               the first layers of that model at full width (stablelm-3b
               2, recurrentgemma-2b one pattern period, 3) on 2 x 4096
               tokens with the kernels against plain attention (loss and
               every gradient leaf); ``dense_digest`` equal to the
               parent's.  Then qwen3-4b at
               full width on 2 x 4096 tokens from the port's
               ``DataLoader``: loss and every gradient leaf of 2 layers
               with the kernels against the same with the plain attention
               swapped in for ``ops.flash_attention``; launch counts set to
               0, then 16 of 36 layers (fp32 weights from seed 0, bf16
               compute, remat "full", AdamW at the launcher's schedule)
               for 1 warm and 4 timed ``make_train_step`` steps, the counts
               read right after (per step flash_dense 32, each backward
               kernel 16), step time, tokens/s, peak allocated memory, the
               loss at step 0 within 0.5 of ln(vocab), a device profile of
               one more step; last ``launch.train`` at its defaults with
               --steps 12 --checkpoint-every 4 (smoke_config: no custom
               kernel) and a ``Trainer`` that fails once at step 6,
               restores step 4's checkpoint and replays
  moe_train    qwen3-moe-30b-a3b at full width cut to 2 of 48 layers,
               dispatch "ragged", remat "full", on 2 x 4096 tokens from the
               ``DataLoader``: loss and every gradient leaf with the kernels
               against the same with the plain grouped matmul in place of
               ``_expert_matmul``; launch counts set to 0, then 1 warm and
               3 timed AdamW ``make_train_step`` steps, the counts read
               right after (per layer and step gmm 6: forward and the
               remat's recompute for wi, wg and wo; gmm_dx 3; gmm_dw 3;
               flash_dense 2; each backward kernel 1); step time, tokens/s,
               peak memory, a device profile of one more step; then dX
               (``gmm_dx``) and dW (``gmm_dw``) alone at the step's shapes
               against ``grouped_matmul_bwd_plain``, two runs
               bit-identical, their times, ``torch.bmm``'s, the bound and
               a digest of the dX outputs
  kernels_any_dtype
               the kernels for the dtypes and shapes the block-aligned
               wgmma kernels do not take (``gmm_any.cu``: bf16 / fp16 on
               wgmma, fed by TMA or by the thread loader; ``gmm_simt.cu``,
               ``flash_simt.cu``, ``flash_simt_bwd.cu``: plain fp32 FMA)
               against their plain versions: gmm, gmm_dx and gmm_dw in
               fp32, bf16 and fp16 at the reference MoE demo's shape (4
               experts x 16 rows, 8-row tiles, d 64, f 32) and at
               qwen3-moe-30b-a3b's width in 8-row tiles (128 x 64 rows, d
               2048, f 768), in bf16 and fp16 at f 764 (rows TMA cannot
               describe) and in bf16 with x and dY 2 bytes off 16, each
               with the kernel and route it took, bit-identical across
               schedules and ``sched_p`` (a misaligned call also to an
               aligned copy); ``gmm_digest`` (the fp32 family's outputs)
               equal to the first general kernel's
               (``PARENT_GMM_DIGEST``); the off-block path (counts from 0:
               ``grouped_matmul`` and ``grouped_matmul_bwd`` in bf16 and
               fp16 at qwen3-moe's width, 8-row tiles and 64 rows an
               expert, and in bf16 at f 764: ``gmm_any`` 3, ``gmm_dx_any``
               3, ``gmm_dw_any`` 2 and ``gmm_dw`` 1 launches);
               the fp32 flash forward dense and causal at head dims 64,
               80 and 128 on the tensor cores (``flash_f32.cu``, route
               "tf32x3": three TF32 products each) with the general
               kernel's error and times on the same tensors beside it, and
               at 256 (window 2048) on cluster pairs (``"tf32x3_256"``,
               ``flash_dense_f32_256``, the general kernel beside it); ragged at the
               main path's lanes in a fac2 plan (``flash_sched_f32``, the
               general kernel beside it; bit-identical under static / 8
               and gss / 1); the fp32 backward at qwen3-4b's training
               shape and at recurrentgemma-2b's (hd 256, window 2048; on
               cluster pairs) on the tensor cores (``flash_f32_bwd.cu``,
               the general backward beside each); fp16 flash (the fp16
               path, counts from 0: ``FP16_PATH_LAUNCHES``, dense forward
               and backward on the fp16 instantiations of ``flash_dense``
               and ``flash_dense_bwd``, the schedule-aware call on the
               fp16 instantiation of ``flash_sched``; then dense at
               qwen3-4b's prefill, the backward at qwen3-4b's training
               shape and the scheduled call at the main path's lanes (bits
               equal under static / 8 and gss / 1), each with the general
               kernel on the same tensors beside it, against SDPA in fp16,
               each with the share of the fp16 gate it uses;
               ``flash16_digest`` and ``flash16_sched_digest`` twice each,
               equal).
               Each: its route, its time (single calls and back to back),
               the plain version's, ``torch.bmm`` / SDPA in fp32 on the
               same tensors, and the bound (fp32 operations at 67 TFLOP/s;
               the tensor-core rows also at 3 x operations / 494.7 TFLOP/s,
               ``bound_ms_tf32x3``; the fp16 rows at 989 TFLOP/s, the
               tensor-core ones also at the reference's precision,
               ``bound_ms_fp32_pv``, the general kernels' also at 67
               TFLOP/s, ``bound_ms_fp32_fma``); and
               ``flash32_digests`` (below; ``flash32_digest`` held to
               ``PARENT_FLASH32_DIGEST``).  Then launch counts set to 0
               and the fp32 model path: ``flash_attention`` with a
               schedule at the main path's lanes, dense attention at
               recurrentgemma-2b's local-attention shape in fp32 forward
               and backward, one loss and gradient of qwen3-4b and of the
               ragged qwen3-moe-30b-a3b at full width, 2 layers,
               compute_dtype "float32", on 2 x 4096 tokens; the counts
               read right after (``FP32_PATH_LAUNCHES`` for the flash
               kernels, every other general kernel launched), then the
               gradients against the plain attention's and the plain
               grouped matmul's; then counts set to 0 and the general
               kernels' path (``GENERAL_PATH_LAUNCHES``: the schedule-aware
               fp32 call at recurrentgemma-2b's hd 256 on the general
               kernel, and a dense fp32 call there forward and backward on
               views whose strides TMA cannot describe, copied to TMA's
               layout by ``tma_pack`` and run on the cluster pairs'
               kernels), each output against its plain version, the
               general dense kernels launched directly on the same views,
               ``tma_pack`` against its plain version, and
               ``packed_sweep`` (the dense entry on such views at every
               head dim 1-256 in each dtype, one launch of each pass of
               the copies' route)
  examples     the seven twins of ``examples/`` (``torch_*.py``), each in
               its own process at its default arguments, launch counts from
               0 at its start and read at its end: exit code, wall seconds
               and the numbers each prints (losses, checkpoint steps, the
               restart step and shares, tokens/s, the tile plan's p.i.);
               moe_balance_demo under ``torch.profiler``: 2 launches of
               ``gmm_simt``, no plain version
  kernels      the summary line, one entry per kernel; ``launches`` sums
               the counted runs of every path that launches the kernel
               (``launches_by_path``); flash_sched's and flash_dense's
               entries carry ``by_head_dim`` and ``bound_ms_fp32_pv``, the
               bound of the work at the reference's precision (S = Q K^T
               once and P V twice: P in fp32 as bf16 hi + lo);
               flash_dense's and flash_dense_bwd's carry ``by_arch``, the
               archs phase's times at each arch's shape (their
               ``archs_prefill`` and ``archs_train`` paths count its
               prefills and 2-layer gradients)

then the card's name and power limit as ``nvidia-smi`` prints them, and
last ``{"ok": true, "device": {...}}``.  Any failed check raises and the
script exits non-zero; it also exits non-zero, printing no result, when no
CUDA device is present or ``src/repro_torch`` is missing beside it.

    python3 chip_smoke.py --dense-digest [SRC]
    python3 chip_smoke.py --hd80-digest [SRC]
    python3 chip_smoke.py --sched-digest [SRC]
    python3 chip_smoke.py --dense-times [SRC]
    python3 chip_smoke.py --bwd-times [SRC]
    python3 chip_smoke.py --moe-bwd-times [SRC]
    python3 chip_smoke.py --yardsticks [SRC]
    python3 chip_smoke.py --gmm-digest [SRC]
    python3 chip_smoke.py --gmm-times [SRC]
    python3 chip_smoke.py --flash32-digest [SRC]
    python3 chip_smoke.py --flash32-times [SRC]
    python3 chip_smoke.py --sdpa32-kernels [SRC]
    python3 chip_smoke.py --bwd-digest [SRC]
    python3 chip_smoke.py --flash16-times [SRC]

print only that digest (``dense_digest``; ``hd80_digest``: ``flash_dense``'s
output and lse and ``flash_dense_bwd``'s dQ, dK, dV at stablelm-3b's
shape; ``sched_digest``: ``flash_sched``'s outputs at head dims 64 and 128
on small ragged shapes), or only ``flash_dense``'s single-call and
back-to-back times at the prefill's shape (head_dim 128, causal), at
head_dim 64 with a window of 200 and at stablelm-3b's head_dim 80 (with
SDPA's time beside it), or only ``flash_dense_bwd``'s back-to-back times
at the train phase's four shapes with SDPA's backward beside them
(``bwd_times``), or only the MoE backward's dX and dW back-to-back times
at the moe_train step's shapes with a digest of the dX outputs
(``moe_bwd_times``), or only the yardsticks that could send a kernel back
to the bring_up queue (``yardsticks``: ``flex_attention`` against
``flash_dense`` at head_dim 256, ``torch.linalg.vecdot`` against the
backward's delta pass, ``torch.bmm`` against ``gmm_dw`` in turns), or
only a hash of the fp32 grouped matmul family's outputs at both
SIMT_GMM_SHAPES (``gmm_digest``: the forward in a fac2 plan, dX, dW), or
only that family's back-to-back times at qwen3-moe's width in 8-row
tiles in fp32, bf16 and fp16 and at f 764 in bf16 and fp16 with
``torch.bmm`` beside them and the routes taken (``gmm_times``), or only
a hash of the fp32 dense flash forward's output and lse and its
backward's dQ, dK, dV at FLASH32_DIGEST_SHAPES (``flash32_digest``) and,
under names of their own, of the hd-256 windowed backward fed the general
forward's output and lse, of that forward on the tree's own route then
that backward, and of the ragged schedule-aware fp32 forward
(``flash32_digests``), or only the fp32
dense flash forward's back-to-back times at SIMT_DENSE_SHAPES' head dims
64, 80, 128 and 256 (the general kernel's beside each), the backward's at SIMT_BWD_SHAPE and at
recurrentgemma-2b's hd-256 window and the schedule-aware call's at the
main path's lanes, with SDPA's beside them and the kernels each call
launched (``flash32_times``), or only the profiler's names of the kernels SDPA
launches in fp32 at the hd-128 rows' shapes (``sdpa32_kernels``), or only
hashes of ``flash_dense_bwd``'s bf16 gradients (with the forward's output
and lse) at hd 128 and at a windowed hd-256 MQA (``bwd_digest``), or only
the fp16 dense forward's back-to-back time at qwen3-4b's prefill, its
backward's at SIMT_BWD_SHAPE and the schedule-aware call's at the main
path's lanes (the general kernel's beside it), with SDPA's in fp16 beside
them and the kernels each call launched (``flash16_times``), for
the package under ``SRC`` (default: this
checkout's ``src``), so that another tree's kernels can be held against
this one bit for bit, and timed against it in turns (parent, change,
change, parent) in one call.

Tolerance of the 2-layer ``forward`` / ``decode_step`` comparison (bf16
compute), also held by the recurrent ``forward`` / ``decode_step``
comparisons and by the 2-layer MoE dispatch comparison on the tokens that
both dispatches route to the same experts in every layer, which must be
at least 90% of them (the argmax bound holds for all tokens there): max
|logit difference| <= 0.25 and the same argmax at >= 80% of the positions.
The layer-by-layer MoE dispatch comparison holds every token's FFN output
to the same 0.25.  Both paths keep the residual stream in
bf16 (a step of 2^-8 to 2^-7 near 1), and they differ in where they round:
the prefill's attention is the dense kernel (fp32 scores and
probabilities, one rounding of the output to bf16), the decode's rounds
scores and probabilities to bf16 and multiplies a one-row GEMV where the
prefill runs a GEMM.  The logits of random weights have a spread of about
1, so a difference of a few bf16 steps in the hidden state moves a logit by
about 0.01-0.05 and flips the argmax where the two largest logits lie
closer than that.  The recurrent forms differ more: the chunkwise mLSTM
rounds its scores to bf16 where the step form keeps an fp32 state, and the
states carry a difference on from step to step.

The plain versions run with TF32 off (``torch.backends.cuda.matmul.
allow_tf32`` and ``torch.backends.cudnn.allow_tf32`` False), in fp32.
Tolerance for a bf16 kernel output against the plain version:
|kernel - plain| <= 2^-7 + 2^-7 * |plain|, i.e. about two bf16 rounding
steps: the kernels sum in another order (and split P into two bf16 terms)
before the final rounding to bf16.

The train phase's gates.  ``flash_dense_bwd``'s dQ, dK and dV against the
fp32 plain backward: max |kernel - plain| <= 2^-6 max |plain| per tensor
(P and dS are rounded to bf16 before their products, and the result to
bf16 once).  The 2-layer steps (and recurrentgemma-2b's 3 layers),
kernels against plain attention (bf16 compute, the residual stream in
bf16), and the MoE step against the plain grouped matmul: losses within
1e-2, every gradient leaf within 2^-4 of that leaf's largest |plain|
entry.  The MoE backward kernels alone: |kernel - plain| <= 2^-7 + 2^-7
|plain|, as the forward kernels.  The Trainer's
replayed steps within 1e-3 of the first pass's losses (the embedding's
backward sums with atomics on the card).
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12         # H100 SXM HBM3 rate
ATOL = RTOL = 2.0 ** -7
REPS = 20                    # timed calls per kernel measurement

# main-path widths: qwen3-moe-30b-a3b (src/repro/configs/qwen3_moe_30b_a3b.py)
B, S, H, KVH, HD = 8, 4096, 32, 4, 128
# this slice: qwen3-4b (src/repro/configs/qwen3_4b.py) at full width
ARCH, PREFILL_S, PARITY_S, PARITY_LAYERS = "qwen3-4b", 4096, 2560, 2
SERVE_REQUESTS, SERVE_SLOTS, SERVE_MAX_LEN = 8, 4, 256
PARITY_MAX_DIFF, PARITY_ARGMAX = 0.25, 0.80
E, C, D_MODEL, D_FF, BLOCK_ROWS = 128, 512, 2048, 768, 128
# this slice: the MoE and recurrent families
MOE_ARCH, MOE_LAYERS, MOE_PARITY_LAYERS = "qwen3-moe-30b-a3b", 8, 2
MOE_ROUTED_ALIKE = 0.90
RECURRENT_ARCHS = ("xlstm-1.3b", "recurrentgemma-2b")
RECURRENT_PARITY_S, RECURRENT_PROFILE_S = 640, 512
RECURRENT_REQUESTS, RECURRENT_SLOTS = 4, 2
# this slice: flash_dense at head dim 80 (src/repro/configs/stablelm_3b.py)
DENSE80_ARCH = "stablelm-3b"
# flash_sched at the head dims of stablelm-3b and recurrentgemma-2b: the
# main path's 8 ragged lanes of 4096 at 32 / 8 heads
SCHED_WIDE_HEAD_DIMS, SCHED_WIDE_KVH = (80, 256), 8
# the campaign phase: time-steps of each Table 1 config (of 352.nab's
# 1,002); 3 until the dryrun phase took its place in the time limit
CAMPAIGN_TIMESTEPS = 2
IDENTITY_SCHEDULES = ("static", "ss", "gss", "fac2", "awf_b", "ws_rr",
                      "dls_steal")
# the sample phase: the sampler on the card against the CPU for these keys,
# split / bits at these shapes, uniform and categorical at the vocabulary of
# qwen3-4b and qwen3-moe-30b-a3b (151936, padded), categorical on
# SAMPLE_ROWS rows a key; the Gumbel noise within SAMPLE_GUMBEL_ULPS ulp of
# max(|g|, 1) (its logs run in float64 on both, rounded once to float32)
SAMPLE_SEEDS = (0, 1, 42)
SAMPLE_SHAPES = ((), (1,), (5,), (3, 7, 11), (4, 151936))
SAMPLE_VOCAB, SAMPLE_ROWS, SAMPLE_GUMBEL_ULPS = 151936, 16, 4
# moe_serve_sampled: the engine's seed (run twice), then another seed
SAMPLED_SEEDS = (3, 4)
# the cluster phase: launch.serve --replicas at the launcher's defaults
# (16 requests, 4 slots, max_len 128), and the MoE model on 2 replicas
CLUSTER_REQUESTS, CLUSTER_REPLICAS, CLUSTER_SLOTS, CLUSTER_MAX_LEN = \
    16, 4, 4, 128
CLUSTER_NODE_TECHNIQUES, CLUSTER_THREAD_TECHNIQUE = ("awf_b", "static"), \
    "fac2"
MOE_CLUSTER_REQUESTS, MOE_CLUSTER_REPLICAS = 8, 2
# the decode step of the MoE cluster run whose MoE inputs (every layer's)
# are held against the plain grouped matmul
MOE_CLUSTER_TAP_STEP = 20
# 4 replicas may peak this much above 1 replica on the same requests: their
# KV caches (~0.3 GB at qwen3-4b's width), not a copy of the weights each
CLUSTER_MEMORY_MARGIN = 1e9
GOLDEN_DIGESTS = ROOT / "tests" / "data" / "pr8_trial_digests.json"
# the training slice: flash_dense_bwd at qwen3-4b's attention shape (b 2,
# s 4096, 32 / 8 heads, hd 128) and granite-moe-1b-a400m's (16 / 8 heads,
# hd 64), causal; dQ, dK, dV within BWD_REL_TOL of max |plain| each
BWD_ARCH_64 = "granite-moe-1b-a400m"
BWD_KERNELS = ("flash_dense_bwd_delta", "flash_dense_bwd_dkdv",
               "flash_dense_bwd_dq")
BWD_REL_TOL = 2.0 ** -6
# dense_digest() of the parent's flash_dense (PR 17's tree, on an H100):
# the lse write must leave the forward's bits as they were
PARENT_DENSE_DIGEST = "251ae83caaa69f6f"
# the step of qwen3-4b at full width on 2 x 4096 tokens from the DataLoader:
# TRAIN_PARITY_LAYERS layers with the kernels against plain attention, then
# TRAIN_LAYERS layers (of 36: fp32 params, grads and two AdamW moments of
# all 36 need 70.6 GB) for 1 warm and TRAIN_STEPS timed steps
TRAIN_BATCH, TRAIN_S = 2, 4096
TRAIN_PARITY_LAYERS, TRAIN_LAYERS, TRAIN_STEPS = 2, 16, 4
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-2, 2.0 ** -4
# the Trainer on the card: one RuntimeError at step 6, replayed from the
# step-4 checkpoint; replayed losses within TRAIN_REPLAY_TOL of the first
# pass's (the embedding's backward sums with atomics on the card)
TRAIN_FAIL_AT, TRAIN_REPLAY_TOL = 6, 1e-3
# the backward at every head dim the configs use: 80 (stablelm-3b, 32 / 32
# heads, its exact width) and 256 (recurrentgemma-2b, 10 / 1, window 2048),
# b 2 x 4096; then a full-width step of each model with the kernels against
# plain attention: stablelm-3b at 2 layers, recurrentgemma-2b at one
# block-pattern period (rglru, rglru, local_attn)
BWD_WIDE_ARCHS = {"80": ("stablelm-3b", 2), "256": ("recurrentgemma-2b", 3)}
# the backward's dkdv and dq kernels at each head dim (all TMA + wgmma)
BWD_KERNELS_BY_HEAD_DIM = {
    "64": "dkdv_wgmma<64, 64>, dq_wgmma<64, 64>",
    "128": "dkdv_wgmma<128, 128>, dq_wgmma<128, 128>",
    "80": "dkdv_wgmma<128, 80>, dq_wgmma<128, 80> (tiles of 128, products "
          "at width 80)",
    "256": "dkdv_wgmma_hd256, dq_wgmma_hd256 (64-row blocks, the outputs "
           "split between the consumer warpgroups)"}
# the ragged MoE's training: qwen3-moe-30b-a3b at full width, dispatch
# "ragged", cut to MOE_TRAIN_LAYERS of 48 layers, remat "full", AdamW, on
# TRAIN_BATCH x TRAIN_S tokens, 1 warm and MOE_TRAIN_STEPS timed steps.
# Per layer and step gmm runs 6 times (wi, wg, wo: forward and the remat
# recompute), gmm_dx and gmm_dw 3 times each.
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = 2, 3
MOE_GMM_PER_LAYER, MOE_DX_PER_LAYER, MOE_DW_PER_LAYER = 6, 3, 3
# a sanity band, not a reference: with random weights the first loss is
# ln(vocab) plus about half the logits' variance (qwen3-4b's 16 layers read
# 0.48 above ln 151936, these 2 MoE layers 0.64 above)
MOE_TRAIN_LOSS0_BAND = 1.0
# the general kernels (gmm_simt.cu: the fp32 gmm family; flash_simt.cu,
# flash_simt_bwd.cu: every flash call the wgmma kernels do not take), in
# plain fp32 FMA; gmm_any.cu's bf16 / fp16 rows are held here too.
# Their bound counts fp32 operations at the card's rate outside the tensor
# cores (bf16 and fp16 ones at the tensor cores' bf16 rate).  Tolerances
# against the fp32 plain versions (TF32 off): SIMT_GMM_TOL + SIMT_GMM_TOL
# |plain| for the grouped matmul family, SIMT_FLASH_TOL likewise for flash
# attention (sums of up to thousands of fp32 products in another order);
# a bf16 output within ATOL + RTOL |plain| as the wgmma kernels
PEAK_FP32_FLOPS = 67e12      # H100 SXM fp32 rate outside the tensor cores
PEAK_TF32_FLOPS = 494.7e12   # H100 SXM dense TF32 tensor-core rate
SIMT_GMM_TOL, SIMT_FLASH_TOL = 1e-5, 1e-4
# the grouped matmul family's tolerance by output dtype (fp16: two fp16
# rounding steps, as tests/test_torch_cuda_kernels.py's SIMT_TOL)
GMM_TOL = {"float32": SIMT_GMM_TOL, "bfloat16": ATOL, "float16": 2.0 ** -10}
# the grouped matmul family at the reference MoE demo's fp32 call (4
# experts x 16 rows in 8-row tiles, d 64, f 32) and at qwen3-moe-30b-a3b's
# width in 8-row tiles (128 experts x 64 rows, d 2048, f 768): (E, rows, d,
# f, block_rows)
SIMT_GMM_SHAPES = {"demo": (4, 16, 64, 32, 8),
                   "qwen3_moe": (128, 64, 2048, 768, 8)}
# bf16 and fp16 whose rows TMA cannot describe (f not a multiple of 8; a
# base 2 bytes off 16): gmm_any.cu's thread loader (route "wgmma_ld"), 16
# experts at qwen3-moe's depth; (E, rows, d, f, block_rows, offset of x and
# dY in elements)
SIMT_GMM_OFF8 = {"f764": (16, 64, 2048, 764, 8, 0),
                 "f768_off2": (16, 64, 2048, 768, 8, 1)}
# the fp32 flash forward, dense and causal at each head dim's model shape
# (granite-moe-1b-a400m 16 / 8 heads, stablelm-3b 32 / 32, qwen3-4b 32 / 8,
# recurrentgemma-2b 10 / 1 with its window of 2048): (b, s, h, kvh, hd,
# window); ragged at the main path's lanes in a fac2 plan; the backward at
# qwen3-4b's training shape
SIMT_DENSE_SHAPES = {"64": (1, 4096, 16, 8, 64, 0),
                     "80": (1, 4096, 32, 32, 80, 0),
                     "128": (1, 4096, 32, 8, 128, 0),
                     "256": (1, 4096, 10, 1, 256, 2048)}
SIMT_BWD_SHAPE = (2, 4096, 32, 8, 128)
# the fp32 model path: qwen3-4b and qwen3-moe-30b-a3b (ragged) at full
# width, FP32_MODEL_LAYERS layers, compute_dtype "float32", one loss and
# gradient on TRAIN_BATCH x TRAIN_S tokens (above flash_threshold)
FP32_MODEL_LAYERS = 2
# gmm_digest() of the fp32 grouped matmul family as the first general
# kernel computed it (one 8-row tile a step, on an H100): the SGEMM keeps
# every bit
PARENT_GMM_DIGEST = "136d16b43e67d0d8"
# bf16 / fp16 off gmm.cu's blocks (gmm_any.cu), launches of the off-block
# path: grouped_matmul at block_rows 8 in bf16 and fp16 (TMA) and at f 764
# in bf16 (thread loader), the backward at 64 rows an expert in bf16 (dW on
# gmm.cu's gmm_dw), fp16 (TMA) and at f 764 (thread loader)
OFF_BLOCK_LAUNCHES = {"gmm_any": 3, "gmm_dx_any": 3, "gmm_dw_any": 2,
                      "gmm_dw": 1}
# the fp32 flash kernels on the tensor cores (route "tf32x3": flash_f32.cu,
# flash_f32_bwd.cu; each product three TF32 products) at SIMT_DENSE_SHAPES'
# head dims 64, 80 and 128, at the main path's lanes (flash_sched_f32), at
# SIMT_BWD_SHAPE and at recurrentgemma-2b's hd-256 backward
# (flash_f32_bwd256_*), held to the fp32 plain versions at SIMT_FLASH_TOL
# with the general kernels on the same tensors
TF32X3_HEAD_DIMS = ("64", "80", "128")
# the fp32 model path's flash launches: qwen3-4b's and qwen3-moe's 2 layers
# each run the dense forward twice (remat "full") and the backward once,
# on the tensor cores, and so do the scheduled call and the hd-256
# attention, forward and backward (cluster pairs); the general kernels'
# delta pass serves every fp32 backward (no general dense, dkdv or dq
# pass); the fp32 grouped matmul family must launch too
FP32_PATH_LAUNCHES = {"flash_dense_f32": 8, "flash_f32_bwd_dkdv": 4,
                      "flash_f32_bwd_dq": 4, "flash_sched_f32": 1,
                      "flash_dense_simt": 0, "flash_dense_f32_256": 1,
                      "flash_simt_bwd_delta": 5,
                      "flash_simt_bwd_dkdv": 0, "flash_simt_bwd_dq": 0,
                      "flash_f32_bwd256_dkdv": 1, "flash_f32_bwd256_dq": 1}
# the dry run's cells on the card's machine: (arch, shape, multi_pod,
# variant, layers at full width or None for all), on meta shards over the
# fake group; the train cells cut in depth to keep the phase near a minute
# (DTensor's strategy search on the 512-rank mesh's three axes costs some
# 30 s of host time a new op shape, whatever the depth)
DRYRUN_META_CELLS = (("qwen3-4b", "train_4k", False, "baseline", 8),
                     ("qwen3-4b", "prefill_32k", False, "baseline", None),
                     ("qwen3-4b", "decode_32k", False, "baseline", None),
                     ("qwen3-moe-30b-a3b", "train_4k", True, "ragged", 2))
# the card-resident cell's depth (qwen3-4b train_4k, rank 0 of 16 x 16)
# and its launches: 8 layers x 4 microbatches, flash_dense in the forward
# and the remat recompute, each flash_dense_bwd pass once
DRYRUN_CARD_LAYERS = 8
DRYRUN_CARD_LAUNCHES = {"flash_dense": 64, **{n: 32 for n in BWD_KERNELS}}
# what the tensor-core flash kernels leave to the general ones, counted
# on a path of its own: the schedule-aware fp32 call at recurrentgemma-2b's
# local attention (hd 256; ragged lanes, fac2) on the general kernel, and a
# dense fp32 call there, forward and backward, on q, k, v views whose head
# stride (hd + 2 floats) TMA cannot describe: copied to TMA's layout
# (tma_pack, once forward and once backward), then the cluster pairs'
# kernels (and the general delta pass every fp32 backward runs); no
# general dense, dkdv or dq pass
GENERAL_PATH_LAUNCHES = {"flash_sched_simt": 1, "tma_pack": 2,
                         "flash_dense_f32_256": 1,
                         "flash_simt_bwd_delta": 1,
                         "flash_f32_bwd256_dkdv": 1,
                         "flash_f32_bwd256_dq": 1, "flash_dense_simt": 0,
                         "flash_simt_bwd_dkdv": 0, "flash_simt_bwd_dq": 0}
# packed_sweep(): the dense entry on views TMA cannot describe at every
# head dim 1-256 in each dtype, (b, s, h, kvh), causal, the window of
# each case cycling through these
PACKED_SWEEP_SHAPE = (1, 70, 4, 2)
PACKED_SWEEP_WINDOWS = (0, 17, 0, 64)
# --flash16-times' bf16 row at an odd head dim (copied to hd 104):
# qwen3-4b's prefill heads, (b, s, h, kvh, hd)
PACKED_BF16_SHAPE = (1, 4096, 32, 8, 100)
FP32_PATH_GMM = ("gmm_simt", "gmm_dx_simt", "gmm_dw_simt")
# flash32_digest(): (b, s, h, kvh, hd, window, causal) of the fp32 dense
# kernels' outputs hashed for later trees to hold bit for bit
FLASH32_DIGEST_SHAPES = ((1, 1000, 8, 2, 128, 0, True),
                         (2, 700, 4, 4, 80, 100, True),
                         (1, 600, 4, 1, 64, 0, False))
# flash32_digest() as PR 27's kernels computed it (on an H100); later trees
# hold it bit for bit
PARENT_FLASH32_DIGEST = "ef94b919e827c1f1"
# flash32_digests()' three more, each under a name of its own: the hd-256
# windowed backward (b, s, h, kvh, hd, window; causal) fed the general
# forward's output and lse (``flash32_bwd256_digest``, held to the bits
# the cluster-pair backward first computed on an H100,
# PARENT_FLASH32_BWD256_DIGEST), the hd-256 forward on
# the tree's own route and that backward on its output and lse
# (``flash32_256_digest``), and the ragged schedule-aware forward (b, s,
# h, kvh, hd, sched_p; kv_lens from numpy seed 28, one lane of length 0,
# causal, fac2)
FLASH32_BWD256_DIGEST_SHAPE = (1, 1100, 10, 1, 256, 300)
PARENT_FLASH32_BWD256_DIGEST = "fefc47f2ed3e1d1f"
FLASH32_SCHED_DIGEST_SHAPE = (3, 1000, 8, 2, 128, 7)
# bwd_digest(): the bf16 backward, (b, s, h, kvh, hd, window), causal
BWD_DIGEST_SHAPES = ((2, 1100, 32, 8, 128, 0), (1, 1300, 10, 1, 256, 300))
# flash16_digest(): the fp16 dense forward and backward on the tensor
# cores, (b, s, h, kvh, hd, window, causal)
FLASH16_DIGEST_SHAPES = ((1, 1000, 8, 2, 128, 0, True),
                         (2, 700, 4, 4, 80, 100, True),
                         (1, 600, 4, 1, 64, 0, False),
                         (1, 1100, 10, 1, 256, 300, True))
# fp16 flash, counted as the fp16 path and timed against SDPA in fp16:
# dense at qwen3-4b's prefill, the backward at SIMT_BWD_SHAPE and the
# schedule-aware entry at the main path's lanes on the fp16 instantiations
# of flash_dense.cu, flash_dense_bwd.cu and flash_sched.cu (the general
# kernels, flash_simt.cu and flash_simt_bwd.cu, beside them on the same
# tensors); the fp16 gate 2^-10 + 2^-10 |plain| (two fp16 rounding steps)
# against the fp32 plain versions
FP16_FLASH_TOL = 2.0 ** -10
FP16_PATH_LAUNCHES = {"flash_dense": 1, "flash_sched": 1,
                      "flash_sched_simt": 0,
                      "flash_dense_bwd_delta": 1, "flash_dense_bwd_dkdv": 1,
                      "flash_dense_bwd_dq": 1}
# flash16_sched_digest(): the fp16 schedule-aware forward, (b, s, h, kvh,
# hd, window, block, sched_p; kv_lens from numpy seed 16, causal, fac2)
FLASH16_SCHED_DIGEST_SHAPES = ((3, 1000, 8, 2, 128, 0, 128, 7),
                               (2, 700, 4, 1, 64, 100, 64, 7),
                               (2, 600, 4, 2, 80, 0, 512, 5),
                               (2, 1100, 10, 1, 256, 300, 128, 7))
# the examples phase: the seven twins of examples/, each in its own process
# at its default arguments (their printed lines are held against the
# originals' on the CPU by tests/test_torch_examples_*.py)
EXAMPLES = ("torch_cluster_demo", "torch_quickstart",
            "torch_custom_technique", "torch_serve_demo",
            "torch_moe_balance_demo", "torch_train_100m",
            "torch_elastic_restart")
EXAMPLES_TOGETHER = ("torch_cluster_demo", "torch_quickstart",
                     "torch_custom_technique")
EXAMPLE_TIMEOUT_S = 300
# the archs phase: the four archs no other phase runs, in this order, at
# full width (random fp32 weights from seed 0, bf16 compute); each at all
# of its layers unless its fp32 tree and the serving engine's bf16 copy of
# the matmul weights would leave less than ARCHS_FREE_BYTES of the card
# free; ARCHS_SERVE_ROWS requests on that many slots at ARCHS_SERVE_MAX_LEN;
# the backward of ARCHS_BWD_SPLIT also profiled pass by pass
ARCHS_RUN = ("internvl2-1b", "musicgen-medium", "codeqwen1.5-7b",
             "granite-20b")
ARCHS_FREE_BYTES = 8e9
ARCHS_SERVE_ROWS, ARCHS_SERVE_MAX_LEN = 4, 128
ARCHS_BWD_SPLIT = "granite-20b"


T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One phase's JSON line, with the script's elapsed seconds ``t``."""
    print(json.dumps({"phase": phase, "t": time.perf_counter() - T0,
                      **fields}), flush=True)


def check_close(name, got, want):
    """Max abs error of a bf16 kernel output; raises outside
    |got - want| <= ATOL + RTOL |want|."""
    diff = (got.float() - want.float()).abs()
    bad = diff > ATOL + RTOL * want.float().abs()
    err = float(diff.max())
    assert not bool(bad.any()), (
        f"{name}: {int(bad.sum())} elements outside tolerance, "
        f"max abs err {err}")
    return err


def cuda_ms(fn, n):
    """Median device time of ``fn`` over ``n`` calls after one warm-up, in
    ms (CUDA events)."""
    import numpy as np
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def cuda_ms_b2b(fn, n):
    """ms per call of ``fn`` launched ``n`` times back to back between two
    CUDA events, after one warm-up; the median of 3 rounds.  A call's host
    work overlaps the previous call's kernel, so where the kernel is the
    longer this is near its own time (``cuda_ms`` also counts the host work
    before the launch)."""
    import numpy as np
    import torch
    fn()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        rounds.append(a.elapsed_time(b) / n)
    return float(np.median(rounds))


def bound(flops, nbytes):
    """(bound_ms, bound_by): the larger of operations over the bf16 peak
    and bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def device_profile(fn, top=8, watch=()):
    """Run ``fn`` under ``torch.profiler``: wall ms, the summed device time
    of the kernels, the device's idle share of the wall time, the ``top``
    kernels by device time and, for each substring in ``watch``, the device
    ms and count of the kernels whose name holds it (the profiler's own
    overhead is in the wall time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        kernels.append((us / 1e3, ev.count, ev.key[:90]))
    kernels.sort(reverse=True)
    busy_ms = sum(k[0] for k in kernels)
    out = dict(wall_ms=wall_ms, device_ms=busy_ms,
               idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
               launches=sum(k[1] for k in kernels),
               top=[{"kernel": k[2], "ms": k[0], "count": k[1]}
                    for k in kernels[:top]])
    for sub in watch:
        hit = [k for k in kernels if sub in k[2]]
        out[sub] = {"ms": sum(k[0] for k in hit),
                    "count": sum(k[1] for k in hit)}
    return out


def first_layers(cfg, params, n):
    """``cfg`` cut to its first ``n`` layers, a whole number of
    block-pattern periods, and those layers' parameters (views)."""
    import dataclasses

    import torch
    period = len(cfg.block_pattern)
    assert n % period == 0 and n <= cfg.num_layers, (n, period)
    g = n // period

    def cut(v):
        return v[:g] if torch.is_tensor(v) else {k: cut(x)
                                                  for k, x in v.items()}

    return (dataclasses.replace(cfg, num_layers=n),
            dict(params, groups=tuple(cut(grp) for grp in params["groups"]),
                 remainder=()))


def plain_grouped_matmul(xe, w, *, block_rows, **_):
    """``grouped_matmul``'s identity-order product on the plain version,
    to stand in for it in the model's ragged dispatch."""
    import torch
    from repro_torch.kernels.grouped_matmul import grouped_matmul as gm
    e, r, d = xe.shape
    tiles = r // block_rows
    te = torch.arange(e * tiles, device=xe.device) // tiles
    return gm.grouped_matmul_tiles_plain(
        xe.reshape(e * tiles, block_rows, d), w, te).reshape(e, r, -1)


def logits_agree(name, got, want):
    """(max |difference|, argmax agreement) of two logit tensors; raises
    outside PARITY_MAX_DIFF and PARITY_ARGMAX."""
    diff = float((got - want).abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    assert diff <= PARITY_MAX_DIFF and agree >= PARITY_ARGMAX, (
        name, diff, agree)
    return diff, agree


def decode_parity(dev, cfg, params, tokens):
    """``forward`` against ``decode_step`` fed the same tokens one by one:
    (max |difference|, argmax agreement, seconds of the decode loop, the
    largest |logit| of ``forward``)."""
    import torch
    from repro_torch.models import decode_step, forward, init_decode_state
    s = tokens.shape[1]
    full, _ = forward(params, cfg, tokens)
    state = init_decode_state(cfg, 1, max_len=s, device=dev)
    steps = []
    t0 = time.perf_counter()
    with torch.no_grad():
        for i in range(s):
            step, state = decode_step(params, cfg, state, tokens[:, i:i + 1])
            steps.append(step[0, 0])
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    return (*logits_agree(cfg.name, torch.stack(steps), full[0]), decode_s,
            float(full.abs().max()))


def host_ms(fn, n=REPS):
    """Median host time of ``fn`` over ``n`` single calls after one
    warm-up, in ms (no device synchronisation)."""
    import numpy as np
    fn()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def plan_split_ms(fa, lane_lens, p, dev):
    """The host work of one ``flash_sched`` call at the main path's shape
    (fac2, ``p`` workers), piece by piece: the per-group kv ranges and
    costs, the DLS plan, the descriptors and CTA bounds, and the pinned
    upload of the table (enqueue only)."""
    from repro_torch.core.torch_sched import plan_tiles_for_kernel
    nq = S // 512
    kw = dict(causal=True, window=0, kv_lens=lane_lens)
    lo, hi, costs, lens = fa._kv_ranges(B * H, S, 512, 512, **kw)
    plan = plan_tiles_for_kernel(costs, p=p, technique="fac2")
    desc = fa._descriptors(plan.order, lo, hi, lens, nq)
    bounds = fa.descriptor_bounds(desc, plan)
    return {
        "costs": host_ms(lambda: fa._kv_ranges(B * H, S, 512, 512, **kw)),
        "plan": host_ms(lambda: plan_tiles_for_kernel(costs, p=p,
                                                      technique="fac2")),
        "descriptors": host_ms(lambda: fa.descriptor_bounds(
            fa._descriptors(plan.order, lo, hi, lens, nq), plan)),
        "upload": host_ms(lambda: fa._upload_table(desc, bounds, dev))}


def sched_tiles(desc, bounds, block_q, block_k):
    """(total, most on one CTA): the live 128 x 128 tiles of a causal
    ``flash_sched`` launch without a window, counted from its descriptors
    as ``flash_sched.cu``'s Walk counts them; the CTA with the most sets
    the kernel's time."""
    import numpy as np
    _, qi, kj, first, last, lim = (np.asarray(a, np.int64) for a in desc)
    g0, g1 = np.flatnonzero(first), np.flatnonzero(last)
    qb0 = qi[g0] * block_q
    qb1 = np.minimum(qb0 + block_q, S)
    c_lo = kj[g0] * block_k
    c_end = np.minimum(np.minimum((kj[g1] + 1) * block_k, S), lim[g0])
    per_group = np.zeros(g0.size, np.int64)
    for row0 in range(0, block_q, 128):
        row0 = qb0 + row0
        hi = np.minimum(c_end, np.minimum(row0 + 128, qb1))
        n = (hi - 1 - c_lo) // 128 + 1
        per_group += np.where((row0 < qb1) & (hi > c_lo), n, 0)
    cta = np.searchsorted(np.asarray(bounds), g0, side="right") - 1
    per_cta = np.bincount(cta, per_group, minlength=len(bounds) - 1)
    return int(per_group.sum()), int(per_cta.max())


def dense_digest(dev):
    """sha256 (16 hex digits) of ``flash_dense``'s bf16 outputs at the
    prefill's shape (causal) and at a small windowed head_dim-64 shape, on
    inputs from a generator of their own (seed 1234), so that two builds
    of the kernel can be held bit for bit against each other."""
    import hashlib

    import torch
    from repro_torch.kernels.flash_attention import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(1234)
    h = hashlib.sha256()
    for b, s, h_, kvh, hd, win in ((1, PREFILL_S, 32, 8, 128, 0),
                                   (1, 1000, 4, 1, 64, 200)):
        q, k, v = (torch.randn(b, s, n, hd, generator=gen, device=dev)
                   .to(torch.bfloat16) for n in (h_, kvh, kvh))
        out = fa._flash_dense_cuda(q, k, v, causal=True, window=win)
        h.update(out.view(torch.int16).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def dense_kernel_ms(q, k, v, window):
    """``flash_dense``'s kernel alone, causal: (ms of single calls, ms back
    to back)."""
    from repro_torch.kernels.flash_attention import flash_attention as fa

    def kernel():
        return fa._flash_dense_cuda(q, k, v, causal=True, window=window)

    return cuda_ms(kernel, REPS), cuda_ms_b2b(kernel, REPS)


def window_mask(s, window, dev):
    """The (s, s) boolean mask of causal attention within ``window``."""
    import torch
    i = torch.arange(s, device=dev)
    return (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)


def ragged_mask(kv_lens, dev):
    """The (B, 1, S, S) boolean mask of causal attention over each lane's
    first ``kv_lens`` columns."""
    import torch
    i = torch.arange(S, device=dev)
    return (i[None, :] <= i[:, None])[None, None] & (
        i[None, None, None, :] < torch.as_tensor(
            kv_lens, device=dev)[:, None, None, None])


def sdpa_fn(q, k, v, window, mask=None):
    """``scaled_dot_product_attention`` on (b, s, h|kvh, hd) q, k, v in its
    (b, h, s, hd) layout, KV heads repeated, causal (the ``window`` as a
    boolean mask when > 0, or the (b, 1, s, s) boolean ``mask`` given): a
    yardstick the port never calls.  Returns a function of no arguments."""
    import torch
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt = q.permute(0, 2, 1, 3)
    kt, vt = (x.permute(0, 2, 1, 3).repeat_interleave(
        q.shape[2] // k.shape[2], dim=1) for x in (k, v))
    if mask is None and window > 0:
        mask = window_mask(q.shape[1], window, q.device)
    if mask is None:
        return lambda: sdpa(qt, kt, vt, is_causal=True)
    return lambda: sdpa(qt, kt, vt, attn_mask=mask)


def sdpa_grad_fns(q, k, v, do, window):
    """SDPA's backward and forward + backward on (b, s, h|kvh, hd) q, k, v
    and the output gradient do (``enable_gqa``; causal, the ``window`` as a
    boolean mask when > 0): a yardstick the port never calls.  Returns two
    functions of no arguments: the backward through one retained graph,
    and forward + backward."""
    import torch
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.permute(0, 2, 1, 3).detach().requires_grad_(True)
                  for x in (q, k, v))
    dot = do.permute(0, 2, 1, 3)
    mask_kw = ({"attn_mask": window_mask(q.shape[1], window, q.device)}
               if window > 0 else {"is_causal": True})
    with torch.enable_grad():
        graph = sdpa(qt, kt, vt, enable_gqa=True, **mask_kw)

    def backward():
        return torch.autograd.grad(graph, (qt, kt, vt), dot,
                                   retain_graph=True)

    def fwd_bwd():
        with torch.enable_grad():
            o = sdpa(qt, kt, vt, enable_gqa=True, **mask_kw)
            return torch.autograd.grad(o, (qt, kt, vt), dot)

    return backward, fwd_bwd


def dense_full_shape(randn, plain, b, s, h, kvh, hd, window):
    """``flash_dense`` at one full (b, s, h, kvh, hd, window) shape, causal:
    the kernel against its plain version, its times (single calls and back
    to back), the plain version's, ``scaled_dot_product_attention``'s with
    the same mask (a yardstick: the port never calls it) and the bound from
    the live (row, column) pairs.  Returns (fields, the kernel's output)."""
    import torch
    from repro_torch.kernels.flash_attention.ops import flash_attention
    q, k, v = randn(b, s, h, hd), randn(b, s, kvh, hd), randn(b, s, kvh, hd)
    out = flash_attention(q, k, v, causal=True, window=window)
    err = check_close(f"flash_dense hd {hd}", out, plain(q, k, v, True,
                                                          window))
    ms, ms_b2b = dense_kernel_ms(q, k, v, window)
    call_ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True,
                                              window=window), REPS)
    plain_ms = cuda_ms(lambda: plain(q, k, v, True, window), 3)
    run_sdpa = sdpa_fn(q, k, v, window)
    library_ms = cuda_ms(run_sdpa, REPS)
    library_ms_b2b = cuda_ms_b2b(run_sdpa, REPS)
    sdpa_err = float((run_sdpa().permute(0, 2, 1, 3).float()
                      - out.float()).abs().max())
    # live (row, col) pairs: row r sees min(r + 1, window) columns
    rows = torch.arange(1, s + 1, dtype=torch.float64)
    pairs = int((torch.minimum(rows, torch.tensor(float(window)))
                 if window > 0 else rows).sum())
    flops = 4 * hd * b * h * pairs
    nbytes = 2 * (2 * b * s * h * hd + 2 * b * s * kvh * hd)
    bound_ms, bound_by = bound(flops, nbytes)
    return dict(shape=[b, s, h, kvh, hd], window=window, max_abs_err=err,
                ms=ms, ms_b2b=ms_b2b, call_ms=call_ms, plain_ms=plain_ms,
                library_ms=library_ms, library_ms_b2b=library_ms_b2b,
                bound_ms=bound_ms, bound_by=bound_by,
                bound_ms_fp32_pv=bound(flops * 3 // 2, nbytes)[0],
                sdpa_max_abs_diff=sdpa_err, flops=flops, bytes=nbytes), out


def sched_full_shape(dev, randn, hd, kv_lens, n_sm):
    """``flash_sched`` at the main path's ragged lanes (B x S, causal, fac2,
    sched_p = SM count) at head dim ``hd`` with 32 / SCHED_WIDE_KVH heads:
    the kernel against its plain version, bit-identity with static at
    sched_p 8, its times (single calls and back to back), the plain
    version's, ``scaled_dot_product_attention``'s with the same boolean
    mask (a yardstick) and the bound from the live (row, column) pairs."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ops import flash_attention
    kvh = SCHED_WIDE_KVH
    q, k, v = randn(B, S, H, hd), randn(B, S, kvh, hd), randn(B, S, kvh, hd)
    out = flash_attention(q, k, v, causal=True, schedule="fac2",
                          kv_lens=kv_lens, sched_p=n_sm)
    assert torch.equal(out, flash_attention(
        q, k, v, causal=True, schedule="static", kv_lens=kv_lens,
        sched_p=8)), f"flash_sched hd {hd}: static at p 8 differs"
    qf, kf, vf = fa.broadcast_flatten(q, k, v)
    lane_lens = np.repeat(kv_lens, H)

    def plain():
        return fa.flash_attention_sched_plain(qf, kf, vf, kv_lens=lane_lens,
                                              causal=True)

    err = check_close(f"flash_sched hd {hd}", out,
                      plain().reshape(B, H, S, hd).permute(0, 2, 1, 3))
    plain_ms = cuda_ms(plain, 3)
    del qf, kf, vf
    desc, plan = fa._plan_kv_descriptors(
        B * H, S, 512, 512, causal=True, window=0, kv_lens=lane_lens,
        schedule="fac2", p=n_sm)
    bounds = fa.descriptor_bounds(desc, plan)

    def kernel():
        return fa._flash_sched_cuda(q, k, v, desc, bounds, block_q=512,
                                    block_k=512, causal=True, window=0)

    library_ms = cuda_ms(sdpa_fn(q, k, v, 0, mask=ragged_mask(kv_lens, dev)),
                         REPS)
    pairs = sum(H * int(np.minimum(np.arange(1, S + 1), lim).sum())
                for lim in kv_lens)
    flops = 4 * hd * pairs
    nbytes = 2 * (2 * B * S * H * hd
                  + 2 * kvh * hd * int(np.minimum(kv_lens, S).sum()))
    bound_ms, bound_by = bound(flops, nbytes)
    return dict(shape=[B, S, H, kvh, hd], max_abs_err=err,
                ms=cuda_ms(kernel, REPS), ms_b2b=cuda_ms_b2b(kernel, REPS),
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by,
                bound_ms_fp32_pv=bound(flops * 3 // 2, nbytes)[0],
                flops=flops, bytes=nbytes)


def dense_times(dev):
    """``flash_dense``'s ms and ms_b2b at the qwen3-4b prefill's shape, at
    head_dim 64, window 200, and at stablelm-3b's prefill shape (head_dim
    80, with SDPA's ms_b2b beside it), on inputs of a seed of their own."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for key, (b, s, h, kvh, hd, win) in (
            ("hd128", (1, PREFILL_S, 32, 8, 128, 0)),
            ("hd64_w200", (1, PREFILL_S, 32, 8, 64, 200)),
            ("hd80", (1, PREFILL_S, 32, 32, 80, 0))):
        q, k, v = (torch.randn(b, s, n, hd, generator=gen, device=dev)
                   .to(torch.bfloat16) for n in (h, kvh, kvh))
        ms, ms_b2b = dense_kernel_ms(q, k, v, win)
        out[key] = {"ms": ms, "ms_b2b": ms_b2b}
        if hd == 80:
            out[key]["sdpa_ms_b2b"] = cuda_ms_b2b(sdpa_fn(q, k, v, win), REPS)
    return out


def hd80_digest(dev):
    """sha256 (16 hex digits) of ``flash_dense``'s bf16 output and fp32 lse
    and ``flash_dense_bwd``'s dQ, dK and dV at stablelm-3b's attention shape
    (2 x 4096, 32 / 32 heads, head_dim 80, causal), on inputs from a
    generator of their own (seed 80), so that two builds can be held bit
    for bit against each other."""
    import hashlib

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention as fa
    cfg = get_arch(DENSE80_ARCH)
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device=dev).manual_seed(80)
    q, k, v, do = (torch.randn(TRAIN_BATCH, TRAIN_S, n, hd, generator=gen,
                               device=dev).to(torch.bfloat16)
                   for n in (h, kvh, kvh, h))
    out, lse, kw = dense_fwd_res(fa, q, k, v, True, 0)
    grads = fa._flash_dense_bwd_cuda(q, k, v, out, do, lse, causal=True,
                                     window=0, **kw)
    digest = hashlib.sha256()
    for x in (out, lse, *grads):
        digest.update(x.contiguous().view(torch.uint8).cpu().numpy()
                      .tobytes())
    return digest.hexdigest()[:16]


def bwd_digest(dev):
    """sha256 (16 hex digits) of ``flash_dense_bwd``'s bf16 dQ, dK and dV,
    with the forward's output and lse, at each of BWD_DIGEST_SHAPES (causal;
    ragged s; qwen3-4b's 32 / 8 heads at hd 128, a windowed MQA at hd 256),
    on inputs from a generator of their own (seed 129), so that two builds
    can be held bit for bit against each other: ``{"bwd128_digest": ...,
    "bwd256_digest": ...}``."""
    import hashlib

    import torch
    from repro_torch.kernels.flash_attention import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(129)
    out = {}
    for b, s, h, kvh, hd, window in BWD_DIGEST_SHAPES:
        q, k, v, do = (torch.randn(b, s, n, hd, generator=gen, device=dev)
                       .to(torch.bfloat16) for n in (h, kvh, kvh, h))
        o, lse, kw = dense_fwd_res(fa, q, k, v, True, window)
        digest = hashlib.sha256()
        for x in (o, lse, *fa._flash_dense_bwd_cuda(
                q, k, v, o, do, lse, causal=True, window=window, **kw)):
            digest.update(x.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes())
        out[f"bwd{hd}_digest"] = digest.hexdigest()[:16]
    return out


def dense_fwd_res(fa, q, k, v, causal, window):
    """The dense forward of ``fa`` (this tree's module or an older one's)
    with its residuals, as a backward needs them: (out, lse, the
    backward's extra keywords).  Where the forward also returns the
    output's rounding residual o_lo (fp16), the keywords pass it on; older
    trees return (out, lse)."""
    out, lse, *rest = fa._flash_dense_cuda(q, k, v, causal=causal,
                                           window=window, with_lse=True)
    return out, lse, ({"o_lo": rest[0]} if rest and rest[0] is not None
                      else {})


def flash16_digest(dev):
    """sha256 (16 hex digits) of the fp16 dense flash kernels' forward
    output and lse and their backward's dQ, dK and dV at
    FLASH16_DIGEST_SHAPES (hd 64, 80, 128 and 256, ragged s, a window), on
    inputs of a seed of their own (29): two runs must give the same hex."""
    import hashlib

    import torch
    from repro_torch.kernels.flash_attention import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(29)
    digest = hashlib.sha256()
    for b, s, h, kvh, hd, window, causal in FLASH16_DIGEST_SHAPES:
        q, k, v, do = (torch.randn(b, s, n, hd, generator=gen, device=dev)
                       .half() for n in (h, kvh, kvh, h))
        o, lse, kw = dense_fwd_res(fa, q, k, v, causal, window)
        for x in (o, lse, *fa._flash_dense_bwd_cuda(
                q, k, v, o, do, lse, causal=causal, window=window, **kw)):
            digest.update(x.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes())
    return digest.hexdigest()[:16]


def flash16_sched_digest(dev):
    """sha256 (16 hex digits) of the fp16 schedule-aware forward's outputs
    at FLASH16_SCHED_DIGEST_SHAPES (hd 64, 80, 128 and 256, ragged lanes,
    windows, 64- to 512-row blocks; fac2), on inputs of a seed of their own
    (16): two runs must give the same hex."""
    import hashlib

    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention.ops import flash_attention
    gen = torch.Generator(device=dev).manual_seed(16)
    rng = np.random.default_rng(16)
    digest = hashlib.sha256()
    for b, s, h, kvh, hd, win, blk, p in FLASH16_SCHED_DIGEST_SHAPES:
        q, k, v = (torch.randn(b, s, n, hd, generator=gen, device=dev)
                   .half() for n in (h, kvh, kvh))
        out = flash_attention(q, k, v, causal=True, window=win,
                              schedule="fac2", block_q=blk, block_k=blk,
                              kv_lens=rng.integers(1, s + 1, size=b),
                              sched_p=p)
        digest.update(out.view(torch.int16).cpu().numpy().tobytes())
    return digest.hexdigest()[:16]


def sched_digest(dev):
    """sha256 (16 hex digits) of ``flash_sched``'s bf16 outputs at head dims
    64 and 128 on small ragged shapes (GQA, MQA, windows, 64- and 512-row
    blocks, causal and not; fac2, sched_p 7), on inputs from a generator of
    their own (seed 64)."""
    import hashlib

    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention.ops import flash_attention
    gen = torch.Generator(device=dev).manual_seed(64)
    rng = np.random.default_rng(64)
    digest = hashlib.sha256()
    for b, s, h, kvh, hd, win, blk, causal in (
            (2, 1000, 8, 2, 128, 0, 128, True),
            (3, 700, 4, 1, 64, 100, 64, True),
            (2, 2048, 8, 4, 128, 300, 512, True),
            (2, 513, 4, 2, 64, 0, 512, True),
            (2, 600, 4, 2, 128, 0, 128, False)):
        q, k, v = (torch.randn(b, s, n, hd, generator=gen, device=dev)
                   .to(torch.bfloat16) for n in (h, kvh, kvh))
        out = flash_attention(q, k, v, causal=causal, window=win,
                              schedule="fac2", block_q=blk, block_k=blk,
                              kv_lens=rng.integers(1, s + 1, size=b),
                              sched_p=7)
        digest.update(out.view(torch.int16).cpu().numpy().tobytes())
    return digest.hexdigest()[:16]


def bwd_times(dev):
    """``flash_dense_bwd``'s ms_b2b (the three launches of one backward) at
    the train phase's shapes (b 2, s 4096, causal; head dims 128, 64, 80
    and 256 with the configs' heads and windows), on inputs of a seed of
    their own, and SDPA's backward beside it on the same tensors."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for arch in (ARCH, BWD_ARCH_64, *(a for a, _ in BWD_WIDE_ARCHS.values())):
        cfg = get_arch(arch)
        h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        q, k, v, do = (torch.randn(TRAIN_BATCH, TRAIN_S, n, hd, generator=gen,
                                   device=dev).to(torch.bfloat16)
                       for n in (h, kvh, kvh, h))
        o, lse, kw = dense_fwd_res(fa, q, k, v, True, cfg.window)
        out[str(hd)] = {"arch": arch, "ms_b2b": cuda_ms_b2b(
            lambda: fa._flash_dense_bwd_cuda(q, k, v, o, do, lse, causal=True,
                                             window=cfg.window, **kw), REPS)}
        out[str(hd)]["sdpa_bwd_ms_b2b"] = cuda_ms_b2b(
            sdpa_grad_fns(q, k, v, do, cfg.window)[0], REPS)
        del q, k, v, do, o, lse, kw
    return out


def yardsticks(dev):
    """Times that decide whether a kernel goes back to the bring_up queue,
    each beside the kernel it measures, on inputs of a seed of their own:

      * ``flash_dense`` at recurrentgemma-2b's shape (1 x 4096, 10 / 1
        heads, hd 256, causal, window 2048) back to back, against
        ``torch.nn.attention.flex_attention`` compiled with that
        sliding-window causal block mask and SDPA with the window as a
        boolean mask (yardsticks only, never on the path; a compile error
        is reported as it is);
      * ``flash_dense_bwd``'s delta pass at qwen3-4b's training shape (2 x
        4096, 32 heads, hd 128) against ``torch.linalg.vecdot(do.float(),
        o.float())``, with its bytes bound (o and dO read, lse read, lse
        log2(e) and D written at the padded rows);
      * ``gmm_dw`` (wi + wg + wo) against ``torch.bmm(x^T, dy)`` at the
        moe_train step's shapes, back to back in turns (kernel, bmm, bmm,
        kernel)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.grouped_matmul import grouped_matmul as gm
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16)

    cfg = get_arch("recurrentgemma-2b")
    h, kvh, hd, win = (cfg.num_heads, cfg.num_kv_heads,
                       cfg.resolved_head_dim, cfg.window)
    q, k, v = rnd(1, PREFILL_S, h, hd), rnd(1, PREFILL_S, kvh, hd), \
        rnd(1, PREFILL_S, kvh, hd)
    flash = fa._flash_dense_cuda(q, k, v, causal=True, window=win)
    row = {"shape": [1, PREFILL_S, h, kvh, hd], "window": win,
           "flash_dense_ms_b2b": dense_kernel_ms(q, k, v, win)[1],
           "sdpa_masked_ms_b2b": cuda_ms_b2b(sdpa_fn(q, k, v, win), REPS)}
    try:
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)

        def sliding_causal(b, hh, qi, ki):
            return (ki <= qi) & (qi - ki < win)

        mask = create_block_mask(sliding_causal, None, None, PREFILL_S,
                                 PREFILL_S, device=dev)
        flex = torch.compile(flex_attention)
        qt, kt, vt = (x.permute(0, 2, 1, 3) for x in (q, k, v))
        t0 = time.perf_counter()
        got = flex(qt, kt, vt, block_mask=mask, enable_gqa=True)
        torch.cuda.synchronize()
        row["flex_compile_s"] = time.perf_counter() - t0
        row["flex_max_abs_diff"] = float(
            (got.permute(0, 2, 1, 3).float() - flash.float()).abs().max())
        row["flex_ms_b2b"] = cuda_ms_b2b(
            lambda: flex(qt, kt, vt, block_mask=mask, enable_gqa=True), REPS)
    except Exception as exc:  # a yardstick: report why it did not run
        row["flex_error"] = f"{type(exc).__name__}: {str(exc)[:300]}"
    out["flash_dense_hd256"] = row
    del q, k, v, flash

    cfg = get_arch(ARCH)
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    b, s = TRAIN_BATCH, TRAIN_S
    o, do = rnd(b, s, h, hd), rnd(b, s, h, hd)
    lse = torch.randn(b, h, s, generator=gen, device=dev)
    s_pad = -(-s // fa.BWD_ROW_PAD) * fa.BWD_ROW_PAD
    lse2, delta = torch.empty((2, b, h, s_pad), dtype=torch.float32,
                              device=dev).unbind(0)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def delta_pass():
        fa.FLASH_DENSE_BWD_DELTA.launch(
            o.data_ptr(), do.data_ptr(), lse.data_ptr(), lse2.data_ptr(),
            delta.data_ptr(), b, s, s_pad, h, hd, stream)

    def vecdot():
        return torch.linalg.vecdot(do.float(), o.float())

    delta_pass()
    err = float((delta[:, :, :s] - vecdot().permute(0, 2, 1)).abs().max())
    nbytes = 2 * o.numel() * 2 + lse.numel() * 4 + 2 * b * h * s_pad * 4
    out["delta_kernel"] = {
        "shape": [b, s, h, hd], "max_abs_diff_vecdot": err,
        "ms_b2b": cuda_ms_b2b(delta_pass, REPS),
        "vecdot_ms_b2b": cuda_ms_b2b(vecdot, REPS), "bytes": nbytes,
        "bound_ms": 1e3 * nbytes / PEAK_BYTES, "bound_by": "bytes"}
    del o, do, lse, lse2, delta

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    mcfg, _ = moe_train_cfg()
    rows = moe_train_rows(mcfg)
    calls = moe_bwd_calls(dev, mcfg, rows)

    def dw_ms():
        return sum(cuda_ms_b2b(lambda xi=xi, w=w, dy=dy: gm.grouped_matmul_bwd(
            xi, w, dy, need_dx=False, sched_p=n_sm), REPS)
            for xi, w, dy in calls)

    def bmm_ms():
        return sum(cuda_ms_b2b(lambda xi=xi, dy=dy: torch.bmm(
            xi.transpose(1, 2), dy), REPS) for xi, _, dy in calls)

    turns = [("gmm_dw", dw_ms), ("bmm", bmm_ms), ("bmm", bmm_ms),
             ("gmm_dw", dw_ms)]
    out["gmm_dw"] = {"rows": rows, "turns_ms_b2b": [
        [name, fn()] for name, fn in turns]}
    return out


def phase_flash_dense(dev, randn):
    """The dense kernel against its plain version at the prefill's shape,
    at the full attention shapes of stablelm-3b (head dim 80, computed at
    128) and recurrentgemma-2b (head dim 256, window 2048) and at small
    ragged ones; times and bounds of each full shape.  Returns the fields
    of its ``kernels`` entry (launches come from the prefills)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention.ops import flash_attention

    plain = plain_attention
    small = {}
    for b, s, h, kvh, hd, win, causal in ((2, 300, 4, 2, 128, 0, True),
                                          (1, 200, 4, 1, 64, 32, True),
                                          (2, 333, 8, 2, 128, 200, True),
                                          (1, 1000, 4, 1, 64, 200, True),
                                          (1, 96, 2, 2, 64, 0, False),
                                          # the padded head dims
                                          (1, 300, 4, 2, 80, 0, True),
                                          (2, 333, 4, 1, 80, 100, True),
                                          (1, 200, 2, 2, 80, 0, False),
                                          (1, 300, 4, 2, 256, 0, True),
                                          (2, 333, 5, 1, 256, 100, True),
                                          (1, 2100, 10, 1, 256, 2048, True),
                                          (1, 129, 2, 1, 256, 1, True),
                                          (1, 200, 2, 2, 256, 0, False)):
        qs, ks, vs = randn(b, s, h, hd), randn(b, s, kvh, hd), \
            randn(b, s, kvh, hd)
        got = flash_attention(qs, ks, vs, causal=causal, window=win)
        key = f"s{s}_h{h}_kv{kvh}_hd{hd}_w{win}" + ("" if causal else "_full")
        small[key] = check_close("flash_dense small", got,
                                 plain(qs, ks, vs, causal, win))

    by_head_dim = {}
    for arch, window in ((ARCH, 0), ("stablelm-3b", 0),
                         ("recurrentgemma-2b", 2048)):
        cfg = get_arch(arch)
        assert cfg.window in (0, window), (arch, cfg.window)
        fields, _ = dense_full_shape(
            randn, plain, 1, PREFILL_S, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, window)
        by_head_dim[str(cfg.resolved_head_dim)] = dict(arch=arch, **fields)
    main = by_head_dim["128"]
    fields = {k: main[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}
    emit("flash_dense", shape=main["shape"], causal=True,
         digest=dense_digest(dev), small_max_abs_err=small,
         ms_b2b=main["ms_b2b"], call_ms=main["call_ms"],
         sdpa_max_abs_diff=main["sdpa_max_abs_diff"], flops=main["flops"],
         bytes=main["bytes"], by_head_dim=by_head_dim, **fields)
    fields["max_abs_err"] = max(r["max_abs_err"] for r in by_head_dim.values())
    fields["by_head_dim"] = {
        hd: {k: r[k] for k in ("arch", "shape", "window", "max_abs_err", "ms",
                               "ms_b2b", "plain_ms", "library_ms", "bound_ms",
                               "bound_by", "bound_ms_fp32_pv")}
        for hd, r in by_head_dim.items()}
    return fields


def phase_prefill(dev, cfg, params, phase="prefill", parity=True):
    """``forward`` of the full model with the counts from 0 (the slice's
    main path), then timing, a device profile and (``parity``) the 2-layer
    comparison of ``forward`` with ``decode_step``.  Returns the launch
    counts."""
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.models import forward

    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, PREFILL_S))).to(dev)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    logits, _ = forward(params, cfg, tokens)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {n: kern.launches for n, kern in _build.KERNELS.items()}
    assert launches["flash_dense"] == cfg.num_layers, launches
    assert tuple(logits.shape) == (1, PREFILL_S, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all()), "prefill logits not finite"
    del logits

    def run():
        forward(params, cfg, tokens)

    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    prof = device_profile(run, watch=("flash_dense",))
    fields = dict(arch=cfg.name, layers=cfg.num_layers, tokens=PREFILL_S,
                  head_dim=cfg.resolved_head_dim, launches=launches,
                  first_s=first_s, warm_s=warm_s,
                  tokens_per_s=PREFILL_S / warm_s, profile=prof)
    if not parity:
        emit(phase, cut="none: full width and depth; random fp32 weights "
             "from seed 0", **fields)
        return launches

    # forward against decode_step on the same tokens, 2 layers
    cfg2, params2 = first_layers(cfg, params, PARITY_LAYERS)
    tok2 = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, PARITY_S))).to(dev)
    before = _build.KERNELS["flash_dense"].launches
    max_diff, agree, decode_s, logit_abs_max = decode_parity(dev, cfg2,
                                                             params2, tok2)
    assert _build.KERNELS["flash_dense"].launches == before + PARITY_LAYERS
    emit(phase, **fields,
         parity={"layers": PARITY_LAYERS, "s": PARITY_S,
                 "max_abs_diff": max_diff, "argmax_agreement": agree,
                 "tolerance": [PARITY_MAX_DIFF, PARITY_ARGMAX],
                 "logit_abs_max": logit_abs_max, "decode_s": decode_s})
    return launches


def phase_serve(dev, cfg, params):
    """DecodeEngine through ``launch.serve``'s code path, bf16 and int8 KV
    caches, then a device profile of a short run."""
    import dataclasses

    import torch

    rows = {}
    for name, c in (("bf16", cfg),
                    ("kv8", dataclasses.replace(cfg, kv_cache_dtype="int8"))):
        rows[name], eng = serve_rows(dev, c, params, SERVE_REQUESTS,
                                     SERVE_SLOTS, SERVE_MAX_LEN)
        assert len(eng.kernel_records) == eng.plan_calls
        rows[name].update(plan_calls=eng.plan_calls,
                          plan_time_s=eng.plan_time_s,
                          plan_cache_hits=eng.plan_cache_hits)
        del eng
        torch.cuda.empty_cache()
    prof = device_profile(lambda: serve_rows(dev, cfg, params, 4,
                                             SERVE_SLOTS, 64, seed=1))
    emit("serve", arch=cfg.name, requests=SERVE_REQUESTS, slots=SERVE_SLOTS,
         max_len=SERVE_MAX_LEN, technique="fac2", profile_4_requests=prof,
         **rows)


def serve_rows(dev, cfg, params, n, slots, max_len, seed=0):
    """``n`` requests drawn as the launcher draws them through
    ``launch.serve``'s ``run_engine`` on ``slots`` slots; raises unless all
    complete with the tokens asked for.  Returns (the engine's numbers, the
    engine)."""
    import numpy as np
    from repro_torch.launch.serve import make_requests, run_engine
    requests = make_requests(n, max_len, seed)
    eng, stats = run_engine(cfg, params, requests, slots=slots,
                            max_len=max_len, technique="fac2", device=dev)
    assert stats.completed == n, (cfg.name, stats)
    for r in requests:
        out = eng.output(r.rid)
        assert len(out) == min(r.max_new_tokens, max_len // 2), r.rid
        assert all(0 <= t < cfg.padded_vocab for t in out), (cfg.name, r.rid)
    return dict(completed=f"{stats.completed}/{n}", steps=stats.steps,
                tokens=stats.tokens, tok_per_s=stats.tok_per_s,
                wall_s=stats.wall_s,
                step_ms_median=float(np.median(stats.step_ms)),
                step_ms_p90=float(np.percentile(stats.step_ms, 90)),
                sample_output=eng.output(0)[:8]), eng


def serve_times(dev):
    """Serving alone, to hold two trees' engines against each other on one
    card: qwen3-4b at full width, greedy, then the MoE model of moe_serve
    (MOE_LAYERS layers, ragged dispatch), greedy and then sampled (seed
    SAMPLED_SEEDS[0]); each SERVE_REQUESTS requests on SERVE_SLOTS slots
    after a 4-request warm-up.  The engine's numbers per run."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import init_decoder
    base = get_arch(MOE_ARCH)
    moe = dataclasses.replace(base, num_layers=MOE_LAYERS, moe=dataclasses.
                              replace(base.moe, dispatch="ragged"))
    out = {}
    for cfg in (get_arch(ARCH), moe):
        params, _ = init_decoder(0, cfg, device=dev)
        serve_rows(dev, cfg, params, 4, SERVE_SLOTS, 64, seed=1)
        out[f"{cfg.name}_greedy"], _ = serve_rows(
            dev, cfg, params, SERVE_REQUESTS, SERVE_SLOTS, SERVE_MAX_LEN)
        if cfg is moe:
            stats, _ = sampled_run(dev, cfg, params, SERVE_REQUESTS,
                                   SERVE_MAX_LEN, SAMPLED_SEEDS[0])
            out[f"{cfg.name}_sampled"] = dict(
                tok_per_s=stats.tok_per_s,
                step_ms_median=float(np.median(stats.step_ms)),
                step_ms_p90=float(np.percentile(stats.step_ms, 90)))
        for row in out.values():
            row.pop("sample_output", None)
        del params
        torch.cuda.empty_cache()
    return out


def gmm_model_shapes(dev, cfg, n_sm, randn):
    """``gmm`` alone at the MoE prefill's expert shapes (the identity tile
    order with one CTA per SM, as ``moe_ragged`` calls it): single-call and
    back-to-back ms of wi + wg + wo, the plain version's and ``torch.bmm``'s
    ms, and the bound of the three calls."""
    import torch
    from repro_torch.kernels.grouped_matmul import grouped_matmul as gm
    from repro_torch.kernels.grouped_matmul.ops import grouped_matmul
    from repro_torch.models.moe import _capacity
    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff
    rows = -(-_capacity(cfg, PREFILL_S) // BLOCK_ROWS) * BLOCK_ROWS
    x, h = randn(e, rows, d), randn(e, rows, f)
    w_in = randn(e, d, f, scale=d ** -0.5)
    w_out = randn(e, f, d, scale=f ** -0.5)
    tiles = e * rows // BLOCK_ROWS
    te = torch.arange(tiles, device=dev) // (rows // BLOCK_ROWS)
    calls = ((x, w_in), (x, w_in), (h, w_out))      # wi, wg, wo
    out = {"ms": 0.0, "ms_b2b": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "flops": 0, "bytes": 0}
    for xi, w in calls:
        def run(xi=xi, w=w):
            return grouped_matmul(xi, w, block_rows=BLOCK_ROWS, sched_p=n_sm)
        out["ms"] += cuda_ms(run, REPS)
        out["ms_b2b"] += cuda_ms_b2b(run, REPS)
        xt = xi.reshape(tiles, BLOCK_ROWS, xi.shape[2])
        out["plain_ms"] += cuda_ms(
            lambda xt=xt, w=w: gm.grouped_matmul_tiles_plain(xt, w, te), 3)
        out["library_ms"] += cuda_ms(lambda xi=xi, w=w: torch.bmm(xi, w),
                                     REPS)
        out["flops"] += 2 * e * rows * xi.shape[2] * w.shape[2]
        out["bytes"] += 2 * (xi.numel() + w.numel() + e * rows * w.shape[2])
    out["bound_ms"], out["bound_by"] = bound(out["flops"], out["bytes"])
    out["shapes"] = {"x": [e, rows, d], "wi_wg": [e, d, f], "wo": [e, f, d]}
    return out


def phase_moe_prefill(dev, n_sm, randn):
    """``forward`` of qwen3-moe-30b-a3b (8 layers, ragged dispatch) with the
    counts from 0, then timing, a profile, bit-identity, the dropped-slot
    share, the kernel-against-plain check of one layer's FFN, the 2-layer
    dense-dispatch comparison and gmm at the model's shapes.  Returns
    (cfg, params, launches, gmm's model-path fields for the kernels line)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.models import decoder, forward, init_decoder
    from repro_torch.models import moe as tmoe

    base = get_arch(MOE_ARCH)
    cfg = dataclasses.replace(
        base, num_layers=MOE_LAYERS,
        moe=dataclasses.replace(base.moe, dispatch="ragged"))
    params, _ = init_decoder(0, cfg, device=dev)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, PREFILL_S))).to(dev)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    logits, aux = forward(params, cfg, tokens)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {n: kern.launches for n, kern in _build.KERNELS.items()}
    assert launches["gmm"] == 3 * cfg.num_layers, launches
    assert launches["flash_dense"] == cfg.num_layers, launches
    assert tuple(logits.shape) == (1, PREFILL_S, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all()), "MoE logits not finite"

    def run():
        forward(params, cfg, tokens)

    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    prof = device_profile(run, top=10, watch=("gmm", "flash_dense"))

    # a second run, bit for bit, recording each layer's FFN input and loads
    cap = tmoe._capacity(cfg, PREFILL_S)
    taps = []
    real_moe = decoder.moe

    def moe_tap(p, c, x):
        out = real_moe(p, c, x)
        taps.append((p, x, out[2]))
        return out

    decoder.moe = moe_tap
    try:
        again, _ = forward(params, cfg, tokens)
    finally:
        decoder.moe = real_moe
    assert torch.equal(again, logits), "two MoE prefills differ"
    del again, logits
    load = torch.stack([t[2] for t in taps])        # (layers, E)
    # one sequence is one token group, so an expert drops load - cap slots
    dropped = float(torch.clamp_min(load - cap, 0).sum()
                    / (cfg.num_layers * PREFILL_S * cfg.moe.top_k))

    # one layer's ragged FFN: gmm against the plain grouped matmul
    ffn0 = {k: v[0] for k, v in params["groups"][0]["ffn"].items()}
    x = randn(1, PREFILL_S, cfg.d_model)
    y = tmoe.moe_ragged(ffn0, cfg, x)[0]
    real_gm = tmoe.grouped_matmul
    tmoe.grouped_matmul = plain_grouped_matmul
    try:
        want = tmoe.moe_ragged(ffn0, cfg, x)[0]
    finally:
        tmoe.grouped_matmul = real_gm
    ffn_err = check_close("moe_ragged", y, want)
    del y, want, x

    # every layer's FFN under both dispatches on the input it had in the
    # run above, at capacity factor E / top_k: the capacity is then the
    # token count, so no expert can overflow, and the router sees one input,
    # so both dispatches route every token alike (equal loads)
    parity_cf = cfg.moe.num_experts / cfg.moe.top_k
    cfg_cf = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=parity_cf))
    assert tmoe._capacity(cfg_cf, PREFILL_S) >= PREFILL_S
    layer_diff, layer_abs = [], []
    for p, x, _ in taps:
        yr, _, load_r = tmoe.moe_ragged(p, cfg_cf, x)
        yd, _, load_d = tmoe.moe_dense(p, cfg_cf, x)
        assert torch.equal(load_r, load_d), "the dispatches routed apart"
        layer_diff.append(float((yr - yd).abs().max()))
        layer_abs.append(float(yd.abs().max()))
    del taps, yr, yd
    assert max(layer_diff) <= PARITY_MAX_DIFF, layer_diff

    # 2 layers end to end, ragged against dense at the same capacity
    # factor (at 8 the random router sent 2219 of 4096 tokens to one
    # expert of the second layer, over its capacity of 2048, and the ragged
    # dispatch dropped them).  The first layer's router sees the same input
    # under both dispatches; the second's sees hidden states that differ by
    # bf16 rounding, and where a token's 8th and 9th experts are that close
    # the two runs pick different experts for it, which moves its logits by
    # far more than a rounding step.  So the difference bound holds the
    # tokens routed alike in every layer, which must be at least
    # MOE_ROUTED_ALIKE of them; the argmax bound holds all tokens.
    cfg2, params2 = first_layers(cfg_cf, params, MOE_PARITY_LAYERS)
    logits2, routes, loads2 = {}, {}, {}
    real_route = tmoe._route

    def route_tap(*args):
        out = real_route(*args)
        routes[dispatch].append(torch.sort(out[0][0], dim=-1).values)
        loads2[dispatch].append(int(out[3].max()))
        return out

    tmoe._route = route_tap
    try:
        for dispatch in ("ragged", "dense"):
            routes[dispatch], loads2[dispatch] = [], []
            c = dataclasses.replace(cfg2, moe=dataclasses.replace(
                cfg2.moe, dispatch=dispatch))
            logits2[dispatch] = forward(params2, c, tokens)[0][0]
    finally:
        tmoe._route = real_route
    same = [(a == b).all(-1) for a, b in zip(routes["ragged"],
                                             routes["dense"])]
    assert bool(same[0].all()), "layer 1 routed differently"
    alike = torch.stack(same).all(0)                         # (s,)
    alike_share = float(alike.float().mean())
    assert alike_share >= MOE_ROUTED_ALIKE, alike_share
    diff_all = float((logits2["ragged"] - logits2["dense"]).abs().max())
    diff, agree = logits_agree("ragged vs dense, tokens routed alike",
                               logits2["ragged"][alike],
                               logits2["dense"][alike])
    agree_all = float((logits2["ragged"].argmax(-1)
                       == logits2["dense"].argmax(-1)).float().mean())
    assert agree_all >= PARITY_ARGMAX, agree_all
    logit_abs_max = float(logits2["dense"].abs().max())
    del logits2, params2
    gmm = gmm_model_shapes(dev, cfg, n_sm, randn)
    emit("moe_prefill", arch=cfg.name, layers=cfg.num_layers,
         cut=f"{cfg.num_layers} of {base.num_layers} layers; random fp32 "
             "weights from seed 0",
         dispatch="ragged", tokens=PREFILL_S, launches=launches,
         first_s=first_s, warm_s=warm_s, tokens_per_s=PREFILL_S / warm_s,
         aux=float(aux), profile=prof, bit_identical=True,
         capacity=cap, dropped_share_cf1_25=dropped,
         ffn_plain_max_abs_err=ffn_err,
         load_max_per_layer=load.max(-1).values.tolist(),
         dispatch_by_layer={"capacity_factor": parity_cf,
                            "max_abs_diff": layer_diff,
                            "ffn_abs_max": layer_abs,
                            "tolerance": PARITY_MAX_DIFF},
         dispatch_parity={"layers": MOE_PARITY_LAYERS,
                          "capacity_factor": parity_cf,
                          "load_max_per_layer": loads2,
                          "tokens_routed_alike": int(alike.sum()),
                          "routed_alike_floor": MOE_ROUTED_ALIKE,
                          "max_abs_diff": diff, "argmax_agreement": agree,
                          "max_abs_diff_all": diff_all,
                          "argmax_agreement_all": agree_all,
                          "logit_abs_max": logit_abs_max,
                          "tolerance": [PARITY_MAX_DIFF, PARITY_ARGMAX]},
         gmm_model_shapes=gmm)
    return cfg, params, launches, gmm


def phase_moe_serve(dev, cfg, params):
    """The MoE model in DecodeEngine: 8 requests on 4 slots; the counts
    from 0 around the run; then a device profile of a short run."""
    from repro_torch.kernels import _build
    _build.reset_launches()
    row, _ = serve_rows(dev, cfg, params, SERVE_REQUESTS, SERVE_SLOTS,
                        SERVE_MAX_LEN)
    launches = {n: kern.launches for n, kern in _build.KERNELS.items()}
    assert launches["gmm"] > 0, launches
    prof = device_profile(lambda: serve_rows(dev, cfg, params, 4, SERVE_SLOTS,
                                             64, seed=1),
                          watch=("gmm",))
    emit("moe_serve", arch=cfg.name, layers=cfg.num_layers, dispatch="ragged",
         requests=SERVE_REQUESTS, slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
         technique="fac2", kv="bf16", launches=launches,
         profile_4_requests=prof, **row)
    return launches


def phase_sample(dev):
    """The sampler (``repro_torch.random``) on the card against the same
    calls on the CPU: ``split`` and ``bits`` bit for bit for SAMPLE_SEEDS,
    ``uniform`` at (4, the vocabulary), the Gumbel noise within
    SAMPLE_GUMBEL_ULPS ulp of max(|g|, 1), and ``categorical`` on CUDA
    logits, from a key on the card and from one on the host, against the
    CPU on the same logits copied over, every token equal; then the
    device time of one decode step's sampling as the engine samples (a
    split on the host and a categorical at SERVE_SLOTS rows of the
    vocabulary)."""
    import numpy as np
    import torch
    from repro_torch import random as trandom
    rng = np.random.default_rng(0)
    worst, compared, equal = 0.0, 0, 0
    for seed in SAMPLE_SEEDS:
        kg, kc = trandom.key(seed, device=dev), trandom.key(seed, device="cpu")
        for num in (2, 3, 7):
            assert torch.equal(trandom.split(kg, num).cpu(),
                               trandom.split(kc, num)), ("split", seed, num)
        for shape in SAMPLE_SHAPES:
            assert torch.equal(trandom.bits(kg, shape).cpu(),
                               trandom.bits(kc, shape)), ("bits", seed, shape)
        shape = (SERVE_SLOTS, SAMPLE_VOCAB)
        assert torch.equal(trandom.uniform(kg, shape).cpu(),
                           trandom.uniform(kc, shape)), ("uniform", seed)
        want = trandom.gumbel(kc, shape).numpy()
        got = trandom.gumbel(kg, shape).cpu().numpy()
        ulp = np.spacing(np.maximum(np.abs(want), 1).astype(np.float32))
        worst = max(worst, float((np.abs(got - want) / ulp).max()))
        logits = torch.from_numpy((3 * rng.standard_normal(
            (SAMPLE_ROWS, SAMPLE_VOCAB))).astype(np.float32))
        tc = trandom.categorical(kc, logits)
        for k in (kg, kc):
            tg = trandom.categorical(k, logits.to(dev)).cpu()
            compared += tc.numel()
            equal += int((tc == tg).sum())
    key = trandom.key(0, device="cpu")
    logits = torch.randn(SERVE_SLOTS, SAMPLE_VOCAB, device=dev)

    def step():
        # as DecodeEngine samples: the key split on the host, drawn here
        return trandom.categorical(trandom.split(key)[1], logits)

    prof = device_profile(step, top=3)
    emit("sample", seeds=list(SAMPLE_SEEDS),
         shapes=[list(x) for x in SAMPLE_SHAPES],
         uniform_shape=[SERVE_SLOTS, SAMPLE_VOCAB], split_bits_equal=True,
         uniform_equal=True, gumbel_max_gap_ulp=worst,
         gumbel_tolerance_ulp=SAMPLE_GUMBEL_ULPS, tokens_compared=compared,
         tokens_equal=equal, step_sample_ms=cuda_ms(step, REPS),
         step_sample_ms_b2b=cuda_ms_b2b(step, REPS),
         step_sample_kernels=prof["launches"],
         step_sample_device_ms=prof["device_ms"])
    assert worst <= SAMPLE_GUMBEL_ULPS, worst
    assert compared == 2 * SAMPLE_ROWS * len(SAMPLE_SEEDS), compared
    assert equal == compared, (equal, compared)


def sampled_run(dev, cfg, params, n, max_len, seed):
    """``DecodeEngine(greedy=False, seed=seed)`` on ``n`` requests drawn as
    the launcher draws them (seed 0), SERVE_SLOTS slots, fac2; raises
    unless all complete with the tokens asked for, in the vocabulary.
    Returns (stats, {rid: tokens})."""
    from repro_torch.launch.serve import make_requests
    from repro_torch.serve.engine import DecodeEngine
    requests = make_requests(n, max_len, 0)
    eng = DecodeEngine(cfg, params, slots=SERVE_SLOTS, max_len=max_len,
                       technique="fac2", greedy=False, seed=seed, device=dev)
    for r in requests:
        eng.submit(r)
    stats = eng.run()
    assert stats.completed == n, (cfg.name, stats)
    outs = {r.rid: eng.output(r.rid) for r in requests}
    for r in requests:
        assert len(outs[r.rid]) == min(r.max_new_tokens, max_len // 2)
        assert all(0 <= t < cfg.padded_vocab for t in outs[r.rid])
    return stats, outs


def phase_moe_serve_sampled(dev, cfg, params):
    """The MoE model of moe_serve saved with ``CheckpointStore``, restored
    with ``shardings=`` onto a (1, 1) CUDA ``DeviceMesh`` (placements from
    ``production_rules``), each leaf held bit for bit to the saved one;
    then sampled serving from the restored leaves: 8 requests on 4 slots
    with the counts from 0 around the run; then a short run (4 requests,
    max_len 64) under a device profile, again with the same seed
    (identical tokens) and with another seed (other tokens).  Returns the
    launch counts."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_host_mesh, production_rules
    from repro_torch.models import init_decoder_axes
    from repro_torch.models.layers import dtype_of
    from repro_torch.serve.engine import prepare_params
    from repro_torch.sharding import param_shardings
    from repro_torch.tree import tree_leaves, tree_map

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    try:
        store = CheckpointStore(str(tmp / "ckpt"), keep=1)
        t0 = time.perf_counter()
        store.save(1, params)
        store.wait()
        save_s = time.perf_counter() - t0
        ckpt_bytes = sum(f.stat().st_size for f in (tmp / "ckpt").rglob("*"))
        dist.init_process_group("nccl", init_method=f"file://{tmp}/pg",
                                rank=0, world_size=1)
        mesh = make_host_mesh()
        assert mesh.shape == (1, 1) and mesh.device_type == dev.type
        shardings = param_shardings(
            production_rules(mesh, dict(cfg.sharding_overrides) or None),
            params, init_decoder_axes(cfg))
        t0 = time.perf_counter()
        restored, _ = store.restore(1, params, shardings=shardings)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        leaves = 0
        for got, want, sh in zip(tree_leaves(restored), tree_leaves(params),
                                 tree_leaves(shardings)):
            assert isinstance(got, DTensor), type(got)
            assert tuple(got.placements) == sh.placements
            assert torch.equal(got.to_local(), want), "restore differs"
            leaves += 1
        # one GPU holds each leaf whole: serve from the local shards
        local = prepare_params(tree_map(lambda t: t.to_local(), restored),
                               dtype_of(cfg.compute_dtype), dev)
        del restored
        _build.reset_launches()
        stats, first = sampled_run(dev, cfg, local, SERVE_REQUESTS,
                                   SERVE_MAX_LEN, SAMPLED_SEEDS[0])
        launches = {n: kern.launches for n, kern in _build.KERNELS.items()}
        assert launches["gmm"] == 3 * cfg.num_layers * stats.steps, (
            launches, stats.steps)
        # determinism on short runs (4 requests, max_len 64): the first
        # profiled, again with its seed, then with the other seed
        short = {}
        prof = device_profile(lambda: short.update(
            first=sampled_run(dev, cfg, local, 4, 64, SAMPLED_SEEDS[0])[1]),
            watch=("gmm",))
        first_short = short["first"]
        again = sampled_run(dev, cfg, local, 4, 64, SAMPLED_SEEDS[0])[1]
        other = sampled_run(dev, cfg, local, 4, 64, SAMPLED_SEEDS[1])[1]
        emit("moe_serve_sampled", arch=cfg.name, layers=cfg.num_layers,
             dispatch="ragged", requests=SERVE_REQUESTS, slots=SERVE_SLOTS,
             max_len=SERVE_MAX_LEN, technique="fac2", seeds=SAMPLED_SEEDS,
             mesh={"shape": list(mesh.shape),
                   "names": list(mesh.mesh_dim_names)},
             checkpoint={"leaves": leaves, "bytes": ckpt_bytes,
                         "save_s": save_s, "restore_s": restore_s,
                         "bit_equal": True},
             launches=launches, completed=f"{stats.completed}/"
             f"{SERVE_REQUESTS}", steps=stats.steps, tokens=stats.tokens,
             tok_per_s=stats.tok_per_s, wall_s=stats.wall_s,
             step_ms_median=float(np.median(stats.step_ms)),
             step_ms_p90=float(np.percentile(stats.step_ms, 90)),
             idle_share=prof["idle_share"], profile_4_requests=prof,
             same_seed_identical=again == first_short,
             other_seed_differs=other != first_short,
             sample_output=first[0][:8])
        assert again == first_short, "the same seed gave other tokens"
        assert other != first_short, "another seed gave the same tokens"
        return launches
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def cluster_run(dev, cfg, params, node, *, replicas, n):
    """``launch.serve.run_cluster`` on the card: ``n`` requests drawn as
    the launcher draws them, node technique ``node`` over ``replicas``
    engines of ``CLUSTER_SLOTS`` slots, thread technique fac2, with the
    counts from 0 around it.  Raises if a request does not complete with
    the tokens asked for, in vocabulary, or if the router's choices differ
    from ``run_cluster``'s on the CPU at ``smoke_config`` of the same arch
    (decode steps depend on neither width nor token values).  Returns (the
    run's numbers, its launch counts)."""
    import numpy as np
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.core.schedule import resolve
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import make_requests, run_cluster
    from repro_torch.models import init_decoder
    from repro_torch.serve.engine import DecodeEngine

    requests = make_requests(n, CLUSTER_MAX_LEN, 0)
    kw = dict(replicas=replicas, slots=CLUSTER_SLOTS,
              max_len=CLUSTER_MAX_LEN)
    spec, node_spec = resolve(CLUSTER_THREAD_TECHNIQUE), resolve(node)
    engines, step_ms = {}, []
    real_run = DecodeEngine.run

    def run(eng, *args, **kwargs):
        # each node chunk's engine run: note the engine and its step times
        stats = real_run(eng, *args, **kwargs)
        engines[id(eng)] = eng
        step_ms.extend(stats.step_ms)
        return stats

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev)
    _build.reset_launches()
    DecodeEngine.run = run
    t0 = time.perf_counter()
    try:
        out = run_cluster(cfg, params, spec, node_spec, requests=requests,
                          device=dev, **kw)
        torch.cuda.synchronize()
    finally:
        DecodeEngine.run = real_run
    wall_s = time.perf_counter() - t0
    launches = {k: kern.launches for k, kern in _build.KERNELS.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    assert out["completed"] == n, (cfg.name, node, out)
    for r in requests:
        outs = [e.output(r.rid) for e in engines.values() if e.output(r.rid)]
        assert len(outs) == 1, (cfg.name, node, r.rid, len(outs))
        assert len(outs[0]) == min(r.max_new_tokens, CLUSTER_MAX_LEN // 2)
        assert all(0 <= t < cfg.padded_vocab for t in outs[0]), r.rid
    del engines

    t0 = time.perf_counter()
    small = smoke_config(cfg)
    small_params, _ = init_decoder(0, small, device="cpu")
    want = run_cluster(small, small_params, spec, node_spec,
                       requests=make_requests(n, CLUSTER_MAX_LEN, 0),
                       device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    for key in ("completed", "tokens", "replica_steps", "replica_requests",
                "node_chunks"):
        assert out[key] == want[key], (cfg.name, node, key, out[key],
                                       want[key])
    return dict(schedule=f"{node_spec}/{spec}", replicas=replicas,
                requests=n, completed=f"{out['completed']}/{n}",
                tokens=out["tokens"], replica_steps=out["replica_steps"],
                replica_requests=out["replica_requests"],
                node_chunks=out["node_chunks"],
                cross_node_cov=out["cross_node_cov"],
                cross_node_pi=out["cross_node_pi"], wall_s=wall_s,
                tokens_per_s=out["tokens"] / wall_s, steps=len(step_ms),
                step_ms_median=float(np.median(step_ms)),
                step_ms_p90=float(np.percentile(step_ms, 90)),
                resident_bytes=resident, peak_bytes=peak,
                router_equals_cpu_smoke=True, cpu_smoke_s=cpu_s), launches


def phase_cluster_dense(dev, cfg, params):
    """The cluster phase's qwen3-4b runs, while that model's weights are on
    the card: 4 replicas under each node technique, then 1 replica on the
    same requests, whose peak memory the 4-replica runs may exceed by less
    than ``CLUSTER_MEMORY_MARGIN``.  Returns the phase's dense fields."""
    runs = {node: cluster_run(dev, cfg, params, node,
                              replicas=CLUSTER_REPLICAS,
                              n=CLUSTER_REQUESTS)[0]
            for node in CLUSTER_NODE_TECHNIQUES}
    one = cluster_run(dev, cfg, params, CLUSTER_NODE_TECHNIQUES[0],
                      replicas=1, n=CLUSTER_REQUESTS)[0]
    over = {node: r["peak_bytes"] - one["peak_bytes"]
            for node, r in runs.items()}
    assert max(over.values()) < CLUSTER_MEMORY_MARGIN, over
    return dict(arch=cfg.name, layers=cfg.num_layers,
                cut="none: full width and depth; random fp32 weights from "
                    "seed 0", runs=runs, one_replica=one,
                peak_over_one_replica_bytes=over,
                memory_margin_bytes=CLUSTER_MEMORY_MARGIN)


def cluster_trials():
    """The 20 golden trial digests through ``repro_torch.trials`` on the
    host, against ``tests/data/pr8_trial_digests.json``, and one
    ``ResilienceConfig()`` trial of the thermal scenario."""
    import dataclasses

    from repro_torch.serve import ResilienceConfig
    from repro_torch.trials import (Scenario, elastic_program,
                                    failure_program, run_trial,
                                    thermal_program)
    # the fault / elasticity sweep the golden digests pin
    # (tests/test_resilience.py)
    scenarios = [
        Scenario(name="kill_recover", traffic="spiky", n=120,
                 num_replicas=3,
                 events=failure_program(kill_at=0.05, replicas=(0,),
                                        recover_at=0.2)),
        Scenario(name="kill_forever", traffic="zipf", n=120, num_replicas=3,
                 events=failure_program(kill_at=0.05, replicas=(0, 1))),
        Scenario(name="scale_up", traffic="bursty", n=120, num_replicas=2,
                 events=elastic_program((0.05, 5))),
        Scenario(name="scale_down", traffic="spiky", n=120, num_replicas=4,
                 events=elastic_program((0.05, 2))),
        Scenario(name="thermal", traffic="diurnal", n=120, num_replicas=3,
                 events=thermal_program(0, times=(0.05, 0.1),
                                        speeds=(2.0, 5.0))),
    ]
    gold = json.loads(GOLDEN_DIGESTS.read_text())
    t0 = time.perf_counter()
    got = {f"{sc.name}|{sp}": run_trial(sc, sp, seed=gold["seed"]).digest()
           for sc in scenarios for sp in gold["schedules"]}
    digests_s = time.perf_counter() - t0
    bad = sorted(k for k in gold["digests"] if got.get(k) != gold[
        "digests"][k])
    assert len(got) == len(gold["digests"]) == 20 and not bad, bad
    thermal = dataclasses.replace(scenarios[-1],
                                  resilience=ResilienceConfig())
    res = run_trial(thermal, "awf_b/fac2", seed=gold["seed"])
    assert res.served_once and res.complete, res
    return dict(golden_digests_equal=len(got), digests_s=digests_s,
                thermal_resilient={
                    "schedule": res.schedule, "seed": res.seed,
                    "served_once": res.served_once,
                    "reclaimed": res.reclaimed,
                    "duplicates": res.duplicates,
                    "quarantines": res.quarantines,
                    "makespan": res.makespan, "p99": res.p99})


def phase_cluster(dev, dense, cfg, params):
    """The cluster phase: the MoE model on 2 replicas (ragged dispatch, so
    ``gmm`` launches; counts from 0 around the run), gmm held against the
    plain grouped matmul on the MoE inputs of one decode step of that run,
    the trial digests, and the line with the qwen3-4b runs of
    ``phase_cluster_dense``.  Returns (the MoE run's launch counts, gmm's
    max abs error at the decode shapes)."""
    import torch
    from repro_torch.models import decoder
    from repro_torch.models import moe as tmoe

    # every layer's MoE input of one decode step on ``dev`` (not of the
    # CPU run the router is held to); the tap launches nothing
    first = MOE_CLUSTER_TAP_STEP * cfg.num_layers
    calls, taps = [0], []
    real_moe = decoder.moe

    def moe_tap(p, c, x):
        if x.device.type == dev.type:
            if first <= calls[0] < first + cfg.num_layers:
                taps.append((p, x.clone()))
            calls[0] += 1
        return real_moe(p, c, x)

    decoder.moe = moe_tap
    try:
        moe, launches = cluster_run(dev, cfg, params,
                                    CLUSTER_NODE_TECHNIQUES[0],
                                    replicas=MOE_CLUSTER_REPLICAS,
                                    n=MOE_CLUSTER_REQUESTS)
    finally:
        decoder.moe = real_moe
    assert launches["gmm"] > 0, launches
    assert len(taps) == cfg.num_layers, (len(taps), calls)

    # the counts are read: the same inputs through moe_ragged with gmm and
    # with the plain grouped matmul in its place
    real_gm, shapes, errs = tmoe.grouped_matmul, set(), []

    def plain(xe, w, **kw):
        shapes.add((tuple(xe.shape), tuple(w.shape)))
        return plain_grouped_matmul(xe, w, **kw)

    for p, x in taps:
        got = tmoe.moe_ragged(p, cfg, x)[0]
        tmoe.grouped_matmul = plain
        try:
            want = tmoe.moe_ragged(p, cfg, x)[0]
        finally:
            tmoe.grouped_matmul = real_gm
        assert bool(torch.isfinite(got).all()), "moe_ragged decode"
        errs.append(check_close("moe_ragged decode", got, want))
    x_shape = list(taps[0][1].shape)
    del taps, got, want
    gmm_decode = dict(step=MOE_CLUSTER_TAP_STEP, layers=cfg.num_layers,
                      x_shape=x_shape,
                      xe_w_shapes=[list(map(list, sh))
                                   for sh in sorted(shapes)],
                      max_abs_err=max(errs),
                      tolerance=f"{ATOL} + {RTOL}*|plain|")
    emit("cluster", dense=dense,
         moe=dict(arch=cfg.name, layers=cfg.num_layers, dispatch=(
             cfg.moe.dispatch), launches=launches, gmm_decode=gmm_decode,
             **moe),
         **cluster_trials())
    return launches, gmm_decode["max_abs_err"]


def phase_recurrent(dev, arch):
    """A full-width, full-depth recurrent model: 4096-token prefill with the
    counts from 0 (recurrentgemma-2b's local attention runs ``flash_dense``
    at head dim 256, once per ``local_attn`` layer), a profile of the warm
    prefill where it launches ``flash_dense`` and of a short prefill,
    forward against decode_step on one block-pattern period, and serving
    with lane reuse.  Returns the prefill's launch counts."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.models import forward, init_decoder

    cfg = get_arch(arch)
    params, _ = init_decoder(0, cfg, device=dev)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (1, PREFILL_S))).to(dev)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    logits, _ = forward(params, cfg, tokens)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {n: kern.launches for n, kern in _build.KERNELS.items()}
    n_attn = sum(kind in ("attn", "local_attn")
                 for kind in cfg.pattern_layers)
    assert launches["flash_dense"] == n_attn, (arch, launches, n_attn)
    assert tuple(logits.shape) == (1, PREFILL_S, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all()), f"{arch} logits not finite"
    del logits
    t0 = time.perf_counter()
    forward(params, cfg, tokens)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    prefill = {"first_s": first_s, "warm_s": warm_s,
               "tokens_per_s": PREFILL_S / warm_s}
    if n_attn:
        prefill["profile"] = device_profile(
            lambda: forward(params, cfg, tokens), top=6,
            watch=("flash_dense",))
    # below flash_threshold every arch's attention is the einsum branch
    short = tokens[:, :RECURRENT_PROFILE_S]
    prof = device_profile(lambda: forward(params, cfg, short), top=6)

    period = len(cfg.block_pattern)
    cfg_p, params_p = first_layers(cfg, params, period)
    ptok = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (1, RECURRENT_PARITY_S))).to(dev)
    diff, agree, decode_s, logit_abs_max = decode_parity(dev, cfg_p,
                                                         params_p, ptok)
    del params_p
    row, _ = serve_rows(dev, cfg, params, RECURRENT_REQUESTS,
                        RECURRENT_SLOTS, SERVE_MAX_LEN)
    emit("recurrent", arch=arch, layers=cfg.num_layers,
         pattern=list(cfg.block_pattern), tokens=PREFILL_S,
         launches=launches, prefill=prefill,
         profile={"tokens": RECURRENT_PROFILE_S, **prof},
         parity={"layers": period, "s": RECURRENT_PARITY_S,
                 "max_abs_diff": diff, "argmax_agreement": agree,
                 "tolerance": [PARITY_MAX_DIFF, PARITY_ARGMAX],
                 "logit_abs_max": logit_abs_max, "decode_s": decode_s},
         serve={"requests": RECURRENT_REQUESTS, "slots": RECURRENT_SLOTS,
                "max_len": SERVE_MAX_LEN, "technique": "fac2", **row})
    del params
    torch.cuda.empty_cache()
    return launches


def _records_agree(name, got, want, rtol):
    """A graph-band result against the host batch engine's: equal chunk
    counts, finish times and t_par within ``rtol`` (0: bit for bit)."""
    import numpy as np
    assert len(got) == len(want), name
    for g, w in zip(got, want):
        rg, rw = g.record, w.record
        assert g.engine_used == "graph", (name, g.engine_used)
        assert rg.n_chunks == rw.n_chunks, (name, rg.n_chunks, rw.n_chunks)
        if rtol == 0:
            assert rg.t_par == rw.t_par, name
            assert np.array_equal(rg.thread_finish, rw.thread_finish), name
        else:
            np.testing.assert_allclose(rg.thread_finish, rw.thread_finish,
                                       rtol=rtol, err_msg=name)
            np.testing.assert_allclose(rg.t_par, rw.t_par, rtol=rtol,
                                       err_msg=name)


def phase_campaign(dev):
    """The port's campaign engine (``graph_sim``) on the card at the paper's
    Table 1 size (``configs/paper_campaign.py``): 352.nab (N = 44,794) on
    miniHPC-Broadwell (p = 20) and miniHPC-KNL (p = 64), the campaign's
    adaptive techniques at every Table 1 chunk parameter, 5 repetitions,
    ``CAMPAIGN_TIMESTEPS`` of Table 1's 1,002 time-steps (so every
    technique's adaptive state carries from instance to instance on the
    card), held against the host batch engine: bit for bit below p = 8
    (not reached here), rtol 1e-9 above, BOLD included (its documented
    log-ulp tolerance is the same rtol).  The simulator is deterministic,
    so both engines fold the repetitions of a config into one lane.  Then
    ``auto_simulate(engine="graph")`` on the card against
    ``engine="batch"`` (the same arms), and ``plan_schedule(backend="graph")``
    on the card against the host plan for every plannable technique."""
    import numpy as np
    import torch
    from repro_torch.configs.paper_campaign import CAMPAIGN
    from repro_torch.core import (REGISTRY, AutoSelector, BatchConfig,
                                  auto_simulate, graph_sim, nab_like,
                                  plan_schedule, simulate_batch)

    app, n_iter, n_steps = CAMPAIGN.applications[0][:3]
    nodes = [nd for nd in CAMPAIGN.nodes if nd.name in (
        "miniHPC-Broadwell", "miniHPC-KNL")]
    techs = [t for t in CAMPAIGN.techniques if REGISTRY[t].meta.adaptive
             or REGISTRY[t].meta.worker_dependent]
    reps = CAMPAIGN.repetitions
    w = nab_like(n=n_iter, seed=0)
    rows = {}
    for node in nodes:
        p = node.cores
        cps = CAMPAIGN.chunk_params(w.n, p)
        cfgs = [BatchConfig(technique=t, workload=w, p=p, chunk_param=cp,
                            seed=r, timesteps=CAMPAIGN_TIMESTEPS)
                for t in techs for cp in cps for r in range(reps)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph = graph_sim.simulate_batch_graph(cfgs, device=dev)
        torch.cuda.synchronize()
        graph_s = time.perf_counter() - t0
        stats = dict(graph_sim.LAST_RUN)
        t0 = time.perf_counter()
        host = simulate_batch(cfgs)
        host_s = time.perf_counter() - t0
        rtol = 0.0 if p < 8 else 1e-9
        for cfg, g, h in zip(cfgs, graph, host):
            assert len(g) == CAMPAIGN_TIMESTEPS, (cfg.technique, len(g))
            _records_agree(f"{cfg.technique},{cfg.chunk_param} p{p}", g, h,
                           rtol)
        t_par = {t: min(sum(r.record.t_par for r in g)
                        for c, g in zip(cfgs, graph) if c.technique == t)
                 for t in techs}
        rows[node.name] = dict(
            p=p, configs=len(cfgs), chunk_params=cps, lanes=stats["lanes"],
            groups=stats["groups"], rounds=stats["rounds"],
            host_syncs=stats["syncs"], graph_wall_s=graph_s,
            host_batch_wall_s=host_s, rtol=rtol, best_sum_t_par=t_par)
        if p == nodes[0].cores:
            # the device's idle share of one technique's group
            af = [c for c in cfgs if c.technique == "af"]
            prof = device_profile(lambda: graph_sim.simulate_batch_graph(
                af, device=dev), top=4)
            rows[node.name]["profile_af"] = dict(
                lanes=graph_sim.LAST_RUN["lanes"],
                rounds=graph_sim.LAST_RUN["rounds"], **prof)

    # the selector over the campaign's techniques: graph against batch
    p = nodes[0].cores
    steps = len(CAMPAIGN.techniques) + 6
    hist = {}
    for engine in ("graph", "batch"):
        sel, h = auto_simulate(
            w, p=p, timesteps=steps, chunk_param=w.n // (4 * p),
            engine=engine, device=dev,
            selector=AutoSelector(CAMPAIGN.techniques,
                                  policy="explore_commit"))
        hist[engine] = (sel, h)
    arms = [x["technique"] for x in hist["graph"][1]]
    assert arms == [x["technique"] for x in hist["batch"][1]], "arms differ"
    np.testing.assert_allclose([x["t_par"] for x in hist["graph"][1]],
                               [x["t_par"] for x in hist["batch"][1]],
                               rtol=1e-9)
    best = str(hist["graph"][0].best)
    assert best == str(hist["batch"][0].best)

    # closed forms on the card against the host plans
    plannable = sorted(REGISTRY.graph_names(plannable=True))
    t0 = time.perf_counter()
    for name in plannable:
        kw = (dict(mu=w.mu, sigma=w.sigma) if REGISTRY[name].meta
              .requires_profiling else {})
        for node in nodes:
            for cp in (1, w.n // (4 * node.cores)):
                got = plan_schedule(f"{name},{cp},backend=graph", w.n,
                                    node.cores, device=dev, **kw)
                want = plan_schedule(name, w.n, node.cores, chunk_param=cp,
                                     **kw)
                assert got.chunks == want.chunks, (name, node.name, cp)
    plan_s = time.perf_counter() - t0
    emit("campaign", application=app, n=w.n, techniques=techs,
         repetitions=reps, timesteps=CAMPAIGN_TIMESTEPS,
         cut=f"time-steps {n_steps:,} -> {CAMPAIGN_TIMESTEPS}",
         nodes=rows,
         auto={"p": p, "steps": steps, "arms": arms, "best": best,
               "same_as_batch": True},
         plans={"techniques": plannable, "p": [nd.cores for nd in nodes],
                "equal_to_host": True, "wall_s": plan_s})


def live_pairs(s, window=0):
    """(row, column) pairs of a causal s x s grid, within ``window`` of the
    diagonal when it is > 0."""
    if window <= 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def bwd_shape(dev, seed, b, s, h, kvh, hd, window=0, split=False):
    """``flash_dense_bwd`` at one full (b, s, h, kvh, hd) causal shape (with
    a sliding ``window`` when > 0): the three kernels against the plain
    backward (``torch.autograd.grad`` through the fp32 plain forward),
    bit-identity of two runs, times of the backward alone and of forward +
    backward (single calls and back to back), the plain backward's, and
    ``scaled_dot_product_attention``'s backward and forward + backward on
    the same tensors (``is_causal``, or the window as a boolean mask;
    ``enable_gqa``; a yardstick the port never calls).  ``split``: also
    each pass's device ms a launch (``split_ms``), from a profile of REPS
    backwards back to back (the profiler may miss the first launches)."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(b, s, n, hd, generator=gen, device=dev)
                   .to(torch.bfloat16) for n in (h, kvh, kvh, h))
    out, lse, kw = dense_fwd_res(fa, q, k, v, True, window)

    def backward():
        return fa._flash_dense_bwd_cuda(q, k, v, out, do, lse, causal=True,
                                        window=window, **kw)

    def fwd_bwd():
        o, l_, kw_ = dense_fwd_res(fa, q, k, v, True, window)
        return fa._flash_dense_bwd_cuda(q, k, v, o, do, l_, causal=True,
                                        window=window, **kw_)

    got, again = backward(), backward()
    identical = all(torch.equal(x, y) for x, y in zip(got, again))
    assert identical, f"flash_dense_bwd hd {hd}: two runs differ"
    want = fa.flash_attention_dense_bwd_plain(q, k, v, do, window=window)
    errors = {}
    for nm, x, y in zip(("dq", "dk", "dv"), got, want):
        top = float(y.abs().max())
        err = float((x.float() - y).abs().max())
        errors[nm] = {"max_abs_err": err, "max_abs_plain": top,
                      "rel": err / top}
        assert err <= BWD_REL_TOL * top, (hd, nm, err, top)
    del got, again, want
    plain_ms = cuda_ms(lambda: fa.flash_attention_dense_bwd_plain(
        q, k, v, do, window=window), 3)
    ms, ms_b2b = cuda_ms(backward, REPS), cuda_ms_b2b(backward, REPS)
    fb_ms, fb_b2b = cuda_ms(fwd_bwd, REPS), cuda_ms_b2b(fwd_bwd, REPS)
    sdpa_bwd, sdpa_fwd_bwd = sdpa_grad_fns(q, k, v, do, window)
    library_ms = cuda_ms(sdpa_bwd, REPS)
    library_fb_ms = cuda_ms(sdpa_fwd_bwd, REPS)
    library_ms_b2b = cuda_ms_b2b(sdpa_bwd, REPS)
    del sdpa_bwd, sdpa_fwd_bwd
    extra = {}
    if split:
        passes = ("delta_kernel", "dkdv_wgmma", "dq_wgmma")
        prof = device_profile(lambda: [backward() for _ in range(REPS)],
                              watch=passes)
        assert all(prof[p]["count"] for p in passes), prof
        extra["split_ms"] = {p: prof[p]["ms"] / prof[p]["count"]
                             for p in passes}
    # the backward's MMA work at the real head dim: 5 products of depth hd
    # per live pair, 2.5x the forward's 2; bytes: q, k, v, o, dO and lse
    # read, dq, dk, dv written
    pairs = live_pairs(s, window)
    flops = 10 * hd * b * h * pairs
    nbytes = 2 * (4 * b * s * h * hd + 4 * b * s * kvh * hd) + 4 * b * h * s
    bound_ms, bound_by = bound(flops, nbytes)
    return dict(shape=[b, s, h, kvh, hd], causal=True, window=window,
                errors=errors,
                max_rel_err=max(r["rel"] for r in errors.values()),
                max_abs_err=max(r["max_abs_err"] for r in errors.values()),
                tolerance=f"{BWD_REL_TOL}*max|plain|", bit_identical=identical,
                ms=ms, ms_b2b=ms_b2b, fwd_bwd_ms=fb_ms,
                fwd_bwd_ms_b2b=fb_b2b, plain_ms=plain_ms,
                library_ms=library_ms, library_ms_b2b=library_ms_b2b,
                library_fwd_bwd_ms=library_fb_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                fwd_bwd_bound_ms=bound(14 * hd * b * h * pairs, nbytes)[0],
                flops=flops, bytes=nbytes, **extra)


def plain_attention(q, k, v, causal=True, window=0):
    """The dense kernel's plain version in the model layout (fp32 masked
    softmax, differentiated by autograd); the train phase swaps it in for
    ``ops.flash_attention``."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    b, s, h, hd = q.shape
    out = fa.flash_attention_dense_plain(*fa.broadcast_flatten(q, k, v),
                                         causal=causal, window=window)
    return out.reshape(b, h, s, hd).permute(0, 2, 1, 3)


def train_batches(cfg, n):
    """``n`` batches of TRAIN_BATCH x TRAIN_S tokens from the port's
    ``DataLoader``, sized as ``launch.train`` sizes its data."""
    from repro_torch.data.pipeline import DataConfig, DataLoader
    loader = DataLoader(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
        global_batch=TRAIN_BATCH, mean_doc_len=min(512.0, TRAIN_S * 1.2)))
    try:
        return [next(loader) for _ in range(n)]
    finally:
        loader.close()


def grads_agree(params, grads_k, grads_p):
    """{leaf path: max |kernel - plain| / max |plain|}; raises where a leaf
    is outside TRAIN_GRAD_TOL of its largest |plain| entry."""
    from repro_torch.tree import tree_flatten_with_path
    rel = {}
    for (path, _), a, b in zip(tree_flatten_with_path(params), grads_k,
                               grads_p):
        top = float(b.abs().max())
        err = float((a - b).abs().max())
        rel["/".join(str(k) for _, k in path)] = err / max(top, 1e-30)
        assert err <= TRAIN_GRAD_TOL * top, (path, err, top)
    return rel


def train_parity(dev, cfg, batch, layers=TRAIN_PARITY_LAYERS, prefix=None):
    """Loss and gradients of the first ``layers`` full-width layers with
    the kernels, then with ``plain_attention`` in place of
    ``ops.flash_attention`` (the check calls the plain version itself);
    ``prefix``: the (b, prefix_len, d_model) embeddings put before the
    tokens."""
    import dataclasses

    import torch
    from repro_torch.kernels import _build
    from repro_torch.models import attention as tattn
    from repro_torch.models import init_decoder
    from repro_torch.train import steps as tsteps

    cfg2 = dataclasses.replace(cfg, num_layers=layers)
    pattern = cfg.block_pattern
    attn_layers = sum(pattern[i % len(pattern)] in ("attn", "local_attn")
                      for i in range(layers))
    params, _ = init_decoder(0, cfg2, device=dev)
    before = {n: kern.launches for n, kern in _build.KERNELS.items()}
    loss_k, _, grads_k = tsteps._grads(params, batch["tokens"],
                                       batch["labels"], prefix, cfg2)
    torch.cuda.synchronize()
    launches = {n: kern.launches - before[n]
                for n, kern in _build.KERNELS.items()}
    assert attn_layers > 0, cfg.name
    for n in BWD_KERNELS:
        assert launches[n] == attn_layers, launches
    real = tattn.flash_attention
    tattn.flash_attention = plain_attention
    try:
        loss_p, _, grads_p = tsteps._grads(params, batch["tokens"],
                                           batch["labels"], prefix, cfg2)
        torch.cuda.synchronize()
    finally:
        tattn.flash_attention = real
    rel = grads_agree(params, grads_k, grads_p)
    loss_diff = abs(float(loss_k) - float(loss_p))
    assert loss_diff <= TRAIN_LOSS_TOL, (float(loss_k), float(loss_p))
    del params, grads_k, grads_p
    torch.cuda.empty_cache()
    return dict(arch=cfg.name, layers=layers, attention_layers=attn_layers,
                loss_kernel=float(loss_k),
                loss_plain=float(loss_p), loss_abs_diff=loss_diff,
                grad_rel_err=rel, max_grad_rel_err=max(rel.values()),
                tolerance={"loss_abs": TRAIN_LOSS_TOL,
                           "grad_rel_to_leaf_max": TRAIN_GRAD_TOL},
                launches=launches)


def train_full(dev, cfg, batches):
    """``make_train_step`` on TRAIN_LAYERS full-width layers, remat "full",
    AdamW: counts from 0, 1 warm step and TRAIN_STEPS timed steps, counts
    read; a device profile of one more step.  Returns (fields, counts)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.models import init_decoder
    from repro_torch.optim.adamw import OptimizerConfig, adamw_init
    from repro_torch.train.steps import make_train_step
    from repro_torch.tree import tree_leaves

    cfgn = dataclasses.replace(cfg, num_layers=TRAIN_LAYERS, remat="full")
    params, _ = init_decoder(0, cfgn, device=dev)
    opt = adamw_init(params)
    # the launcher's schedule: 20 warm-up steps (lr <= 7.5e-5 here)
    step = make_train_step(cfgn, OptimizerConfig(warmup_steps=20,
                                                 total_steps=200))
    feed = [{k: torch.from_numpy(v).to(dev) for k, v in bt.items()
             if not k.startswith("_")} for bt in batches]
    n_params = sum(p.numel() for p in tree_leaves(params))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    losses, times = [], []
    for i in range(1 + TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, feed[i])
        losses.append(float(metrics["loss"]))
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    launches = {n: kern.launches for n, kern in _build.KERNELS.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    steps_run = 1 + TRAIN_STEPS
    per_step = {n: c / steps_run for n, c in launches.items() if c}
    assert per_step.get("flash_dense") == 2 * TRAIN_LAYERS, per_step
    for n in BWD_KERNELS:
        assert per_step.get(n) == TRAIN_LAYERS, per_step
    assert all(math.isfinite(x) for x in losses), losses
    assert abs(losses[0] - math.log(cfg.vocab_size)) <= 0.5, losses[0]
    prof = device_profile(lambda: step(params, opt, feed[-1]), top=10,
                          watch=("flash_dense", "dkdv", "dq_wgmma",
                                 "delta_kernel"))
    step_s = float(np.median(times[1:]))
    tokens = TRAIN_BATCH * TRAIN_S
    del params, opt, feed
    torch.cuda.empty_cache()
    return dict(arch=cfg.name, layers=TRAIN_LAYERS, of_layers=cfg.num_layers,
                params=n_params, tokens_per_step=tokens, remat="full",
                losses=losses, step_s=times, step_s_median=step_s,
                tokens_per_s=tokens / step_s, peak_allocated_gb=peak / 1e9,
                launches=launches, launches_per_step=per_step,
                profile=prof), launches


def train_trainer(dev, tmp):
    """``launch.train`` at its defaults with --steps 12 --checkpoint-every
    4 (smoke config, seq 256: below flash_threshold, so no custom kernel
    runs), then a ``Trainer`` that fails once at step 6, restores step 4's
    checkpoint and replays."""
    import contextlib
    import io

    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import _build
    from repro_torch.launch import train as launch_train
    from repro_torch.optim.adamw import OptimizerConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    before = sum(k.launches for k in _build.KERNELS.values())
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        launch_train.main(["--arch", ARCH, "--steps", "12",
                           "--checkpoint-every", "4", "--ckpt",
                           str(tmp / "launch")])
    launch_s = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    assert lines[-1].endswith("checkpoints=[4, 8, 12]"), lines[-1]

    cfg = smoke_config(get_arch(ARCH))
    fired = []

    def fail(step):
        if step == TRAIN_FAIL_AT and not fired:
            fired.append(step)
            raise RuntimeError("injected failure")

    tr = Trainer(cfg, OptimizerConfig(learning_rate=3e-4, warmup_steps=20,
                                      total_steps=12),
                 TrainerConfig(steps=12, checkpoint_every=4,
                               checkpoint_dir=str(tmp / "trainer"),
                               log_every=100),
                 DataConfig(vocab_size=cfg.vocab_size, seq_len=256,
                            global_batch=8, mean_doc_len=307.2),
                 failure_hook=fail, device=dev)
    with contextlib.redirect_stdout(io.StringIO()):
        hist = tr.run()
    steps = [r["step"] for r in hist]
    assert fired and steps == [*range(TRAIN_FAIL_AT),
                               *range(4, 12)], steps
    first = {r["step"]: r["loss"] for r in hist[:TRAIN_FAIL_AT]}
    replay = {r["step"]: r["loss"] for r in hist[TRAIN_FAIL_AT:]}
    replay_diff = max(abs(first[s] - replay[s]) for s in (4, 5))
    assert replay_diff <= TRAIN_REPLAY_TOL, (first, replay)
    assert tr.store.steps() == [4, 8, 12]
    custom = sum(k.launches for k in _build.KERNELS.values()) - before
    return dict(launch_lines=[lines[0], lines[-1]], launch_s=launch_s,
                custom_kernel_launches=custom,
                note="smoke_config, seq 256 < flash_threshold: no custom "
                     "kernel runs", failure_at=TRAIN_FAIL_AT,
                replayed_steps=[4, 5], replay_max_abs_diff=replay_diff,
                replay_tolerance=TRAIN_REPLAY_TOL,
                losses=[r["loss"] for r in hist],
                checkpoints=tr.store.steps())


def arch_depth(cfg):
    """(layers, cut, memory) of ``cfg`` on the card: all of its layers, or
    the largest depth whose fp32 tree and the serving engine's bf16 copy
    of its matmul weights (reckoned from the parameters' shapes) leave
    ARCHS_FREE_BYTES of what ``torch.cuda.mem_get_info`` finds free."""
    import dataclasses

    import torch
    from repro_torch.models.decoder import decoder_param_specs
    from repro_torch.serve.engine import _MATMUL_WEIGHTS
    from repro_torch.tree import tree_flatten_with_path

    def need(n):
        specs, _ = decoder_param_specs(dataclasses.replace(cfg, num_layers=n))
        fp32 = bf16 = 0
        for path, x in tree_flatten_with_path(specs):
            kind, name = path[-1]
            fp32 += 4 * x.numel()
            if kind == "key" and name in _MATMUL_WEIGHTS:
                bf16 += 2 * x.numel()
        return fp32, bf16

    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    layers = next(n for n in range(cfg.num_layers, 0, -1)
                  if free - sum(need(n)) >= ARCHS_FREE_BYTES)
    fp32, bf16 = need(layers)
    memory = dict(free_gb=free / 1e9, total_gb=total / 1e9,
                  fp32_tree_gb=fp32 / 1e9, bf16_copy_gb=bf16 / 1e9,
                  left_gb=(free - fp32 - bf16) / 1e9,
                  full_depth_gb=sum(need(cfg.num_layers)) / 1e9)
    if layers == cfg.num_layers:
        return layers, "none: full width and depth; random fp32 weights " \
            "from seed 0", memory
    return layers, (
        f"{layers} of {cfg.num_layers} layers at full width: the fp32 tree "
        f"and the serving engine's bf16 copy of all {cfg.num_layers} need "
        f"{memory['full_depth_gb']:.1f} GB of the {free / 1e9:.1f} GB free; "
        f"{layers} is the largest depth that leaves "
        f"{ARCHS_FREE_BYTES / 1e9:.0f} GB free; random fp32 weights from "
        "seed 0"), memory


def arch_run(dev, arch, seed):
    """One arch of the archs phase (module docstring).  Returns (its
    ``dense_full_shape`` and ``bwd_shape`` fields, its prefill's launch
    counts, its 2-layer gradient's)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.models import attention as tattn
    from repro_torch.models import forward, init_decoder

    full = get_arch(arch)
    layers, cut, memory = arch_depth(full)
    cfg = dataclasses.replace(full, num_layers=layers)
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    pre = cfg.prefix_len
    torch.cuda.reset_peak_memory_stats(dev)
    params, _ = init_decoder(0, cfg, device=dev)
    torch.cuda.synchronize()
    memory.update(init_peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                  free_after_init_gb=torch.cuda.mem_get_info()[0] / 1e9)

    # the prefill, the counted path: PREFILL_S positions, the prefix first
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, PREFILL_S - pre))).to(dev)
    prefix = (torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, pre, cfg.d_model), dtype=np.float32)).to(dev) if pre else None)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    logits, _ = forward(params, cfg, tokens, prefix)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {n: kern.launches for n, kern in _build.KERNELS.items()}
    assert {n: c for n, c in launches.items() if c} == {
        "flash_dense": layers}, (arch, launches)
    assert tuple(logits.shape) == (1, PREFILL_S, cfg.padded_vocab), \
        (arch, logits.shape)
    assert bool(torch.isfinite(logits).all()), f"{arch}: logits not finite"
    del logits

    def run():
        forward(params, cfg, tokens, prefix)

    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    prefill = dict(tokens=PREFILL_S - pre, positions=PREFILL_S,
                   launches={n: c for n, c in launches.items() if c},
                   first_s=first_s, warm_s=warm_s,
                   tokens_per_s=PREFILL_S / warm_s,
                   profile=device_profile(run, watch=("flash_dense",)))

    # 2 layers with the kernels against plain attention, same positions
    cfg2, params2 = first_layers(cfg, params, PARITY_LAYERS)
    before = _build.KERNELS["flash_dense"].launches
    got, _ = forward(params2, cfg2, tokens, prefix)
    real = tattn.flash_attention
    tattn.flash_attention = plain_attention
    try:
        want, _ = forward(params2, cfg2, tokens, prefix)
    finally:
        tattn.flash_attention = real
    torch.cuda.synchronize()
    assert _build.KERNELS["flash_dense"].launches == before + PARITY_LAYERS
    max_diff, agree = logits_agree(f"{arch} 2 layers", got, want)
    parity = dict(layers=PARITY_LAYERS, positions=PREFILL_S,
                  max_abs_diff=max_diff, argmax_agreement=agree,
                  tolerance=[PARITY_MAX_DIFF, PARITY_ARGMAX],
                  logit_abs_max=float(want.abs().max()))
    del got, want, params2

    # serving: token prompts, no prefix (as in the reference's engine)
    torch.cuda.reset_peak_memory_stats(dev)
    serve, eng = serve_rows(dev, cfg, params, ARCHS_SERVE_ROWS,
                            ARCHS_SERVE_ROWS, ARCHS_SERVE_MAX_LEN)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    serve.update(requests=ARCHS_SERVE_ROWS, slots=ARCHS_SERVE_ROWS,
                 max_len=ARCHS_SERVE_MAX_LEN, technique="fac2",
                 kv_cache=cfg.kv_cache_dtype, peak_allocated_gb=peak / 1e9,
                 total_less_peak_gb=memory["total_gb"] - peak / 1e9)
    del eng, params, tokens, prefix
    torch.cuda.empty_cache()

    # the gradient of 2 layers at TRAIN_BATCH x TRAIN_S positions
    batch = train_batches(cfg, 1)[0]
    batch = {k: torch.from_numpy(batch[k][:, :TRAIN_S - pre]).to(dev)
             for k in ("tokens", "labels")}
    prefix = (torch.from_numpy(np.random.default_rng(2).standard_normal(
        (TRAIN_BATCH, pre, cfg.d_model), dtype=np.float32)).to(dev)
        if pre else None)
    train = train_parity(dev, cfg, batch, PARITY_LAYERS, prefix)
    del batch, prefix
    torch.cuda.empty_cache()

    # the kernels alone at the arch's attention shape
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16)

    fwd, _ = dense_full_shape(randn, plain_attention, 1, PREFILL_S, h, kvh,
                              hd, 0)
    torch.cuda.empty_cache()
    bwd = bwd_shape(dev, seed, TRAIN_BATCH, TRAIN_S, h, kvh, hd,
                    split=arch == ARCHS_BWD_SPLIT)
    torch.cuda.empty_cache()
    emit("archs", arch=arch, layers=layers, of_layers=full.num_layers,
         cut=cut, heads=[h, kvh, hd], prefix_len=pre,
         memory=memory, prefill=prefill, parity=parity, serve=serve,
         train_parity=train, flash_dense=fwd, flash_dense_bwd=bwd)
    return fwd, bwd, launches, train["launches"]


def phase_archs(dev):
    """The archs phase: ``arch_run`` for each of ARCHS_RUN.  Returns (the
    ``by_arch`` maps of flash_dense's and flash_dense_bwd's kernels
    entries, the prefills' summed launch counts, the 2-layer gradients'
    summed launch counts)."""
    keys = ("shape", "max_abs_err", "ms", "ms_b2b", "plain_ms", "library_ms",
            "library_ms_b2b", "bound_ms", "bound_by")
    fwd, bwd, prefill, train = {}, {}, {}, {}
    for i, arch in enumerate(ARCHS_RUN):
        f, b, pl, tl = arch_run(dev, arch, 31 + i)
        fwd[arch] = {k: f[k] for k in keys}
        bwd[arch] = {k: v for k, v in b.items() if k in (
            *keys, "max_rel_err", "bit_identical", "fwd_bwd_ms",
            "fwd_bwd_ms_b2b", "library_fwd_bwd_ms", "split_ms")}
        for total, counts in ((prefill, pl), (train, tl)):
            for n, c in counts.items():
                total[n] = total.get(n, 0) + c
    return fwd, bwd, prefill, train


def phase_train(dev):
    """The training slice: flash_dense_bwd against its plain version at
    qwen3-4b's and granite-moe-1b-a400m's attention shapes, the 2-layer
    step with the kernels against plain attention, the 16-layer full-width
    run (the counted path), then the Trainer on the card.  Returns the
    fields of the kernels line's flash_dense_bwd entry and the 16-layer
    run's launch counts."""
    import tempfile

    import torch
    from repro_torch.configs import get_arch
    cfg = get_arch(ARCH)
    moe = get_arch(BWD_ARCH_64)
    shapes = {"128": bwd_shape(dev, 11, TRAIN_BATCH, TRAIN_S, cfg.num_heads,
                               cfg.num_kv_heads, cfg.resolved_head_dim),
              "64": bwd_shape(dev, 12, TRAIN_BATCH, TRAIN_S, moe.num_heads,
                              moe.num_kv_heads, moe.resolved_head_dim)}
    shapes["128"]["arch"], shapes["64"]["arch"] = ARCH, BWD_ARCH_64
    wide_parity = {}
    for i, (hd, (arch, layers)) in enumerate(BWD_WIDE_ARCHS.items()):
        wcfg = get_arch(arch)
        shapes[hd] = bwd_shape(dev, 13 + i, TRAIN_BATCH, TRAIN_S,
                               wcfg.num_heads, wcfg.num_kv_heads,
                               wcfg.resolved_head_dim, window=wcfg.window)
        shapes[hd]["arch"] = arch
        torch.cuda.empty_cache()
        wide_parity[arch] = train_parity(dev, wcfg, {
            k: torch.from_numpy(v).to(dev)
            for k, v in train_batches(wcfg, 1)[0].items()
            if k in ("tokens", "labels")}, layers=layers)
    digest = dense_digest(dev)
    assert digest == PARENT_DENSE_DIGEST, (digest, PARENT_DENSE_DIGEST)
    batches = train_batches(cfg, 1 + TRAIN_STEPS)
    parity = train_parity(dev, cfg, {
        k: torch.from_numpy(batches[0][k]).to(dev)
        for k in ("tokens", "labels")})
    full, launches = train_full(dev, cfg, batches)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = train_trainer(dev, Path(tmp))
    emit("train", by_head_dim=shapes, dense_digest=digest,
         dense_digest_parent=PARENT_DENSE_DIGEST, parity=parity,
         parity_by_head_dim=wide_parity, full=full, trainer=trainer,
         cut=f"{TRAIN_LAYERS} of {cfg.num_layers} layers at full width "
             "(fp32 params, grads and two AdamW moments of all 36 need "
             "70.6 GB); random fp32 weights from seed 0")
    main = shapes["128"]
    fields = {k: main[k] for k in ("max_abs_err", "ms", "ms_b2b",
                                   "fwd_bwd_ms", "fwd_bwd_ms_b2b",
                                   "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "library_fwd_bwd_ms")}
    fields["max_rel_err"] = max(r["max_rel_err"] for r in shapes.values())
    fields["by_head_dim"] = {
        hd: {"route": "cuda", "kernels": BWD_KERNELS_BY_HEAD_DIM[hd],
             **{k: r[k] for k in (
                 "arch", "shape", "window", "max_rel_err", "bit_identical",
                 "ms", "ms_b2b", "fwd_bwd_ms", "fwd_bwd_ms_b2b", "plain_ms",
                 "library_ms", "library_fwd_bwd_ms", "bound_ms",
                 "bound_by")}}
        for hd, r in shapes.items()}
    return fields, launches


def moe_train_cfg():
    """qwen3-moe-30b-a3b cut to MOE_TRAIN_LAYERS layers, dispatch "ragged",
    remat "full" (the moe_train phase's model), and its base config."""
    import dataclasses

    from repro_torch.configs import get_arch
    base = get_arch(MOE_ARCH)
    return dataclasses.replace(
        base, num_layers=MOE_TRAIN_LAYERS, remat="full",
        moe=dataclasses.replace(base.moe, dispatch="ragged")), base


def moe_train_rows(cfg):
    """Expert rows of the ragged dispatch at TRAIN_BATCH x TRAIN_S tokens:
    the groups' capacities laid out and padded to BLOCK_ROWS."""
    from repro_torch.models import moe as tmoe
    groups = min(cfg.moe_groups, TRAIN_BATCH)
    while TRAIN_BATCH % groups:
        groups //= 2
    cap = tmoe._capacity(cfg, TRAIN_BATCH // groups * TRAIN_S)
    return -(-groups * cap // BLOCK_ROWS) * BLOCK_ROWS


def moe_bwd_calls(dev, cfg, rows):
    """The MoE step's three backward products (wi, wg, wo) as (x, w, dy) on
    random bf16 inputs from a generator of their own (seed 21)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(21)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(
            torch.bfloat16)

    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff
    x, h = rnd(e, rows, d), rnd(e, rows, f)
    w_in, w_out = rnd(e, d, f, scale=d ** -0.5), rnd(e, f, d, scale=f ** -0.5)
    dy_h, dy_o = rnd(e, rows, f), rnd(e, rows, d)
    return ((x, w_in, dy_h), (x, w_in, dy_h), (h, w_out, dy_o))


def moe_dx_digest(calls, n_sm):
    """sha256 (16 hex digits) of the three dX outputs, so that two builds
    of the MoE backward can be held bit for bit against each other."""
    import hashlib

    import torch
    from repro_torch.kernels.grouped_matmul import grouped_matmul as gm
    h = hashlib.sha256()
    for xi, w, dy in calls:
        dx = gm.grouped_matmul_bwd(xi, w, dy, need_dw=False, sched_p=n_sm)[0]
        h.update(dx.view(torch.int16).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def moe_bwd_times(dev):
    """dX's and dW's ms_b2b (wi + wg + wo) at the moe_train step's shapes and
    the digest of the dX outputs, on ``moe_bwd_calls``' inputs."""
    import torch
    from repro_torch.kernels.grouped_matmul import grouped_matmul as gm
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    cfg, _ = moe_train_cfg()
    rows = moe_train_rows(cfg)
    calls = moe_bwd_calls(dev, cfg, rows)
    out = {"rows": rows, "dx_digest": moe_dx_digest(calls, n_sm)}
    for part, kw in (("dx", {"need_dw": False}), ("dw", {"need_dx": False})):
        out[part] = {"ms_b2b": sum(cuda_ms_b2b(
            lambda xi=xi, w=w, dy=dy: gm.grouped_matmul_bwd(
                xi, w, dy, sched_p=n_sm, **kw), REPS)
            for xi, w, dy in calls)}
    return out


def moe_bwd_kernels(dev, cfg, rows, n_sm):
    """dX (``gmm_dx``) and dW (``gmm_dw``) alone at the MoE step's shapes (E
    experts x ``rows`` rows; wi, wg and wo), on ``moe_bwd_calls``' inputs:
    each against ``grouped_matmul_bwd_plain`` (ATOL + RTOL |plain|), two
    runs bit-identical, ms (single and back to back), the plain version's
    ms, ``torch.bmm``'s for the same products and the bound, summed over
    the three projections; the digest of the dX outputs."""
    import torch
    from repro_torch.kernels.grouped_matmul import grouped_matmul as gm

    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff
    calls = moe_bwd_calls(dev, cfg, rows)
    out = {}
    for part, kw, lib in (
            ("dx", {"need_dw": False},
             lambda xi, w, dy: torch.bmm(dy, w.transpose(1, 2))),
            ("dw", {"need_dx": False},
             lambda xi, w, dy: torch.bmm(xi.transpose(1, 2), dy))):
        r = {"ms": 0.0, "ms_b2b": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
             "library_ms_b2b": 0.0, "max_abs_err": 0.0, "flops": 0,
             "bytes": 0}
        for xi, w, dy in calls:
            def run(xi=xi, w=w, dy=dy, kw=kw):
                got = gm.grouped_matmul_bwd(xi, w, dy, sched_p=n_sm, **kw)
                return got[0] if part == "dx" else got[1]

            got, again = run(), run()
            assert torch.equal(got, again), f"{part}: two runs differ"
            want = gm.grouped_matmul_bwd_plain(xi, w, dy, **kw)
            want = want[0] if part == "dx" else want[1]
            r["max_abs_err"] = max(r["max_abs_err"],
                                   check_close(f"moe {part}", got, want))
            del got, again, want
            r["ms"] += cuda_ms(run, REPS)
            r["ms_b2b"] += cuda_ms_b2b(run, REPS)
            r["plain_ms"] += cuda_ms(
                lambda xi=xi, w=w, dy=dy, kw=kw: gm.grouped_matmul_bwd_plain(
                    xi, w, dy, **kw), 3)
            r["library_ms"] += cuda_ms(
                lambda xi=xi, w=w, dy=dy: lib(xi, w, dy), REPS)
            r["library_ms_b2b"] += cuda_ms_b2b(
                lambda xi=xi, w=w, dy=dy: lib(xi, w, dy), REPS)
            # every row, live or padding, as the kernels compute them: the
            # two operands read once, the product written once
            r["flops"] += 2 * xi.numel() * w.shape[2]
            r["bytes"] += 2 * (xi.numel() + dy.numel() + w.numel())
        r["bound_ms"], r["bound_by"] = bound(r["flops"], r["bytes"])
        r["shapes"] = {"rows": [e, rows], "wi_wg": [e, d, f], "wo": [e, f, d]}
        out[part] = r
    out["dx"]["digest"] = moe_dx_digest(calls, n_sm)
    return out


def phase_moe_train(dev, n_sm):
    """The ragged MoE trains on the card: qwen3-moe-30b-a3b at full width,
    MOE_TRAIN_LAYERS layers, dispatch "ragged", remat "full".  Loss and
    every gradient leaf with the kernels against the same with the plain
    grouped matmul in place of ``_expert_matmul``; counts from 0, then
    1 warm and MOE_TRAIN_STEPS timed AdamW steps, the counts read (per
    layer and step gmm 6, gmm_dx 3, gmm_dw 3, flash_dense 2, each backward
    kernel 1);
    step time, tokens/s, peak memory, a device profile of one more step;
    then the backward kernels alone at the step's shapes.  Returns the
    launch counts and ``moe_bwd_kernels``' fields."""
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.models import init_decoder
    from repro_torch.models import moe as tmoe
    from repro_torch.optim.adamw import OptimizerConfig, adamw_init
    from repro_torch.train import steps as tsteps
    from repro_torch.tree import tree_leaves

    cfg, base = moe_train_cfg()
    params, _ = init_decoder(0, cfg, device=dev)
    n_params = sum(p.numel() for p in tree_leaves(params))
    feed = [{k: torch.from_numpy(v).to(dev) for k, v in bt.items()
             if k in ("tokens", "labels")}
            for bt in train_batches(cfg, 1 + MOE_TRAIN_STEPS)]

    # the kernels' gradients against the plain grouped matmul's
    _build.reset_launches()
    loss_k, _, grads_k = tsteps._grads(params, feed[0]["tokens"],
                                       feed[0]["labels"], None, cfg)
    torch.cuda.synchronize()
    parity_launches = {n: k.launches for n, k in _build.KERNELS.items()
                       if k.launches}
    real = tmoe._expert_matmul
    tmoe._expert_matmul = lambda xe, w: plain_grouped_matmul(
        xe, w, block_rows=BLOCK_ROWS)
    try:
        loss_p, _, grads_p = tsteps._grads(params, feed[0]["tokens"],
                                           feed[0]["labels"], None, cfg)
        torch.cuda.synchronize()
    finally:
        tmoe._expert_matmul = real
    rel = grads_agree(params, grads_k, grads_p)
    loss_diff = abs(float(loss_k) - float(loss_p))
    assert loss_diff <= TRAIN_LOSS_TOL, (float(loss_k), float(loss_p))
    del grads_k, grads_p
    torch.cuda.empty_cache()

    opt = adamw_init(params)
    step = tsteps.make_train_step(cfg, OptimizerConfig(warmup_steps=20,
                                                       total_steps=200))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    losses, times = [], []
    for i in range(1 + MOE_TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, feed[i])
        losses.append(float(metrics["loss"]))
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in _build.KERNELS.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    steps_run = 1 + MOE_TRAIN_STEPS
    per_layer = {n: c / (steps_run * cfg.num_layers)
                 for n, c in launches.items() if c}
    want = {"gmm": MOE_GMM_PER_LAYER, "gmm_dx": MOE_DX_PER_LAYER,
            "gmm_dw": MOE_DW_PER_LAYER,
            "flash_dense": 2, **dict.fromkeys(BWD_KERNELS, 1)}
    assert per_layer == want, per_layer
    assert all(math.isfinite(x) for x in losses), losses
    assert abs(losses[0] - math.log(cfg.vocab_size)) <= MOE_TRAIN_LOSS0_BAND, \
        losses[0]
    prof = device_profile(lambda: step(params, opt, feed[-1]), top=12,
                          watch=("gmm_kernel", "gmm_dx_kernel",
                                 "gmm_dw_kernel",
                                 "flash_dense_kernel", "dkdv", "dq_wgmma",
                                 "delta_kernel"))
    step_s = float(np.median(times[1:]))
    tokens = TRAIN_BATCH * TRAIN_S
    del params, opt, feed
    torch.cuda.empty_cache()

    rows = moe_train_rows(cfg)
    kernels = moe_bwd_kernels(dev, cfg, rows, n_sm)
    emit("moe_train", arch=cfg.name, layers=cfg.num_layers,
         of_layers=base.num_layers, dispatch="ragged", remat="full",
         params=n_params, tokens_per_step=tokens, expert_rows=rows,
         parity={"loss_kernel": float(loss_k), "loss_plain": float(loss_p),
                 "loss_abs_diff": loss_diff, "grad_rel_err": rel,
                 "max_grad_rel_err": max(rel.values()),
                 "tolerance": {"loss_abs": TRAIN_LOSS_TOL,
                               "grad_rel_to_leaf_max": TRAIN_GRAD_TOL},
                 "launches": parity_launches},
         losses=losses, step_s=times, step_s_median=step_s,
         tokens_per_s=tokens / step_s, peak_allocated_gb=peak / 1e9,
         launches=launches, launches_per_layer_step=per_layer,
         profile=prof, kernels=kernels,
         cut=f"{cfg.num_layers} of {base.num_layers} layers at full width "
             "(fp32 params, grads and two AdamW moments: ~0.62 B parameters "
             "a layer plus 0.62 B of embedding and unembedding, 16 B each, "
             "~30 GB before activations); random fp32 weights from seed 0")
    return launches, kernels


def check_tol(name, got, want, tol):
    """Max abs error of a kernel output; raises outside
    |got - want| <= tol + tol |want|."""
    diff = (got.float() - want.float()).abs()
    bad = diff > tol + tol * want.float().abs()
    err = float(diff.max())
    assert not bool(bad.any()), (
        f"{name}: {int(bad.sum())} elements outside tolerance {tol}, "
        f"max abs err {err}")
    return err


def gate_share(got, want, tol):
    """max |got - want| / (tol + tol |want|): the share of the gate the
    output uses (below 1 where ``check_tol`` passes)."""
    want = want.float()
    return float(((got.float() - want).abs() / (tol + tol * want.abs()))
                 .max())


def simt_bound(flops, nbytes, dtype):
    """(bound_ms, bound_by) of a general kernel's call: operations over the
    rate of its type (fp32 outside the tensor cores, bf16 / fp16 in them)
    against bytes over the memory rate."""
    import torch
    peak = PEAK_FP32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def measured(name, kernel, run, plain, library, flops, nbytes, dtype, tol,
             reps=REPS):
    """One general-kernel check: ``run`` launches ``kernel`` once (the path
    taken), its outputs against ``plain``'s, then the times of the call
    (single calls and back to back), of the plain version and of the one
    PyTorch call ``library`` (a yardstick), and the bound."""
    import torch
    before = kernel.launches
    got = run()
    torch.cuda.synchronize()
    assert kernel.launches == before + 1, (name, kernel.name)
    want = plain()
    pairs = (list(zip(got, want)) if isinstance(got, tuple)
             else [(got, want)])
    err = max(check_tol(name, g, w, tol) for g, w in pairs)
    share = max(gate_share(g, w, tol) for g, w in pairs)
    del got, want, pairs
    bound_ms, bound_by = simt_bound(flops, nbytes, dtype)
    return dict(kernel=kernel.name, dtype=str(dtype).replace("torch.", ""),
                max_abs_err=err, gate_share=share,
                tolerance=f"{tol} + {tol}*|plain|",
                ms=cuda_ms(run, reps), ms_b2b=cuda_ms_b2b(run, reps),
                plain_ms=cuda_ms(plain, 2), library_ms=cuda_ms(library, reps),
                library_ms_b2b=cuda_ms_b2b(library, reps), bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                bytes=nbytes)


def planned_gmm(x, w, bm, live, n_sm):
    """``grouped_matmul``'s call with ``schedule="fac2"`` and ``sched_p``
    = n_sm, its tile plan made once here: a function that runs the kernel
    on that plan, so that a timing leaves out the host planner."""
    from repro_torch.balance.moe import plan_tiles
    from repro_torch.kernels.grouped_matmul.ops import _grouped_matmul_core
    order, plan = plan_tiles(live, bm, p=n_sm, technique="fac2",
                             capacity_rows=x.shape[1], return_plan=True)
    return lambda: _grouped_matmul_core(x, w, order, block_rows=bm,
                                        sched_p=n_sm, plan=plan)


def offset_randn(gen, dev, shape, dtype, offset, scale=1.0):
    """A contiguous tensor of ``shape`` from ``gen``, ``offset`` elements
    into its storage (``offset`` 1 of a 2-byte type: a base 2 bytes off
    16)."""
    import torch
    n = math.prod(shape)
    return (torch.randn(n + offset, generator=gen, device=dev)
            * scale).to(dtype)[offset:].view(*shape)


def simt_gmm_rows(dev, n_sm):
    """The grouped matmul family at SIMT_GMM_SHAPES in fp32, bf16 and fp16,
    and in bf16 and fp16 at SIMT_GMM_OFF8 (f 764, and a misaligned base in
    bf16): the forward on ``grouped_matmul``'s fac2 plan (sched_p = SM
    count; timed with the plan made beforehand, and its output equal to
    ``grouped_matmul``'s own call), dX and dW through their launchers; the
    kernel and route each call takes (``gmm_simt`` for fp32, ``gmm_any`` /
    ``gmm_dx_any`` / ``gmm_dw_any`` for the 2-byte calls off gmm.cu's
    blocks, on TMA or on the thread loader), against the plain versions,
    with ``torch.bmm`` on the same tensors; the outputs bit-identical across
    schedules and ``sched_p`` (1, 8 and the SM count), a misaligned call's
    also equal to an aligned copy's."""
    import numpy as np
    import torch
    from repro_torch.kernels.grouped_matmul import grouped_matmul as gm
    from repro_torch.kernels.grouped_matmul.ops import grouped_matmul
    gen = torch.Generator(device=dev).manual_seed(24)
    cases = [(name, shape + (0,), dt)
             for dt in (torch.float32, torch.bfloat16, torch.float16)
             for name, shape in SIMT_GMM_SHAPES.items()]
    cases += [(name, shape, dt)
              for name, shape in SIMT_GMM_OFF8.items()
              for dt in (torch.bfloat16, torch.float16)
              if dt == torch.bfloat16 or not shape[-1]]
    rows = {}
    for name, (e, c, d, f, bm, off), dtype in cases:
        tol = GMM_TOL[str(dtype).replace("torch.", "")]
        esz = torch.finfo(dtype).bits // 8
        x = offset_randn(gen, dev, (e, c, d), dtype, off)
        w = offset_randn(gen, dev, (e, d, f), dtype, 0, d ** -0.5)
        dy = offset_randn(gen, dev, (e, c, f), dtype, off)
        live = np.random.default_rng(e).integers(c // 2, c + 1, size=e)
        t = e * (c // bm)
        te = torch.arange(t, device=dev) // (c // bm)
        routes = (gm.gmm_route(dtype, dtype, bm, d, f, gm._aligned(x, w)),
                  gm.gmm_dx_route(dtype, dtype, c, d, f, gm._aligned(dy, w)),
                  gm.gmm_dw_route(dtype, dtype, c, d, f,
                                  gm._aligned(x, dy)))
        if dtype != torch.float32:
            assert "simt" not in routes, (name, dtype, routes)
        run = planned_gmm(x, w, bm, live, n_sm)
        fwd = measured(
            f"gmm {name} {dtype}", gm.GMM_BY_ROUTE[routes[0]], run,
            lambda: gm.grouped_matmul_tiles_plain(
                x.reshape(t, bm, d), w, te).reshape(e, c, f),
            lambda: torch.bmm(x, w), 2 * e * c * d * f,
            esz * (e * c * d + e * d * f + e * c * f), dtype, tol)
        out = grouped_matmul(x, w, block_rows=bm, schedule="fac2",
                             expert_rows=live, sched_p=n_sm)
        assert torch.equal(run(), out), (name, dtype)
        for kw in ({"sched_p": 8}, {"schedule": "gss",
                                    "expert_rows": live, "sched_p": 1}):
            assert torch.equal(grouped_matmul(x, w, block_rows=bm, **kw),
                               out), (name, dtype, kw)
        dx = measured(
            f"gmm_dx {name} {dtype}", gm.GMM_DX_BY_ROUTE[routes[1]],
            lambda: gm.gmm_dx_cuda(dy, w, sched_p=n_sm),
            lambda: gm.grouped_matmul_bwd_plain(x, w, dy,
                                                need_dw=False)[0],
            lambda: torch.bmm(dy, w.transpose(1, 2)), 2 * e * c * d * f,
            esz * (e * c * f + e * d * f + e * c * d), dtype, tol)
        dw = measured(
            f"gmm_dw {name} {dtype}", gm.GMM_DW_BY_ROUTE[routes[2]],
            lambda: gm.gmm_dw_cuda(x, dy, sched_p=n_sm),
            lambda: gm.grouped_matmul_bwd_plain(x, w, dy,
                                                need_dx=False)[1],
            lambda: torch.bmm(x.transpose(1, 2), dy), 2 * e * c * d * f,
            esz * (e * c * d + e * c * f + e * d * f), dtype, tol)
        outs = (gm.gmm_dx_cuda(dy, w, sched_p=n_sm),
                gm.gmm_dw_cuda(x, dy, sched_p=n_sm))
        for p in (1, 8):
            assert torch.equal(gm.gmm_dx_cuda(dy, w, sched_p=p),
                               outs[0]), (name, dtype, p)
            assert torch.equal(gm.gmm_dw_cuda(x, dy, sched_p=p),
                               outs[1]), (name, dtype, p)
        if off:
            xa, dya = x.clone(), dy.clone()
            assert torch.equal(grouped_matmul(
                xa, w, block_rows=bm, schedule="fac2", expert_rows=live,
                sched_p=n_sm), out), name
            assert torch.equal(gm.gmm_dx_cuda(dya, w, sched_p=n_sm),
                               outs[0]), name
            assert torch.equal(gm.gmm_dw_cuda(xa, dya, sched_p=n_sm),
                               outs[1]), name
            del xa, dya
        for row, route in zip((fwd, dx, dw), routes):
            row["route"] = route
        key = f"{name}_{str(dtype).replace('torch.', '')}"
        rows[key] = dict(shape=[e, c, d, f, bm], offset=off, gmm=fwd,
                         gmm_dx=dx, gmm_dw=dw)
        del x, w, dy, out, outs
    return rows


def off_block_path(dev, n_sm):
    """The 2-byte calls off gmm.cu's blocks that a user makes, counts from
    0 just before and read just after: ``grouped_matmul`` in bf16 and in
    fp16 with block_rows 8 at qwen3-moe-30b-a3b's width (SIMT_GMM_SHAPES)
    in a fac2 plan, ``grouped_matmul_bwd`` in bf16 and fp16 at its 64 rows
    an expert (dX off gmm_dx's 128-row tiles; fp16 dW off gmm_dw's
    dtype), and both in bf16 at f 764 (SIMT_GMM_OFF8: rows TMA cannot
    describe).  Then, outside the counted run, the outputs against the
    plain versions."""
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.grouped_matmul import grouped_matmul as gm
    from repro_torch.kernels.grouped_matmul.ops import grouped_matmul
    gen = torch.Generator(device=dev).manual_seed(28)
    calls = []
    for (e, c, d, f, bm), dts in (
            (SIMT_GMM_SHAPES["qwen3_moe"], (torch.bfloat16, torch.float16)),
            (SIMT_GMM_OFF8["f764"][:5], (torch.bfloat16,))):
        x = torch.randn(e, c, d, generator=gen, device=dev)
        w = torch.randn(e, d, f, generator=gen, device=dev) * d ** -0.5
        dy = torch.randn(e, c, f, generator=gen, device=dev)
        live = np.random.default_rng(e).integers(c // 2, c + 1, size=e)
        calls += [((e, c, d, f, bm), dt, live, x.to(dt), w.to(dt), dy.to(dt))
                  for dt in dts]
        del x, w, dy
    torch.cuda.synchronize()
    _build.reset_launches()
    outs = [(grouped_matmul(x, w, block_rows=shape[-1], schedule="fac2",
                            expert_rows=live, sched_p=n_sm),
             *gm.grouped_matmul_bwd(x, w, dy, sched_p=n_sm))
            for shape, dt, live, x, w, dy in calls]
    torch.cuda.synchronize()
    launches = {n: kern.launches for n, kern in _build.KERNELS.items()
                if kern.launches}
    assert launches == OFF_BLOCK_LAUNCHES, launches
    err, routes = {}, {}
    for ((e, c, d, f, bm), dt, _, x, w, dy), (y, dx, dw) in zip(calls, outs):
        key = f"f{f}_{str(dt).replace('torch.', '')}"
        routes[key] = [gm.gmm_route(dt, dt, bm, d, f),
                       gm.gmm_dx_route(dt, dt, c, d, f),
                       gm.gmm_dw_route(dt, dt, c, d, f)]
        t = e * (c // bm)
        te = torch.arange(t, device=dev) // (c // bm)
        want = gm.grouped_matmul_tiles_plain(x.reshape(t, bm, d), w, te)
        want_dx, want_dw = gm.grouped_matmul_bwd_plain(x, w, dy)
        err[key] = {
            n: check_tol(f"off-block {n} {key}", got, ref,
                         GMM_TOL[str(dt).replace("torch.", "")])
            for n, got, ref in (("gmm", y, want.reshape(e, c, f)),
                                ("gmm_dx", dx, want_dx),
                                ("gmm_dw", dw, want_dw))}
    del calls, outs
    return dict(launches=launches, routes=routes, max_abs_err=err,
                shapes={"qwen3_moe": list(SIMT_GMM_SHAPES["qwen3_moe"]),
                        "f764": list(SIMT_GMM_OFF8["f764"][:5])})


def gmm_digest(dev):
    """A hash of the fp32 grouped matmul family's outputs at both
    SIMT_GMM_SHAPES: the forward through ``grouped_matmul`` in a fac2 plan
    on one CTA per SM, dX and dW through their launchers."""
    import hashlib

    import numpy as np
    import torch
    from repro_torch.kernels.grouped_matmul import grouped_matmul as gm
    from repro_torch.kernels.grouped_matmul.ops import grouped_matmul
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(27)
    h = hashlib.sha256()
    for e, c, d, f, bm in SIMT_GMM_SHAPES.values():
        x = torch.randn(e, c, d, generator=gen, device=dev)
        w = torch.randn(e, d, f, generator=gen, device=dev) * d ** -0.5
        dy = torch.randn(e, c, f, generator=gen, device=dev)
        live = np.random.default_rng(e).integers(c // 2, c + 1, size=e)
        for out in (grouped_matmul(x, w, block_rows=bm, schedule="fac2",
                                   expert_rows=live, sched_p=n_sm),
                    gm.gmm_dx_cuda(dy, w, sched_p=n_sm),
                    gm.gmm_dw_cuda(x, dy, sched_p=n_sm)):
            h.update(out.contiguous().view(torch.uint8).cpu().numpy()
                     .tobytes())
    return h.hexdigest()[:16]


def gmm_times(dev):
    """Back-to-back times of the grouped matmul family at qwen3-moe's
    width in 8-row tiles (SIMT_GMM_SHAPES) in fp32, bf16 and fp16 and at f
    764 (SIMT_GMM_OFF8) in bf16 and fp16 (the forward on
    ``grouped_matmul``'s fac2 plan, made beforehand; dX and dW through
    their launchers; one CTA per SM), with ``torch.bmm`` on the same
    tensors and the route each call takes."""
    import numpy as np
    import torch
    from repro_torch.kernels.grouped_matmul import grouped_matmul as gm
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(29)
    out = {}
    for name, (e, c, d, f, bm), dts in (
            ("qwen3_moe", SIMT_GMM_SHAPES["qwen3_moe"],
             (torch.float32, torch.bfloat16, torch.float16)),
            ("f764", SIMT_GMM_OFF8["f764"][:5],
             (torch.bfloat16, torch.float16))):
        live = np.random.default_rng(e).integers(c // 2, c + 1, size=e)
        for dt in dts:
            x = torch.randn(e, c, d, generator=gen, device=dev).to(dt)
            w = (torch.randn(e, d, f, generator=gen, device=dev)
                 * d ** -0.5).to(dt)
            dy = torch.randn(e, c, f, generator=gen, device=dev).to(dt)
            key = str(dt).replace("torch.", "")
            out[key if name == "qwen3_moe" else f"{name}_{key}"] = dict(
                shape=[e, c, d, f, bm],
                routes=[gm.gmm_route(dt, dt, bm, d, f),
                        gm.gmm_dx_route(dt, dt, c, d, f),
                        gm.gmm_dw_route(dt, dt, c, d, f)],
                gmm=cuda_ms_b2b(planned_gmm(x, w, bm, live, n_sm), REPS),
                gmm_dx=cuda_ms_b2b(
                    lambda: gm.gmm_dx_cuda(dy, w, sched_p=n_sm), REPS),
                gmm_dw=cuda_ms_b2b(
                    lambda: gm.gmm_dw_cuda(x, dy, sched_p=n_sm), REPS),
                bmm=cuda_ms_b2b(lambda: torch.bmm(x, w), REPS),
                bmm_dx=cuda_ms_b2b(lambda: torch.bmm(dy, w.transpose(1, 2)),
                                   REPS),
                bmm_dw=cuda_ms_b2b(lambda: torch.bmm(x.transpose(1, 2), dy),
                                   REPS))
            del x, w, dy
    return out


def tf32x3_bound(flops):
    """ms of ``flops`` fp32-accurate operations as three TF32 products each
    at the tensor cores' TF32 rate."""
    return 1e3 * 3 * flops / PEAK_TF32_FLOPS


def flash32_digest(dev):
    """A hash of the fp32 dense flash kernels' outputs at
    FLASH32_DIGEST_SHAPES: the forward's output and lse, then the
    backward's dQ, dK and dV, on inputs of a seed of their own."""
    import hashlib

    import torch
    from repro_torch.kernels.flash_attention import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(27)
    h_ = hashlib.sha256()
    for b, s, h, kvh, hd, window, causal in FLASH32_DIGEST_SHAPES:
        q, k, v, do = (torch.randn(b, s, n, hd, generator=gen, device=dev)
                       for n in (h, kvh, kvh, h))
        o, lse, kw = dense_fwd_res(fa, q, k, v, causal, window)
        for out in (o, lse, *fa._flash_dense_bwd_cuda(
                q, k, v, o, do, lse, causal=causal, window=window, **kw)):
            h_.update(out.contiguous().view(torch.uint8).cpu().numpy()
                      .tobytes())
    return h_.hexdigest()[:16]


def flash32_digests(dev):
    """``flash32_digest`` and, under names of their own, hashes at
    FLASH32_BWD256_DIGEST_SHAPE (fp32) of the hd-256 windowed backward's
    dQ, dK and dV (``_flash_dense_bwd_cuda``) fed the general forward's
    output and lse (``flash32_bwd256_digest``) and of the forward of the
    tree's own route (output, lse) then that backward on them
    (``flash32_256_digest``, twice, equal), and of the ragged
    schedule-aware forward at FLASH32_SCHED_DIGEST_SHAPE (fp32,
    ``flash_attention`` with a schedule), on inputs of seeds of their
    own."""
    import hashlib

    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ops import flash_attention

    def digest(outs):
        h_ = hashlib.sha256()
        for out in outs:
            h_.update(out.contiguous().view(torch.uint8).cpu().numpy()
                      .tobytes())
        return h_.hexdigest()[:16]

    gen = torch.Generator(device=dev).manual_seed(28)
    b, s, h, kvh, hd, window = FLASH32_BWD256_DIGEST_SHAPE
    q, k, v, do = (torch.randn(b, s, n, hd, generator=gen, device=dev)
                   for n in (h, kvh, kvh, h))
    o, lse, _ = fa._flash_dense_simt_cuda(q, k, v, causal=True,
                                          window=window, with_lse=True)
    bwd = digest(fa._flash_dense_bwd_cuda(q, k, v, o, do, lse, causal=True,
                                          window=window))

    def chain():
        o, lse, kw = dense_fwd_res(fa, q, k, v, True, window)
        return digest([o, lse, *fa._flash_dense_bwd_cuda(
            q, k, v, o, do, lse, causal=True, window=window, **kw)])

    chains = [chain(), chain()]
    assert chains[0] == chains[1], chains
    del q, k, v, do, o, lse
    b, s, h, kvh, hd, p = FLASH32_SCHED_DIGEST_SHAPE
    kv_lens = np.random.default_rng(28).integers(1, s + 1, size=b)
    kv_lens[0] = 0
    q, k, v = (torch.randn(b, s, n, hd, generator=gen, device=dev)
               for n in (h, kvh, kvh))
    sched = digest([flash_attention(q, k, v, causal=True, schedule="fac2",
                                    kv_lens=kv_lens, sched_p=p)])
    return {"flash32_digest": flash32_digest(dev),
            "flash32_bwd256_digest": bwd, "flash32_256_digest": chains[0],
            "flash32_sched_digest": sched}


def kernels_run(fn):
    """The names of the kernels one call of ``fn`` launches."""
    import torch
    from repro_torch.kernels import _build
    before = {n: k.launches for n, k in _build.KERNELS.items()}
    fn()
    torch.cuda.synchronize()
    return sorted(n for n, k in _build.KERNELS.items()
                  if k.launches != before[n])


def strided_views(gen, dev, dtype, b, s, h, kvh, hd):
    """q, k, v (b, s, h|kvh, hd) and do (b, s, h, hd) of ``dtype`` as views
    of one (b, s, 2 h + 2 kvh, hd + 2) buffer of seeded normal values:
    heads hd + 2 elements apart, a stride TMA cannot describe."""
    import torch
    buf = torch.randn(b, s, 2 * h + 2 * kvh, hd + 2, generator=gen,
                      device=dev).to(dtype)
    cuts = (0, h, h + kvh, h + 2 * kvh, 2 * h + 2 * kvh)
    return tuple(buf[:, :, a:z, :hd] for a, z in zip(cuts, cuts[1:]))


def pack_row(fa, tensors, hd):
    """The copy to TMA's layout of ``tensors`` alone (``_tma_pack``): b2b
    (about the wrapper's host work where the copy is short), its device
    time a launch from a profile of 10 calls (``device_ms``; None where
    the profile saw no launch of it), and its bytes bound: each tensor it
    copies read once and written once at the head dim rounded up to 8.
    None on a tree without it."""
    if not hasattr(fa, "_tma_pack"):
        return None
    hd_pad = fa.tma_head_dim(hd)
    nbytes = sum(x.numel() // x.shape[3] * (x.shape[3] + hd_pad)
                 * x.element_size() for x in tensors
                 if x.shape[3] != hd_pad or not fa._tma_ok(x))

    def pack():
        return fa._tma_pack(hd_pad, *tensors)

    prof = device_profile(lambda: [pack() for _ in range(10)],
                          watch=("tma_pack",))["tma_pack"]
    return dict(ms_b2b=cuda_ms_b2b(pack, REPS),
                device_ms=prof["ms"] / prof["count"] if prof["count"] else None,
                bytes=nbytes,
                bound_ms=1e3 * nbytes / PEAK_BYTES)


def packed_fwd_times(fa, q, k, v, window):
    """The dense forward of ``fa`` (this tree's module or an older one's)
    on q, k, v views TMA cannot describe, b2b, through
    ``_flash_dense_cuda`` (a copy to TMA's layout, then the tensor-core
    kernel of the copies' route; on older trees the general kernel),
    beside the general kernel's on the same views (``simt_ms_b2b``),
    SDPA's on contiguous copies made beforehand (its kernels refuse these
    views) and the copy's alone (``pack``), with the kernels the call
    launched."""
    b, s, h, hd = q.shape

    def fwd():
        return fa._flash_dense_cuda(q, k, v, causal=True, window=window)

    def simt():
        return fa._flash_dense_simt_cuda(q, k, v, causal=True, window=window)

    return dict(shape=[b, s, h, k.shape[2], hd], window=window,
                dtype=str(q.dtype).replace("torch.", ""),
                kernels=kernels_run(fwd), ms_b2b=cuda_ms_b2b(fwd, REPS),
                ms=cuda_ms(fwd, REPS), simt_ms_b2b=cuda_ms_b2b(simt, 5),
                sdpa_ms_b2b=cuda_ms_b2b(sdpa_fn(
                    *(x.contiguous() for x in (q, k, v)), window), REPS),
                pack=pack_row(fa, (q, k, v), hd))


def packed_bwd_times(fa, q, k, v, do, window):
    """The dense backward of ``fa`` on views TMA cannot describe, b2b,
    through ``_flash_dense_bwd_cuda`` on the forward's residuals (copies
    to TMA's layout of q, k, v, o and dO, then the route's backward; on
    older trees the general kernels), beside the general backward's on
    the general forward's residuals with the contiguous copies the entry
    made for it (``simt_ms_b2b``), SDPA's on contiguous copies made
    beforehand (its kernels refuse these views) and the copy's alone
    (``pack``), with the kernels the call launched."""
    import torch
    b, s, h, hd = q.shape
    o, lse, kw = dense_fwd_res(fa, q, k, v, True, window)
    o_s, lse_s, *rest = fa._flash_dense_simt_cuda(q, k, v, causal=True,
                                                  window=window,
                                                  with_lse=True)
    kw_s = {"o_lo": rest[0]} if rest and rest[0] is not None else {}
    stream = torch.cuda.current_stream(q.device).cuda_stream

    def bwd():
        return fa._flash_dense_bwd_cuda(q, k, v, o, do, lse, causal=True,
                                        window=window, **kw)

    def simt():
        return fa._flash_simt_bwd_cuda(
            *(x.contiguous() for x in (q, k, v, o_s, do)), lse_s,
            causal=True, window=window, stream=stream, **kw_s)

    return dict(shape=[b, s, h, k.shape[2], hd], window=window,
                dtype=str(q.dtype).replace("torch.", ""),
                kernels=kernels_run(bwd), ms_b2b=cuda_ms_b2b(bwd, 5),
                ms=cuda_ms(bwd, 5), simt_ms_b2b=cuda_ms_b2b(simt, 3),
                sdpa_ms_b2b=cuda_ms_b2b(sdpa_grad_fns(
                    *(x.contiguous() for x in (q, k, v, do)), window)[0], 5),
                pack=pack_row(fa, (q, k, v, o, do, *kw.values()), hd))


def flash32_times(dev):
    """Back-to-back times of the fp32 flash forward at SIMT_DENSE_SHAPES
    (head dims 64, 80, 128 and 256; the general kernel's on the same
    tensors beside each, ``simt_ms_b2b``), of its backward at SIMT_BWD_SHAPE and at
    recurrentgemma-2b's hd-256 window (``bwd_256``), and of the
    schedule-aware entry at the main path's lanes (fac2, sched_p = the SM
    count, the plan made beforehand), through the private launchers
    (``_flash_dense_cuda``, ``_flash_dense_bwd_cuda``, ``_flash_sched_cuda``;
    older trees have them too), with SDPA's (forward; backward; the
    boolean mask of the lanes) on the same tensors and the kernels each
    call launched.  Then the dense calls on views TMA cannot describe
    (``packed_fwd_times`` / ``packed_bwd_times``): at recurrentgemma-2b's
    hd-256 window forward and backward (``strided_256``,
    ``strided_256_bwd``), qwen3-4b's prefill forward (``strided_128``) and
    its training shape's backward (``strided_bwd``)."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(31)
    out = {}
    for key, (b, s, h, kvh, hd, window) in SIMT_DENSE_SHAPES.items():
        q, k, v = (torch.randn(b, s, n, hd, generator=gen, device=dev)
                   for n in (h, kvh, kvh))

        def fwd():
            return fa._flash_dense_cuda(q, k, v, causal=True, window=window)

        def simt():
            return fa._flash_dense_simt_cuda(q, k, v, causal=True,
                                             window=window)

        out[key] = dict(shape=[b, s, h, kvh, hd], window=window,
                        kernels=kernels_run(fwd),
                        ms_b2b=cuda_ms_b2b(fwd, REPS),
                        simt_ms_b2b=cuda_ms_b2b(simt, 5),
                        sdpa_ms_b2b=cuda_ms_b2b(sdpa_fn(q, k, v, window),
                                                REPS))
        del q, k, v
    for name, (b, s, h, kvh, hd), window in (
            ("bwd", SIMT_BWD_SHAPE, 0),
            ("bwd_256", SIMT_DENSE_SHAPES["256"][:5],
             SIMT_DENSE_SHAPES["256"][5])):
        q, k, v, do = (torch.randn(b, s, n, hd, generator=gen, device=dev)
                       for n in (h, kvh, kvh, h))
        o, lse, kw = dense_fwd_res(fa, q, k, v, True, window)

        def bwd():
            return fa._flash_dense_bwd_cuda(q, k, v, o, do, lse, causal=True,
                                            window=window, **kw)

        out[name] = dict(shape=[b, s, h, kvh, hd], window=window,
                         kernels=kernels_run(bwd), ms_b2b=cuda_ms_b2b(bwd, 5),
                         sdpa_ms_b2b=cuda_ms_b2b(
                             sdpa_grad_fns(q, k, v, do, window)[0], 5))
        del q, k, v, do, o, lse, kw
    # on views TMA cannot describe (heads hd + 2 apart): recurrentgemma-2b's
    # hd-256 window forward and backward, qwen3-4b's prefill forward and
    # its training shape's backward
    for key, shape, window, parts in (
            ("strided_256", SIMT_DENSE_SHAPES["256"][:5],
             SIMT_DENSE_SHAPES["256"][5], ("fwd", "bwd")),
            ("strided_128", SIMT_DENSE_SHAPES["128"][:5], 0, ("fwd",)),
            ("strided_bwd", SIMT_BWD_SHAPE, 0, ("bwd",))):
        q, k, v, do = strided_views(gen, dev, torch.float32, *shape)
        if "fwd" in parts:
            out[key] = packed_fwd_times(fa, q, k, v, window)
        if "bwd" in parts:
            out[key + ("_bwd" if "fwd" in parts else "")] = \
                packed_bwd_times(fa, q, k, v, do, window)
        del q, k, v, do
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    kv_lens = np.random.default_rng(0).integers(64, S + 1, size=B)
    kv_lens[0] = S
    q, k, v = (torch.randn(B, S, n, HD, generator=gen, device=dev)
               for n in (H, KVH, KVH))
    desc, plan = fa._plan_kv_descriptors(
        B * H, S, 512, 512, causal=True, window=0,
        kv_lens=np.repeat(kv_lens, H), schedule="fac2", p=n_sm)
    bounds = fa.descriptor_bounds(desc, plan)

    def sched():
        return fa._flash_sched_cuda(q, k, v, desc, bounds, block_q=512,
                                    block_k=512, causal=True, window=0)

    out["sched"] = dict(
        shape=[B, S, H, KVH, HD], kernels=kernels_run(sched),
        ms_b2b=cuda_ms_b2b(sched, 5),
        sdpa_ms_b2b=cuda_ms_b2b(
            sdpa_fn(q, k, v, 0, mask=ragged_mask(kv_lens, dev)), 3))
    return out


def simt_flash_rows(dev, n_sm):
    """fp32 flash attention: dense causal at SIMT_DENSE_SHAPES, on the
    tensor cores at head dims 64, 80 and 128 (route "tf32x3") and on their
    cluster pairs at head dim 256 (recurrentgemma-2b's window, route
    "tf32x3_256"), with the general kernel's run on the same tensors beside
    each; ragged in
    a fac2 plan at the main path's lanes (sched_p = SM count, the plan made
    beforehand; ``flash_sched_f32``, the general kernel beside it, and bits
    equal under static / 8 and gss / 1); the backward at SIMT_BWD_SHAPE and
    at recurrentgemma-2b's shape (tensor cores, the hd-256 one on cluster
    pairs; the general backward beside each).  Each against its plain
    version, with SDPA in fp32 (TF32 off) on the same tensors as the
    yardstick, and each backward's delta pass (``flash_simt_bwd_delta``)
    with ``torch.linalg.vecdot`` beside it; ``flash32_digests``."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ops import flash_attention
    gen = torch.Generator(device=dev).manual_seed(25)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def dense_bytes(b, s, h, kvh, hd):
        return 4 * (2 * b * s * h * hd + 2 * b * s * kvh * hd)

    def bwd_bytes(b, s, h, kvh, hd):
        return 4 * (4 * b * s * h * hd + 4 * b * s * kvh * hd) + 4 * b * h * s

    rows = {"dense": {}}
    for key, (b, s, h, kvh, hd, window) in SIMT_DENSE_SHAPES.items():
        q, k, v = rnd(b, s, h, hd), rnd(b, s, kvh, hd), rnd(b, s, kvh, hd)
        flops = 4 * hd * b * h * live_pairs(s, window)
        route = fa._check_kernel_inputs("flash_dense", q, k, v)
        args = (lambda: fa.flash_attention_dense_plain(
            *fa.broadcast_flatten(q, k, v), causal=True,
            window=window).reshape(b, h, s, hd).permute(0, 2, 1, 3),
            sdpa_fn(q, k, v, window), flops, dense_bytes(b, s, h, kvh, hd),
            torch.float32, SIMT_FLASH_TOL)
        simt = measured(
            f"flash_dense_simt hd {hd}", fa.FLASH_DENSE_SIMT,
            lambda: fa._flash_dense_simt_cuda(q, k, v, causal=True,
                                              window=window), *args, reps=5)
        row = simt
        if route != "simt":
            kernel = fa.FLASH_DENSE_BY_ROUTE[route]
            row = dict(measured(
                f"{kernel.name} hd {hd}", kernel,
                lambda: flash_attention(q, k, v, causal=True, window=window),
                *args, reps=5), bound_ms_tf32x3=tf32x3_bound(flops),
                simt=simt)
        rows["dense"][key] = dict(shape=[b, s, h, kvh, hd], window=window,
                                  route=route, **row)
        del q, k, v
    # ragged: the main path's lanes and kv_lens (seed 0), fac2
    kv_lens = np.random.default_rng(0).integers(64, S + 1, size=B)
    kv_lens[0] = S
    q, k, v = rnd(B, S, H, HD), rnd(B, S, KVH, HD), rnd(B, S, KVH, HD)
    pairs = sum(H * int(np.minimum(np.arange(1, S + 1), lim).sum())
                for lim in kv_lens)

    desc, plan = fa._plan_kv_descriptors(
        B * H, S, 512, 512, causal=True, window=0,
        kv_lens=np.repeat(kv_lens, H), schedule="fac2", p=n_sm)
    bounds = fa.descriptor_bounds(desc, plan)

    def sched(launcher=fa._flash_sched_cuda):
        return lambda: launcher(q, k, v, desc, bounds, block_q=512,
                                block_k=512, causal=True, window=0)

    flops = 4 * HD * pairs
    args = (lambda: fa.flash_attention_sched_plain(
        *fa.broadcast_flatten(q, k, v), kv_lens=np.repeat(kv_lens, H),
        causal=True).reshape(B, H, S, HD).permute(0, 2, 1, 3),
        sdpa_fn(q, k, v, 0, mask=ragged_mask(kv_lens, dev)), flops,
        4 * (2 * B * S * H * HD
             + 2 * KVH * HD * int(np.minimum(kv_lens, S).sum())),
        torch.float32, SIMT_FLASH_TOL)
    simt = measured("flash_sched_simt", fa.FLASH_SCHED_SIMT,
                    sched(fa._flash_sched_simt_cuda), *args, reps=5)
    rows["sched"] = dict(
        shape=[B, S, H, KVH, HD], kv_lens=kv_lens.tolist(),
        **measured("flash_sched_f32", fa.FLASH_SCHED_F32, sched(), *args,
                   reps=5), bound_ms_tf32x3=tf32x3_bound(flops), simt=simt)
    out = flash_attention(q, k, v, causal=True, schedule="fac2",
                          kv_lens=kv_lens, sched_p=n_sm)
    assert torch.equal(out, sched()())
    for tech, p in (("static", 8), ("gss", 1)):
        assert torch.equal(flash_attention(
            q, k, v, causal=True, schedule=tech, kv_lens=kv_lens,
            sched_p=p), out), tech
    del q, k, v, out
    # the backward at qwen3-4b's training shape and at recurrentgemma-2b's
    # (tensor cores, the latter on cluster pairs; the general kernels
    # beside)
    for name, (b, s, h, kvh, hd), window in (
            ("bwd", SIMT_BWD_SHAPE, 0),
            ("bwd_256", SIMT_DENSE_SHAPES["256"][:5],
             SIMT_DENSE_SHAPES["256"][5])):
        q, k, v, do = rnd(b, s, h, hd), rnd(b, s, kvh, hd), \
            rnd(b, s, kvh, hd), rnd(b, s, h, hd)
        o, lse, kw = dense_fwd_res(fa, q, k, v, True, window)
        route = fa.flash_route(torch.float32, hd)
        kernel = fa.FLASH_F32_BWD_BY_ROUTE[route][0]

        def backward():
            return fa._flash_dense_bwd_cuda(q, k, v, o, do, lse, causal=True,
                                            window=window, **kw)

        def simt_backward():
            return fa._flash_simt_bwd_cuda(
                q, k, v, o, do, lse, causal=True, window=window,
                stream=torch.cuda.current_stream(dev).cuda_stream)

        first = backward()
        assert all(torch.equal(x, y) for x, y in zip(first, backward()))
        del first
        sdpa_bwd = sdpa_grad_fns(q, k, v, do, window)[0]
        flops = 10 * hd * b * h * live_pairs(s, window)
        args = (lambda: tuple(fa.flash_attention_dense_bwd_plain(
            q, k, v, do, window=window)), sdpa_bwd, flops,
            bwd_bytes(b, s, h, kvh, hd), torch.float32, SIMT_FLASH_TOL)
        simt = measured(f"flash_simt_bwd hd {hd}", fa.FLASH_SIMT_BWD_DKDV,
                        simt_backward, *args, reps=5)
        # the delta pass every fp32 backward runs, D = rowsum(dO o O)
        # (b, h, s): bytes, O and dO read and D written once
        stream = torch.cuda.current_stream(dev).cuda_stream
        delta = measured(
            f"flash_simt_bwd_delta hd {hd}", fa.FLASH_SIMT_BWD_DELTA,
            lambda: fa._simt_delta(o, do, stream),
            lambda: (do * o).sum(-1).permute(0, 2, 1),
            lambda: torch.linalg.vecdot(do, o), 2 * b * s * h * hd,
            4 * (2 * b * s * h * hd + b * h * s), torch.float32,
            SIMT_FLASH_TOL)
        rows[name] = dict(shape=[b, s, h, kvh, hd], window=window,
                          route=route, **measured(
                              f"{kernel.name} hd {hd}", kernel, backward,
                              *args, reps=5),
                          bound_ms_tf32x3=tf32x3_bound(flops), simt=simt,
                          delta=delta)
        del q, k, v, do, o, lse, sdpa_bwd
    rows.update(flash32_digests(dev))
    assert rows["flash32_digest"] == PARENT_FLASH32_DIGEST, rows
    assert rows["flash32_bwd256_digest"] == PARENT_FLASH32_BWD256_DIGEST, \
        rows
    return rows


def fp16_flash_rows(dev, n_sm):
    """fp16 flash attention: the fp16 path with the counts from 0 before it
    and read after (``flash_attention`` with a schedule at the main path's
    lanes, fac2, sched_p = SM count; dense attention at SIMT_BWD_SHAPE
    forward and backward under autograd; all on the fp16 instantiations of
    ``flash_sched``, ``flash_dense`` and ``flash_dense_bwd``;
    FP16_PATH_LAUNCHES), then each kernel against its fp32 plain version
    at FP16_FLASH_TOL (with the share of the gate it uses) and timed
    against SDPA in fp16 on the same tensors: dense at qwen3-4b's prefill
    (SIMT_DENSE_SHAPES["128"]), the scheduled call (plan made beforehand;
    bits equal under static / 8 and gss / 1) and the backward at
    SIMT_BWD_SHAPE, each with the general kernel's run on the same tensors
    beside it (``simt``).  The tensor-core rows' bound is operations at
    the tensor cores' fp16 rate; ``bound_ms_fp32_pv`` is the bound of the
    work at the reference's precision (forward: S once and P V twice;
    backward: S and dP once, dV, dK and dQ twice, P and dS as hi + lo); the
    general kernels' rows carry the bound at the CUDA cores' fp32 FMA rate
    they compute at (``bound_ms_fp32_fma``).  Last ``flash16_digest`` and
    ``flash16_sched_digest`` twice each, which must agree."""
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ops import flash_attention
    gen = torch.Generator(device=dev).manual_seed(16)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).half()

    kv_lens = np.random.default_rng(0).integers(64, S + 1, size=B)
    kv_lens[0] = S
    q, k, v = rnd(B, S, H, HD), rnd(B, S, KVH, HD), rnd(B, S, KVH, HD)
    b, s, h, kvh, hd = SIMT_BWD_SHAPE
    tq, tk, tv, tdo = (rnd(b, s, n, hd) for n in (h, kvh, kvh, h))
    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    torch.cuda.synchronize()
    _build.reset_launches()
    attn = flash_attention(q, k, v, causal=True, schedule="fac2",
                           kv_lens=kv_lens, sched_p=n_sm)
    dense = flash_attention(*leaves, causal=True)
    dense.backward(tdo)
    torch.cuda.synchronize()
    launches = {n: kern.launches for n, kern in _build.KERNELS.items()
                if kern.launches}
    assert launches == {n: c for n, c in FP16_PATH_LAUNCHES.items() if c}, \
        launches
    for x in (attn, dense, *(x.grad for x in leaves)):
        assert x.dtype == torch.float16 and bool(torch.isfinite(x).all())
    del attn, dense, leaves
    rows = {"launches": launches}

    def with_fma(row, flops):
        return dict(row, bound_ms_fp32_fma=1e3 * flops / PEAK_FP32_FLOPS)

    # dense forward, qwen3-4b's prefill: flash_dense, flash_dense_simt beside
    b, s, h, kvh, hd, window = SIMT_DENSE_SHAPES["128"]
    xq, xk, xv = rnd(b, s, h, hd), rnd(b, s, kvh, hd), rnd(b, s, kvh, hd)
    flops = 4 * hd * b * h * live_pairs(s, window)
    args = (lambda: plain_attention(xq.float(), xk.float(), xv.float()),
            sdpa_fn(xq, xk, xv, 0), flops,
            2 * (2 * b * s * h * hd + 2 * b * s * kvh * hd), torch.float16,
            FP16_FLASH_TOL)
    assert fa._check_kernel_inputs("flash_dense", xq, xk, xv) == "wgmma"
    rows["dense"] = dict(
        shape=[b, s, h, kvh, hd], route="wgmma", **measured(
            "flash_dense fp16", fa.FLASH_DENSE,
            lambda: fa._flash_dense_cuda(xq, xk, xv, causal=True, window=0),
            *args), bound_ms_fp32_pv=bound(flops * 3 // 2, args[3])[0],
        simt=with_fma(measured(
            "flash_dense_simt fp16", fa.FLASH_DENSE_SIMT,
            lambda: fa._flash_dense_simt_cuda(xq, xk, xv, causal=True,
                                              window=0), *args, reps=5),
            flops))
    del xq, xk, xv
    # the scheduled call at the main path's lanes: flash_sched, the
    # general kernel beside it
    desc, plan = fa._plan_kv_descriptors(
        B * H, S, 512, 512, causal=True, window=0,
        kv_lens=np.repeat(kv_lens, H), schedule="fac2", p=n_sm)
    bounds = fa.descriptor_bounds(desc, plan)
    pairs = sum(H * int(np.minimum(np.arange(1, S + 1), lim).sum())
                for lim in kv_lens)
    flops = 4 * HD * pairs

    def sched(launcher=fa._flash_sched_cuda):
        return lambda: launcher(q, k, v, desc, bounds, block_q=512,
                                block_k=512, causal=True, window=0)

    args = (lambda: fa.flash_attention_sched_plain(
        *(x.float() for x in fa.broadcast_flatten(q, k, v)),
        kv_lens=np.repeat(kv_lens, H), causal=True).reshape(
            B, H, S, HD).permute(0, 2, 1, 3),
        sdpa_fn(q, k, v, 0, mask=ragged_mask(kv_lens, dev)), flops,
        2 * (2 * B * S * H * HD
             + 2 * KVH * HD * int(np.minimum(kv_lens, S).sum())),
        torch.float16, FP16_FLASH_TOL)
    assert fa._check_kernel_inputs("flash_sched", q, k, v) == "wgmma"
    rows["sched"] = dict(
        shape=[B, S, H, KVH, HD], route="wgmma", **measured(
            "flash_sched fp16", fa.FLASH_SCHED, sched(), *args, reps=10),
        bound_ms_fp32_pv=bound(flops * 3 // 2, args[3])[0],
        simt=with_fma(measured(
            "flash_sched_simt fp16", fa.FLASH_SCHED_SIMT,
            sched(fa._flash_sched_simt_cuda), *args, reps=3), flops))
    out = flash_attention(q, k, v, causal=True, schedule="fac2",
                          kv_lens=kv_lens, sched_p=n_sm)
    assert torch.equal(out, sched()())
    for tech, p in (("static", 8), ("gss", 1)):
        assert torch.equal(flash_attention(
            q, k, v, causal=True, schedule=tech, kv_lens=kv_lens,
            sched_p=p), out), tech
    del q, k, v, out
    # the backward at qwen3-4b's training shape: flash_dense_bwd, the
    # general backward beside (on the same forward's output and lse)
    b, s, h, kvh, hd = SIMT_BWD_SHAPE
    o, lse, kw = dense_fwd_res(fa, tq, tk, tv, True, 0)
    flops = 10 * hd * b * h * live_pairs(s, 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (lambda: tuple(fa.flash_attention_dense_bwd_plain(
        tq, tk, tv, tdo)), sdpa_grad_fns(tq, tk, tv, tdo, 0)[0], flops,
        2 * (4 * b * s * h * hd + 4 * b * s * kvh * hd) + 4 * b * h * s,
        torch.float16, FP16_FLASH_TOL)
    assert fa.flash_route(torch.float16, hd) == "wgmma"
    rows["bwd"] = dict(
        shape=[b, s, h, kvh, hd], route="wgmma", **measured(
            "flash_dense_bwd fp16", fa.FLASH_DENSE_BWD_DKDV,
            lambda: fa._flash_dense_bwd_cuda(tq, tk, tv, o, tdo, lse,
                                             causal=True, window=0, **kw),
            *args, reps=10), bound_ms_fp32_pv=bound(flops * 8 // 5,
                                                    args[3])[0],
        # the general backward, D from the output and its rounding
        # residual as the tensor-core kernels form it, held to the same
        # fp32 plain version
        simt=with_fma(measured(
            "flash_simt_bwd fp16", fa.FLASH_SIMT_BWD_DKDV,
            lambda: fa._flash_simt_bwd_cuda(tq, tk, tv, o, tdo, lse,
                                            causal=True, window=0,
                                            stream=stream, **kw),
            *args, reps=3), flops))
    del tq, tk, tv, tdo, o, lse, kw
    for fn in (flash16_digest, flash16_sched_digest):
        digests = [fn(dev), fn(dev)]
        assert digests[0] == digests[1], (fn.__name__, digests)
        rows[fn.__name__] = digests[0]
    return rows


def flash16_times(dev):
    """Back-to-back times of the fp16 dense flash forward at qwen3-4b's
    prefill (SIMT_DENSE_SHAPES["128"]), of its backward at SIMT_BWD_SHAPE
    and of the schedule-aware entry at the main path's lanes (fac2,
    sched_p = the SM count, the plan made beforehand; the general kernel's
    on the same tensors beside it, ``simt_ms_b2b``), through the private
    launchers (older trees have them too; ``dense_fwd_res`` passes the
    output's residual where a tree asks for it), with SDPA's in fp16 on
    the same tensors and the kernels each call launched.  Then the dense
    calls on views TMA cannot describe (``packed_fwd_times`` /
    ``packed_bwd_times``): the prefill forward (``strided_dense``) and the
    training shape's backward (``strided_bwd``) in fp16, and bf16 at the
    odd head dim 100, qwen3-4b's heads, forward and backward
    (``bf16_hd100``, ``bf16_hd100_bwd``)."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(161)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).half()

    out = {}
    b, s, h, kvh, hd, window = SIMT_DENSE_SHAPES["128"]
    q, k, v = rnd(b, s, h, hd), rnd(b, s, kvh, hd), rnd(b, s, kvh, hd)

    def fwd():
        return fa._flash_dense_cuda(q, k, v, causal=True, window=window)

    out["dense"] = dict(shape=[b, s, h, kvh, hd], kernels=kernels_run(fwd),
                        ms_b2b=cuda_ms_b2b(fwd, REPS),
                        sdpa_ms_b2b=cuda_ms_b2b(sdpa_fn(q, k, v, window),
                                                REPS))
    del q, k, v
    b, s, h, kvh, hd = SIMT_BWD_SHAPE
    q, k, v, do = (rnd(b, s, n, hd) for n in (h, kvh, kvh, h))
    o, lse, kw = dense_fwd_res(fa, q, k, v, True, 0)

    def bwd():
        return fa._flash_dense_bwd_cuda(q, k, v, o, do, lse, causal=True,
                                        window=0, **kw)

    out["bwd"] = dict(shape=[b, s, h, kvh, hd], kernels=kernels_run(bwd),
                      ms_b2b=cuda_ms_b2b(bwd, 5),
                      sdpa_ms_b2b=cuda_ms_b2b(
                          sdpa_grad_fns(q, k, v, do, 0)[0], 5))
    del q, k, v, do, o, lse, kw
    # on views TMA cannot describe (heads hd + 2 apart): the prefill
    # forward and the training shape's backward in fp16, and bf16 at the
    # odd head dim 100 (copied to hd 104), forward and backward
    for key, dtype, shape, parts in (
            ("strided_dense", torch.float16, SIMT_DENSE_SHAPES["128"][:5],
             ("fwd",)),
            ("strided_bwd", torch.float16, SIMT_BWD_SHAPE, ("bwd",)),
            ("bf16_hd100", torch.bfloat16, PACKED_BF16_SHAPE,
             ("fwd", "bwd"))):
        q, k, v, do = strided_views(gen, dev, dtype, *shape)
        if "fwd" in parts:
            out[key] = packed_fwd_times(fa, q, k, v, 0)
        if "bwd" in parts:
            out[key + ("_bwd" if "fwd" in parts else "")] = \
                packed_bwd_times(fa, q, k, v, do, 0)
        del q, k, v, do
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    kv_lens = np.random.default_rng(0).integers(64, S + 1, size=B)
    kv_lens[0] = S
    q, k, v = rnd(B, S, H, HD), rnd(B, S, KVH, HD), rnd(B, S, KVH, HD)
    desc, plan = fa._plan_kv_descriptors(
        B * H, S, 512, 512, causal=True, window=0,
        kv_lens=np.repeat(kv_lens, H), schedule="fac2", p=n_sm)
    bounds = fa.descriptor_bounds(desc, plan)

    def sched():
        return fa._flash_sched_cuda(q, k, v, desc, bounds, block_q=512,
                                    block_k=512, causal=True, window=0)

    def simt():
        return fa._flash_sched_simt_cuda(q, k, v, desc, bounds, block_q=512,
                                         block_k=512, causal=True, window=0)

    out["sched"] = dict(
        shape=[B, S, H, KVH, HD], kernels=kernels_run(sched),
        ms_b2b=cuda_ms_b2b(sched, 5), simt_ms_b2b=cuda_ms_b2b(simt, 3),
        sdpa_ms_b2b=cuda_ms_b2b(
            sdpa_fn(q, k, v, 0, mask=ragged_mask(kv_lens, dev)), 3))
    return out


def sdpa32_kernels(dev):
    """The names of the kernels SDPA launches in fp32 (TF32 off) at the
    hd-128 rows' shapes, forward and backward: the profiler's top three by
    device time."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, (b, s, h, kvh, hd) in (
            ("forward", SIMT_DENSE_SHAPES["128"][:5]),
            ("backward", SIMT_BWD_SHAPE)):
        q, k, v, do = (torch.randn(b, s, n, hd, generator=gen, device=dev)
                       for n in (h, kvh, kvh, h))
        fn = (sdpa_fn(q, k, v, 0) if name == "forward"
              else sdpa_grad_fns(q, k, v, do, 0)[0])
        fn()
        out[name] = [t["kernel"] for t in device_profile(fn, top=3)["top"]]
    return out


def fp32_model_path(dev, n_sm):
    """The path of a float32 model above flash_threshold, counts from 0
    before it and read after: ``flash_attention`` with a schedule at the
    main path's lanes in fp32, dense attention at recurrentgemma-2b's
    local-attention shape (hd 256, window 2048; forward and backward on
    the tensor cores' cluster pairs) forward and backward,
    then one loss and gradient of qwen3-4b and of
    qwen3-moe-30b-a3b (ragged dispatch) at full width, FP32_MODEL_LAYERS
    layers, compute_dtype "float32", on TRAIN_BATCH x TRAIN_S tokens.
    The peak allocated memory of that run, weights included.  Then,
    outside the counted run, the gradients against the plain attention's
    and the plain grouped matmul's."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models import attention as tattn
    from repro_torch.models import init_decoder
    from repro_torch.models import moe as tmoe
    from repro_torch.train import steps as tsteps

    gen = torch.Generator(device=dev).manual_seed(26)
    kv_lens = np.random.default_rng(0).integers(64, S + 1, size=B)
    q, k, v = (torch.randn(B, S, n, HD, generator=gen, device=dev)
               for n in (H, KVH, KVH))
    b, s, h, kvh, hd, window = SIMT_DENSE_SHAPES["256"]
    local = [torch.randn(b, s, n, hd, generator=gen, device=dev)
             for n in (h, kvh, kvh)]
    local_do = torch.randn(b, s, h, hd, generator=gen, device=dev)
    dense_cfg = dataclasses.replace(get_arch(ARCH), compute_dtype="float32",
                                    num_layers=FP32_MODEL_LAYERS)
    moe_cfg = dataclasses.replace(moe_train_cfg()[0], compute_dtype="float32",
                                  num_layers=FP32_MODEL_LAYERS)
    models = []
    for cfg in (dense_cfg, moe_cfg):
        params, _ = init_decoder(0, cfg, device=dev)
        batch = {k_: torch.from_numpy(x).to(dev) for k_, x in
                 train_batches(cfg, 1)[0].items()
                 if k_ in ("tokens", "labels")}
        models.append((cfg, params, batch))
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    attn = flash_attention(q, k, v, causal=True, schedule="fac2",
                           kv_lens=kv_lens, sched_p=n_sm)
    results = [tsteps._grads(params, batch["tokens"], batch["labels"], None,
                             cfg) for cfg, params, batch in models]
    torch.cuda.synchronize()
    # the seconds of the calls earlier trees timed; the hd-256 attention
    # is counted but not timed
    seconds = time.perf_counter() - t0
    leaves = [x.requires_grad_(True) for x in local]
    local_out = flash_attention(*leaves, causal=True, window=window)
    local_out.backward(local_do)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    launches = {n: kern.launches for n, kern in _build.KERNELS.items()
                if kern.launches}
    got = {n: launches.get(n, 0) for n in FP32_PATH_LAUNCHES}
    assert got == FP32_PATH_LAUNCHES, (got, launches)
    for n in FP32_PATH_GMM:
        assert launches.get(n, 0) > 0, (n, launches)
    assert bool(torch.isfinite(attn).all()) and attn.dtype == torch.float32
    assert all(bool(torch.isfinite(x.grad).all()) for x in leaves)
    del attn, q, k, v, local, leaves, local_out, local_do

    out = dict(seconds=seconds, launches=launches,
               peak_allocated_gb=peak / 1e9, models={})
    for (cfg, params, batch), (loss_k, _, grads_k) in zip(models, results):
        assert math.isfinite(float(loss_k)), cfg.name
        if cfg.family == "moe":
            real, swap = tmoe, ("_expert_matmul",
                                lambda xe, w: plain_grouped_matmul(
                                    xe, w, block_rows=BLOCK_ROWS))
        else:
            real, swap = tattn, ("flash_attention", plain_attention)
        saved = getattr(real, swap[0])
        setattr(real, swap[0], swap[1])
        try:
            loss_p, _, grads_p = tsteps._grads(params, batch["tokens"],
                                               batch["labels"], None, cfg)
            torch.cuda.synchronize()
        finally:
            setattr(real, swap[0], saved)
        rel = grads_agree(params, grads_k, grads_p)
        loss_diff = abs(float(loss_k) - float(loss_p))
        assert loss_diff <= TRAIN_LOSS_TOL, (cfg.name, loss_diff)
        out["models"][cfg.name] = dict(
            layers=cfg.num_layers, loss_kernel=float(loss_k),
            loss_plain=float(loss_p), loss_abs_diff=loss_diff,
            max_grad_rel_err=max(rel.values()))
        del grads_p
    del models, results
    torch.cuda.empty_cache()
    return out


def general_path(dev, n_sm):
    """What the tensor-core flash kernels leave to the general ones, counts
    from 0 before it and read after (GENERAL_PATH_LAUNCHES): at
    recurrentgemma-2b's local-attention shape in fp32
    (SIMT_DENSE_SHAPES["256"]), ``flash_attention`` with a schedule on
    ragged lanes (fac2, sched_p = SM count; the general kernel) and a
    dense call forward and backward under autograd on q, k, v views of one
    (b, s, h + 2 kvh, hd + 2) buffer, whose head stride TMA cannot
    describe (copied to TMA's layout, then the cluster pairs' kernels).
    Then the outputs against the plain versions at SIMT_FLASH_TOL, the
    dense call's bits against the route's kernels on contiguous copies,
    the general dense kernels launched directly on the same views against
    the plain versions, the copy (``tma_pack``) against its plain version
    and its times (``pack``), the times of the dense call, the general
    kernels and SDPA on those views (``packed``), the schedule-aware
    general kernel's row, and ``packed_sweep``.  Returns the launches
    (every key of GENERAL_PATH_LAUNCHES), the outputs' max abs errors, the
    rows and the sweep."""
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ops import flash_attention
    gen = torch.Generator(device=dev).manual_seed(30)
    b, s, h, kvh, hd, window = SIMT_DENSE_SHAPES["256"]
    kv_lens = np.random.default_rng(30).integers(64, s + 1, size=b)
    q, k, v = (torch.randn(b, s, n, hd, generator=gen, device=dev)
               for n in (h, kvh, kvh))
    buf = torch.randn(b, s, h + 2 * kvh, hd + 2, generator=gen, device=dev,
                      requires_grad=True)
    views = buf[..., :h, :hd], buf[..., h:h + kvh, :hd], \
        buf[..., h + kvh:, :hd]
    do = torch.randn(b, s, h, hd, generator=gen, device=dev)
    # the layout's route is still "simt"; the dense entry copies it
    assert fa._check_kernel_inputs("flash_dense", *views) == "simt"
    torch.cuda.synchronize()
    _build.reset_launches()
    ragged = flash_attention(q, k, v, causal=True, schedule="fac2",
                             kv_lens=kv_lens, sched_p=n_sm)
    dense = flash_attention(*views, causal=True, window=window)
    dense.backward(do)
    torch.cuda.synchronize()
    launches = {n: kern.launches for n, kern in _build.KERNELS.items()
                if kern.launches}
    assert launches == {n: c for n, c in GENERAL_PATH_LAUNCHES.items() if c}, \
        launches
    launches = {n: launches.get(n, 0) for n in GENERAL_PATH_LAUNCHES}
    plain = fa.flash_attention_sched_plain(
        *fa.broadcast_flatten(q, k, v), kv_lens=np.repeat(kv_lens, h),
        causal=True).reshape(b, h, s, hd).permute(0, 2, 1, 3)
    err = {"sched": check_tol("general sched", ragged, plain,
                              SIMT_FLASH_TOL)}
    views = [x.detach() for x in views]

    def dense_plain():
        return fa.flash_attention_dense_plain(
            *fa.broadcast_flatten(*views), causal=True,
            window=window).reshape(b, h, s, hd).permute(0, 2, 1, 3)

    def bwd_plain():
        return fa.flash_attention_dense_bwd_plain(*views, do, window=window)

    plain = dense_plain()
    err["dense"] = check_tol("general dense", dense.detach(), plain,
                             SIMT_FLASH_TOL)
    grads = bwd_plain()
    grad = buf.grad
    got = (grad[..., :h, :hd], grad[..., h:h + kvh, :hd],
           grad[..., h + kvh:, :hd])
    for name, g, want in zip(("dq", "dk", "dv"), got, grads):
        err[name] = check_tol(f"general {name}", g, want, SIMT_FLASH_TOL)
    # the route's kernels on contiguous copies (hd 256: no column to pad)
    # give the copied call's bits
    copies = [x.contiguous() for x in views]
    o_c, lse_c, _ = fa._flash_dense_packed(*copies, hd, causal=True,
                                           window=window, with_lse=True)
    assert torch.equal(o_c, dense.detach())
    for g, want in zip(fa._flash_dense_bwd_packed(
            *copies, o_c, do, lse_c, None, hd, causal=True, window=window),
            got):
        assert torch.equal(g, want)
    # the general kernels, which no route of the dense entry launches,
    # held to the plain versions on the same views by direct call
    stream = torch.cuda.current_stream(dev).cuda_stream
    o_s, lse_s, _ = fa._flash_dense_simt_cuda(*views, causal=True,
                                              window=window, with_lse=True)
    err["dense_simt"] = check_tol("general flash_dense_simt", o_s, plain,
                                  SIMT_FLASH_TOL)
    for name, g, want in zip(("dq_simt", "dk_simt", "dv_simt"),
                             fa._flash_simt_bwd_cuda(
                                 *copies, o_s, do, lse_s, causal=True,
                                 window=window, stream=stream), grads):
        err[name] = check_tol(f"general {name}", g, want, SIMT_FLASH_TOL)
    del ragged, dense, got, grad, copies, o_c, lse_c, o_s, lse_s, plain, \
        grads
    # the copy to TMA's layout alone: one launch for q, k and v, bit for
    # bit its plain version (torch's copy and fill), timed beside it
    before = fa.TMA_PACK.launches
    packs = fa._tma_pack(hd, *views)
    torch.cuda.synchronize()
    assert fa.TMA_PACK.launches == before + 1
    assert all(torch.equal(x, y) for x, y in
               zip(packs, fa.tma_pack_plain(hd, *views)))
    del packs
    pack = dict(pack_row(fa, views, hd), kernel="tma_pack", dtype="float32",
                max_abs_err=0.0, tolerance="bit-equal", shape=[b, s, h, kvh, hd],
                ms=cuda_ms(lambda: fa._tma_pack(hd, *views), REPS),
                plain_ms=cuda_ms(lambda: fa.tma_pack_plain(hd, *views), REPS),
                plain_ms_b2b=cuda_ms_b2b(
                    lambda: fa.tma_pack_plain(hd, *views), REPS),
                library_ms=None, bound_by="bytes")
    # the dense call's times on the views: the copy and the cluster
    # pairs' kernels, the copy alone, the general kernels, SDPA; its bound
    # the copy's bytes plus the kernels' three TF32 products each
    packed = {"forward": packed_fwd_times(fa, *views, window),
              "backward": packed_bwd_times(fa, *views, do, window)}
    pairs = live_pairs(s, window)
    for key, flops, plain_fn in (("forward", 4 * hd * b * h * pairs,
                                  dense_plain),
                                 ("backward", 10 * hd * b * h * pairs,
                                  bwd_plain)):
        row = packed[key]
        row.update(flops=flops, plain_ms=cuda_ms(plain_fn, 2),
                   bound_ms=row["pack"]["bound_ms"] + tf32x3_bound(flops),
                   bound_by="bytes and operations")
    # the schedule-aware call's general kernel timed at this shape, on a
    # plan made beforehand, beside SDPA fp32 with the boolean mask
    desc, plan = fa._plan_kv_descriptors(
        b * h, s, 512, 512, causal=True, window=0,
        kv_lens=np.repeat(kv_lens, h), schedule="fac2", p=n_sm)
    bounds = fa.descriptor_bounds(desc, plan)
    pairs = sum(h * int(np.minimum(np.arange(1, s + 1), lim).sum())
                for lim in kv_lens)
    sched_256 = measured(
        "flash_sched_simt", fa.FLASH_SCHED_SIMT,
        lambda: fa._flash_sched_simt_cuda(q, k, v, desc, bounds, block_q=512,
                                          block_k=512, causal=True,
                                          window=0),
        lambda: fa.flash_attention_sched_plain(
            *fa.broadcast_flatten(q, k, v), kv_lens=np.repeat(kv_lens, h),
            causal=True).reshape(b, h, s, hd).permute(0, 2, 1, 3),
        sdpa_fn(q, k, v, 0, mask=ragged_mask(kv_lens, dev)), 4 * hd * pairs,
        4 * (2 * b * s * h * hd
             + 2 * kvh * hd * int(np.minimum(kv_lens, s).sum())),
        torch.float32, SIMT_FLASH_TOL, reps=5)
    sched_256["shape"] = [b, s, h, kvh, hd]
    del q, k, v, buf, views, do
    torch.cuda.empty_cache()
    return dict(launches=launches, max_abs_err=err, sched_256=sched_256,
                pack=pack, packed=packed, packed_sweep=packed_sweep(dev))


def packed_sweep(dev):
    """The dense entry, forward and backward under autograd, on views TMA
    cannot describe at every head dim 1-256 in float32, bfloat16 and
    float16 (PACKED_SWEEP_SHAPE, causal, the window cycling through
    PACKED_SWEEP_WINDOWS; the layout cycling through q, k, v and dO heads
    hd + 2 apart, a base one element off 16 bytes, and a contiguous q with
    k and v heads hd + 2 apart): counts from 0 before each call, one launch
    of each pass of the route of the head dim rounded up to 8 and no other
    kernel but ``tma_pack``, once forward and once backward; the output
    and gradients the bits of the route's kernels on
    explicitly zero-padded contiguous copies (``_flash_dense_packed``,
    ``_flash_dense_bwd_packed``) and within the route's gate against the
    plain versions (fp32 SIMT_FLASH_TOL and fp16 FP16_FLASH_TOL
    elementwise; bf16 ATOL + RTOL |plain| for the output, BWD_REL_TOL max
    |plain| + 1e-5 for a gradient).  Returns the calls made and each
    dtype's largest error."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(33)
    b, s, h, kvh = PACKED_SWEEP_SHAPE
    sizes = (h, kvh, kvh, h)
    errs = {}

    def layout(i, dtype, hd):
        n = [b * s * x * hd for x in sizes]
        if i == 1:
            flat = torch.randn(sum(n) + 1, generator=gen,
                               device=dev).to(dtype)[1:]
            cuts = [sum(n[:j]) for j in range(5)]
            return [flat[a:z].view(b, s, x, hd)
                    for a, z, x in zip(cuts, cuts[1:], sizes)]
        xs = strided_views(gen, dev, dtype, b, s, h, kvh, hd)
        return ([x.contiguous() if j in (0, 3) else x
                 for j, x in enumerate(xs)] if i == 2 else list(xs))

    def pad(x, hd_pad):
        y = x.new_zeros(*x.shape[:3], hd_pad)
        y[..., :x.shape[3]] = x
        return y

    calls = 0
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        worst = 0.0
        for hd in range(1, 257):
            window = PACKED_SWEEP_WINDOWS[hd % len(PACKED_SWEEP_WINDOWS)]
            q, k, v, do = layout(hd % 3, dtype, hd)
            where = (str(dtype), hd, hd % 3)
            assert fa._check_kernel_inputs("flash_dense", q, k, v) == \
                "simt", where
            hd_pad = fa.tma_head_dim(hd)
            route = fa.flash_route(dtype, hd_pad)
            want = dict.fromkeys(
                ("flash_dense", "flash_dense_bwd_delta",
                 "flash_dense_bwd_dkdv", "flash_dense_bwd_dq")
                if route == "wgmma" else
                (fa.FLASH_DENSE_BY_ROUTE[route].name, "flash_simt_bwd_delta",
                 *(x.name for x in fa.FLASH_F32_BWD_BY_ROUTE[route])), 1)
            want["tma_pack"] = 2
            leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
            torch.cuda.synchronize()
            _build.reset_launches()
            out = fa.flash_attention_dense_bshd(*leaves, causal=True,
                                                window=window)
            out.backward(do)
            torch.cuda.synchronize()
            out = out.detach()
            launches = {n: kern.launches for n, kern in _build.KERNELS.items()
                        if kern.launches}
            assert launches == want, (where, launches)
            padded = [pad(x, hd_pad) for x in (q, k, v)]
            o_p, lse_p, o_lo = fa._flash_dense_packed(
                *padded, hd, causal=True, window=window, with_lse=True)
            grads_p = fa._flash_dense_bwd_packed(
                *padded, pad(o_p, hd_pad), pad(do, hd_pad), lse_p, o_lo, hd,
                causal=True, window=window)
            grads = [x.grad for x in leaves]
            assert torch.equal(out, o_p), where
            assert all(torch.equal(g, w) for g, w in zip(grads, grads_p)), \
                where
            plain = fa.flash_attention_dense_plain(
                *(x.float() for x in fa.broadcast_flatten(q, k, v)),
                causal=True, window=window).reshape(
                    b, h, s, hd).permute(0, 2, 1, 3)
            plain_grads = fa.flash_attention_dense_bwd_plain(
                q, k, v, do, window=window)
            if dtype == torch.bfloat16:
                worst = max(worst, check_tol(f"packed {where}", out, plain,
                                             ATOL))
                for g, w in zip(grads, plain_grads):
                    e = float((g.float() - w).abs().max())
                    assert e <= BWD_REL_TOL * float(w.abs().max()) + 1e-5, \
                        (where, e)
                    worst = max(worst, e)
            else:
                tol = (SIMT_FLASH_TOL if dtype == torch.float32
                       else FP16_FLASH_TOL)
                for g, w in zip((out, *grads), (plain, *plain_grads)):
                    worst = max(worst, check_tol(f"packed {where}", g, w,
                                                 tol))
            calls += 1
        errs[str(dtype).replace("torch.", "")] = worst
    return dict(calls=calls, max_abs_err=errs)


def phase_kernels_any_dtype(dev, n_sm):
    """The general kernels against their plain versions at every dtype and
    shape of this slice, the off-block path (counted), fp32 flash, fp16
    flash (counted), the fp32 model path (counted), then the general
    kernels' path (counted).  Returns the rows and the paths' launch
    counts."""
    import torch
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gmm_rows = simt_gmm_rows(dev, n_sm)
    digest = gmm_digest(dev)
    assert digest == PARENT_GMM_DIGEST, (digest, PARENT_GMM_DIGEST)
    off_block = off_block_path(dev, n_sm)
    flash_rows = simt_flash_rows(dev, n_sm)
    fp16_rows = fp16_flash_rows(dev, n_sm)
    model = fp32_model_path(dev, n_sm)
    general = general_path(dev, n_sm)
    emit("kernels_any_dtype", seconds=time.perf_counter() - t0,
         gmm=gmm_rows, gmm_digest=digest,
         gmm_digest_parent=PARENT_GMM_DIGEST, off_block_path=off_block,
         flash=flash_rows, flash_fp16=fp16_rows, model_path=model,
         general_path=general)
    return (gmm_rows, flash_rows, fp16_rows, model["launches"],
            off_block["launches"], general)


EXAMPLE_RUNNER = """
import json, runpy, sys, time
sys.path.insert(0, 'src')
import torch
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.grouped_matmul import grouped_matmul
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
path, prof = sys.argv[1], sys.argv[2] == '1'
sys.argv = [path]
_build.reset_launches()
t0 = time.perf_counter()
if prof:
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        runpy.run_path(path, run_name='__main__')
        torch.cuda.synchronize()
else:
    runpy.run_path(path, run_name='__main__')
    torch.cuda.synchronize()
res = {'seconds': time.perf_counter() - t0,
       'launches': {n: k.launches for n, k in _build.KERNELS.items()
                    if k.launches}}
if prof:
    res['device_kernels'] = {
        ev.key[:120]: ev.count for ev in p.key_averages()
        if ev.device_type == DeviceType.CUDA}
print('EXAMPLE_RESULT ' + json.dumps(res), flush=True)
"""


def example_numbers(name, lines):
    """The key numbers an example prints, parsed from its lines."""
    import re
    text = "\n".join(lines)

    def grab(pattern, cast=float):
        m = re.search(pattern, text)
        return cast(m.group(1)) if m else None

    steps = re.findall(r"^step (\d+) loss=([0-9.]+)", text, re.M)
    out = {"lines": len(lines)}
    if steps:
        out["last_logged_step"], out["last_logged_loss"] = \
            int(steps[-1][0]), float(steps[-1][1])
    if name == "torch_train_100m":
        out["first10"] = grab(r"first10=([0-9.]+)")
        out["last10"] = grab(r"last10=([0-9.]+)")
        out["checkpoints"] = grab(r"checkpoints: (\[[0-9, ]*\])", json.loads)
    elif name == "torch_elastic_restart":
        out["phase1_checkpoints"] = grab(
            r"phase 1 checkpoints: (\[[0-9, ]*\])", json.loads)
        out["resumed_at"] = grab(r"resumed at step (\d+)", int)
        out["final_shares"] = grab(r"final shares=(\[[0-9, ]*\])",
                                   json.loads)
    elif name == "torch_serve_demo":
        out["tokens_per_s"] = grab(r"\((\d+) tok/s on")
        out["decode_s"] = grab(r"tokens in ([0-9.]+)s")
    elif name == "torch_moe_balance_demo":
        out["kernel_pi_percent"] = grab(r"kernel p\.i\. ([0-9.]+)%")
        out["peak_over_mean_last"] = float(re.findall(
            r"^\s*\d+\s+([0-9.]+)$", text, re.M)[-1])
    elif name == "torch_quickstart":
        out["runtime_line"] = grab(r"(schedule\(runtime\) -> .*)", str)
    return out


def dryrun_collectives(coll):
    """The dry run's collectives record, without the per-kind bytes."""
    return dict(n_ops=coll["n_ops"],
                total_wire_bytes=coll["total_wire_bytes"],
                total_result_bytes=coll["total_result_bytes"],
                counts={k: v["count"] for k, v in coll["ops"].items()})


def dryrun_cell(arch, shape, multi_pod, variant, layers):
    """One dry-run cell (``repro_torch.launch.dryrun.measure``) on meta
    shards over the fake group, ``layers`` of the arch's layers at full
    width (None: all): the record's fields, and the production run's
    FLOPs and collectives beside the one-microbatch run's."""
    import dataclasses
    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.launch import dryrun
    cfg = dryrun.variant_config(get_arch(arch), variant)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    t0 = time.perf_counter()
    m = dryrun.measure(cfg, SHAPES[shape], multi_pod=multi_pod,
                       variant=variant)
    return dict(arch=arch, shape=shape, mesh="pod2" if multi_pod else "pod1",
                variant=variant, layers=f"{cfg.num_layers} of "
                f"{get_arch(arch).num_layers}", status="ok",
                chips=m["chips"], microbatches=m["microbatches"],
                seconds=time.perf_counter() - t0, step_s=m["seconds"],
                flops=m["flops"], memory=m["memory"],
                collectives=dryrun_collectives(m["collectives"]),
                production=dict(flops=m["production"]["flops"],
                                collectives=dryrun_collectives(
                                    m["production"]["collectives"])))


def dryrun_card_cell(dev):
    """Rank 0 of the 16 x 16 mesh with every local shard on the card:
    qwen3-4b train_4k at DRYRUN_CARD_LAYERS layers, one step at the
    production microbatch count (``dryrun.run_step``)."""
    import dataclasses
    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.launch import dryrun
    cfg = dataclasses.replace(get_arch("qwen3-4b"),
                              num_layers=DRYRUN_CARD_LAYERS)
    shape = SHAPES["train_4k"]
    t0 = time.perf_counter()
    with dryrun.cell_mesh(cfg, device=dev) as (mesh, rules):
        mb = dryrun.production_microbatches(cfg, shape, mesh)
        r = dryrun.run_step(cfg, shape, mesh, rules, num_microbatches=mb,
                            device=dev)
    return dict(arch="qwen3-4b", shape="train_4k", mesh="pod1",
                variant="baseline", layers=f"{cfg.num_layers} of "
                f"{get_arch('qwen3-4b').num_layers}", microbatches=mb,
                seconds=time.perf_counter() - t0, step_s=r["seconds"],
                flops=r["flops"], memory=r["memory"],
                collectives=dryrun_collectives(r["collectives"]))


def dryrun_flash_check(dev, b=64, s=4096, seed=0):
    """The card cell's sharded flash attention held to its plain version
    on rank 0's shards: ``attention._flash_sharded`` on DTensors over the
    fake group of the 16 x 16 mesh at qwen3-4b's heads, q (b, s, 32, 128)
    sharded by batch and head (local (b / 16, s, 2, 128)), k and v (b, s,
    8, 128) replicated over the model axis, so that the local path reads
    kv head 0 as a ``[:, :, 0:1]`` view and returns a partial dK / dV;
    seeded random bf16.  The output within ATOL + RTOL |plain|; dQ and
    dK / dV of kv head 0 within BWD_REL_TOL of max |plain|, the other kv
    heads' zero.  The shards are laid out as the kernel takes them, so
    no collective runs (the fake group moves no data)."""
    import dataclasses
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.launch import dryrun
    from repro_torch.models import attention
    cfg = dataclasses.replace(get_arch("qwen3-4b"), num_layers=1)
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator().manual_seed(seed)
    with dryrun.cell_mesh(cfg, device=dev) as (mesh, _):
        nb, nh = b // mesh.size(0), h // mesh.size(1)
        ql, kl, vl, dol = (torch.randn((nb, s, n, hd), generator=gen)
                           .to(dev, torch.bfloat16)
                           for n in (nh, kvh, kvh, nh))
        qpl, kvpl = [Shard(0), Shard(2)], [Shard(0), Replicate()]

        def dt(x, placements, heads, grad=True):
            shape = (b, s, heads, hd)
            t = DTensor.from_local(x, mesh, placements, run_check=False,
                                   shape=shape, stride=(s * heads * hd,
                                                        heads * hd, hd, 1))
            return t.detach().requires_grad_() if grad else t

        q, k, v = dt(ql, qpl, h), dt(kl, kvpl, kvh), dt(vl, kvpl, kvh)
        out = attention._flash_sharded(q, k, v, 0)
        assert tuple(out.placements) == tuple(qpl), out.placements
        out.backward(dt(dol, qpl, h, grad=False))
        got = out.to_local().detach()
        grads = [x.grad.to_local() for x in (q, k, v)]
    kv0, vv0 = kl[:, :, 0:1], vl[:, :, 0:1]
    errors = {"out": check_close("dryrun flash_dense", got,
                                 plain_attention(ql, kv0, vv0))}
    want = fa.flash_attention_dense_bwd_plain(ql, kv0, vv0, dol)
    for nm, x, y in zip(("dq", "dk", "dv"), grads, want):
        if nm != "dq":
            assert not bool(x[:, :, 1:].any()), f"{nm}: other kv heads"
            x = x[:, :, 0:1]
        top = float(y.abs().max())
        err = float((x.float() - y).abs().max())
        errors[nm] = {"max_abs_err": err, "max_abs_plain": top,
                      "rel": err / top}
        assert err <= BWD_REL_TOL * top, (nm, err, top)
    return dict(q_local=list(ql.shape), kv_local=list(kl.shape),
                kv_read="[:, :, 0:1]", errors=errors,
                tolerance=f"fwd {ATOL} + {RTOL}*|plain|; bwd "
                          f"{BWD_REL_TOL}*max|plain| per gradient")


def phase_dryrun(dev):
    """The multi-pod dry run (``repro_torch.launch.dryrun``) on the card's
    machine: DRYRUN_META_CELLS on meta shards over the fake group, then
    the card cell (``dryrun_card_cell``): counts from 0 just before it and
    read just after, and exactly DRYRUN_CARD_LAUNCHES; its collectives
    and tracked peak those of its meta twin's production run (the first
    meta cell), its ``max_memory_allocated`` beside them; then its flash
    attention on rank 0's shards against the plain version
    (``dryrun_flash_check``).  The fake group moves no data, so the card
    cell's values gate nothing.  Returns the card cell's launches."""
    import torch
    from repro_torch.kernels import _build
    import traceback
    t0 = time.perf_counter()
    cells = []
    for cell in DRYRUN_META_CELLS:
        try:
            cells.append(dryrun_cell(*cell))
        except Exception as e:          # every cell runs; the phase fails
            print(traceback.format_exc(), file=sys.stderr, flush=True)
            cells.append(dict(zip(("arch", "shape", "multi_pod", "variant",
                                   "layers"), cell), status="error",
                              error=f"{type(e).__name__}: {e}"[:2000]))
    assert DRYRUN_META_CELLS[0] == ("qwen3-4b", "train_4k", False,
                                    "baseline", DRYRUN_CARD_LAYERS)
    meta = cells[0]
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    _build.reset_launches()
    card = dryrun_card_cell(dev)
    torch.cuda.synchronize()
    launches = {n: kern.launches for n, kern in _build.KERNELS.items()
                if kern.launches}
    card.update(launches=launches,
                max_memory_allocated=torch.cuda.max_memory_allocated(dev)
                - base,
                meta_argument_bytes=meta.get("memory", {}).get(
                    "argument_size_in_bytes"),
                meta_peak_bytes=meta.get("memory", {}).get(
                    "peak_memory_in_bytes"))
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    flash = dryrun_flash_check(dev)
    flash["seconds"] = time.perf_counter() - t1
    torch.cuda.empty_cache()
    emit("dryrun", seconds=time.perf_counter() - t0, cells=cells, card=card,
         flash_check=flash,
         note="fake process group: no data moves; the card cell's values "
              "are not checked, its flash attention is (flash_check); "
              "meta cells and the card cell at the depth given in layers")
    assert all(c["status"] == "ok" for c in cells), [
        c["error"] for c in cells if c["status"] != "ok"]
    assert launches == DRYRUN_CARD_LAUNCHES, launches
    assert card["collectives"] == meta["production"]["collectives"], (
        card["collectives"], meta["production"]["collectives"])
    assert (card["memory"]["argument_size_in_bytes"],
            card["memory"]["peak_memory_in_bytes"]) == (
        card["meta_argument_bytes"], card["meta_peak_bytes"]), card
    return launches


def dryrun_alone(dev):
    """The dryrun phase and the general path (with flash_sched_simt timed
    at hd 256) after building the kernels, TF32 off."""
    import torch
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    return dict(dryrun_launches=phase_dryrun(dev),
                general_path=general_path(dev, n_sm))


def phase_examples(dev):
    """The seven example twins on the card, each in its own process at its
    default arguments, launch counts from 0 at its start and read at its
    end.  The host demos (EXAMPLES_TOGETHER: the simulator, the planners,
    the cluster layer; ~9 s of each process is its start) run at the same
    time, the others one after another.  moe_balance_demo runs under
    ``torch.profiler``: its two grouped matmuls are two launches of the
    general kernel, no plain version.  The checkpoint directories of
    train_100m and elastic_restart are made anew in the temporary
    directory and removed after."""
    import os
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    del dev
    rows = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    env = dict(os.environ, TMPDIR=tmp)

    def run(name):
        prof = name == "torch_moe_balance_demo"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", EXAMPLE_RUNNER,
             str(ROOT / "examples" / f"{name}.py"), "1" if prof else "0"],
            cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=EXAMPLE_TIMEOUT_S)
        wall = time.perf_counter() - t0
        assert proc.returncode == 0, (name, proc.stderr[-3000:])
        lines = proc.stdout.splitlines()
        res = json.loads(lines[-1].removeprefix("EXAMPLE_RESULT "))
        row = dict(exit_code=proc.returncode, wall_s=wall,
                   run_s=res["seconds"], launches=res["launches"],
                   together=name in EXAMPLES_TOGETHER,
                   **example_numbers(name, lines[:-1]))
        if prof:
            gmm = {k: c for k, c in res["device_kernels"].items()
                   if "gmm" in k}
            assert sum(gmm.values()) == 2 and all(
                "gmm_f32_kernel" in k for k in gmm), gmm
            assert res["launches"].get("gmm_simt") == 2, res["launches"]
            row["gmm_kernels_profiled"] = gmm
        rows[name] = row

    try:
        with ThreadPoolExecutor(len(EXAMPLES_TOGETHER)) as pool:
            for fut in [pool.submit(run, n) for n in EXAMPLES_TOGETHER]:
                fut.result()
        for name in EXAMPLES:
            if name not in EXAMPLES_TOGETHER:
                run(name)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("examples", **{n: rows[n] for n in EXAMPLES})
    return rows


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    # --dense-digest / --hd80-digest / --sched-digest / --dense-times /
    # --bwd-times / --moe-bwd-times / --yardsticks / --serve-times /
    # --gmm-digest / --gmm-times / --flash32-digest / --flash32-times /
    # --sdpa32-kernels / --bwd-digest / --flash16-times / --dryrun [SRC]:
    # print only that function's result
    # for the package under SRC (default: this checkout's src), to hold two
    # trees' builds against each other
    modes = {"--dense-digest": dense_digest, "--hd80-digest": hd80_digest,
             "--sched-digest": sched_digest, "--dense-times": dense_times,
             "--bwd-times": bwd_times, "--moe-bwd-times": moe_bwd_times,
             "--yardsticks": yardsticks, "--serve-times": serve_times,
             "--gmm-digest": gmm_digest, "--gmm-times": gmm_times,
             "--flash32-digest": flash32_digests,
             "--flash32-times": flash32_times,
             "--sdpa32-kernels": sdpa32_kernels,
             "--bwd-digest": bwd_digest, "--flash16-times": flash16_times,
             "--dryrun": dryrun_alone}
    mode = modes.get(argv[0]) if argv else None
    src = ROOT / "src"
    if mode is not None and len(argv) > 1:
        src = Path(argv[1]).resolve()
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} is missing; run "
              "from a checkout of the repository", file=sys.stderr)
        return 3
    sys.path.insert(0, str(src))
    if mode is not None:
        print(json.dumps({mode.__name__: mode(torch.device("cuda", 0)),
                          "src": str(src)}), flush=True)
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for log in _build.build_info().get("logs", {}).values()
             for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit("env", gpu=smi, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], sm_count=n_sm,
         build_seconds=build_s, ptxas=ptxas)

    import numpy as np
    from repro_torch.balance.moe import plan_tiles
    from repro_torch.core import REGISTRY, LoopRecorder
    from repro_torch.core.torch_sched import worker_bounds
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.grouped_matmul import grouped_matmul as gm
    from repro_torch.kernels.grouped_matmul.ops import grouped_matmul
    from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref

    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)

    def randn(*shape, scale=1.0):
        x = torch.randn(*shape, generator=gen, device=dev,
                        dtype=torch.float32) * scale
        return x.to(torch.bfloat16)

    # ---- inputs ------------------------------------------------------------
    q = randn(B, S, H, HD)
    k = randn(B, S, KVH, HD)
    v = randn(B, S, KVH, HD)
    kv_lens = rng.integers(64, S + 1, size=B)
    kv_lens[0] = S
    counts = np.bincount((rng.zipf(1.3, size=E * C // 2) - 1) % E,
                         minlength=E)
    expert_rows = np.minimum(counts, C)
    live = torch.arange(C, device=dev)[None, :] < torch.as_tensor(
        expert_rows, device=dev)[:, None]
    xe = randn(E, C, D_MODEL) * live[:, :, None]
    wi = randn(E, D_MODEL, D_FF, scale=D_MODEL ** -0.5)
    wo = randn(E, D_FF, D_MODEL, scale=D_FF ** -0.5)
    torch.cuda.synchronize()

    # ---- main path: counts from 0, the calls a user makes, counts read ----
    rec = LoopRecorder()
    _build.reset_launches()
    t0 = time.perf_counter()
    attn = flash_attention(q, k, v, causal=True, schedule="fac2",
                           kv_lens=kv_lens, sched_p=n_sm, recorder=rec)
    attn_p8 = flash_attention(q, k, v, causal=True, schedule="fac2",
                              kv_lens=kv_lens, sched_p=8, recorder=rec)
    hid = grouped_matmul(xe, wi, schedule="fac2", expert_rows=expert_rows,
                         block_rows=BLOCK_ROWS, sched_p=n_sm, recorder=rec)
    act = torch.nn.functional.silu(hid.float()).to(torch.bfloat16)
    ffn = grouped_matmul(act, wo, schedule="fac2", expert_rows=expert_rows,
                         block_rows=BLOCK_ROWS, sched_p=n_sm, recorder=rec)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {n: kern.launches for n, kern in _build.KERNELS.items()}
    assert launches["flash_sched"] > 0 and launches["gmm"] > 0, launches
    for name, out, shape in (("attn", attn, (B, S, H, HD)),
                             ("ffn", ffn, (E, C, D_MODEL))):
        assert tuple(out.shape) == shape, (name, out.shape)
        assert bool(torch.isfinite(out).all()), f"{name} is not finite"
    assert torch.equal(attn, attn_p8), "sched_p=SM and sched_p=8 differ"
    assert len(rec.records) == 4 and [r.loop for r in rec.records] == [
        "flash_kv", "flash_kv", "grouped_matmul", "grouped_matmul"]
    emit("main_path", seconds=main_s, launches=launches,
         records=[{"loop": r.loop, "technique": r.technique, "p": r.p,
                   "n": r.n, "n_chunks": r.n_chunks,
                   "percent_imbalance": r.percent_imbalance}
                  for r in rec.records])

    # ---- small ragged shapes against the plain oracles -------------------
    small = {}
    for bs, ss, hs, kvhs, hd, win, bq, lens, strided in (
            (2, 300, 4, 2, 128, 0, 128, None, False),
            (3, 200, 2, 1, 64, 70, 64, None, False),
            (1, 96, 2, 2, 128, 0, 512, None, False),
            # a 128-column tile spans two 64-column kv blocks
            (2, 300, 4, 2, 128, 0, 64, None, False),
            # a window narrower than a tile, MQA
            (2, 300, 4, 1, 128, 32, 128, None, False),
            # one row past a tile; a lane of kv_len 0 (zeros)
            (3, 129, 4, 2, 128, 0, 128, [0, 129, 77], False),
            # q, k, v strided from one (b, s, 3, h, hd) buffer
            (2, 300, 4, 2, 64, 0, 128, None, True),
            # head dims 32 (padded to 64), 80 (its exact width) and 256
            # (64-column kv tiles): GQA, windowed MQA, one row past a tile
            (2, 300, 4, 2, 32, 0, 128, None, False),
            (2, 300, 4, 1, 80, 40, 64, None, False),
            (2, 129, 4, 2, 256, 0, 128, None, False),
            (2, 333, 10, 1, 256, 100, 128, None, False)):
        if strided:
            buf = randn(bs, ss, 3, hs, hd)
            qs, ks, vs = buf[:, :, 0], buf[:, :, 1, :kvhs], buf[:, :, 2, :kvhs]
        else:
            qs, ks, vs = randn(bs, ss, hs, hd), randn(bs, ss, kvhs, hd), \
                randn(bs, ss, kvhs, hd)
        lens = (rng.integers(1, ss + 1, size=bs) if lens is None
                else np.asarray(lens))
        got = flash_attention(qs, ks, vs, causal=True, window=win,
                              block_q=bq, block_k=bq, schedule="gss",
                              kv_lens=lens, sched_p=5)
        qf, kf, vf = fa.broadcast_flatten(qs, ks, vs)
        want = attention_ref(qf, kf, vf, causal=True, window=win,
                             kv_lens=np.repeat(lens, hs))
        want = want.reshape(bs, hs, ss, hd).permute(0, 2, 1, 3)
        key = f"flash_s{ss}_hd{hd}_w{win}_b{bq}" + ("_strided" if strided
                                                    else "")
        small[key] = check_close("flash small", got, want)
    es, cs, ds, fs = 4, 256, 96, 256
    xs, ws = randn(es, cs, ds), randn(es, ds, fs, scale=ds ** -0.5)
    rows = np.array([256, 0, 130, 7])
    got = grouped_matmul(xs, ws, schedule="fac2", expert_rows=rows,
                         block_rows=128, sched_p=3)
    tpe = cs // 128
    want = grouped_matmul_ref(xs.reshape(es * tpe, 128, ds), ws,
                              torch.arange(es * tpe, device=dev) // tpe)
    small["gmm_e4"] = check_close("gmm small", got,
                                  want.reshape(es, cs, fs))
    emit("small", max_abs_err=small)

    # ---- flash_sched at the main path's shapes ---------------------------
    qf, kf, vf = fa.broadcast_flatten(q, k, v)
    lane_lens = np.repeat(kv_lens, H)
    plain = fa.flash_attention_sched_plain(qf, kf, vf, kv_lens=lane_lens,
                                           causal=True)
    plain = plain.reshape(B, H, S, HD).permute(0, 2, 1, 3)
    flash_err = check_close("flash_sched", attn, plain)
    del plain
    for sched in IDENTITY_SCHEDULES:
        out = flash_attention(q, k, v, schedule=sched, kv_lens=kv_lens,
                              sched_p=n_sm)
        assert torch.equal(out, attn), f"flash output differs for {sched}"
    s_small = 1024
    qs, ks, vs = q[:, :s_small].contiguous(), k[:, :s_small].contiguous(), \
        v[:, :s_small].contiguous()
    lens_small = np.minimum(kv_lens, s_small)
    base = None
    for tech in REGISTRY:
        out = flash_attention(qs, ks, vs, schedule=tech, kv_lens=lens_small,
                              sched_p=n_sm)
        base = out if base is None else base
        assert torch.equal(out, base), f"flash output differs for {tech}"

    def flash_plan(schedule, p):
        d, pl = fa._plan_kv_descriptors(
            B * H, S, 512, 512, causal=True, window=0, kv_lens=lane_lens,
            schedule=schedule, p=p)
        return d, fa.descriptor_bounds(d, pl), pl

    def flash_kernel(schedule, p):
        d, bd, _ = flash_plan(schedule, p)
        return lambda: fa._flash_sched_cuda(
            q, k, v, d, bd, block_q=512, block_k=512, causal=True, window=0)

    def flash_kernel_ms(schedule, p, n):
        return cuda_ms(flash_kernel(schedule, p), n)

    desc, bounds, plan = flash_plan("fac2", n_sm)
    plan8 = flash_plan("fac2", 8)[2]
    flash_ms = flash_kernel_ms("fac2", n_sm, REPS)
    flash_ms_b2b = cuda_ms_b2b(flash_kernel("fac2", n_sm), REPS)
    tiles, tiles_cta = sched_tiles(desc, bounds, 512, 512)
    # probe: self-scheduling (one group a chunk) balances this plan to
    # within 1%, so it shows the kernel's rate apart from fac2's balance
    desc_ss, bounds_ss, plan_ss = flash_plan("ss", n_sm)
    tiles_cta_ss = sched_tiles(desc_ss, bounds_ss, 512, 512)[1]
    flash_ms_b2b_ss = cuda_ms_b2b(flash_kernel("ss", n_sm), REPS)
    flash_ms_static = flash_kernel_ms("static", n_sm, REPS)
    flash_ms_p8 = flash_kernel_ms("fac2", 8, max(3, REPS // 4))
    flash_ms_p8_static = flash_kernel_ms("static", 8, max(3, REPS // 4))
    call_ms = cuda_ms(lambda: flash_attention(
        q, k, v, schedule="fac2", kv_lens=kv_lens, sched_p=n_sm), REPS)
    plan_split = plan_split_ms(fa, lane_lens, n_sm, dev)
    plain_ms = cuda_ms(lambda: fa.flash_attention_sched_plain(
        qf, kf, vf, kv_lens=lane_lens, causal=True), 3)
    del qf, kf, vf
    # yardstick only: one PyTorch call for the same function
    run_sdpa = sdpa_fn(q, k, v, 0, mask=ragged_mask(kv_lens, dev))
    library_ms = cuda_ms(run_sdpa, REPS)
    sdpa_err = float((run_sdpa().permute(0, 2, 1, 3).float()
                      - attn.float()).abs().max())
    del run_sdpa
    pairs = sum(H * int(np.minimum(np.arange(1, S + 1), lim).sum())
                for lim in kv_lens)
    flash_flops = 4 * HD * pairs
    flash_bytes = 2 * (2 * B * S * H * HD
                       + 2 * KVH * HD * int(np.minimum(kv_lens, S).sum()))
    flash_bound = 1e3 * max(flash_flops / PEAK_BF16_FLOPS,
                            flash_bytes / PEAK_BYTES)
    flash_bound_fp32_pv = bound(flash_flops * 3 // 2, flash_bytes)[0]
    sched_by_head_dim = {str(hd): sched_full_shape(dev, randn, hd, kv_lens,
                                                   n_sm)
                         for hd in SCHED_WIDE_HEAD_DIMS}
    emit("flash_sched", shape=[B, S, H, KVH, HD], kv_lens=kv_lens.tolist(),
         max_abs_err=flash_err, sdpa_max_abs_diff=sdpa_err,
         identical_schedules=list(IDENTITY_SCHEDULES),
         identical_techniques_s1024=len(REGISTRY),
         ms=flash_ms, ms_b2b=flash_ms_b2b, ms_static=flash_ms_static,
         ms_sched_p8=flash_ms_p8, ms_sched_p8_static=flash_ms_p8_static,
         call_ms_with_planning=call_ms, plan_split_ms=plan_split,
         live_tiles=tiles, live_tiles_max_cta=tiles_cta,
         us_per_tile_max_cta=1e3 * flash_ms_b2b / tiles_cta,
         ms_b2b_ss=flash_ms_b2b_ss, live_tiles_max_cta_ss=tiles_cta_ss,
         percent_imbalance_ss=plan_ss.percent_imbalance,
         plain_ms=plain_ms, library_ms=library_ms, bound_ms=flash_bound,
         bound_ms_fp32_pv=flash_bound_fp32_pv, flops=flash_flops, bytes=flash_bytes, groups=int(plan.n),
         descriptors=int(desc[0].shape[0]),
         percent_imbalance=plan.percent_imbalance,
         percent_imbalance_p8=plan8.percent_imbalance,
         by_head_dim=sched_by_head_dim)

    # ---- gmm at the main path's shapes (wi and wo) -----------------------
    gmm_rows = {}
    for name, x, w, y in (("wi", xe, wi, hid), ("wo", act, wo, ffn)):
        e_, c_, d_ = x.shape
        f_ = w.shape[2]
        tpe = c_ // BLOCK_ROWS
        x_tiles = x.reshape(e_ * tpe, BLOCK_ROWS, d_)
        tile_expert = torch.arange(e_ * tpe, device=dev,
                                   dtype=torch.int32) // tpe
        plain = gm.grouped_matmul_tiles_plain(x_tiles, w, tile_expert)
        err = check_close(f"gmm {name}", y, plain.reshape(e_, c_, f_))
        del plain
        for sched in ("static", "ss", "gss", "awf_b", "dls_steal"):
            out = grouped_matmul(x, w, schedule=sched,
                                 expert_rows=expert_rows,
                                 block_rows=BLOCK_ROWS, sched_p=n_sm)
            assert torch.equal(out, y), f"gmm {name} differs for {sched}"
        for kw in ({"schedule": "fac2", "expert_rows": expert_rows,
                    "sched_p": 8}, {"sched_p": n_sm}):
            out = grouped_matmul(x, w, block_rows=BLOCK_ROWS, **kw)
            assert torch.equal(out, y), f"gmm {name} differs for {kw}"
        xt = x_tiles.contiguous()

        def gmm_kernel(schedule):
            order, gp = plan_tiles(expert_rows, BLOCK_ROWS, p=n_sm,
                                   technique=schedule, capacity_rows=c_,
                                   return_plan=True)
            gb = worker_bounds(gp.step_worker, n_sm)
            return (lambda: gm.gmm_cuda(xt, w, tile_expert, order, gb,
                                        gp.n)), gp

        run_fac2, gplan = gmm_kernel("fac2")
        ms = cuda_ms(run_fac2, REPS)
        ms_static = cuda_ms(gmm_kernel("static")[0], REPS)
        # back to back, so that the wrapper's host work drops out: the fac2
        # order; the identity order split into n_sm spans (an expert's tiles
        # one after another on one CTA); the same with every tile on expert
        # 0, whose weights then stay in L2 (another function: timing only)
        t_ = e_ * tpe
        ident = (np.arange(t_, dtype=np.int32), gm.span_bounds(t_, n_sm), t_)
        expert0 = torch.zeros_like(tile_expert)
        ms_b2b = {
            "fac2": cuda_ms_b2b(run_fac2, REPS),
            "identity": cuda_ms_b2b(
                lambda: gm.gmm_cuda(xt, w, tile_expert, *ident), REPS),
            "identity_expert0": cuda_ms_b2b(
                lambda: gm.gmm_cuda(xt, w, expert0, *ident), REPS)}
        p_ms = cuda_ms(lambda: gm.grouped_matmul_tiles_plain(
            xt, w, tile_expert), 3)
        lib_ms = cuda_ms(lambda: torch.bmm(x, w), REPS)
        # every tile, live or dead, as the TPU kernel's CostEstimate counts
        # it: the kernel and torch.bmm both compute the dead tiles too
        rows_all = e_ * c_
        flops = 2 * rows_all * d_ * f_
        nbytes = 2 * (rows_all * d_ + e_ * d_ * f_ + rows_all * f_)
        gmm_rows[name] = dict(
            max_abs_err=err, ms=ms, ms_static=ms_static, ms_b2b=ms_b2b,
            plain_ms=p_ms, library_ms=lib_ms,
            library_ms_b2b=cuda_ms_b2b(lambda: torch.bmm(x, w), REPS),
            bound_ms=1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES),
            flops=flops, bytes=nbytes, live_tiles=int(gplan.n),
            tiles=int(e_ * tpe), percent_imbalance=gplan.percent_imbalance)
    emit("gmm", expert_rows=expert_rows.tolist(), shapes={
        "wi": [E, C, D_MODEL, D_FF], "wo": [E, C, D_FF, D_MODEL]},
        **gmm_rows)

    def total(key):
        return sum(r[key] for r in gmm_rows.values())

    # ---- this slice: the dense kernel, prefill and serving of qwen3-4b ----
    del q, k, v, xe, wi, wo, hid, act, ffn, attn, attn_p8, live
    torch.cuda.empty_cache()
    dense = phase_flash_dense(dev, randn)
    from repro_torch.configs import get_arch
    from repro_torch.models import init_decoder
    cfg = get_arch(ARCH)
    params, _ = init_decoder(0, cfg, device=dev)
    prefill_launches = phase_prefill(dev, cfg, params)
    phase_serve(dev, cfg, params)
    cluster_dense = phase_cluster_dense(dev, cfg, params)
    del params
    torch.cuda.empty_cache()

    # ---- this slice: the MoE and recurrent families --------------------
    moe_cfg, moe_params, moe_launches, gmm_model = phase_moe_prefill(
        dev, n_sm, randn)
    serve_launches = phase_moe_serve(dev, moe_cfg, moe_params)
    cluster_launches, cluster_gmm_err = phase_cluster(
        dev, cluster_dense, moe_cfg, moe_params)

    # ---- this slice: sampled decoding, from a sharded restore -----------
    phase_sample(dev)
    sampled_launches = phase_moe_serve_sampled(dev, moe_cfg, moe_params)
    del moe_params
    torch.cuda.empty_cache()
    recurrent_launches = {arch: phase_recurrent(dev, arch)
                          for arch in RECURRENT_ARCHS}

    # ---- this slice: the four archs no other phase runs -----------------
    arch_fwd, arch_bwd, arch_prefill, arch_train = phase_archs(dev)

    # ---- this slice: stablelm-3b (head dim 80) and the campaign engine ----
    cfg = get_arch(DENSE80_ARCH)
    params, _ = init_decoder(0, cfg, device=dev)
    dense80_launches = phase_prefill(dev, cfg, params, phase="prefill_80",
                                     parity=False)
    assert dense80_launches["flash_dense"] == cfg.num_layers
    del params
    torch.cuda.empty_cache()
    phase_campaign(dev)

    # ---- this slice: training on the card -------------------------------
    torch.cuda.empty_cache()
    bwd, train_launches = phase_train(dev)

    # ---- this slice: the ragged MoE trains on the card ------------------
    torch.cuda.empty_cache()
    moe_train_launches, moe_bwd = phase_moe_train(dev, n_sm)

    # ---- this slice: every dtype and shape, and the examples ------------
    (simt_gmm, simt_flash, fp16_flash, fp32_launches, any_launches,
     general) = phase_kernels_any_dtype(dev, n_sm)
    general_launches = general["launches"]
    fp16_launches = fp16_flash["launches"]
    torch.cuda.empty_cache()
    examples = phase_examples(dev)
    demo_launches = examples["torch_moe_balance_demo"]["launches"]

    # ---- this slice: the multi-pod dry run on DTensors ------------------
    dryrun_launches = phase_dryrun(dev)

    def simt_entry(name, source, replaces, row, launches_by_path, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(launches_by_path.values()),
                "launches_by_path": launches_by_path,
                **{k: row[k] for k in (
                    "max_abs_err", "tolerance", "ms", "ms_b2b", "plain_ms",
                    "library_ms", "library_ms_b2b", "bound_ms", "bound_by",
                    "dtype")},
                **extra}

    # the tensor-core kernels' bound_ms is the work as they do it, three
    # TF32 products each (bound_ms_fp32_fma: at the CUDA cores' fp32 rate)
    def fp16_summary(row):
        """An fp16 tensor-core row (``fp16_flash_rows``) with the general
        kernel's numbers on the same tensors beside it."""
        keys = ("max_abs_err", "gate_share", "ms", "ms_b2b", "plain_ms",
                "library_ms_b2b", "bound_ms")
        return dict(shape=row["shape"], route=row["route"],
                    bound_ms_fp32_pv=row["bound_ms_fp32_pv"],
                    **{k: row[k] for k in keys},
                    simt={k: row["simt"][k] for k in keys})

    def tf32x3_summary(row):
        """A tensor-core row's numbers beside the general kernel's on the
        same tensors."""
        keys = ("max_abs_err", "ms_b2b", "plain_ms", "library_ms_b2b",
                "bound_ms")
        return dict(shape=row["shape"], bound_ms_tf32x3=row["bound_ms_tf32x3"],
                    **{k: row[k] for k in keys},
                    simt={k: row["simt"][k] for k in keys})

    gmm_simt_row = simt_gmm["qwen3_moe_float32"]
    gmm_any_row = simt_gmm["qwen3_moe_bfloat16"]
    gmm_dw_any_row = simt_gmm["qwen3_moe_float16"]

    def by_shape(kernel, op):
        return {k: r[op] for k, r in simt_gmm.items()
                if r[op]["kernel"] == kernel}

    simt_src = "src/repro_torch/kernels/csrc/"
    moe_note = ("no Pallas kernel: the reference differentiates moe_ragged's "
                "expert einsums by autodiff")

    gmm_flops = total("flops")
    gmm_bytes = total("bytes")
    kernels = [
        {"name": "flash_sched", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_sched.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:168",
         "launches": launches["flash_sched"] + fp16_launches["flash_sched"],
         "launches_by_path": {"main_path": launches["flash_sched"],
                              "fp16": fp16_launches["flash_sched"]},
         "max_abs_err": flash_err,
         "tolerance": f"{ATOL} + {RTOL}*|plain|",
         "ms": flash_ms, "plain_ms": plain_ms, "bound_ms": flash_bound,
         "bound_by": ("operations" if flash_flops / PEAK_BF16_FLOPS
                      >= flash_bytes / PEAK_BYTES else "bytes"),
         "library_ms": library_ms,
         "percent_imbalance": plan.percent_imbalance,
         "by_head_dim": {hd: {k: r[k] for k in (
             "shape", "max_abs_err", "ms", "ms_b2b", "plain_ms", "library_ms",
             "bound_ms", "bound_by", "bound_ms_fp32_pv")}
             for hd, r in sched_by_head_dim.items()},
         "bound_ms_fp32_pv": flash_bound_fp32_pv,
         "fp16": fp16_summary(fp16_flash["sched"]),
         "flash16_sched_digest": fp16_flash["flash16_sched_digest"]},
        {"name": "gmm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gmm.cu",
         "replaces": "src/repro/kernels/grouped_matmul/grouped_matmul.py:37",
         "launches": (launches["gmm"] + moe_launches["gmm"]
                      + serve_launches["gmm"] + cluster_launches["gmm"]
                      + sampled_launches["gmm"]
                      + moe_train_launches["gmm"]),
         "launches_by_path": {"main_path": launches["gmm"],
                              "moe_prefill": moe_launches["gmm"],
                              "moe_serve": serve_launches["gmm"],
                              "cluster_moe": cluster_launches["gmm"],
                              "moe_serve_sampled": sampled_launches["gmm"],
                              "moe_train": moe_train_launches["gmm"]},
         "max_abs_err": max(max(r["max_abs_err"] for r in gmm_rows.values()),
                            cluster_gmm_err),
         "tolerance": f"{ATOL} + {RTOL}*|plain|",
         "ms": total("ms"), "plain_ms": total("plain_ms"),
         "bound_ms": total("bound_ms"),
         "bound_by": ("operations" if gmm_flops / PEAK_BF16_FLOPS
                      >= gmm_bytes / PEAK_BYTES else "bytes"),
         "library_ms": total("library_ms"),
         "percent_imbalance": gmm_rows["wi"]["percent_imbalance"],
         "model_path": {k: gmm_model[k] for k in (
             "ms", "ms_b2b", "plain_ms", "library_ms", "bound_ms",
             "bound_by", "shapes")}},
        {"name": "flash_dense", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_dense.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:51",
         "launches": (prefill_launches["flash_dense"]
                      + moe_launches["flash_dense"]
                      + dense80_launches["flash_dense"]
                      + recurrent_launches["recurrentgemma-2b"][
                          "flash_dense"]
                      + train_launches["flash_dense"]
                      + moe_train_launches["flash_dense"]
                      + fp16_launches["flash_dense"]
                      + arch_prefill["flash_dense"]
                      + dryrun_launches["flash_dense"]),
         "launches_by_path": {
             "prefill": prefill_launches["flash_dense"],
             "moe_prefill": moe_launches["flash_dense"],
             "prefill_80": dense80_launches["flash_dense"],
             "recurrentgemma_prefill": recurrent_launches[
                 "recurrentgemma-2b"]["flash_dense"],
             "train": train_launches["flash_dense"],
             "moe_train": moe_train_launches["flash_dense"],
             "fp16": fp16_launches["flash_dense"],
             "archs_prefill": arch_prefill["flash_dense"],
             "dryrun": dryrun_launches["flash_dense"]},
         "tolerance": f"{ATOL} + {RTOL}*|plain|", **dense,
         "by_arch": arch_fwd,
         "fp16": fp16_summary(fp16_flash["dense"]),
         "flash16_digest": fp16_flash["flash16_digest"]},
        {"name": "flash_dense_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_dense_bwd.cu",
         "replaces": "src/repro/models/attention.py:191",
         "replaces_note": "no Pallas kernel: the reference differentiates "
                          "_attend_flash by autodiff",
         "launches": (train_launches["flash_dense_bwd_dkdv"]
                      + moe_train_launches["flash_dense_bwd_dkdv"]
                      + fp16_launches["flash_dense_bwd_dkdv"]
                      + arch_train["flash_dense_bwd_dkdv"]
                      + dryrun_launches["flash_dense_bwd_dkdv"]),
         "launches_by_kernel": {n: train_launches[n] + moe_train_launches[n]
                                + fp16_launches[n] + arch_train[n]
                                + dryrun_launches.get(n, 0)
                                for n in BWD_KERNELS},
         "launches_by_path": {
             "train": train_launches["flash_dense_bwd_dkdv"],
             "moe_train": moe_train_launches["flash_dense_bwd_dkdv"],
             "fp16": fp16_launches["flash_dense_bwd_dkdv"],
             "archs_train": arch_train["flash_dense_bwd_dkdv"],
             "dryrun": dryrun_launches["flash_dense_bwd_dkdv"]},
         "tolerance": f"{BWD_REL_TOL}*max|plain| per gradient", **bwd,
         "by_arch": arch_bwd,
         "fp16": fp16_summary(fp16_flash["bwd"])},
        {"name": "gmm_dx", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gmm.cu",
         "replaces": "src/repro/models/moe.py:143",
         "replaces_note": "no Pallas kernel: the reference differentiates "
                          "moe_ragged's expert einsums by autodiff; dX = dY "
                          "W^T on an expert-major raster",
         "launches": moe_train_launches["gmm_dx"],
         "launches_by_path": {"moe_train": moe_train_launches["gmm_dx"]},
         "tolerance": f"{ATOL} + {RTOL}*|plain|",
         **{k: moe_bwd["dx"][k] for k in (
             "max_abs_err", "ms", "ms_b2b", "plain_ms", "library_ms",
             "library_ms_b2b", "bound_ms", "bound_by", "shapes", "digest")}},
        {"name": "gmm_dw", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gmm.cu",
         "replaces": "src/repro/models/moe.py:143",
         "replaces_note": "no Pallas kernel: the reference differentiates "
                          "moe_ragged's expert einsums by autodiff",
         "launches": moe_train_launches["gmm_dw"],
         "launches_by_path": {"moe_train": moe_train_launches["gmm_dw"]},
         "tolerance": f"{ATOL} + {RTOL}*|plain|",
         **{k: moe_bwd["dw"][k] for k in (
             "max_abs_err", "ms", "ms_b2b", "plain_ms", "library_ms",
             "library_ms_b2b", "bound_ms", "bound_by", "shapes")}},
        simt_entry(
            "gmm_simt", simt_src + "gmm_simt.cu",
            "src/repro/kernels/grouped_matmul/grouped_matmul.py:37",
            gmm_simt_row["gmm"],
            {"fp32_model": fp32_launches["gmm_simt"],
             "moe_balance_demo": demo_launches["gmm_simt"]},
            shape=gmm_simt_row["shape"],
            by_shape=by_shape("gmm_simt", "gmm")),
        simt_entry(
            "gmm_dx_simt", simt_src + "gmm_simt.cu",
            "src/repro/models/moe.py:143", gmm_simt_row["gmm_dx"],
            {"fp32_model": fp32_launches["gmm_dx_simt"]},
            replaces_note=moe_note, shape=gmm_simt_row["shape"],
            by_shape=by_shape("gmm_dx_simt", "gmm_dx")),
        simt_entry(
            "gmm_dw_simt", simt_src + "gmm_simt.cu",
            "src/repro/models/moe.py:143", gmm_simt_row["gmm_dw"],
            {"fp32_model": fp32_launches["gmm_dw_simt"]},
            replaces_note=moe_note, shape=gmm_simt_row["shape"],
            by_shape=by_shape("gmm_dw_simt", "gmm_dw")),
        simt_entry(
            "gmm_any", simt_src + "gmm_any.cu",
            "src/repro/kernels/grouped_matmul/grouped_matmul.py:37",
            gmm_any_row["gmm"], {"off_block": any_launches["gmm_any"]},
            shape=gmm_any_row["shape"], by_shape=by_shape("gmm_any", "gmm")),
        simt_entry(
            "gmm_dx_any", simt_src + "gmm_any.cu",
            "src/repro/models/moe.py:143", gmm_any_row["gmm_dx"],
            {"off_block": any_launches["gmm_dx_any"]},
            replaces_note=moe_note, shape=gmm_any_row["shape"],
            by_shape=by_shape("gmm_dx_any", "gmm_dx")),
        simt_entry(
            "gmm_dw_any", simt_src + "gmm_any.cu",
            "src/repro/models/moe.py:143", gmm_dw_any_row["gmm_dw"],
            {"off_block": any_launches["gmm_dw_any"]},
            replaces_note=moe_note, shape=gmm_dw_any_row["shape"],
            by_shape=by_shape("gmm_dw_any", "gmm_dw")),
        simt_entry(
            "flash_dense_f32", simt_src + "flash_f32.cu",
            "src/repro/kernels/flash_attention/flash_attention.py:51",
            simt_flash["dense"]["128"],
            {"fp32_model": fp32_launches["flash_dense_f32"]},
            shape=simt_flash["dense"]["128"]["shape"], flash_route="tf32x3",
            bound_ms=simt_flash["dense"]["128"]["bound_ms_tf32x3"],
            bound_ms_fp32_fma=simt_flash["dense"]["128"]["bound_ms"],
            by_head_dim={k: tf32x3_summary(simt_flash["dense"][k])
                         for k in TF32X3_HEAD_DIMS},
            flash32_digest=simt_flash["flash32_digest"]),
        simt_entry(
            "flash_f32_bwd", simt_src + "flash_f32_bwd.cu",
            "src/repro/models/attention.py:191", simt_flash["bwd"],
            {"fp32_model": fp32_launches["flash_f32_bwd_dkdv"]},
            replaces_note="no Pallas kernel: the reference differentiates "
                          "_attend_flash by autodiff",
            launches_by_kernel={n: fp32_launches[n] for n in (
                "flash_f32_bwd_dkdv", "flash_f32_bwd_dq")},
            shape=simt_flash["bwd"]["shape"], flash_route="tf32x3",
            bound_ms=simt_flash["bwd"]["bound_ms_tf32x3"],
            bound_ms_fp32_fma=simt_flash["bwd"]["bound_ms"],
            general_kernel=tf32x3_summary(simt_flash["bwd"])["simt"]),
        simt_entry(
            "flash_sched_f32", simt_src + "flash_f32.cu",
            "src/repro/kernels/flash_attention/flash_attention.py:168",
            simt_flash["sched"],
            {"fp32_model": fp32_launches["flash_sched_f32"]},
            shape=simt_flash["sched"]["shape"], flash_route="tf32x3",
            bound_ms=simt_flash["sched"]["bound_ms_tf32x3"],
            bound_ms_fp32_fma=simt_flash["sched"]["bound_ms"],
            general_kernel=tf32x3_summary(simt_flash["sched"])["simt"],
            flash32_sched_digest=simt_flash["flash32_sched_digest"]),
        simt_entry(
            "flash_f32_bwd256", simt_src + "flash_f32_bwd.cu",
            "src/repro/models/attention.py:191", simt_flash["bwd_256"],
            {"fp32_model": fp32_launches["flash_f32_bwd256_dkdv"]},
            replaces_note="no Pallas kernel: the reference differentiates "
                          "_attend_flash by autodiff",
            launches_by_kernel={n: fp32_launches[n] for n in (
                "flash_f32_bwd256_dkdv", "flash_f32_bwd256_dq")},
            shape=simt_flash["bwd_256"]["shape"],
            window=simt_flash["bwd_256"]["window"],
            flash_route="tf32x3_256",
            bound_ms=simt_flash["bwd_256"]["bound_ms_tf32x3"],
            bound_ms_fp32_fma=simt_flash["bwd_256"]["bound_ms"],
            general_kernel=tf32x3_summary(simt_flash["bwd_256"])["simt"],
            flash32_bwd256_digest=simt_flash["flash32_bwd256_digest"]),
        simt_entry(
            "flash_dense_f32_256", simt_src + "flash_f32.cu",
            "src/repro/kernels/flash_attention/flash_attention.py:51",
            simt_flash["dense"]["256"],
            {"fp32_model": fp32_launches["flash_dense_f32_256"]},
            shape=simt_flash["dense"]["256"]["shape"],
            window=simt_flash["dense"]["256"]["window"],
            flash_route="tf32x3_256",
            bound_ms=simt_flash["dense"]["256"]["bound_ms_tf32x3"],
            bound_ms_fp32_fma=simt_flash["dense"]["256"]["bound_ms"],
            general_kernel=tf32x3_summary(simt_flash["dense"]["256"])["simt"],
            flash32_256_digest=simt_flash["flash32_256_digest"]),
        simt_entry(
            "flash_dense_simt", simt_src + "flash_simt.cu",
            "src/repro/kernels/flash_attention/flash_attention.py:51",
            simt_flash["dense"]["256"]["simt"],
            {"general": general_launches["flash_dense_simt"]},
            launches_note="no route of the dense entry launches it: a call "
                          "whose layout TMA cannot describe is copied to "
                          "TMA's layout and runs the tensor-core kernels "
                          "(dense_entry); held to the plain version by "
                          "direct call",
            shape=simt_flash["dense"]["256"]["shape"],
            window=simt_flash["dense"]["256"]["window"],
            by_head_dim={k: r["simt"]
                         for k, r in simt_flash["dense"].items()},
            fp16=fp16_flash["dense"]["simt"],
            dense_entry=general["packed"]["forward"],
            packed_sweep=general["packed_sweep"]),
        simt_entry(
            "flash_sched_simt", simt_src + "flash_simt.cu",
            "src/repro/kernels/flash_attention/flash_attention.py:168",
            fp16_flash["sched"]["simt"],
            {"general": general_launches["flash_sched_simt"]},
            shape=fp16_flash["sched"]["shape"],
            bound_ms_fp32_fma=fp16_flash["sched"]["simt"]["bound_ms_fp32_fma"],
            fp32=tf32x3_summary(simt_flash["sched"])["simt"],
            fp32_hd256=general["sched_256"]),
        simt_entry(
            "flash_simt_bwd", simt_src + "flash_simt_bwd.cu",
            "src/repro/models/attention.py:191", fp16_flash["bwd"]["simt"],
            {"fp32_model": fp32_launches["flash_simt_bwd_delta"],
             "fp16": fp16_launches.get("flash_simt_bwd_delta", 0),
             "general": general_launches["flash_simt_bwd_delta"]},
            replaces_note="no Pallas kernel: the reference differentiates "
                          "_attend_flash by autodiff",
            launches_note="its delta pass serves every fp32 backward; no "
                          "route of the dense entry launches dkdv or dq "
                          "(fp32 takes flash_f32_bwd, 2-byte types "
                          "flash_dense_bwd, on copies in TMA's layout "
                          "where the inputs' layout is not: dense_entry)",
            launches_by_kernel={n: fp32_launches.get(n, 0)
                                + fp16_launches.get(n, 0)
                                + general_launches.get(n, 0) for n in (
                                    "flash_simt_bwd_delta",
                                    "flash_simt_bwd_dkdv",
                                    "flash_simt_bwd_dq")},
            shape=fp16_flash["bwd"]["shape"],
            bound_ms_fp32_fma=fp16_flash["bwd"]["simt"]["bound_ms_fp32_fma"],
            delta={k: {x: simt_flash[k]["delta"][x] for x in (
                "max_abs_err", "ms", "ms_b2b", "plain_ms", "library_ms_b2b",
                "bound_ms", "bound_by", "bytes")} for k in ("bwd", "bwd_256")},
            fp32_hd256=tf32x3_summary(simt_flash["bwd_256"])["simt"],
            fp32_training_shape=simt_flash["bwd"]["simt"],
            dense_entry=general["packed"]["backward"]),
        {"name": "tma_pack", "route": "cuda",
         "source": simt_src + "tma_pack.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:51",
         "replaces_note": "no Pallas kernel: the reference's BlockSpecs read "
                          "any layout; this copy puts a dense call's tensors "
                          "in TMA's layout for the tensor-core ports of "
                          "_flash_kernel and its backward",
         "launches": general_launches["tma_pack"],
         "launches_by_path": {"general": general_launches["tma_pack"]},
         "launches_note": "packed_sweep launches it twice a call outside "
                          "the counted run",
         **{k: general["pack"][k] for k in (
             "max_abs_err", "tolerance", "ms", "ms_b2b", "device_ms",
             "plain_ms", "plain_ms_b2b", "library_ms", "bound_ms", "bound_by",
             "bytes", "shape", "dtype")}},
    ]
    for kern in kernels:
        assert all(math.isfinite(kern[x]) for x in
                   ("max_abs_err", "ms", "plain_ms", "bound_ms"))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
