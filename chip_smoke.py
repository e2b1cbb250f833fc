"""On-card smoke test of the PyTorch / CUDA port (``src/repro_torch``).

Run from the root of a checkout, on a machine with one NVIDIA H100::

    python3 chip_smoke.py

Phases, one line each (any failure raises and exits non-zero):

  1. environment: the card's name and power limit (``nvidia-smi``), torch and
     CUDA versions, and the nvcc builds of every ``csrc/*.cu``, one nvcc
     process per source, all started together, with ptxas's register and
     spill lines (a spill in a wgmma kernel, or its warning C7514, fails)
     and the wgmma route's shared memory at each instantiation;
  2. each kernel entry point against its plain PyTorch version on the card,
     bit for bit: the per-row entry on the sweep engine's layout (probabilities
     (2, 256, 20 000, 15), thresholds (1, 256, 1, 15) read as they lie; also
     (2, 256, 2 000, 64)) and on (rows, n) thresholds, the static entry with a tuple, at
     n = 15, 64 and 100, and at the fault path's shapes (phase 11): the
     grid's probabilities (1, 72, 20 000, 15) with thresholds (1, 72, 1, 15),
     the executor's plan on one 8-worker row (1, 8) and on one 15-worker row
     (1, 15), and at the serving path's shapes (phase 12): the admission
     gate's (1, 96, 2 000, 15) with thresholds (1, 96, 1, 15) (a stride-0
     view over the rounds) and a round's allocation, (96 x 6, 15) with
     per-row thresholds, and at the speed path's round blocks (phase 14):
     (2, 256, 2 500, 15) with thresholds (1, 256, 1, 15) and a row shard's
     (2, 16, 500, 15) with (1, 16, 1, 15); each with its time, the plain version's time and the
     card's bound for the same work (distinct threshold rows counted once).
     Every time here and in phases 6 and 9 is taken twice, the
     same way for kernel, plain version and library call (``time_ms``): a
     single call between CUDA events (``ms``; on an idle card this counts
     the call's host work before its launch too) and 10 back-to-back calls
     over 10 (``*_batched``; host work hidden where it is shorter than the
     kernel), each the median of warm runs.  Then the fused allocation
     (``allocate_masked_cuda``) against the composition it replaces (stable
     sort, B1, argmax) at one fig3 block (2, 1 024, 2 330, 15), a slice of a
     (2, 1 024, 4 660, 15) tensor, with the engine's (1, 1 024, 1, .) pool:
     loads and i* equal to the bit, one launch and no sort kernel under
     ``allocate_masked`` (``torch.profiler``), timed as kernel, through
     ``allocate_masked`` and as the composition, beside its byte bound
     (p read, loads and i* written), each also per 20 000-round sweep.
     Then the static resampler's
     kernel (``static_resample_cuda``) against its plain version at one
     (1 024, 2 330, 15) block of the fig3 sweep: both driven by the
     engine's loop on the same CUDA uniforms, equal to the bit with the
     same reads a try; a block's tries timed (host reads included) beside
     the plain version's, with the bound from that run's bytes, and the
     first try alone;
  3. the main path: ``sweeps.run("fig3", seeds=64)`` at the paper's scale
     (n = 15, K* = 99, M = 20 000 rounds, 4 chains, lea / static / oracle),
     held to the committed ``BENCH_fig3.json`` (|mean - value| <= 4.5 x the
     across-seed standard deviation, LEA above static everywhere); the
     fused allocation's and the resampler's launch counts must rise, and B1's
     per-row entry must not launch;
  4. the static-threshold entry: ``throughput.compare`` on Fig. 3 scenario 1;
     the static kernel's and the resampler's launch counts must rise;
  5. a small fig3 run on the card and on the CPU from the same recorded
     draws: the per-round successes may differ in at most 0.1% of rounds
     (the kernel repeats the plain version's roundings, so 0 is expected);
  6. the coding kernels against their plain versions on the card, at the
     coded path's shapes and one ragged shape each: the exact GF(p) matmul
     (``matmul_gf_cuda``, ``bmm_gf_cuda``; equal to ``matmul_gf_dot`` to the
     bit, residues 0 and p-1 included) at every product of the exact rounds
     and of phase 11's per-packet decode,
     x~^T read as it lies, and any int32 (negative values, p) in place of
     residues, each timed through the kernel alone, through ``gf.matmul_gf`` /
     ``gf.bmm_gf`` and through the ``to_gf`` passes and copy the ops layer
     made before it read operands as they lie (``passes_ms``); the
     Lagrange encode GEMM (its
     streaming route at k = 8 and 5, the scalar stream at ragged columns,
     the tiled route at k = 64; each line names its route) and the fused
     coded gradient (within the float32 reduction-order bound
     |diff| <= 1e-5 * (|A| |B|) elementwise, and the same bits on two calls;
     (150, 60, 3000, 1), (7, 13, 301, 3), (2, 4096, 8, 4) and
     (2, 65 536, 8, 1) on the rows route, each line with its row plan, then
     the chunk route with its residual in shared memory and in global
     memory), each timed beside its plain version, its bound and its library
     call or composition of calls;
  7. the coded path: the exact degree-1 round at the paper's EC2 scenario 1
     for every feasible LEA round of a 2 000-round rollout (the first 8
     rounds equal to the CPU plain route, one round equal to the numpy
     oracle on a 64-column slice), the exact degree-2 gradient on a Fig. 3
     scenario 3 rollout (first 6 rounds equal to the CPU plain route), and
     the float coded regression at k = 5, LEA vs static (every accepted
     round within 1e-2 relative of the uncoded gradient, LEA above static),
     and the same regression at k = 8, read and not checked (its per-round
     relative errors and the rounds the guard rejects); each part counts
     its launches before its cross-checks, and every coding kernel's count
     must rise; the exact rounds print their ms per round and B3's launches,
     and no operand of theirs may be copied contiguous or pass through
     ``to_gf`` at x~'s size before B3 (``gf.operand_passes``);
  8. the ported examples, ``repro_torch.examples.coded_regression.run()``
     and ``repro_torch.examples.quickstart.run(rounds=500)``;
  9. flash attention (B6) against its plain version ``flash_attention_ref``
     on the card: the serving prefill's shape q (4, 16, 2048, 128) against
     k, v (4, 8, 2048, 128) in bf16, fp16 and float32, the same at D = 64,
     phase 15's prefills (q (4, 24, 2048, 128) over 8 KV heads, (4, 32, 2048,
     128) over 4),
     the SMOKE configs' D = 32, ragged Sq = Sk = 1000, non-causal,
     decode-aligned Sq = 16 < Sk = 2048, Sq > Sk with rows that must be 0,
     and the Mixtral attention widths (48 over 8 heads, 4096 tokens) with a
     1024-token window, and the head widths of the repo's other configs
     (phi-3-vision 96, zamba2 112, nemotron-4 192), float32 at D = 192 and
     D = 40, and phase 17's prefills (olmoe's (4, 16, 2048, 128) over 16,
     mixtral's (1, 48, 6144, 128) over 8 with its 4096-token window,
     zamba2's (4, 32, 2048, 112) over 32), and phase 18's (whisper's
     non-causal encoder (8, 6, 1500, 64), its non-causal cross-attention
     q (8, 6, 432, 64) over k, v (8, 6, 1500, 64), phi-3-vision's
     (4, 32, 2048, 96) over 32), and phase 19's (yi-9b's per-rank
     (4, 16, 2048, 128) over 2 at tp = 2);
     each line names the route its dtype and D take (wgmma, mma or ffma) and
     the instantiation that ran; inputs are the (B, H, S, D) views of (B, S, H, D)
     tensors, as the layer passes them.  bf16 and fp16 within
     eps max|v| + eps |ref| elementwise, eps the type's rounding unit (2^-8,
     2^-11: P rounded to the input type for P V, and the output's
     rounding), float32 within 1e-5 (P |V|); each timed beside its plain
     version, its bound and, where Sq = Sk or nothing is masked,
     ``scaled_dot_product_attention`` (a window given as a boolean mask);
     then Sk = 0 on every route must give zeros;
 10. the LM serving path at full width: ``qwen3_0_6b`` (28 layers, d_model
     1024, vocab 151 936, already a multiple of the 128 it pads to, bf16,
     random weights from a seeded generator) with ``attn_impl="flash"`` serves 4 prompts of 2048
     tokens through ``make_prefill_step(cfg, max_len=2112)`` and 64 greedy
     ``make_serve_step`` steps (which sum bf16 split-K partials in float32
     for their call and leave PyTorch's flag as they found it: checked);
     B6 must launch 28 times (one per layer) in
     the prefill, the flash prefill's logits must be no further from a
     float32 evaluation of the model than 1.5 x the dense bf16 prefill's
     plus 5e-3, four decode steps must match a fresh flash prefill over the same
     prefix, and every logit must be finite; then one more prefill and 8
     decode steps run under ``torch.profiler`` for the device's busy share
     and the kernels that take the most device time;
 11. the fault-injection runtime (``repro_torch.faults``, ``runtime``):
     (a) ``sweeps.expand("packet_erasure", rounds=20_000)`` with 8 seeds a
     cell (72 rows, lea and static, ``preempt`` + ``packet_bernoulli`` with
     each row's parameters) through ``faults.sweep_faults``: the fused
     allocation must launch, as many times as for one cell; no round recovered all-or-nothing may
     be lost by the conserving decode, which must recover more rounds over
     the faulted cells; each cell's LEA rates (all-or-nothing, conserving,
     partial only) within 4.5 sd of ``BENCH_faults.json`` (a 512-round,
     one-seed run: sd is the across-seed spread scaled to 512 rounds, not
     below a 512-round binomial sd); wall time, row-rounds/s and peak
     memory logged; (b) a 2 000-round, 4-seed grid on the card and on the
     CPU from the same recorded draws, fault stream included: outcomes may
     differ in at most 0.1% of rounds; (c) the exact per-packet decode at
     ``CodeSpec(15, 10, 50, 2)``, x (50, 60, 3000), on 250 rounds of the
     LEA masks of cell ``erasure_pre0.2_drop0.05``: every decodable block
     equal to the numpy oracle, one packet with no channel equal to
     ``coded_matmul_exact``, no operand pass of x~'s size, B3 launched;
     (d) the float per-packet decode at ``CodeSpec(15, 10, 5, 2)`` under
     two cells' channels (B4 launched): each block within the float32
     forward-error bound of the route of the uncoded X_j @ w (see
     ``faults_float_packets``), its relative error logged; (e) the retry/degrade executor
     under ``preempt`` at 0.35 (packets 4, 2 retries, partial serving) for
     30 rounds: the outcomes sum to 30 and B2 launches; (a) also holds the
     sweep to one ``packet_counts_cuda`` launch; (f) the packet-count kernel
     alone at fault_grid's shapes (S = 2, 288 rows x 20 000 rounds, n = 15,
     r = 10, P = 4; the grid's speeds, deadline, preemptions and drops drawn
     on the card): both modes' counts equal to the bit to the mask
     composition it replaced on the card, each timed beside the kernel's
     byte bound (keep, loads, states and t_cut read once, both counts
     written once);
 12. the streaming serving layer (``repro_torch.serving``) at the paper's
     pool (n = 15, K* = 50, loads (10, 3), p_gg 0.8, p_bb 0.7, mu (10, 3),
     d = 1): (a) ``sweeps.expand("arrival_grid", rounds=512)`` with 16 seeds
     a cell (96 rows), admit-all and controlled on the same generator
     seeds: every row conserves its requests, B1 launches once a call (the
     admission gate) and the fused allocation once a round, each cell's controlled on-time rate within 4.5 across-seed sd of
     ``BENCH_serving.json``, and over the overloaded cells (rate above its
     ``sustainable_rate``) controlled serves strictly more on time than
     admit-all; (b) the same grid at the family's 2 000 rounds, controlled,
     a first and a warmed call timed (row-rounds/s, ms a round, peak
     memory, the same launches), the round loop run under
     ``torch.cuda.set_sync_debug_mode("error")`` (any sync in it raises),
     and a 250-round call under ``torch.profiler`` (launches a round, idle
     share); (c) 4 rows on the card and on the CPU from the same recorded
     draws: every ``ServingOutcomes`` field equal; (d) the serving CLI
     (``repro_torch.launch.serve``) at its defaults (shift_exp, 1 000
     rounds) and ``repro_torch.examples.serve_coded.run()`` (B3's exact
     encode and decodes) on the card, accounting asserted;
 13. observability (``repro_torch.obs``) at the paper's widths: (a) fig3
     (256 rows x 20 000 rounds) through ``sweeps.run_group`` with
     ``telemetry=True, tap=True, tap_stride=2500``: successes bit-equal to
     the flags-off call, ``oracle``'s estimator error exactly 0, each row's
     tap events in order and the last equal to its success sums; (b) phase
     11a's fault grid with both flags: outcomes bit-equal,
     ``received_conserve >= received_aon``, tap totals equal the
     telemetry's sums; (c) the 2 000-round arrival grid, admit-all and
     controlled, taps every 250 rounds with the round loop under the sync
     check: outcomes bit-equal, conservation, boundaries x rows x
     strategies events, ms a round with taps on and off; (d) fig3 (2 000
     rounds) and 50 exact deg-2 rounds under ``profile_trace``: the trace
     holds the five engine phase spans, each printed with its host ms and
     its kernels' device ms; (e) a manifest of (a)'s results and its
     history record in a temporary directory: the provenance names the
     card, CUDA and the power limit, and the repo root is unchanged; (f)
     the serving CLI with ``--progress --tap-log``: every logged event
     valid; (g) a child process loads every kernel with no ``nvcc`` run,
     and the launches of (a)-(d) by kernel are printed;
 14. the speed layer (``sweeps.executor``'s chunked ``run_group`` and
     ``run_multihost``, ``repro_torch.launch``): (a) fig3 (256 rows x 20 000
     rounds) through ``run_group(round_chunk=2500)`` and unchunked on the
     group's generator: both within 4.5 sd of ``BENCH_fig3.json``, the
     fused allocation launched once a block (8 a chunked call); 3 warm runs
     of each timed, and a tapped chunked call gives 256 x 8 events with the
     same successes; (b) two child processes, one after the other,
     with ``REPRO_COMPILE_CACHE`` at one fresh directory: the cold one runs
     two ``nvcc`` (B1 and the static resampler) and the warm one none
     (cache hits), ``build/`` unchanged;
     (c) ``run_multihost("hetero_kstar")`` in two child
     processes joined by gloo on localhost: process 0's merged successes and
     summaries equal this process's interleave of the two row shards, and at
     world 1 ``run_multihost`` gives ``run``'s results; (d) the op-cost rows
     of the three pool-path entry points (``launch.hlo_cost``), counted on
     the card, the bytes and operations of B1's DP included (each launch of
     B1 or of the fused allocation).
  15. the rest of the dense family served at full width, each as phase 10
     serves qwen3 (``serve_config``: flash prefill, greedy decode, bf16,
     seeded random weights): ``llama3_2_3b`` (28 layers, GQA 24 over 8) and
     ``yi_9b`` (48 layers, GQA 32 over 4, ``decode_attn="sharded_lse"``,
     decoded locally) on 4 prompts of 2048 tokens and 16 decode steps, and
     ``nemotron_4_340b`` at full width with 2 of its 96 layers (the only
     cut: the whole model is 341 B parameters) on 1 prompt of 1024 tokens
     and 8 decode steps.  B6 must launch once per layer in each prefill
     (wgmma at D = 128, mma at nemotron's 192), every logit must be finite,
     the flash prefill within 1.5 x the dense bf16 prefill's error (+5e-3)
     of a float32 evaluation (each weight upcast as the forward reads it,
     so no float32 copy of the model is held), two decode steps must match
     fresh prefills; each line gives prefill ms and tokens/s, decode ms a
     step, peak memory and B6's route;
  16. training: ``launch.train.main`` on ``qwen3_0_6b`` at full width
     (remat, bf16 parameters, float32 moments) with ``--batch 8 --seq 1024
     --steps 6 --ckpt-every 3 --coded-dp`` into a temporary checkpoint
     directory, then again with ``--steps 8``, which must resume at step 6
     with the data cursor and LEA counts of the step-6 checkpoint; every
     loss finite and the last below the first; B2 launched at least once
     per coded-DP round (counted over both runs); a 2-step ``--compress
     int8`` run with finite losses; then one ``make_train_step`` step timed
     (ms, tokens/s, peak memory) and profiled (idle share).

  17. the MoE, hybrid and xLSTM families served at full width, each as
     phase 15 serves its configs (``serve_config``): ``olmoe_1b_7b`` (16
     layers, 64 experts top-8, qk-norm, MHA 16 over 16) on 4 prompts of 2048
     tokens and 16 decode steps; ``mixtral_8x22b`` at full width with 2 of
     its 56 layers (the only cut: the whole model is 140.6 B parameters) on
     1 prompt of 6144 tokens, past its 4096-token window, and 8 steps;
     ``zamba2_7b`` at full width with 21 of its 81 Mamba2 layers (the
     shared block applied 4 times: 3 groups of 6 and the tail of 3) and
     ``xlstm_125m`` with 6 of its 12 blocks (sLSTM at 3), both cut to make
     room for phase 19, on 4 x 2048 tokens and 16 steps.  B6 must
     launch ``api.attention_calls(cfg)`` times a prefill (16, 2, 4, 0) and not in
     decode; every logit finite; the flash prefill against float32 as in
     phase 15, and xLSTM's bf16 prefill within ``bf16_bound``; two decode
     steps against fresh prefills, for MoE only on the batch rows where
     neither prefill dropped a route past capacity (counted per row by
     ``MoeDrops``; at least one row held each step); each line gives the
     times, peak memory, B6's route and launches, and the routes dropped in
     the main prefill, ``n_attn_apps`` or the sLSTM steps, and a profiled
     prefill and 8 decode steps (idle share, top kernels).
  18. the encoder-decoder and vision-stub families served at full width,
     each as phase 17 serves its configs, the batch (tokens and the stub's
     frames or patches, random) from ``api.make_batch`` and carried into
     every prefill: ``whisper_tiny`` (4 encoder and 4 decoder layers, 6
     heads of 64) on 8 prompts of 432 tokens over 1 500 frames and 16
     decode steps (448 positions, its text context), and
     ``phi_3_vision_4_2b`` whole (32 layers, 32 heads of 96: the mma
     route) on 4 prompts of 576 patches and 1 472 tokens and 16 steps.
     B6 must launch ``api.attention_calls(cfg)`` times a prefill (12:
     each encoder layer, each decoder layer's self- and cross-attention;
     32) and not in decode; every logit finite; the flash prefill against
     float32 as in phase 15; two decode steps against fresh prefills with
     the same frames or patches; each line gives the times, peak memory,
     B6's route and launches and a profiled prefill and 8 decode steps.

  19. the multi-card paths, each rank a child process of this script on
     the one card (gloo on localhost, every rank on ``cuda:0``), each held
     to the single card's result from the same seeded weights: a probe of
     every collective the slice uses on CUDA tensors (raw, then through
     ``models.sharding``'s host staging of DTensor's all-gather and of
     send / recv), beside the parent's references; ``yi_9b`` whole over
     (1 data x 2 model), 4 prompts of 2048 tokens (B6 48 times a prefill
     on each rank, against float32 as in phase 15) and 16 decode steps
     through ``_sharded_lse_decode`` fed the single card's greedy tokens
     (each against a fresh single-card prefill); ``olmoe_1b_7b`` whole
     with ``moe_impl="ep"`` (32 experts a rank) the same way, 8 steps, MoE
     rows as in phase 17; ``qwen3_0_6b``'s ``make_train_step(grad_shardings
     =)`` step over (2 x 2), four ranks, at full width with 7 of its 28
     layers in float32, as the JAX test whose bounds it keeps (loss within
     2e-3, parameters rtol 2e-2 / atol 2e-3);
     ``pipeline_forward`` of qwen3's SwiGLU MLP over 2 stages (within
     2e-5 of ``reference_forward``); a 2-layer qwen3 train state (tied
     embeddings, bf16 moments: 1.1 GB) saved on
     (2 x 2) and restored onto (1 x 2) by ``restore(shardings=)`` and
     ``reshard_state``, every piece bit-equal to the file; the dry-run CLI
     on ``whisper_tiny x decode_32k`` (``all cells ok``).  The kernels
     line's B6 gains ``sharded_serve`` (both ranks' prefill launches).

It then prints the per-phase walls, the kernels' JSON record, the
``nvidia-smi`` line and, last, ``{"ok": true, "device": {...}}``.  It writes no file outside a temporary
directory it removes (and the kernel libraries under ``build/``).
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from typing import NamedTuple
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12        # H100 SXM FP32 outside the tensor cores
SMS, BOOST_HZ = 132, 1.98e9    # H100 SXM: 132 SMs x 128 FP32 lanes x 2 x 1.98 GHz = 67e12
# The fewest integer instructions a GF(p) term needs on sm_90, whatever the
# kernel does: one IMAD.WIDE.U32 (acc += (uint64)a * b; four products below
# 2^62 fit a uint64, so a fold can wait four terms) and, once per four terms,
# a fold of the group's sum into a uint64 total, (s & p) + (s >> 31): LOP3,
# two SHF and a 64-bit add (IADD3, IADD3.X), 5 instructions.  The IMAD runs
# on the FMA pipe and the fold on the ALU pipe or, as IMAD forms (2^32 = 2
# mod p), on the FMA pipe: 64 lanes a clock per SM each (the CUDA
# programming guide's throughput table, compute capability 9.0), and the
# four schedulers issue 128 a clock per SM.  Shared between the two pipes,
# the 2.25 instructions a term bind at the issue rate.
GF_INSTR_PER_TERM = 1 + 5 / 4
INT_ISSUE_PER_S = SMS * 128 * BOOST_HZ
TOLERANCE = 1e-5
FP32_REL = 1e-5                # float32 reduction-order bound, times |A| |B|
P = (1 << 31) - 1
CSRC = "src/repro_torch/kernels/csrc/"
KERNELS = {   # wrapper: (source, TPU kernel it replaces)
    "success_tails_cuda_w": (CSRC + "poisson_binomial.cu",
                             "src/repro/kernels/poisson_binomial/kernel.py:147"),
    "success_tails_cuda": (CSRC + "poisson_binomial.cu",
                           "src/repro/kernels/poisson_binomial/kernel.py:117"),
    "allocate_masked_cuda": (CSRC + "poisson_binomial.cu",
                             "none (the pairwise rank, B1 and argmax composed in XLA, "
                             "src/repro/core/lea.py:292)"),
    "matmul_gf_cuda": (CSRC + "gf_matmul.cu", "src/repro/kernels/gf/kernel.py:62"),
    "bmm_gf_cuda": (CSRC + "gf_matmul.cu", "src/repro/kernels/gf/kernel.py:62"),
    "encode_matrix_cuda": (CSRC + "lagrange_encode.cu",
                           "src/repro/kernels/lagrange_encode/kernel.py:36"),
    "coded_gradient_cuda": (CSRC + "coded_gradient.cu",
                            "src/repro/kernels/coded_gradient/kernel.py:40"),
    "flash_attention_cuda": (CSRC + "flash_attention.cu",
                             "src/repro/kernels/flash_attention/kernel.py:110"),
    "static_resample_cuda": (CSRC + "static_resample.cu",
                             "none (whole-batch passes, src/repro/core/throughput.py:178)"),
    "packet_counts_cuda": (CSRC + "packet_counts.cu",
                           "none (the packet masks and their sum composed in XLA, "
                           "src/repro/faults/packets.py:68)"),
}
BF16_FLOP_PER_S = 989e12       # H100 SXM dense bf16 tensor cores


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


class Timing(NamedTuple):
    """Two times of one call, in ms, taken the same way for a kernel, its
    plain version and its library call."""
    one: float        # CUDA events around a single call on an idle card: the
                      # call's host work before its launch is counted too
    batched: float    # CUDA events around ``batch`` back-to-back calls, over
                      # ``batch``: the card runs one launch while the host
                      # queues the next, so host work is hidden where it is
                      # shorter than the kernel


def time_ms(fn, warm: int = 3, runs: int = 10, batch: int = 10) -> Timing:
    """Both :class:`Timing` s of ``fn``, each the median of ``runs``
    timings, after ``warm`` untimed calls."""
    for _ in range(warm):
        fn()

    def median_of(calls: int) -> float:
        times = []
        for _ in range(runs):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop) / calls)
        return statistics.median(times)

    return Timing(median_of(1), median_of(batch))


def timing_fields(b_ms: float | None = None, **times: Timing | None) -> dict[str, str | None]:
    """Log fields of named timings: ``<name>`` the single call and
    ``<name>_batched`` the back-to-back one, and the bound's share of the
    kernel's ``ms`` by each."""
    fields: dict[str, str | None] = {}
    for name, t in times.items():
        fields[name] = None if t is None else f"{t.one:.4f}"
        fields[f"{name}_batched"] = None if t is None else f"{t.batched:.4f}"
    if b_ms is not None:
        fields["bound_ms"] = f"{b_ms:.4g}"
        fields["bound_share"] = f"{b_ms / times['ms'].one:.3g}"
        fields["bound_share_batched"] = f"{b_ms / times['ms'].batched:.3g}"
    return fields


def timing_entry(**times: Timing | None) -> dict[str, float | None]:
    """The kernels line's numbers of named timings: ``<name>`` the single
    call, ``<name>_batched`` the back-to-back one."""
    entry: dict[str, float | None] = {}
    for name, t in times.items():
        entry[name] = None if t is None else t.one
        entry[f"{name}_batched"] = None if t is None else t.batched
    return entry


def bound_ms(probs: torch.Tensor, w: torch.Tensor) -> tuple[float, str]:
    """Least time on the card: the bytes one launch moves at the least vs the
    DP's flops on this data, both as ``kernel.launch_work`` counts them
    (distinct threshold rows read once; one add per tail term each feasible
    prefix of this run's thresholds needs)."""
    from repro_torch.kernels.poisson_binomial import kernel as kernel_mod

    moved, flops = kernel_mod.launch_work(probs, w)
    return _bound(moved, flops, FP32_FLOP_PER_S)


def kernel_inputs(lead: tuple[int, ...], n: int, w_lead: tuple[int, ...],
                  gen: torch.Generator):
    """Probabilities (*lead, n), sorted descending, and int32 thresholds
    (*w_lead, n) to broadcast against them."""
    probs = torch.rand(lead + (n,), generator=gen, device="cuda")
    probs = torch.sort(probs, dim=-1, descending=True).values.contiguous()
    # thresholds <= 0, feasible, infeasible (> i~) and the n + 1 padding value
    w = torch.randint(-2, n + 2, w_lead + (n,), generator=gen, device="cuda",
                      dtype=torch.int32)
    w[..., -1] = n + 1
    return probs, w


def check_kernels(kernel_mod, ref) -> dict:
    """Phase 2: every entry point against the plain version, bit for bit, timed."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    engine = (2, 256, 20_000)                 # (lea, oracle) x 256 rows x M rounds
    main_rows = 2 * 256 * 20_000
    # (entry point, layout, probs' leading shape, n, main shape); "engine" is
    # the sweep's thresholds (1, 256, 1, n) read as they lie, "per-row" a
    # (rows, n) tensor of thresholds, "static" a tuple
    cases = [
        ("success_tails_cuda_w", "engine", engine, 15, True),
        ("success_tails_cuda", "static", (2 * 20_000,), 15, True),   # compare: (lea, oracle) x M
        ("success_tails_cuda_w", "per-row", (main_rows,), 15, False),
        ("success_tails_cuda_w", "engine", (2, 256, 2_000), 64, False),
        ("success_tails_cuda_w", "per-row", (1_000_000,), 15, False),
        ("success_tails_cuda", "static", (1_000_000,), 15, False),
        ("success_tails_cuda_w", "per-row", (1_000_000,), 64, False),
        ("success_tails_cuda", "static", (1_000_000,), 64, False),
        ("success_tails_cuda_w", "per-row", (100_000,), 100, False),
        ("success_tails_cuda", "static", (100_000,), 100, False),
        # the fault path (phase 11): the 72-row packet_erasure grid's rollout,
        # phase 11e's executor plan (8 workers), a 15-worker executor's plan
        ("success_tails_cuda_w", "engine", (1, 72, 20_000), 15, False),
        ("success_tails_cuda", "static", (1,), 8, False),
        ("success_tails_cuda", "static", (1,), 15, False),
        # the serving path (phase 12): the admission gate over the 96-row
        # arrival grid, thresholds (1, 96, 1, 15) read as a stride-0 view over
        # the 2 000 rounds; a round's allocation, (96 rows x 6 slots, 15)
        ("success_tails_cuda_w", "engine", (1, 96, 2_000), 15, False),
        ("success_tails_cuda_w", "per-row", (96 * 6,), 15, False),
        # the speed path (phase 14): one round block of 14a's fig3 (256 rows x
        # 2 500 of 20 000 rounds) and of a 14c row shard (16 of hetero_kstar's
        # 32 rows x 500 rounds), thresholds (1, rows, 1, 15) read as they lie
        ("success_tails_cuda_w", "engine", (2, 256, 2_500), 15, False),
        ("success_tails_cuda_w", "engine", (2, 16, 500), 15, False),
    ]
    record = {}
    for name, layout, lead, n, main_shape in cases:
        w_lead = (1, lead[1], 1) if layout == "engine" else lead if layout == "per-row" else ()
        probs, w = kernel_inputs(lead, n, w_lead, gen)
        if name == "success_tails_cuda_w":
            run = lambda: kernel_mod.success_tails_cuda_w(probs, w)
        else:
            w_static = tuple(int(v) for v in w.tolist())
            run = lambda: kernel_mod.success_tails_cuda(probs, w_static)
        out = run()
        torch.cuda.synchronize()
        want = ref(probs, w)
        torch.cuda.synchronize()
        if out.shape != want.shape or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{name} n={n}: bad output {tuple(out.shape)}")
        err = float((out - want).abs().max())
        if not torch.equal(out, want):
            raise AssertionError(f"{name} {layout} {lead} n={n}: not bit-equal to the plain "
                                 f"version, max|diff| {err}")
        ms = time_ms(run)
        plain_ms = time_ms(lambda: ref(probs, w), warm=1, runs=3)
        b_ms, b_by = bound_ms(probs, w)
        log("kernel", name=name, thresholds=layout, probs=lead + (n,), w=tuple(w.shape),
            rows=probs.numel() // n, n=n, main_shape=main_shape, max_abs_err=err,
            bit_equal=True, bound_by=b_by, **timing_fields(b_ms, ms=ms, plain_ms=plain_ms))
        entry = record.setdefault(name, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if main_shape:
            entry.update(timing_entry(ms=ms, plain_ms=plain_ms), bound_ms=b_ms,
                         bound_by=b_by, kernel_route=layout,
                         shape=[list(probs.shape), list(w.shape)])
        del probs, w, out, want
        torch.cuda.empty_cache()
    return record


def check_allocate() -> dict:
    """Phase 2: the fused allocation against the composition it replaces
    (stable sort, B1, argmax) at one fig3 block, (2, 1 024, 2 330, 15) of a
    (2, 1 024, 4 660, 15) tensor with the engine's (1, B, 1, .) pool
    (K* 99, loads (10, 3), full mask): loads, i* and feasible bit-equal, one
    launch and no sort kernel under it; timed as kernel (thresholds given),
    through ``allocate_masked`` and as the composition, against the bytes
    it needs (p read, loads written, i* written)."""
    from repro_torch.core import lea
    from repro_torch.kernels.poisson_binomial import kernel as kernel_mod

    s, b, rounds, m, n = 2, 1024, 4660, 2330, 15
    gen = torch.Generator(device="cuda")
    gen.manual_seed(33)
    counts = torch.randint(0, 12, (2, s, b, rounds, n), generator=gen, device="cuda")
    full = (counts[0] + 1).float() / (counts[0] + counts[1] + 2).float()
    del counts
    full[:, :, ::4] = 0.5
    p = full[:, :, rounds - m:]
    i32 = lambda v: torch.full((1, b, 1), v, dtype=torch.int32, device="cuda")
    pool = lea.PoolLoad(kstar=i32(99), ell_g=i32(10), ell_b=i32(3),
                        mask=torch.ones((1, b, 1, n), dtype=torch.bool, device="cuda"))
    n_valid = pool.mask.to(torch.int32).sum(dim=-1)
    w = lea.prefix_thresholds_traced(pool.kstar, pool.ell_g, pool.ell_b, n_valid, n)
    composed = lambda: lea._allocate_composed(p, pool.mask, n_valid, w, pool.ell_g,
                                              pool.ell_b)
    reset_all_launch_counts()
    loads, i_star, _ = lea.allocate_masked(p, pool)
    want_loads, want_i = composed()
    torch.cuda.synchronize()
    if kernel_mod.launch_counts()["allocate_masked_cuda"] != 1:
        raise AssertionError(f"allocate_masked: {kernel_mod.launch_counts()}")
    if not (torch.equal(loads, want_loads) and torch.equal(i_star, want_i)):
        raise AssertionError(f"allocate_masked_cuda: not bit-equal to the composition, "
                             f"{int(((loads != want_loads).any(-1) | (i_star != want_i)).sum())}"
                             f" rows")
    del loads, i_star, want_loads, want_i
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        lea.allocate_masked(p, pool)
        torch.cuda.synchronize()
    names = sorted({e.name for e in prof.events() if e.device_type == DeviceType.CUDA})
    fused_names = [k for k in names if "pb_tails_allocate" in k]
    if len(fused_names) != 1 or any("sort" in k.lower() or "pb_tails_regs" in k
                                    for k in names):
        raise AssertionError(f"under allocate_masked: {names}")
    kernel = lambda: kernel_mod.allocate_masked_cuda(p, pool.mask, w, pool.ell_g, pool.ell_b)
    ms = time_ms(kernel)
    route_ms = time_ms(lambda: lea.allocate_masked(p, pool))
    plain_ms = time_ms(composed, warm=1, runs=3)
    rows = s * b * m
    moved = 8 * rows * n + 8 * rows
    b_ms, b_by = _bound(moved, 0, 1)
    blocks = 20_000 / m
    log("kernel", name="allocate_masked_cuda", probs=(s, b, m, n), of_rounds=rounds,
        pool=tuple(pool.mask.shape), rows=rows, n=n, bit_equal=True, bound_by=b_by,
        kernels_under_allocate=json.dumps(names),
        sweep_ms=f"{ms.one * blocks:.4f}", sweep_bound_ms=f"{b_ms * blocks:.4f}",
        route_sweep_ms=f"{route_ms.one * blocks:.4f}",
        plain_sweep_ms=f"{plain_ms.one * blocks:.4f}",
        **timing_fields(b_ms, ms=ms, route_ms=route_ms, plain_ms=plain_ms))
    del full, p
    torch.cuda.empty_cache()
    return {"allocate_masked_cuda": {
        "max_abs_err": 0.0, **timing_entry(ms=ms, plain_ms=plain_ms), "bound_ms": b_ms,
        "bound_by": b_by, "kernel_route": "engine", "composition": "sort + B1 + argmax",
        "composition_ms": plain_ms.one, "shape": [[s, b, m, n], [1, b, 1, 2 * n + 2]]}}


def _bound(moved_bytes: float, ops: float, ops_per_s: float) -> tuple[float, str]:
    """Larger of the bytes' and the operations' least times, in ms."""
    t_bytes = moved_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gf_residues(shape, gen: torch.Generator) -> torch.Tensor:
    """Random int32 residues on the card with 0, 1 and p-1 planted."""
    t = torch.randint(0, P, shape, generator=gen, device="cuda", dtype=torch.int32)
    t.view(-1)[:3] = torch.tensor([0, 1, P - 1], dtype=torch.int32, device="cuda")
    return t


# int32 values B3's loaders must reduce mod p: 2^32 = 2 (mod p)
INT32_EDGES = [-(2**31), -1, P, -P, -2, 0, 1, P - 1]


def any_int32(shape, gen: torch.Generator) -> torch.Tensor:
    """Random int32 of both signs on the card, the edges planted."""
    t = torch.randint(-(2**31), 2**31 - 1, shape, generator=gen, device="cuda",
                      dtype=torch.int32)
    t.view(-1)[:len(INT32_EDGES)] = torch.tensor(INT32_EDGES, dtype=torch.int32, device="cuda")
    return t


def check_coding_kernels() -> dict:
    """Phase 6: B3, B4 and B5 against their plain versions, timed."""
    from repro_torch.kernels import coded_gradient as cg
    from repro_torch.kernels import gf
    from repro_torch.kernels import lagrange_encode as le

    if not gf.full_fp32_matmul():
        raise AssertionError("float32 matmuls must run in true float32 here")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    record = {}

    def keep(name, err, main, **timing):
        entry = record.setdefault(name, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if main:
            entry.update(timing)

    # B3: (batch, m, c, n), a's layout, the values; the main shape of each
    # wrapper first.  The exact rounds' products (core/coded_ops.py): the
    # deg-1 worker shards and decode, the deg-2 residual, x~^T r (x~^T the
    # transposed view the round passes) and decode; the encode of each.
    gf_cases = [
        ("matmul_gf_cuda", "encode", (1, 150, 120, 75_000), "rows", "residues", True),
        ("matmul_gf_cuda", "deg-1 worker shards", (1, 3750, 3000, 8), "rows", "residues", False),
        ("matmul_gf_cuda", "deg-1 decode", (1, 120, 120, 200), "rows", "residues", False),
        ("matmul_gf_cuda", "deg-2 residual", (1, 9000, 3000, 1), "rows", "residues", False),
        ("matmul_gf_cuda", "deg-2 decode", (1, 50, 99, 3000), "rows", "residues", False),
        ("matmul_gf_cuda", "per-packet decode", (1, 50, 99, 15), "rows", "residues", False),
        ("matmul_gf_cuda", "ragged", (1, 37, 301, 19), "rows", "residues", False),
        ("matmul_gf_cuda", "any int32", (1, 300, 600, 8), "rows", "int32", False),
        ("bmm_gf_cuda", "deg-2 gradient, x~^T as it lies", (150, 3000, 60, 1), "transposed",
         "residues", True),
        ("bmm_gf_cuda", "deg-2 gradient, contiguous", (150, 3000, 60, 1), "rows", "residues",
         False),
        ("bmm_gf_cuda", "ragged", (3, 37, 301, 5), "rows", "residues", False),
        ("bmm_gf_cuda", "any int32, transposed", (7, 130, 33, 3), "transposed", "int32", False),
    ]
    for name, what, (batch, m, c, n), layout, values, main in gf_cases:
        lead = () if name == "matmul_gf_cuda" else (batch,)
        draw = gf_residues if values == "residues" else any_int32
        if layout == "transposed":               # a (B, m, c) view of a (B, c, m) tensor
            a = draw(lead + (c, m), gen).transpose(-1, -2)
        else:
            a = draw(lead + (m, c), gen)
        b = draw(lead + (c, n), gen)
        if values == "residues":
            a[..., 0, :] = P - 1                  # a row and a column of p-1
            b[..., :, 0] = P - 1
        kern = getattr(gf, name)
        ops = gf.matmul_gf if name == "matmul_gf_cuda" else gf.bmm_gf
        run = lambda: kern(a, b)
        through_ops = lambda: ops(a, b)
        # what the ops layer ran before it read int32 operands as they lie
        passes = lambda: kern(gf.to_gf(a).contiguous(), gf.to_gf(b).contiguous())
        plain = lambda: gf.matmul_gf_dot(gf.to_gf(a), gf.to_gf(b))
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if got.shape != want.shape or err != 0 or not torch.equal(through_ops(), got):
            raise AssertionError(f"{name} {what} {(batch, m, c, n)}: max|diff| {err}")
        ms = time_ms(run)
        ops_ms = time_ms(through_ops)
        passes_ms = time_ms(passes)
        plain_ms = time_ms(plain, warm=1, runs=3)
        b_ms, b_by = _bound(4 * batch * (m * c + c * n + m * n),
                            batch * m * c * n * GF_INSTR_PER_TERM, INT_ISSUE_PER_S)
        log("kernel", name=name, case=json.dumps(what), shape=(batch, m, c, n),
            a_strides=tuple(a.stride()), values=values, max_abs_err=err, bound_by=b_by,
            **timing_fields(b_ms, ms=ms, ops_ms=ops_ms, passes_ms=passes_ms,
                            plain_ms=plain_ms))
        keep(name, err, main, **timing_entry(ms=ms, plain_ms=plain_ms, library_ms=None,
                                             composition_ms=plain_ms),
             bound_ms=b_ms, bound_by=b_by,
             composition="matmul_gf_dot: 8-bit limb split, one fp32 torch.matmul "
                         "per 256-wide K-chunk, 16 Mersenne rotations and adds",
             shape=[batch, m, c, n])
        del a, b, got, want

    # B4: (nr, k, cols)
    # (150, 8) is the float regression at k = 8, read in phase 7; (150, 5) the
    # one phase 7 checks
    # (37, 5, 1001) the ragged stream route; (150, 64, 18 000) the tiled route
    for (nr, k, cols), main in (((150, 8, 180_000), True), ((150, 5, 180_000), False),
                                ((37, 5, 1001), False), ((150, 64, 18_000), False)):
        g = torch.randn((nr, k), generator=gen, device="cuda")
        x = torch.randn((k, cols), generator=gen, device="cuda")
        run = lambda: le.encode_matrix_cuda(g, x)
        plain = lambda: le.encode_matrix_ref(g, x)
        got, want = run(), plain()
        bound = FP32_REL * (g.abs() @ x.abs())
        diff = (got - want).abs()
        torch.cuda.synchronize()
        err = float(diff.max())
        if not bool(torch.isfinite(got).all()) or bool((diff > bound).any()):
            raise AssertionError(f"encode_matrix_cuda {(nr, k, cols)}: max|diff| {err}")
        ms = time_ms(run)
        plain_ms = time_ms(plain, warm=1, runs=3)
        library_ms = time_ms(lambda: torch.matmul(g, x))
        b_ms, b_by = _bound(4 * (nr * k + k * cols + nr * cols), 2 * nr * k * cols,
                            FP32_FLOP_PER_S)
        log("kernel", name="encode_matrix_cuda", shape=(nr, k, cols),
            route=le.encode_route(k, cols), max_abs_err=err, bound_by=b_by,
            **timing_fields(b_ms, ms=ms, plain_ms=plain_ms, library_ms=library_ms))
        keep("encode_matrix_cuda", err, main,
             **timing_entry(ms=ms, plain_ms=plain_ms, library_ms=library_ms),
             bound_ms=b_ms, bound_by=b_by,
             library="torch.matmul", kernel_route=le.encode_route(k, cols),
             shape=[nr, k, cols])
        del g, x, got, want, bound, diff

    # B5: (nr, R, C, P), each on the route its shape takes (gradient_route):
    # the paper's shape and the three others on the rows route, then the
    # chunk route with its residual in shared memory opted in past 48 KB and,
    # past what a block may have, in global memory
    for (nr, r_rows, c, p), main in (((150, 60, 3000, 1), True), ((7, 13, 301, 3), False),
                                     ((2, 4096, 8, 4), False), ((2, 65_536, 8, 1), False),
                                     ((1, 200, 4, 70), False), ((1, 6000, 4, 16), False)):
        x = torch.randn((nr, r_rows, c), generator=gen, device="cuda")
        y = torch.randn((nr, r_rows, p), generator=gen, device="cuda")
        w = torch.randn((c, p), generator=gen, device="cuda")
        run = lambda: cg.coded_gradient_cuda(x, y, w)
        plain = lambda: cg.coded_gradient_ref(x, y, w)
        w_b = w.expand(nr, c, p)
        two_bmm = lambda: torch.bmm(x.transpose(1, 2), torch.bmm(x, w_b) - y)
        got, want = run(), plain()
        again = run()
        ax = x.abs()
        bound = FP32_REL * torch.bmm(ax.transpose(1, 2), torch.bmm(ax, w_b.abs()) + y.abs())
        diff = (got - want).abs()
        torch.cuda.synchronize()
        err = float(diff.max())
        if not bool(torch.isfinite(got).all()) or bool((diff > bound).any()):
            raise AssertionError(f"coded_gradient_cuda {(nr, r_rows, c, p)}: max|diff| {err}")
        if not torch.equal(got, again):
            raise AssertionError(f"coded_gradient_cuda {(nr, r_rows, c, p)}: two calls differ")
        ms = time_ms(run)
        plain_ms = time_ms(plain, warm=1, runs=3)
        composition_ms = time_ms(two_bmm)
        b_ms, b_by = _bound(4 * (nr * r_rows * c + nr * r_rows * p + c * p + nr * c * p),
                            4 * nr * r_rows * c * p, FP32_FLOP_PER_S)
        route = cg.gradient_route(r_rows, c, p)
        if route == "rows":
            plan = cg.row_plan(nr, r_rows, c, p, cg.kernel.row_vec(c, p, True))
            where = {"plan": json.dumps(plan._asdict())}
        else:
            where = {"residual": cg.residual_path(r_rows, p)}
        log("kernel", name="coded_gradient_cuda", shape=(nr, r_rows, c, p), route=route,
            **where, max_abs_err=err, same_bits_twice=True, bound_by=b_by,
            **timing_fields(b_ms, ms=ms, plain_ms=plain_ms, composition_ms=composition_ms))
        keep("coded_gradient_cuda", err, main,
             **timing_entry(ms=ms, plain_ms=plain_ms, library_ms=None,
                            composition_ms=composition_ms),
             bound_ms=b_ms, bound_by=b_by, kernel_route=route,
             composition="two torch.bmm calls (x w - y, then x^T resid), TF32 off",
             shape=[nr, r_rows, c, p])
        del x, y, w, got, again, want, bound, diff, ax
    torch.cuda.empty_cache()
    return record


def coding_launches() -> dict[str, int]:
    from repro_torch.kernels import coded_gradient as cg
    from repro_torch.kernels import gf
    from repro_torch.kernels import lagrange_encode as le
    return {**gf.launch_counts(), **le.launch_counts(), **cg.launch_counts()}


def reset_all_launch_counts() -> None:
    from repro_torch.kernels import coded_gradient as cg
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gf
    from repro_torch.kernels import lagrange_encode as le
    from repro_torch.kernels import packet_counts as pc
    from repro_torch.kernels import poisson_binomial as pb
    from repro_torch.kernels import static_resample as sr
    for mod in (pb, gf, le, cg, fa, sr, pc):
        mod.reset_launch_counts()


def check_static_resample() -> dict:
    """Phase 2, last: the static resampler's kernel against its plain
    version at one (1 024, 2 330, 15) block of the fig3 sweep (the four
    chains' pi_g, a full mask, K* 99, loads (10, 3) per row), both driven by
    the engine's loop on the same CUDA uniforms: loads, flags and the count
    read before each try equal, one launch a try.  Then a block's tries
    timed, host reads included, beside the plain version's, against the
    bytes the kernel moves in them (every round's flag a try, 4n bytes of
    uniforms read and of loads written a round redrawn), and the first try
    alone, on fresh blocks."""
    from repro_torch.core import markov
    from repro_torch.core.throughput import STATIC_MAX_TRIES
    from repro_torch.kernels import static_resample as sr

    b, m, n = 1024, 2330, 15
    gen = torch.Generator(device="cuda")
    gen.manual_seed(30)
    chains = torch.tensor([(0.8, 0.8), (0.8, 0.7), (0.8, 0.533), (0.9, 0.6)],
                          device="cuda").repeat_interleave(256, 0)
    ones = torch.ones((b, n), device="cuda")
    pi_g = markov.stationary_good_prob(chains[:, :1] * ones, chains[:, 1:] * ones)
    rows = lambda v: torch.full((b,), v, dtype=torch.int32, device="cuda")
    args = ([pi_g], m, rows(99)[:, None], rows(10)[:, None, None], rows(3)[:, None, None],
            torch.ones((b, n), dtype=torch.bool, device="cuda"))
    us = []

    def block(impl):
        res = impl(*args)
        reads = []
        for t in range(STATIC_MAX_TRIES):
            reads.append(res.unfinished())
            if not reads[-1]:
                break
            if t == len(us):
                us.append(torch.rand((b, m, n), generator=gen, device="cuda"))
            res.redraw(us[t])
        return res.result(), reads

    want, want_reads = block(sr.StaticResampleRef)
    reset_all_launch_counts()
    got, reads = block(sr.StaticResampleCuda)
    launches = sr.launch_counts()["static_resample_cuda"]
    torch.cuda.synchronize()
    for (gl, gf), (wl, wf) in zip(got, want, strict=True):
        if not (torch.equal(gl, wl) and torch.equal(gf, wf)):
            raise AssertionError("static_resample_cuda: not bit-equal to the plain version "
                                 f"at the fig3 block, {int((gl != wl).any(-1).sum())} rounds")
    tries = len(us)
    if reads != want_reads or launches != tries:
        raise AssertionError(f"static_resample_cuda: reads {reads} against {want_reads}, "
                             f"{launches} launches for {tries} tries")
    del got, want
    ms = time_ms(lambda: block(sr.StaticResampleCuda), warm=1)
    plain_ms = time_ms(lambda: block(sr.StaticResampleRef), warm=1, runs=3, batch=2)
    moved = sum(b * m + 8 * n * r for r in reads[:tries])
    b_ms, b_by = _bound(moved, 0, 1)
    first = []
    for res in [sr.StaticResampleCuda(*args) for _ in range(5)]:
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res.redraw(us[0])
        stop.record()
        stop.synchronize()
        first.append(start.elapsed_time(stop))
    first_bound, _ = _bound(b * m + 8 * n * b * m, 0, 1)
    log("kernel", name="static_resample_cuda", block=(b, m, n), tries=tries,
        pairs_redrawn=sum(reads[:tries]), bit_equal=True, bound_by=b_by,
        first_try_ms=f"{statistics.median(first):.4f}", first_try_bound_ms=f"{first_bound:.4g}",
        **timing_fields(b_ms, ms=ms, plain_ms=plain_ms))
    del us[:]
    torch.cuda.empty_cache()
    return {"static_resample_cuda": {
        "max_abs_err": 0.0, **timing_entry(ms=ms, plain_ms=plain_ms), "bound_ms": b_ms,
        "bound_by": b_by, "kernel_route": "block", "shape": [[b, m, n]]}}


def _feasible_rounds(masks: torch.Tensor, kstar: int) -> list[int]:
    return torch.nonzero(masks.sum(dim=-1) >= kstar)[:, 0].tolist()


def no_x_tilde_passes(passes: dict[str, int], coded) -> dict[str, int]:
    """``passes`` (``gf.operand_passes`` over the exact rounds) if no B3
    operand was copied contiguous and none of x~'s size went through
    ``to_gf``; raises otherwise."""
    if passes["contiguous"] or passes["largest"] >= coded.x_tilde.numel():
        raise AssertionError(f"the exact rounds passed over x~ before B3: {passes}")
    return passes


def exact_deg1(co, lg, throughput, LoadParams) -> None:
    """Phase 7a: the exact degree-1 round at EC2 scenario 1 (Sec. 6.2)."""
    from repro_torch.kernels import gf
    spec = lg.CodeSpec(15, 10, 120, 1)                 # nr = 150, K* = 120
    rows, cols, d = 25, 3000, 8
    rng = np.random.default_rng(61)
    x = rng.integers(0, P, size=(spec.k, rows, cols), dtype=np.int32)
    w = rng.integers(0, P, size=(cols, d), dtype=np.int32)
    lp = LoadParams(15, 120, 10, 1)
    states, loads, feas = throughput.rollout(21, lp, [0.85] * 15, [0.6] * 15, 2000,
                                             strategies=("lea",), device="cuda")
    masks = co.chunk_on_time(states, loads[0], 10.0, 1.0, 2.5, spec.r)
    success = throughput.score_rollout(states, loads, feas, lp, 10.0, 1.0, 2.5)[:, 0]
    if not torch.equal((masks.sum(dim=-1) >= spec.recovery_threshold) & feas[0], success):
        raise AssertionError("chunk masks disagree with the engine's round success")
    rounds = _feasible_rounds(masks, spec.recovery_threshold)
    reset_all_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    coded = co.encode_dataset_modp(spec, x, device="cuda")
    w_dev = torch.as_tensor(w, device="cuda")
    first, oks = [], []
    gf.reset_operand_passes()
    for m in rounds:
        out, ok = co.coded_matmul_exact(coded, w_dev, masks[m])
        oks.append(ok)
        if len(first) < 8:
            first.append(out)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = coding_launches()      # before the checks below launch more
    passes = no_x_tilde_passes(gf.operand_passes(), coded)
    if not bool(torch.stack(oks).all()):
        raise AssertionError("an exact deg-1 round with >= K* results reported not ok")
    # the CPU plain route on the same data and the first 8 rounds
    coded_cpu = co.encode_dataset_modp(spec, x, device="cpu")
    if not torch.equal(coded.x_tilde.cpu(), coded_cpu.x_tilde):
        raise AssertionError("encode on the card differs from the CPU plain route")
    for m, out in zip(rounds, first):
        out_cpu, ok = co.coded_matmul_exact(coded_cpu, torch.as_tensor(w), masks[m].cpu())
        if not bool(ok) or not torch.equal(out.cpu(), out_cpu):
            raise AssertionError(f"exact deg-1 round {m}: card differs from the CPU")
    # the numpy oracle: the encode on a 64-column slice of the flat data, and
    # one whole round of the 64-column sub-problem
    g_np = lg.generator_matrix_modp(spec)
    x_flat = x.reshape(spec.k, -1)
    if not np.array_equal(coded.x_tilde.reshape(spec.nr, -1)[:, :64].cpu().numpy(),
                          lg.matmul_modp(g_np, x_flat[:, :64])):
        raise AssertionError("encode differs from numpy matmul_modp on the slice")
    x64, w64 = x[:, :, :64], w[:64]
    on = masks[rounds[0]]
    out64, ok = co.coded_matmul_exact(co.encode_dataset_modp(spec, x64, device="cuda"),
                                      torch.as_tensor(w64, device="cuda"), on)
    xt = lg.matmul_modp(g_np, x64.reshape(spec.k, -1))
    res = lg.matmul_modp(xt.reshape(spec.nr * rows, 64), w64).reshape(spec.nr, rows, d)
    rec = np.nonzero(on.cpu().numpy())[0][: spec.recovery_threshold]
    want = lg.matmul_modp(lg.decode_matrix_modp(spec, rec), res[rec])
    if not bool(ok) or not np.array_equal(out64.cpu().numpy().astype(np.int64), want):
        raise AssertionError("exact deg-1 round differs from the numpy oracle")
    log("exact_deg1", spec="CodeSpec(15,10,120,1)", x=(spec.k, rows, cols), w=(cols, d),
        rollout_rounds=2000, feasible_rounds=len(rounds),
        lea_throughput=f"{float(success.float().mean()):.4f}", wall_s=f"{wall:.3f}",
        ms_per_round=f"{wall / max(len(rounds), 1) * 1e3:.3f}",
        cpu_rounds_equal=len(first), numpy_slice_equal=True,
        launches=json.dumps(launches), operand_passes=json.dumps(passes))
    return launches


def exact_deg2(co, lg, throughput, LoadParams) -> None:
    """Phase 7b: the exact degree-2 gradient at Sec. 6.1 (Fig. 3 scenario 3)."""
    from repro_torch.kernels import gf
    spec = lg.CodeSpec(15, 10, 50, 2)                  # nr = 150, K* = 99
    rows, cols = 60, 3000
    rng = np.random.default_rng(62)
    x = rng.integers(0, P, size=(spec.k, rows, cols), dtype=np.int32)
    y = rng.integers(0, P, size=(spec.k, rows), dtype=np.int32)
    w = rng.integers(0, P, size=(cols,), dtype=np.int32)
    lp = LoadParams(15, 99, 10, 3)
    states, loads, _ = throughput.rollout(22, lp, [0.8] * 15, [0.533] * 15, 2000,
                                          strategies=("lea",), device="cuda")
    masks = co.chunk_on_time(states, loads[0], 10.0, 3.0, 1.0, spec.r)
    rounds = _feasible_rounds(masks, spec.recovery_threshold)
    reset_all_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    coded = co.encode_dataset_modp(spec, x, y, device="cuda")
    w_dev = torch.as_tensor(w, device="cuda")
    first, oks = [], []
    gf.reset_operand_passes()
    for m in rounds:
        out, ok = co.coded_linear_gradient_modp(coded, w_dev, masks[m])
        oks.append(ok)
        if len(first) < 6:
            first.append(out)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = coding_launches()
    passes = no_x_tilde_passes(gf.operand_passes(), coded)
    if not bool(torch.stack(oks).all()):
        raise AssertionError("an exact deg-2 round with >= K* results reported not ok")
    coded_cpu = co.encode_dataset_modp(spec, x, y, device="cpu")
    if not (torch.equal(coded.x_tilde.cpu(), coded_cpu.x_tilde)
            and torch.equal(coded.y_tilde.cpu(), coded_cpu.y_tilde)):
        raise AssertionError("deg-2 encode on the card differs from the CPU plain route")
    for m, out in zip(rounds, first):
        out_cpu, ok = co.coded_linear_gradient_modp(coded_cpu, torch.as_tensor(w),
                                                    masks[m].cpu())
        if not bool(ok) or not torch.equal(out.cpu(), out_cpu):
            raise AssertionError(f"exact deg-2 round {m}: card differs from the CPU")
    log("exact_deg2", spec="CodeSpec(15,10,50,2)", x=(spec.k, rows, cols),
        rollout_rounds=2000, feasible_rounds=len(rounds), wall_s=f"{wall:.3f}",
        ms_per_round=f"{wall / max(len(rounds), 1) * 1e3:.3f}",
        cpu_rounds_equal=len(first), launches=json.dumps(launches),
        operand_passes=json.dumps(passes))
    return launches


def float_regression(co, lg, throughput, LoadParams, k: int = 5,
                     checked: bool = True) -> dict[str, int]:
    """Phase 7c: coded least-squares descent through B4 and B5, LEA vs static.

    ``checked`` (k = 5): every accepted round within 1e-2 relative of the
    uncoded gradient, the device decode on five rounds too, LEA above
    static.  CodeSpec(15, 10, 5, 2) has K* = 9 <= r, so every received set a
    round can have lies on one or two workers' strided Chebyshev nodes.  At
    k = 8 (K* = 15 > r, the size first planned) the received sets pair up
    nodes and the float32 decode amplifies round-off by a Lebesgue constant
    of 6.8e6; that run is read, not checked: it logs the per-round relative
    errors and the rounds the example's guard rejects.  Bad workers finish
    nothing in the deadline (mu_b * d < 1, ell_b = 0) and good ones are
    scarce (pi_g = 0.2), which is where LEA's allocation matters.  The step
    is a tenth of the example's: with 300 equations in 3000 unknowns the
    example's step drives the gradient to 1e-4 of its start within 60
    rounds, and a vanishing gradient makes the relative error of any float32
    gradient, coded or not, grow without bound.
    """
    spec = lg.CodeSpec(15, 10, k, 2)
    rows, cols, rounds = 60, 3000, 200
    mu_g, mu_b, dl = 10.0, 0.5, 1.0
    lp = LoadParams(15, spec.recovery_threshold, 10, 0)
    rng = np.random.default_rng(63)
    w_true = rng.normal(size=(cols,))
    x_np = rng.normal(size=(k, rows, cols))
    y_np = x_np @ w_true + 0.01 * rng.normal(size=(k, rows))
    x = torch.as_tensor(x_np, dtype=torch.float32, device="cuda")
    y = torch.as_tensor(y_np, dtype=torch.float32, device="cuda")
    strategies = ("lea", "static_equal")
    states, loads, feas = throughput.rollout(23, lp, [0.6] * 15, [0.9] * 15, rounds,
                                             strategies=strategies, device="cuda")
    success = throughput.score_rollout(states, loads, feas, lp, mu_g, mu_b, dl).cpu().numpy()
    on_time = co.chunk_on_time(states, loads, mu_g, mu_b, dl, spec.r).cpu().numpy()
    reset_all_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    coded = co.encode_dataset(spec, x, y)
    lr = 2e-3 / (k * rows)
    line, device_checks = {}, []
    for j, s in enumerate(strategies):
        cache = co.DecodeCache(spec)
        w = torch.zeros((cols,), dtype=torch.float32, device="cuda")
        rels, caught = [], []
        for m in range(rounds):
            if not success[m, j]:
                continue
            grad = co.coded_linear_gradient(coded, w, on_time[j, m], cache=cache)
            gnorm = float(torch.linalg.norm(grad))
            if not np.isfinite(gnorm) or gnorm > 1e4 * k * rows:   # the example's guard
                caught.append(m)
                continue
            true = co.uncoded_linear_gradient(x, y, w)
            rel = float(torch.linalg.norm(grad - true) / torch.linalg.norm(true))
            if checked and not rel <= 1e-2:
                raise AssertionError(f"{s} round {m}: decoded gradient rel err {rel}")
            if checked and len(rels) < 5:      # the device decode, checked below
                device_checks.append((s, m, w, on_time[j, m], true))
            rels.append(rel)
            w = w - lr * grad
        loss = float(torch.mean((x @ w - y) ** 2))
        rel_np = np.asarray(rels)
        line[s] = {"engine": float(throughput.timely_throughput(torch.as_tensor(success[:, j]))),
                   "accepted": len(rels) / rounds, "guard_caught_rounds": caught,
                   "rel_err_first10": [float(f"{v:.3g}") for v in rels[:10]],
                   "rel_err_median": float(np.median(rel_np)) if rels else None,
                   "rel_err_p90": float(np.quantile(rel_np, 0.9)) if rels else None,
                   "rel_err_max": float(rel_np.max()) if rels else None,
                   "rel_err_over_1e-2": int((rel_np > 1e-2).sum()),
                   "loss": loss, "decode_mats": len(cache)}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = coding_launches()
    for s, m, w, mask, true in device_checks:
        dev_grad, ok = co.coded_linear_gradient_device(coded, w, torch.as_tensor(mask, device="cuda"))
        rel_dev = float(torch.linalg.norm(dev_grad - true) / torch.linalg.norm(true))
        if not bool(ok) or not rel_dev <= 1e-2:
            raise AssertionError(f"{s} round {m}: device decode rel err {rel_dev}")
    if checked and not line["lea"]["accepted"] > line["static_equal"]["accepted"]:
        raise AssertionError(f"LEA does not beat static in the coded regression: {line}")
    log("float_regression", spec=f"CodeSpec(15,10,{k},2)", checked=checked,
        x=(k, rows, cols), rounds=rounds, wall_s=f"{wall:.3f}",
        loss_at_zero=f"{float(torch.mean(y ** 2)):.2f}", launches=json.dumps(launches),
        **{s: json.dumps(v) for s, v in line.items()})
    return launches


def coded_path() -> dict[str, int]:
    """Phase 7: the coded-computing path.  Each part sets the counts to 0
    before its own work and reads them after it, before its cross-checks;
    returns their sum."""
    from repro_torch.core import coded_ops as co
    from repro_torch.core import lagrange as lg
    from repro_torch.core import throughput
    from repro_torch.core.lea import LoadParams

    parts = {"exact_deg1": lambda: exact_deg1(co, lg, throughput, LoadParams),
             "exact_deg2": lambda: exact_deg2(co, lg, throughput, LoadParams),
             "float_k5": lambda: float_regression(co, lg, throughput, LoadParams),
             "float_k8_read": lambda: float_regression(co, lg, throughput, LoadParams,
                                                       k=8, checked=False)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    per_part = {name: part() for name, part in parts.items()}
    launches = {name: sum(c[name] for c in per_part.values())
                for name in coding_launches()}
    idle = [name for name, count in launches.items() if count < 1]
    if idle:
        raise AssertionError(f"the coded path never launched {idle}: {per_part}")
    log("coded_path", wall_s=f"{time.perf_counter() - t0:.3f}",
        launches=json.dumps(launches))
    return launches


def visible_pairs(sq: int, sk: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs the masks leave visible: what B6's work depends on."""
    pos = np.arange(sq, dtype=np.int64) + (sk - sq)
    hi = np.minimum(sk - 1, pos) if causal else np.full(sq, sk - 1)
    lo = np.maximum(0, pos - window + 1) if window is not None else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def check_flash_kernel() -> dict:
    """Phase 9: B6 against ``flash_attention_ref`` on the card, timed."""
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                      flash_attention_ref, flash_route,
                                                      head_dim_instance, wgmma_instance)
    from repro_torch.kernels.flash_attention.ref import visible_mask

    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    # (case, B, Hq, Hkv, Sq, Sk, D, dtype, causal, window, main shape)
    cases = [
        ("prefill", 4, 16, 8, 2048, 2048, 128, bf16, True, None, True),
        ("prefill fp16", 4, 16, 8, 2048, 2048, 128, f16, True, None, False),
        ("prefill f32", 4, 16, 8, 2048, 2048, 128, f32, True, None, False),
        ("prefill d64", 4, 16, 8, 2048, 2048, 64, bf16, True, None, False),
        ("smoke width d32", 4, 4, 2, 1000, 1000, 32, bf16, True, None, False),
        ("ragged", 4, 16, 8, 1000, 1000, 128, bf16, True, None, False),
        ("non-causal", 4, 16, 8, 2048, 2048, 128, bf16, False, None, False),
        ("decode-aligned", 4, 16, 8, 16, 2048, 128, bf16, True, None, False),
        ("sq>sk", 2, 16, 8, 300, 100, 128, bf16, True, None, False),
        # Mixtral's attention widths; the window cut from its 4096 so that
        # masking matters at 4096 tokens and the plain version fits
        ("mixtral window", 1, 48, 8, 4096, 4096, 128, bf16, True, 1024, False),
        # the head widths of the repo's other configs, at their heads: the
        # wgmma route's padded instantiations (128 for 96 and 112, 192)
        ("phi-3-vision d96", 1, 32, 32, 2048, 2048, 96, bf16, True, None, False),
        ("zamba2 d112", 1, 32, 32, 2048, 2048, 112, bf16, True, None, False),
        ("nemotron-4 d192", 1, 96, 8, 1024, 1024, 192, bf16, True, None, False),
        # phase 15's prefills: llama3.2-3b's GQA groups of 3 and yi-9b's of 8
        ("llama3.2-3b gqa 24/8", 4, 24, 8, 2048, 2048, 128, bf16, True, None, False),
        ("yi-9b gqa 32/4", 4, 32, 4, 2048, 2048, 128, bf16, True, None, False),
        # phase 19's sharded prefill: yi-9b's heads split over tp = 2, one rank's
        ("yi-9b per rank tp=2 16/2", 4, 16, 2, 2048, 2048, 128, bf16, True, None, False),
        ("nemotron-4 d192 fp16", 1, 96, 8, 1024, 1024, 192, f16, True, None, False),
        # the FFMA route at D = 192 (no config runs float32 attention there)
        ("float32 d192", 1, 4, 4, 2048, 2048, 192, f32, True, None, False),
        # phase 17's prefills: olmoe's MHA with qk-norm, mixtral past its own
        # 4096-token window, zamba2's shared block (D = 112)
        ("olmoe-1b-7b mha 16/16", 4, 16, 16, 2048, 2048, 128, bf16, True, None, False),
        ("mixtral-8x22b window 4096", 1, 48, 8, 6144, 6144, 128, bf16, True, 4096, False),
        ("zamba2-7b d112 batch 4", 4, 32, 32, 2048, 2048, 112, bf16, True, None, False),
        # phase 18's prefills: whisper-tiny's bidirectional encoder over its
        # 1500 frames and its cross-attention (432 text queries over them),
        # phi-3-vision's 32 heads of 96 at batch 4
        ("whisper encoder", 8, 6, 6, 1500, 1500, 64, bf16, False, None, False),
        ("whisper cross", 8, 6, 6, 432, 1500, 64, bf16, False, None, False),
        ("phi-3-vision d96 batch 4", 4, 32, 32, 2048, 2048, 96, bf16, True, None, False),
        ("d40, the next instantiation up", 2, 8, 8, 1000, 1000, 40, bf16, True, None, False),
    ]
    record = {}
    for what, b, hq, hkv, sq, sk, d, dt, causal, window, main in cases:
        # (B, H, S, D) views of (B, S, H, D) tensors, as attention_train passes them
        q = torch.randn((b, sq, hq, d), generator=gen, device="cuda").to(dt).transpose(1, 2)
        k = torch.randn((b, sk, hkv, d), generator=gen, device="cuda").to(dt).transpose(1, 2)
        v = torch.randn((b, sk, hkv, d), generator=gen, device="cuda").to(dt).transpose(1, 2)
        run = lambda: flash_attention_cuda(q, k, v, causal=causal, window=window)
        plain = lambda: flash_attention_ref(q, k, v, causal=causal, window=window, block_q=1024)
        got, want = run(), plain()
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        if dt == f32:
            tol = "1e-5 (P|V|)"
            bound = FP32_REL * flash_attention_ref(q, k, v.abs(), causal=causal,
                                                   window=window, block_q=1024)
        else:     # eps: the type's rounding unit
            eps_log2 = -8 if dt == bf16 else -11
            tol = f"2^{eps_log2} max|v| + 2^{eps_log2} |ref|"
            bound = 2.0 ** eps_log2 * (v.float().abs().amax() + want.float().abs())
        err = float(diff.max())
        if got.shape != want.shape or not bool(torch.isfinite(got).all()) \
                or bool((diff > bound).any()):
            raise AssertionError(f"flash_attention_cuda {what}: max|diff| {err} ({tol})")
        zero_rows = max(sq - sk, 0) if causal else 0
        if zero_rows and bool(got[:, :, :zero_rows].any()):
            raise AssertionError(f"flash_attention_cuda {what}: rows with no key are not 0")
        ms = time_ms(run)
        plain_ms = time_ms(plain, warm=1, runs=3)
        library_ms = None
        sdpa = torch.nn.functional.scaled_dot_product_attention
        if window is None and (sq == sk or not causal):   # SDPA aligns causal masks top-left
            library_ms = time_ms(lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=True))
        elif sq == sk:     # the window as a boolean mask
            mask = visible_mask(range(sq), sq, sk, causal, window, q.device)
            library_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=mask, enable_gqa=True))
        pairs = visible_pairs(sq, sk, causal, window)
        moved = q.element_size() * (2 * b * hq * sq * d + 2 * b * hkv * sk * d)
        b_ms, b_by = _bound(moved, 4 * d * pairs * b * hq,
                            FP32_FLOP_PER_S if dt == f32 else BF16_FLOP_PER_S)
        route = flash_route(dt, d)
        log("kernel", name="flash_attention_cuda", case=json.dumps(what), route=route,
            instantiation=wgmma_instance(d) if route == "wgmma" else head_dim_instance(d),
            q=(b, hq, sq, d), kv=(b, hkv, sk, d), dtype=str(dt).split(".")[-1],
            causal=causal, window=window, zero_rows=zero_rows, max_abs_err=err,
            tolerance=json.dumps(tol),
            tolerance_used=f"{float((diff / bound.clamp_min(1e-30)).max()):.3f}",
            bound_by=b_by,
            **timing_fields(b_ms, ms=ms, plain_ms=plain_ms, library_ms=library_ms))
        entry = record.setdefault("flash_attention_cuda", {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if main:
            entry.update(timing_entry(ms=ms, plain_ms=plain_ms, library_ms=library_ms),
                         bound_ms=b_ms, bound_by=b_by,
                         library="scaled_dot_product_attention(is_causal=True, enable_gqa=True)",
                         kernel_route=route, shape=[[b, hq, sq, d], [b, hkv, sk, d]])
        del q, k, v, got, want, diff, bound
        torch.cuda.empty_cache()
    for dt, d in ((bf16, 128), (f16, 64), (bf16, 32), (f32, 128)):   # no keys: all zero
        q = torch.randn((2, 4, 37, d), generator=gen, device="cuda").to(dt)
        k = torch.empty((2, 2, 0, d), dtype=dt, device="cuda")
        got = flash_attention_cuda(q, k, k, causal=True)
        if got.shape != q.shape or bool(got.any()):
            raise AssertionError(f"flash_attention_cuda Sk = 0 {dt} D = {d}: not all 0")
        log("kernel_no_keys", route=flash_route(dt, d), dtype=str(dt).split(".")[-1], d=d,
            zeros=True)
    return record


def timed(fn):
    """(result, seconds) of ``fn()``, synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


class Float32Layers:
    """A float32 evaluation of bf16 parameters: each tensor upcast when the
    forward reads it, a layer (``layer(i)``: a decoder or Mamba2 layer, an
    xLSTM block) or a block (``params["shared"]``, the hybrid's shared
    attention + MLP) at a time, so the reference needs that much float32,
    not the model's (yi-9b's would be 35 GB, nemotron-4's 65 GB).  The values
    are those of a float32 copy of the model."""

    def __init__(self, params):
        self.params = params

    def __getitem__(self, name: str):
        t = self.params[name]
        if t is None or isinstance(t, torch.Tensor):
            return None if t is None else t.float()
        return {k: v.float() for k, v in t.items()}

    def layer(self, i: int) -> dict:
        return {name: t.float() for name, t in self.params.layer(i).items()}

    def stack(self, name: str) -> list[dict]:
        """One of the encoder-decoder's stacks (``EncDecLM.stack``), upcast
        whole: whisper-tiny's largest is 7 M parameters."""
        return [{k: t.float() for k, t in bp.items()} for bp in self.params.stack(name)]


def bf16_bound(ref_logits: torch.Tensor, cfg) -> float:
    """The bound phase 17 holds xLSTM's bf16 prefill to, against a float32
    evaluation of the same weights (it has no attention, so no flash / dense
    pair): 2^-8, bf16's unit roundoff, for a rounding of the residual stream
    in each block and one in the head, added in the worst case, times the
    largest logit.  ``tests/test_torch_zoo.py``
    (``test_xlstm_bf16_prefill_meets_the_stated_bound``) holds the JAX
    package's bf16 xLSTM and the port's to the same rule on the CPU."""
    return 2.0 ** -8 * (cfg.n_layers + 1) * float(ref_logits.abs().max())


class MoeDrops:
    """While active (``with``), counts each MoE call's routes dropped past
    capacity, per batch row, over the calls: it recomputes the routing from
    the call's own input (``layers.moe_routes``) and then calls the port's
    unchanged ``layers.moe``.  Used only by the decode check, never in a
    timed run."""

    def __init__(self, batch: int):
        self.rows = torch.zeros(batch, dtype=torch.int64, device="cuda")

    def __enter__(self):
        from repro_torch.models import layers as L
        self._layers, self._moe = L, L.moe

        def counted(x, p, cfg):
            self.rows += (~L.moe_routes(x, p, cfg).keep).sum(-1)
            return self._moe(x, p, cfg)

        L.moe = counted
        return self

    def __exit__(self, *exc):
        self._layers.moe = self._moe


def serve_config(name: str, *, batch: int, prompt: int, steps: int, checked_steps,
                 seed: int, tag: str, profile: bool = False, **overrides) -> int:
    """One config's serving path at full width (``overrides`` may cut its
    depth); returns B6's launches in the main path's run (one flash prefill
    and the decode steps).  The batch is ``api.make_batch``'s for a prefill
    cell of ``prompt`` positions: the tokens and, for the stub frontends,
    whisper's frames (beside the prompt) or phi-3-vision's patches (the
    first ``frontend_tokens`` of the prompt's positions), carried into
    every prefill made here.  Phase 10 (qwen3), phase 15 (the rest of the
    dense family), phase 17 (MoE, hybrid, xLSTM) and phase 18 (enc-dec, the
    vision stub) run it."""
    import dataclasses
    import gc

    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import api, hybrid, xlstm
    from repro_torch.models.layers import moe_capacity

    t_config = time.perf_counter()
    cfg = get_config(name, attn_impl="flash", **overrides)
    expected = api.attention_calls(cfg)       # B6's launches a flash prefill
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = api.get_model(cfg).init_params(gen, cfg, device="cuda")
    n_params = sum(t.numel() for t in params.parameters())
    inputs = api.make_batch(cfg, ShapeCell("serve", prompt, batch, "prefill"), gen,
                            device="cuda")
    tokens = inputs["tokens"]
    prefill = api.make_prefill_step(cfg, max_len=prompt + steps)
    serve = api.make_serve_step(cfg)
    # the step functions set the bf16 split-K flag for their call only
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction

    # warm-up (cuBLAS handles, the allocator): one prefill and one step
    logits, cache = prefill(params, inputs)
    serve(params, cache, {"next_token": logits.argmax(-1)})
    del logits, cache
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # -- the main path: prefill, then greedy decode ---------------------------
    reset_all_launch_counts()
    (logits, cache), prefill_s = timed(lambda: prefill(params, inputs))
    launches_prefill = fa.launch_counts()["flash_attention_cuda"]
    first_logits = logits
    fed, kept = [], {}

    def decode():
        nonlocal logits, cache
        for t in range(steps):
            tok = logits.argmax(-1)
            fed.append(tok)
            logits, cache = serve(params, cache, {"next_token": tok})
            if t in checked_steps:
                kept[t] = logits
    _, decode_s = timed(decode)
    launches = fa.launch_counts()["flash_attention_cuda"]
    if torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction != flag:
        raise AssertionError("a step function left the bf16 split-K flag changed")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if launches_prefill != expected or launches != expected:
        raise AssertionError(f"{name}: B6 launched {launches_prefill} times in the prefill "
                             f"and {launches} in all, not {expected} (attention_calls)")
    # every logit finite
    if not all(bool(torch.isfinite(t).all()) for t in (first_logits, *kept.values())):
        raise AssertionError(f"{name}: non-finite logits on the serving path")
    del cache
    torch.cuda.empty_cache()

    # flash vs dense, against a float32 evaluation of the model: the kernel
    # must be no less accurate than the plain attention it replaces.  xLSTM
    # runs no attention: its bf16 prefill is held to bf16_bound instead.
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    ref32 = api.make_prefill_step(cfg32, max_len=prompt, attn_impl="ref")
    want = ref32(Float32Layers(params), inputs)[0]
    torch.cuda.empty_cache()
    real = slice(0, cfg.vocab_size)
    err_flash = float((first_logits[:, real] - want[:, real]).abs().max())
    dense_s = None
    if expected:
        dense = api.make_prefill_step(cfg, max_len=prompt + steps, attn_impl="ref")
        dense_logits, dense_s = timed(lambda: dense(params, inputs)[0])
        torch.cuda.empty_cache()
        err_dense = float((dense_logits[:, real] - want[:, real]).abs().max())
        del dense_logits
        if not err_flash <= 1.5 * err_dense + 5e-3:
            raise AssertionError(f"{name}: flash prefill max|err| {err_flash} vs float32, "
                                 f"dense bf16 {err_dense}: above 1.5 x dense + 5e-3")
    else:
        err_dense = err_flash
        if not err_flash <= bf16_bound(want[:, real], cfg):
            raise AssertionError(f"{name}: bf16 prefill max|err| {err_flash} vs float32 above "
                                 f"{bf16_bound(want[:, real], cfg)} (bf16_bound)")

    # decode vs prefill: step t's logits against a fresh flash prefill over
    # the prompt and the t + 1 tokens fed so far (the same frames or
    # patches).  Both are bf16 evaluations of the same function, each about
    # err_dense from float32, so they may differ by twice that; 0.02 covers
    # the max over other positions.  MoE:
    # a prefill may drop routes past capacity (a decode step never does), and
    # through attention a drop at any position reaches the newest token; so
    # only rows where neither prefill dropped a route are held, and at least
    # one must be.
    tol = 2 * err_dense + 0.02
    generated = torch.stack(fed, dim=1)                 # (B, steps)
    moe = bool(cfg.n_experts)
    drops_main = None
    if moe:
        with MoeDrops(batch) as counter:
            prefill(params, inputs)
        drops_main = counter.rows.tolist()
    before = fa.launch_counts()["flash_attention_cuda"]
    worst, held, skipped = 0.0, {}, {}
    for t, got in kept.items():
        prefix = torch.cat([tokens, generated[:, :t + 1].to(tokens.dtype)], dim=1)
        with MoeDrops(batch) as counter:
            fresh = api.make_prefill_step(cfg)(params, dict(inputs, tokens=prefix))[0]
        rows = list(range(batch))
        if moe:
            fresh_drops = counter.rows.tolist()
            skipped[t] = {r: drops_main[r] + fresh_drops[r] for r in rows
                          if drops_main[r] or fresh_drops[r]}
            rows = [r for r in rows if r not in skipped[t]]
            if not rows:
                raise AssertionError(f"{name}: decode step {t}: every row dropped routes "
                                     f"in a prefill ({skipped[t]}); no row left to hold")
        held[t] = rows
        diff = float((got[rows][:, real] - fresh[rows][:, real]).abs().max())
        worst = max(worst, diff)
        if not diff <= tol:
            raise AssertionError(f"{name}: decode step {t}: max|decode - prefill| {diff} > {tol}"
                                 f" over rows {rows}")
    if fa.launch_counts()["flash_attention_cuda"] - before != expected * len(kept):
        raise AssertionError(f"{name}: a fresh prefill did not launch B6 {expected} times")

    lines = profile_serving(prefill, serve, params, inputs) if profile else {}
    full = get_config(name)
    cut = {f"{k}": f"{v} of {getattr(full, k)}" for k, v in overrides.items()}
    family = {}
    if moe:
        family = dict(experts=f"{cfg.n_experts}top{cfg.top_k}",
                      moe_capacity_prefill=moe_capacity(prompt, cfg),
                      moe_dropped_main_by_row=json.dumps(drops_main),
                      decode_rows_held=json.dumps(held),
                      decode_rows_skipped_drops=json.dumps(skipped))
    elif cfg.family == "hybrid":
        family = dict(n_attn_apps=hybrid.n_attn_apps(cfg), tail_layers=hybrid.group_split(cfg)[1])
    elif expected == 0:
        family = dict(slstm_steps=prompt * xlstm.block_types(cfg).count("slstm"),
                      bf16_bound=bf16_bound(want[:, real], cfg))
    elif cfg.frontend is not None:
        family = dict(frontend=cfg.frontend, frontend_tokens=cfg.frontend_tokens,
                      text_tokens=tokens.shape[1], encoder_layers=cfg.encoder_layers,
                      b6_per_prefill=json.dumps(
                          {"encoder": cfg.encoder_layers, "decoder_self": cfg.n_layers,
                           "cross": cfg.n_layers} if cfg.is_encdec else
                          {"decoder": cfg.n_layers}))
    log(tag, config=cfg.name, params=n_params, layers=cfg.n_layers,
        **({"cut": json.dumps(cut)} if cut else {}),
        d_model=cfg.d_model, heads=f"{cfg.n_heads}/{cfg.n_kv_heads}x{cfg.head_dim_}",
        vocab=cfg.padded_vocab, dtype=cfg.dtype,
        batch=batch, prompt=prompt, decode_steps=steps,
        prefill_ms=f"{prefill_s * 1e3:.3f}",
        dense_prefill_ms="none" if dense_s is None else f"{dense_s * 1e3:.3f}",
        prefill_tokens_per_s=f"{batch * prompt / prefill_s:.0f}",
        decode_ms_per_step=f"{decode_s / steps * 1e3:.3f}",
        decode_tokens_per_s=f"{batch * steps / decode_s:.1f}",
        peak_memory_gib=f"{peak_gib:.2f}", flash_launches=launches,
        b6_route=fa.flash_route(params["embed"].dtype, cfg.head_dim_) if expected else "none",
        err_flash_vs_f32=err_flash, err_dense_vs_f32=err_dense if expected else "none",
        decode_vs_prefill_max=worst, decode_vs_prefill_tol=tol,
        checked_steps=json.dumps(list(kept)), **family,
        bf16_split_k_flag_outside_steps=flag, wall_s=f"{time.perf_counter() - t_config:.1f}",
        gpu=json.dumps(nvidia_smi_line()))
    for part, line in lines.items():
        log(f"{tag}_profile", part=part, **line)
    del params, first_logits, kept, logits, want, fresh
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def serve_lm() -> int:
    """Phase 10: ``qwen3_0_6b``'s serving path at full width, profiled."""
    return serve_config("qwen3_0_6b", batch=4, prompt=2048, steps=64,
                        checked_steps=(0, 21, 42, 63), seed=10, tag="serve", profile=True)


def dense_serve() -> int:
    """Phase 15: the rest of the dense family served at full width (nemotron-4
    at 2 of its 96 layers); returns B6's launches over the three main paths
    (counts set to 0 before each and summed)."""
    t0 = time.perf_counter()
    runs = [("llama3_2_3b", dict(batch=4, prompt=2048, steps=16, checked_steps=(0, 15))),
            ("yi_9b", dict(batch=4, prompt=2048, steps=16, checked_steps=(0, 15))),
            ("nemotron_4_340b", dict(batch=1, prompt=1024, steps=8, checked_steps=(0, 7),
                                     n_layers=2))]
    launches = 0
    for seed, (name, kw) in enumerate(runs, start=15):
        launches += serve_config(name, seed=seed, tag="dense_serve", **kw)
    log("dense_serve_path", b6_launches=launches, wall_s=f"{time.perf_counter() - t0:.1f}")
    return launches


def zoo_serve() -> int:
    """Phase 17: the MoE, hybrid and xLSTM families served at full width
    (mixtral at 2 of its 56 layers, past its 4096-token window; zamba2 at
    21 of its 81 and xlstm at 6 of its 12, to make room for phase 19); returns
    B6's launches over the four main paths (counts set to 0 before each and
    summed)."""
    t0 = time.perf_counter()
    runs = [("olmoe_1b_7b", dict(batch=4, prompt=2048, steps=16, checked_steps=(0, 15))),
            ("mixtral_8x22b", dict(batch=1, prompt=6144, steps=8, checked_steps=(0, 7),
                                   n_layers=2)),
            # depth cut to make room for phase 19 (PERF.md): zamba2 21 of 81
            # layers (3 groups of 6 and the tail of 3, as 81's 13 and 3), xlstm
            # 6 of 12 blocks (sLSTM at 3 among mLSTM blocks, as at 3 and 9)
            ("zamba2_7b", dict(batch=4, prompt=2048, steps=16, checked_steps=(0, 15),
                               n_layers=21)),
            ("xlstm_125m", dict(batch=4, prompt=2048, steps=16, checked_steps=(0, 15),
                                n_layers=6))]
    launches = 0
    for seed, (name, kw) in enumerate(runs, start=17):
        launches += serve_config(name, seed=seed, tag="zoo_serve", profile=True, **kw)
    log("zoo_serve_path", b6_launches=launches, wall_s=f"{time.perf_counter() - t0:.1f}")
    return launches


def frontend_serve() -> dict[str, int]:
    """Phase 18: the encoder-decoder and vision-stub families served at full
    width, each its own main path (counts set to 0 before each): whisper-tiny
    (8 prompts of 432 tokens over 1 500 frames: 448, its text context, with
    the decode steps) and phi-3-vision-4.2b whole (4 prompts of 576 patches
    and 1 472 tokens); returns B6's launches by path.  ``serve_config``
    frees each config's memory before the next."""
    t0 = time.perf_counter()
    launches = {
        "encdec_serve": serve_config("whisper_tiny", batch=8, prompt=432, steps=16,
                                     checked_steps=(0, 15), seed=18, tag="frontend_serve",
                                     profile=True),
        "vlm_serve": serve_config("phi_3_vision_4_2b", batch=4, prompt=2048, steps=16,
                                  checked_steps=(0, 15), seed=19, tag="frontend_serve",
                                  profile=True),
    }
    log("frontend_serve_path", b6_launches=json.dumps(launches),
        wall_s=f"{time.perf_counter() - t0:.1f}")
    return launches


def train_path(tmp: Path) -> dict[str, int]:
    """Phase 16: ``launch.train.main`` on ``qwen3_0_6b`` at full width with
    coded DP, a resume, an int8-compressed run and one timed plain step;
    returns B2's launches over the two coded-DP runs (counts set to 0 just
    before the first, read just after the second)."""
    import math

    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.kernels import poisson_binomial as pb
    from repro_torch.launch import train as train_mod
    from repro_torch.models import api

    batch, seq = 8, 1024
    ckpt = tmp / "ckpt"
    common = ["--arch", "qwen3_0_6b", "--batch", str(batch), "--seq", str(seq),
              "--device", "cuda"]
    coded = common + ["--coded-dp", "--ckpt-every", "3", "--ckpt-dir", str(ckpt)]
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launch_counts()
    first, first_s = timed(lambda: train_mod.main(coded + ["--steps", "6"]))
    after_first = pb.launch_counts()["success_tails_cuda"]
    second, second_s = timed(lambda: train_mod.main(coded + ["--steps", "8"]))
    b2 = pb.launch_counts()["success_tails_cuda"]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    rounds = len(first["history"]) + len(second["history"])
    if rounds != 8 or after_first < 6 or b2 < rounds:
        raise AssertionError(f"B2 launched {b2} times ({after_first} in the first run) "
                             f"over {rounds} coded-DP rounds; at least one a round")
    # the resume: steps 6 and 7 from the step-6 checkpoint and its data cursor
    if [h["step"] for h in second["history"]] != [6, 7]:
        raise AssertionError(f"resume did not pick up step 6: {second['history']}")
    meta = json.loads((ckpt / "step_6" / "meta.json").read_text())
    if meta["pipeline"]["step"] != 6 or meta["lea"]["rounds"] != 6:
        raise AssertionError(f"step 6's checkpoint holds {meta['pipeline']}, "
                             f"{meta['lea']['rounds']} rounds")
    losses = [h["loss"] for h in first["history"] + second["history"] if "loss" in h]
    if not losses or not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"coded-DP training losses {losses}: not finite and falling")
    misses = sum(1 for h in first["history"] + second["history"] if "missed_deadline" in h)
    log("train", config=get_config("qwen3_0_6b").name, batch=batch, seq=seq, steps=8, resumed_at=6,
        losses=json.dumps([round(x, 4) for x in losses]), deadline_misses=misses,
        timely_throughput=f"{second['timely_throughput']:.3f}",
        b2_launches=b2, rounds=rounds, first_run_s=f"{first_s:.2f}",
        resumed_run_s=f"{second_s:.2f}", ms_per_coded_step=f"{first_s / 6 * 1e3:.1f}",
        peak_memory_gib=f"{peak_gib:.2f}", gpu=json.dumps(nvidia_smi_line()))

    packed = train_mod.main(common + ["--steps", "2", "--compress", "int8"])
    packed_losses = [h["loss"] for h in packed["history"]]
    if len(packed_losses) != 2 or not all(math.isfinite(x) for x in packed_losses):
        raise AssertionError(f"int8-compressed losses {packed_losses}")
    log("train_compress", kind="int8", losses=json.dumps(packed_losses))

    # one plain step through make_train_step, timed and profiled
    cfg = get_config("qwen3_0_6b")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(16)
    state = api.init_state(cfg, gen, device="cuda")
    step = api.make_train_step(cfg, peak_lr=1e-3, warmup=5, total_steps=10)
    data = api.make_batch(cfg, ShapeCell("train", seq, batch, "train"), gen, device="cuda")
    state, _ = step(state, data)                          # warm-up
    torch.cuda.reset_peak_memory_stats()
    (state, metrics), step_s = timed(lambda: step(state, data))
    peak_step = torch.cuda.max_memory_allocated() / 2**30
    box = {"state": state}

    def one_step():
        box["state"], box["metrics"] = step(box["state"], data)
    window = profile_window(one_step)
    if not math.isfinite(float(metrics["loss"])):
        raise AssertionError(f"plain step loss {float(metrics['loss'])}")
    log("train_step", config=cfg.name, batch=batch, seq=seq, remat=cfg.remat,
        scan_groups=cfg.scan_groups, microbatch=cfg.microbatch,
        loss=f"{float(metrics['loss']):.4f}", ms_per_step=f"{step_s * 1e3:.1f}",
        tokens_per_s=f"{batch * seq / step_s:.0f}", peak_memory_gib=f"{peak_step:.2f}",
        **{f"profile_{k}": v for k, v in window.items()}, gpu=json.dumps(nvidia_smi_line()))
    log("train_path", b2_launches=b2, wall_s=f"{time.perf_counter() - t0:.1f}")
    del state, box
    torch.cuda.empty_cache()
    return {"success_tails_cuda": b2}


def profile_window(fn) -> dict:
    """Wall time, device busy time and share idle, kernel launches and the
    top kernels by device time of ``fn()``, from ``torch.profiler``'s
    kernel events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = timed(fn)
    by_name: dict[str, float] = {}
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": f"{wall * 1e3:.3f}", "device_busy_ms": f"{busy_ms:.3f}",
            "kernel_launches": len(kernels),
            "idle_share": f"{1 - busy_ms / (wall * 1e3):.3f}",
            "top_kernels_ms": json.dumps({n[:60]: round(us / 1e3, 3) for n, us in top})}


def profile_serving(prefill, serve, params, inputs, steps: int = 8) -> dict:
    """:func:`profile_window` of one prefill of the batch ``inputs`` and of
    ``steps`` decode steps."""
    state = {}

    def run_prefill():
        state["logits"], state["cache"] = prefill(params, inputs)

    def run_decode():
        for _ in range(steps):
            state["logits"], state["cache"] = serve(
                params, state["cache"], {"next_token": state["logits"].argmax(-1)})

    return {"prefill": profile_window(run_prefill),
            f"decode_{steps}_steps": profile_window(run_decode)}


def fault_grid(scenarios, seeds: int, device: str):
    """``sweep_faults``' arguments for a ``packet_erasure`` grid, ``seeds``
    rows a cell (cell-major): the channel ``preempt`` + ``packet_bernoulli``
    with each row's (p_preempt, p_drop), as ``benchmarks/bench_faults.py``
    builds them."""
    from repro_torch import faults
    from repro_torch.core.lea import PoolLoad

    lp, meta = scenarios[0].lp, [dict(sc.meta) for sc in scenarios]
    col = lambda key: torch.tensor([m[key] for m in meta for _ in range(seeds)],
                                   dtype=torch.float32, device=device)
    rows = lambda attr: torch.tensor([getattr(sc, attr) for sc in scenarios
                                      for _ in range(seeds)], dtype=torch.float32,
                                     device=device)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=device)
    pool = PoolLoad(kstar=i32(lp.kstar), ell_g=i32(lp.ell_g), ell_b=i32(lp.ell_b),
                    mask=torch.ones(lp.n, dtype=torch.bool, device=device))
    channel = faults.make_channel([("preempt", {"p_preempt": col("p_preempt")}),
                                   ("packet_bernoulli", {"p_drop": col("p_drop")})])
    sc = scenarios[0]
    args = (pool, rows("p_gg"), rows("p_bb"), sc.mu_g, sc.mu_b, sc.deadline, channel,
            meta[0]["k1star"])
    geometry = dict(rounds=sc.rounds, strategies=("lea", "static"), r=meta[0]["r"],
                    packets=meta[0]["packets"], p1=meta[0]["p1"])
    return args, geometry


def faults_grid() -> dict[str, int]:
    """Phase 11a: the packet_erasure grid at the paper's M, 8 seeds a cell,
    held to ``BENCH_faults.json``; returns the fused allocation's and the
    packet-count kernel's launches."""
    from repro_torch import faults, sweeps
    from repro_torch.kernels import packet_counts as pc
    from repro_torch.kernels import poisson_binomial as pb
    from repro_torch.random import torch_draws

    seeds = 8
    scenarios = sweeps.expand("packet_erasure", rounds=20_000)
    args, geometry = fault_grid(scenarios, seeds, "cuda")
    rounds = geometry["rounds"]
    reset_all_launch_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out, wall = timed(lambda: faults.sweep_faults(torch_draws(11), *args, **geometry))
    launches = pb.launch_counts()["allocate_masked_cuda"]
    counted = pc.launch_counts()["packet_counts_cuda"]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if counted != 1:
        raise AssertionError(f"the grid's sweep launched packet_counts_cuda {counted} times")
    # one cell alone (its first seed's row), the same geometry
    one_args, _ = fault_grid(scenarios[:1], 1, "cuda")
    reset_all_launch_counts()
    faults.sweep_faults(torch_draws(12), *one_args, **geometry)
    torch.cuda.synchronize()
    launches_one = pb.launch_counts()["allocate_masked_cuda"]
    # a second, warmed call of the whole grid, timed beside the first
    _, wall_warm = timed(lambda: faults.sweep_faults(torch_draws(11), *args, **geometry))
    if launches < 1 or launches != launches_one:
        raise AssertionError(f"the allocation launched {launches} times for the grid, "
                             f"{launches_one} for one cell")
    aon, con, part = (x.cpu().numpy() for x in out)
    if aon.shape != (len(scenarios) * seeds, rounds, 2):
        raise AssertionError(f"outcomes of shape {aon.shape}")
    if (aon & ~con).any() or (part & con).any():
        raise AssertionError("a round recovered all-or-nothing is not recovered conserving, "
                             "or partial overlaps full")
    metas = [dict(sc.meta) for sc in scenarios]
    faulted = np.repeat([m["p_preempt"] > 0 or m["p_drop"] > 0 for m in metas], seeds)
    gain = int(con[faulted].sum()) - int(aon[faulted].sum())
    if not gain > 0:
        raise AssertionError(f"conserve does not beat all-or-nothing: gain {gain}")
    bench = {c["name"]: c for c in json.loads((ROOT / "BENCH_faults.json").read_text())["results"]}
    scale = (rounds / 512) ** 0.5       # the committed run: 512 rounds, one seed
    lea_col = geometry["strategies"].index("lea")
    columns = {"recovered_aon": aon, "recovered_conserve": con,
               "recovered_partial_only": part}
    for i, sc in enumerate(scenarios):
        rows = slice(i * seeds, (i + 1) * seeds)
        line = {}
        for name, arr in columns.items():
            per_seed = arr[rows, :, lea_col].mean(axis=1)
            mean, sd = float(per_seed.mean()), float(per_seed.std(ddof=1))
            want = bench[sc.name][name]
            # the sd of a 512-round rate: the across-seed spread scaled to 512
            # rounds, not below the binomial sd of 512 independent rounds
            # (8 seeds can understate a spread; 1/512 where the rate is 0)
            q = min(max(mean, 1 / 512), 1 - 1 / 512)
            sd512 = max(sd * scale, (q * (1 - q) / 512) ** 0.5)
            z = abs(mean - want) / sd512
            if not np.isfinite(per_seed).all() or z > 4.5:
                raise AssertionError(f"{sc.name} {name}: {mean} vs BENCH_faults {want} "
                                     f"(sd at 512 rounds {sd512})")
            line[name] = f"{mean:.4f}"
            line[f"{name}_bench"] = want
            line[f"{name}_z"] = f"{z:.2f}"
        log("faults_cell", cell=sc.name, **line)
    log("faults_grid", rows=len(scenarios) * seeds, rounds=rounds, wall_s=f"{wall:.3f}",
        row_rounds_per_s=f"{len(scenarios) * seeds * rounds / wall:.0f}",
        wall_warm_s=f"{wall_warm:.3f}",
        row_rounds_per_s_warm=f"{len(scenarios) * seeds * rounds / wall_warm:.0f}",
        peak_memory_gib=f"{peak_gib:.2f}", allocation_launches=launches,
        allocation_launches_one_cell=launches_one, packet_counts_launches=counted,
        conserve_gain_rounds=gain,
        containment=True, gpu=json.dumps(nvidia_smi_line()))
    log("faults_profile", part="grid",
        **profile_window(lambda: faults.sweep_faults(torch_draws(11), *args, **geometry)))
    return {"allocate_masked_cuda": launches, "packet_counts_cuda": counted}


def check_packet_counts() -> dict:
    """Phase 11f: the packet-count kernel alone at fault_grid's shapes (S = 2,
    288 rows x 20 000 rounds, n = 15, r = 10, P = 4): states good with
    probability 0.7, loads 10 or 3, speeds (10, 3), deadline 1, a third of
    the cutoffs preempted at a uniform fraction and 5% of the packets
    dropped, all drawn on the card.  Both modes' counts equal to the bit to
    the mask composition the engine ran before (on the card, where P = 4
    divides exactly as on the CPU), one launch; the kernel timed back to
    back and alone beside the composition and the byte bound."""
    from repro_torch.faults import FaultTrace
    from repro_torch.kernels import packet_counts as pc

    s, b, m, n, r, p = 2, 288, 20_000, 15, 10, 4
    gen = torch.Generator(device="cuda")
    gen.manual_seed(35)
    u = lambda *shape: torch.rand(shape, generator=gen, device="cuda")
    states = (u(b, m, n) < 0.7).to(torch.int32)
    loads = torch.where(u(s, b, m, n) < 0.7, 10, 3).to(torch.int32)
    rows = lambda v: torch.full((b,), v, dtype=torch.float32, device="cuda")
    mu_g, mu_b, deadline = rows(10.0), rows(3.0), rows(1.0)
    t_cut = torch.where(u(b, m, n) < 1 / 3, u(b, m, n), 1.0)
    keep = torch.empty((b, m, n, r, p), dtype=torch.bool, device="cuda")
    for lo in range(0, b, 32):
        keep[lo:lo + 32] = u(min(32, b - lo), m, n, r, p) >= 0.05
    args = (states, loads, mu_g, mu_b, deadline, r, p)
    trace = FaultTrace(t_cut, keep)
    reset_all_launch_counts()
    got = pc.decode_counts(*args, trace)
    launches = pc.launch_counts()["packet_counts_cuda"]
    want = pc.packet_counts_ref(*args, trace)
    torch.cuda.synchronize()
    for mode, g, w in zip(("aon", "conserve"), got, want, strict=True):
        if not torch.equal(g, w):
            raise AssertionError(f"packet_counts_cuda {mode}: not bit-equal to the "
                                 f"composition in {int((g != w).sum())} counts")
    if launches != 1:
        raise AssertionError(f"packet_counts_cuda launched {launches} times for one call")
    del got, want
    torch.cuda.empty_cache()
    ms = time_ms(lambda: pc.packet_counts_cuda(*args, t_cut, keep))
    plain_ms = time_ms(lambda: pc.packet_counts_ref(*args, trace), warm=1, runs=3, batch=2)
    moved = keep.numel() + 4 * (loads.numel() + states.numel() + t_cut.numel()
                                + 2 * s * b * m * p + 3 * b)
    b_ms, b_by = _bound(moved, 0, 1)
    vec = pc.vector_width(n, r * p, keep.data_ptr())
    log("kernel", name="packet_counts_cuda", shape=(s, b, m, n, r, p), vector_bytes=vec,
        bit_equal=True, moved_gb=f"{moved / 1e9:.3f}", bound_by=b_by,
        **timing_fields(b_ms, ms=ms, plain_ms=plain_ms), gpu=json.dumps(nvidia_smi_line()))
    del states, loads, t_cut, keep, trace, args
    torch.cuda.empty_cache()
    return {"packet_counts_cuda": {
        "max_abs_err": 0.0, **timing_entry(ms=ms, plain_ms=plain_ms), "bound_ms": b_ms,
        "bound_by": b_by, "kernel_route": f"{vec}-byte keep loads",
        "composition": "packet_on_time + packet_counts, both modes",
        "composition_ms": plain_ms.one, "shape": [[s, b, m, n], [b, m, n, r, p]]}}


def faults_agree() -> None:
    """Phase 11b: the fault grid on the card and on the CPU from the same
    recorded draws, the fault stream included."""
    from repro_torch import faults, sweeps
    from repro_torch.random import RecordedDraws, ReplayedDraws, torch_draws

    scenarios = sweeps.expand("packet_erasure", rounds=2000)
    recorder = RecordedDraws(torch_draws(13))
    args, geometry = fault_grid(scenarios, 4, "cuda")
    on_card = faults.sweep_faults(recorder, *args, **geometry)
    cpu_args, _ = fault_grid(scenarios, 4, "cpu")
    on_cpu = faults.sweep_faults(ReplayedDraws(recorder.calls), *cpu_args, **geometry,
                                 device="cpu")
    differ = {}
    for field in faults.FaultOutcomes._fields:
        a, b = getattr(on_card, field).cpu(), getattr(on_cpu, field)
        if a.shape != b.shape:
            raise AssertionError(f"{field}: shapes {tuple(a.shape)} != {tuple(b.shape)}")
        differ[field] = int((a != b).any(dim=-1).sum())
    limit = on_cpu.full_aon.shape[0] * on_cpu.full_aon.shape[1] // 1000
    if max(differ.values()) > limit:
        raise AssertionError(f"card and CPU differ in {differ} rounds (limit {limit})")
    log("faults_agree", rows=on_cpu.full_aon.shape[0], rounds=on_cpu.full_aon.shape[1],
        fault_calls=sum(1 for c in recorder.kinds if c == "fault"),
        differing_rounds=json.dumps(differ), limit=limit)


def fault_masks(cell: str, rounds: int, lp, mu_b: float, seed: int, packets: int = 4):
    """The LEA column's (rounds, nr, packets) conserving masks of one
    ``packet_erasure`` cell's channel, on a one-row rollout with load
    parameters ``lp`` (and the cell's chain, speeds and deadline), plus the
    all-or-nothing masks at one packet with no channel."""
    from repro_torch import faults, sweeps
    from repro_torch.core import throughput
    from repro_torch.core.lea import pool_load
    from repro_torch.random import torch_draws

    sc, = [s for s in sweeps.expand("packet_erasure", rounds=rounds) if s.name == cell]
    meta = dict(sc.meta)
    draws = torch_draws(seed)
    states, loads, _ = throughput.rollout_pool(draws, pool_load(lp, device="cuda"), sc.p_gg,
                                               sc.p_bb, rounds, ("lea",))
    channel = faults.make_channel([("preempt", {"p_preempt": meta["p_preempt"]}),
                                   ("packet_bernoulli", {"p_drop": meta["p_drop"]})])
    trace = faults.apply_channel(draws, channel, faults.base_trace(
        1, rounds, lp.n, meta["r"], packets, sc.deadline, device="cuda"))
    masks = faults.packet_on_time(states[None], loads, sc.mu_g, mu_b, sc.deadline,
                                  meta["r"], packets, trace=trace)[0]
    whole = faults.packet_on_time(states[None], loads, sc.mu_g, mu_b, sc.deadline,
                                  meta["r"], 1, conserve=False)[0]
    return masks, whole


def faults_exact_packets() -> dict[str, int]:
    """Phase 11c: the exact per-packet decode at the paper's widths; returns
    B3's launches."""
    from repro_torch import faults
    from repro_torch.core import coded_ops as co
    from repro_torch.core import lagrange as lg
    from repro_torch.core.lea import LoadParams
    from repro_torch.kernels import gf

    spec = lg.CodeSpec(15, 10, 50, 2)                  # nr = 150, K* = 99
    rows, cols, packets, rounds = 60, 3000, 4, 250
    rng = np.random.default_rng(64)
    x = rng.integers(0, P, size=(spec.k, rows, cols), dtype=np.int32)
    w = rng.integers(0, P, size=(cols,), dtype=np.int32)
    masks, whole = fault_masks("erasure_pre0.2_drop0.05", rounds, LoadParams(15, 99, 10, 3),
                               3.0, seed=14, packets=packets)
    coded = co.encode_dataset_modp(spec, x, device="cuda")
    w_dev = torch.as_tensor(w, device="cuda")
    reset_all_launch_counts()
    gf.reset_operand_passes()
    outs, oks = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for m in range(rounds):
        out, ok = faults.coded_matmul_exact_packets(coded, w_dev, masks[m])
        outs.append(out)
        oks.append(ok)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = gf.launch_counts()["matmul_gf_cuda"]
    passes = no_x_tilde_passes(gf.operand_passes(), coded)
    if launches < 1:
        raise AssertionError("the exact per-packet decode never launched B3")
    want = lg.matmul_modp(x.reshape(-1, cols).astype(np.int64),
                          w.astype(np.int64)[:, None]).reshape(spec.k, rows)
    rp = rows // packets
    ok_np = torch.stack(oks).cpu().numpy()
    for m in range(rounds):
        got = outs[m].cpu().numpy().astype(np.int64)
        for q in np.nonzero(ok_np[m])[0]:
            block = slice(q * rp, (q + 1) * rp)
            if not np.array_equal(got[:, block], want[:, block]):
                raise AssertionError(f"round {m} packet {q}: differs from the numpy oracle")
    if not ok_np.any():
        raise AssertionError("no packet block was decodable in any round")
    # one packet, no channel: the per-packet path is coded_matmul_exact
    for m in range(8):
        one, ok1 = faults.coded_matmul_exact_packets(coded, w_dev, whole[m])
        ref, ok_ref = co.coded_matmul_exact(coded, w_dev, whole[m, :, 0])
        if bool(ok1[0]) != bool(ok_ref) or not torch.equal(one, ref):
            raise AssertionError(f"round {m}: one packet differs from coded_matmul_exact")
    log("faults_exact_packets", spec="CodeSpec(15,10,50,2)", x=(spec.k, rows, cols),
        packets=packets, rounds=rounds, decodable_blocks=int(ok_np.sum()),
        rounds_all_blocks=int(ok_np.all(axis=1).sum()), bit_equal_numpy=True,
        one_packet_equals_exact=8, b3_launches=launches,
        ms_per_round=f"{wall / rounds * 1e3:.3f}", operand_passes=json.dumps(passes))

    def twenty_rounds():
        for m in range(20):
            faults.coded_matmul_exact_packets(coded, w_dev, masks[m])
    log("faults_profile", part="exact_packets_20_rounds", **profile_window(twenty_rounds))
    return {"matmul_gf_cuda": launches}


def float_route_bound(spec, x: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, float]:
    """The float32 forward-error bound of the per-packet float route.

    The route computes D @ ((G @ X) @ w)[received]: G rounded from float64
    (one rounding an entry), D's entries products of K* - 1 quotients
    (at most 4 K* roundings), then sums over k, cols and K* terms.  So each
    decoded element lies within gamma_n (|D| @ A[received]) of the exact
    X_j @ w, where A = |G| @ (|X| @ |w|) (the magnitudes the results sum)
    and gamma_n = n u / (1 - n u), u = 2^-24, n = cols + 5 (k + K*).
    Returns (A as (nr, rows) float64, gamma_n).
    """
    from repro_torch.core import lagrange as lg

    n = x.shape[-1] + 5 * (spec.k + spec.recovery_threshold)
    u = 2.0 ** -24
    g = lg.generator_matrix(spec, torch.float64, device=x.device)
    mags = torch.einsum("krc,c->kr", x.abs().double(), w.abs().double())
    return g.abs() @ mags, n * u / (1 - n * u)


def faults_float_packets() -> dict[str, int]:
    """Phase 11d: the float per-packet decode under two cells' channels,
    through B4's encode; returns B4's launches.

    Checked: every element of every decodable block lies within the float32
    forward-error bound of the route (:func:`float_route_bound`) of the
    uncoded X_j @ w.  The bound grows with |D|: a preempted worker conserves
    a prefix of its chunks, so a block's received set mixes two workers'
    strided Chebyshev nodes (and, under drops, any K* nodes), where the
    float32 decode at k = 5 can lose every digit and |D| is large; on the
    well-conditioned blocks it is tight enough to fail a wrong decode.  The
    line logs the share of the bound used, the relative errors' quantiles,
    the blocks above 1e-2, and how many blocks the check would fail if each
    decoded its received rows shifted by one (a wrong decode).
    """
    from repro_torch import faults
    from repro_torch.core import coded_ops as co
    from repro_torch.core import lagrange as lg
    from repro_torch.core.lea import LoadParams
    from repro_torch.kernels import lagrange_encode as le

    spec = lg.CodeSpec(15, 10, 5, 2)                   # K* = 9 <= r
    kstar = spec.recovery_threshold
    rows, cols, rounds, packets = 60, 3000, 100, 4
    rng = np.random.default_rng(65)
    x = torch.as_tensor(rng.normal(size=(spec.k, rows, cols)), dtype=torch.float32,
                        device="cuda")
    w = torch.as_tensor(rng.normal(size=(cols,)), dtype=torch.float32, device="cuda")
    reset_all_launch_counts()
    coded = co.encode_dataset(spec, x)
    torch.cuda.synchronize()
    launches = le.launch_counts()["encode_matrix_cuda"]
    if launches < 1:
        raise AssertionError("the float per-packet path never launched B4")
    want = torch.einsum("krc,c->kr", x.double(), w.double())
    mags, gamma = float_route_bound(spec, x, w)
    results = torch.tensordot(coded.x_tilde, w, dims=1)           # (nr, rows)
    rp = rows // packets
    for cell in ("erasure_pre0.2_drop0", "erasure_pre0.2_drop0.05"):
        masks, _ = fault_masks(cell, rounds, LoadParams(15, kstar, 10, 0), 0.5, seed=15)
        rels, used, tight, caught = [], 0.0, 0, 0
        for m in range(rounds):
            out, ok = faults.coded_matmul_packets(coded, w, masks[m])
            for q in torch.nonzero(ok)[:, 0].tolist():
                block = slice(q * rp, (q + 1) * rp)
                received = co.received_indices(masks[m][:, q], kstar)
                d = lg.decode_matrix_jax(spec, received)
                bound = gamma * (d.abs().double() @ mags[received][:, block])
                diff = (out[:, block].double() - want[:, block]).abs()
                if bool((diff > bound).any()):
                    raise AssertionError(
                        f"{cell} round {m} packet {q}: the block misses X_j @ w by "
                        f"{float(diff.max())}, over the float32 bound of the route")
                used = max(used, float((diff / bound).max()))
                tight += bool((bound <= 1e-2 * want[:, block].abs().max()).all())
                shifted = d @ results[torch.roll(received, 1)][:, block]
                caught += bool(((shifted.double() - want[:, block]).abs() > bound).any())
                rels.append(float(torch.linalg.norm(out[:, block].double() - want[:, block])
                                  / torch.linalg.norm(want[:, block])))
        if not rels:
            raise AssertionError(f"{cell}: no float packet block was decodable")
        rels = np.asarray(rels)
        log("faults_float_packets", cell=cell, spec="CodeSpec(15,10,5,2)",
            x=(spec.k, rows, cols), rounds=rounds, decodable_blocks=len(rels),
            within_route_bound=True, gamma_n=f"{gamma:.3e}", bound_used_max=f"{used:.3e}",
            blocks_bound_below_1e_2=tight, shifted_decodes_failing_check=caught,
            rel_err_vs_uncoded_median=f"{np.median(rels):.3e}",
            rel_err_vs_uncoded_p90=f"{np.quantile(rels, 0.9):.3e}",
            rel_err_vs_uncoded_max=f"{rels.max():.3e}",
            blocks_over_1e_2=int((rels > 1e-2).sum()), b4_launches=launches)
    return {"encode_matrix_cuda": launches}


def faults_executor() -> dict[str, int]:
    """Phase 11e: the retry/degrade executor on the card, as the JAX
    package's fault benchmark runs it; returns B2's launches."""
    from repro_torch import faults
    from repro_torch.kernels import poisson_binomial as pb
    from repro_torch.runtime.fault_tolerance import (OUTCOMES, CodedDataParallelExecutor,
                                                     CodedDPConfig)

    cfg = CodedDPConfig(packets=4, max_retries=2, allow_partial=True, p1=1)
    ex = CodedDataParallelExecutor(
        cfg, lambda params, shard: {k: torch.zeros_like(v) for k, v in params.items()},
        draws=0, channel=faults.make_channel([("preempt", {"p_preempt": 0.35})]))
    params = {"w": torch.zeros(2, device="cuda")}
    batch = {"x": torch.zeros((cfg.k, 2), device="cuda")}
    reset_all_launch_counts()
    t0 = time.perf_counter()
    for _ in range(30):
        grads, info = ex.round(params, batch)
        if (grads is None) != (info["outcome"] == "dropped"):
            raise AssertionError(f"round {ex.rounds}: gradient and outcome disagree: {info}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pb.launch_counts()["success_tails_cuda"]
    if sum(ex.outcomes.values()) != ex.rounds or ex.rounds != 30:
        raise AssertionError(f"outcomes {ex.outcomes} do not sum to {ex.rounds} rounds")
    if launches < 1:
        raise AssertionError("the executor never launched B2")
    log("faults_executor", n_workers=cfg.n_workers, r=cfg.r, k=cfg.k, packets=cfg.packets,
        max_retries=cfg.max_retries, p_preempt=0.35, rounds=ex.rounds,
        outcomes=json.dumps({k: ex.outcomes[k] for k in OUTCOMES}),
        b2_launches=launches, ms_per_round=f"{wall / 30 * 1e3:.3f}")

    def ten_rounds():
        for _ in range(10):
            ex.round(params, batch)
    log("faults_profile", part="executor_10_rounds", **profile_window(ten_rounds))
    return {"success_tails_cuda": launches}


def faults_path() -> dict[str, int]:
    """Phase 11: the fault-injection runtime.  Each part sets the counts to
    0 before its own work and reads them after it; returns the launches."""
    launches = faults_grid()
    faults_agree()
    launches.update(faults_exact_packets())
    launches.update(faults_float_packets())
    launches.update(faults_executor())
    log("faults_path", launches=json.dumps(launches))
    return launches


SERVING_SEEDS = 16


def serving_grid(scenarios, seeds: int, device: str, controlled: bool):
    """``sweep_serving``'s arguments for an ``arrival_grid`` grid, ``seeds``
    rows a cell (cell-major), as ``benchmarks/bench_serving.py`` builds them:
    the committed admission settings (controlled) or both gates off
    (admit-all)."""
    from repro_torch import serving

    lp, meta = scenarios[0].lp, [dict(sc.meta) for sc in scenarios]
    rows = len(scenarios) * seeds
    col = lambda key, dtype: torch.tensor([m[key] for m in meta for _ in range(seeds)],
                                          dtype=dtype, device=device)
    chain = lambda attr: torch.tensor([getattr(sc, attr) for sc in scenarios
                                       for _ in range(seeds)], dtype=torch.float32,
                                      device=device)
    if controlled:
        thr, cap = col("admit_threshold", torch.float32), col("reserve_cap", torch.float32)
    else:
        thr = torch.zeros(rows, device=device)
        cap = torch.full((rows,), serving.ADMIT_ALL_CAP, device=device)
    spec = serving.RequestSpec(kstar=lp.kstar, ell_g=lp.ell_g, ell_b=lp.ell_b,
                               deadline_rel=col("deadline_rel", torch.int32),
                               admit_threshold=thr, reserve_cap=cap)
    sc = scenarios[0]
    args = (torch.ones((rows, lp.n), dtype=torch.bool, device=device), chain("p_gg"),
            chain("p_bb"), sc.mu_g, sc.mu_b, sc.deadline, spec,
            serving.make_process("poisson", rate=col("rate", torch.float32)))
    kwargs = dict(rounds=sc.rounds, strategies=("lea",), capacity=meta[0]["capacity"],
                  grace=meta[0]["grace"], device=device)
    return args, kwargs


def conserved(out) -> bool:
    """Every row's requests in exactly one disposition."""
    return bool((out.arrivals == out.admitted + out.rejected).all()
                and (out.admitted == out.served_on_time + out.served_late + out.expired
                     + out.in_flight).all())


def serving_bench() -> None:
    """Phase 12a: the arrival_grid at the committed 512 rounds, 16 seeds a
    cell, admit-all and controlled on the same generator seeds, held to
    ``BENCH_serving.json``."""
    from repro_torch import serving, sweeps
    from repro_torch.kernels import poisson_binomial as pb
    from repro_torch.random import torch_draws

    scenarios = sweeps.expand("arrival_grid", rounds=512)
    rounds, seeds = scenarios[0].rounds, SERVING_SEEDS
    outs, walls, launches = {}, {}, {}
    for mode in ("admit_all", "controlled"):
        args, kwargs = serving_grid(scenarios, seeds, "cuda", mode == "controlled")
        reset_all_launch_counts()
        outs[mode], walls[mode] = timed(lambda: serving.sweep_serving(torch_draws(21), *args,
                                                                      **kwargs))
        launches[mode] = {k: pb.launch_counts()[k]
                          for k in ("success_tails_cuda_w", "allocate_masked_cuda")}
        if launches[mode] != {"success_tails_cuda_w": 1, "allocate_masked_cuda": rounds}:
            raise AssertionError(f"{mode}: launched {launches[mode]}, not B1 once (the "
                                 f"admission gate) and the allocation once a round")
        if not conserved(outs[mode]):
            raise AssertionError(f"{mode}: a row does not conserve its requests")
    bench = json.loads((ROOT / "BENCH_serving.json").read_text())
    cells = {c["name"]: c for c in bench["results"]}
    served = {m: o.served_on_time[:, 0].cpu().numpy() for m, o in outs.items()}
    ctl = outs["controlled"]
    for i, sc in enumerate(scenarios):
        rows = slice(i * seeds, (i + 1) * seeds)
        per_seed = served["controlled"][rows] / rounds
        mean, sd = float(per_seed.mean()), float(per_seed.std(ddof=1))
        want = cells[sc.name]["served_per_round"]
        z = abs(mean - want) / sd if sd > 0 else (0.0 if mean == want else float("inf"))
        if not z <= 4.5:
            raise AssertionError(f"{sc.name}: controlled on-time rate {mean} vs "
                                 f"BENCH_serving {want} (sd {sd})")
        ev = ctl.events[rows, 0].cpu().numpy()
        lat = ctl.sojourn[rows, 0].cpu().numpy()[(ev == serving.EVENT_ON_TIME)
                                                | (ev == serving.EVENT_LATE)]
        pct = np.percentile(lat, [50, 95, 99]) if lat.size else [float("nan")] * 3
        log("serving_cell", cell=sc.name, rate_ctl=f"{mean:.4f}", sd=f"{sd:.4f}",
            bench=want, z=f"{z:.2f}",
            rate_admit_all=f"{served['admit_all'][rows].mean() / rounds:.4f}",
            arrivals=f"{ctl.arrivals[rows, 0].float().mean().item():.1f}",
            rejected_ctl=f"{ctl.rejected[rows, 0].float().mean().item():.1f}",
            expired_ctl=f"{ctl.expired[rows, 0].float().mean().item():.1f}",
            expired_admit_all=f"{outs['admit_all'].expired[rows, 0].float().mean().item():.1f}",
            latency_p50_p95_p99=json.dumps([float(v) for v in pct]))
    rates = np.repeat([dict(sc.meta)["rate"] for sc in scenarios], seeds)
    over = rates > bench["sustainable_rate"]
    gain = int(served["controlled"][over].sum()) - int(served["admit_all"][over].sum())
    if not gain > 0:
        raise AssertionError(f"admission control does not beat admit-all at overload: {gain}")
    log("serving_grid", rows=len(scenarios) * seeds, rounds=rounds,
        wall_admit_all_s=f"{walls['admit_all']:.3f}",
        wall_controlled_s=f"{walls['controlled']:.3f}",
        launches=json.dumps(launches), admission_gain_requests=gain,
        overloaded_rows=int(over.sum()), conservation=True,
        gpu=json.dumps(nvidia_smi_line()))


def strict_round_loop():
    """Wrap the serving engine's round loop so any sync inside it raises
    (``torch.cuda.set_sync_debug_mode("error")``); returns the undo."""
    from repro_torch.serving import engine

    loop = engine._round_loop

    def strict(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return loop(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    engine._round_loop = strict
    return lambda: setattr(engine, "_round_loop", loop)


def serving_stream() -> dict[str, int]:
    """Phase 12b: the same grid at the family's own 2 000 rounds (controlled),
    a first and a warmed call timed, the round loop under the sync check;
    returns B1's and the fused allocation's launches in one call."""
    from repro_torch import serving, sweeps
    from repro_torch.kernels import poisson_binomial as pb
    from repro_torch.random import torch_draws

    scenarios = sweeps.expand("arrival_grid")
    rounds = scenarios[0].rounds
    args, kwargs = serving_grid(scenarios, SERVING_SEEDS, "cuda", True)
    rows = len(scenarios) * SERVING_SEEDS
    undo = strict_round_loop()
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_all_launch_counts()
        first, wall = timed(lambda: serving.sweep_serving(torch_draws(22), *args, **kwargs))
        launches = {k: pb.launch_counts()[k]
                    for k in ("success_tails_cuda_w", "allocate_masked_cuda")}
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        _, wall_warm = timed(lambda: serving.sweep_serving(torch_draws(22), *args, **kwargs))
    finally:
        undo()
    if launches != {"success_tails_cuda_w": 1, "allocate_masked_cuda": rounds}:
        raise AssertionError(f"launched {launches} in a call, not B1 once and the "
                             f"allocation once a round ({rounds})")
    if not conserved(first):
        raise AssertionError("a row does not conserve its requests")
    window = 250
    win_args, win_kwargs = serving_grid(sweeps.expand("arrival_grid", rounds=window),
                                        SERVING_SEEDS, "cuda", True)
    profile = profile_window(lambda: serving.sweep_serving(torch_draws(22), *win_args,
                                                           **win_kwargs))
    log("serving_stream", rows=rows, rounds=rounds, wall_s=f"{wall:.3f}",
        row_rounds_per_s=f"{rows * rounds / wall:.0f}", wall_warm_s=f"{wall_warm:.3f}",
        row_rounds_per_s_warm=f"{rows * rounds / wall_warm:.0f}",
        ms_per_round_warm=f"{wall_warm / rounds * 1e3:.4f}",
        peak_memory_gib=f"{peak_gib:.3f}", launches=json.dumps(launches),
        sync_in_round_loop="none (set_sync_debug_mode error)",
        served_on_time=int(first.served_on_time.sum()), arrivals=int(first.arrivals.sum()),
        gpu=json.dumps(nvidia_smi_line()))
    log("serving_profile", part=f"grid_{window}_rounds", rounds=window,
        launches_per_round=f"{profile['kernel_launches'] / window:.1f}", **profile)
    return launches


def serving_agree() -> None:
    """Phase 12c: 4 rows of the controlled grid on the card and on the CPU
    from the same recorded draws: events, sojourns and counters equal."""
    from repro_torch import serving, sweeps
    from repro_torch.random import RecordedDraws, ReplayedDraws, torch_draws

    scenarios = sweeps.expand("arrival_grid", rounds=512)[2:]     # rates 1.2 and 2.4
    recorder = RecordedDraws(torch_draws(23))
    args, kwargs = serving_grid(scenarios, 1, "cuda", True)
    on_card, wall_card = timed(lambda: serving.sweep_serving(recorder, *args, **kwargs))
    cpu_args, cpu_kwargs = serving_grid(scenarios, 1, "cpu", True)
    t0 = time.perf_counter()
    on_cpu = serving.sweep_serving(ReplayedDraws(recorder.calls), *cpu_args, **cpu_kwargs)
    wall_cpu = time.perf_counter() - t0
    differ = {f: int((getattr(on_card, f).cpu() != getattr(on_cpu, f)).sum())
              for f in serving.ServingOutcomes._fields}
    if any(differ.values()):
        raise AssertionError(f"card and CPU differ: {differ}")
    log("serving_agree", rows=on_cpu.arrivals.shape[0], rounds=kwargs["rounds"],
        draw_calls=json.dumps(recorder.kinds), differing=json.dumps(differ),
        wall_card_s=f"{wall_card:.3f}", wall_cpu_s=f"{wall_cpu:.3f}")


def serving_entry_points() -> dict[str, int]:
    """Phase 12d: the serving CLI at its defaults and the serve_coded
    example on the card; returns the coding kernels' launches."""
    from repro_torch.examples import serve_coded
    from repro_torch.launch import serve

    reset_all_launch_counts()
    summary, wall = timed(lambda: serve.main([], echo=lambda line: None))
    for name, row in summary.items():
        if row["arrivals"] != row["admitted"] + row["rejected"] or row["admitted"] != (
                row["served_on_time"] + row["served_late"] + row["expired"]
                + row["in_flight"]):
            raise AssertionError(f"serve CLI {name}: accounting fails: {row}")
    log("serving_cli", wall_s=f"{wall:.3f}", rounds=1000, summary=json.dumps(summary))
    counts, wall = timed(lambda: serve_coded.run(echo=lambda line: None))
    if counts["checked"] < 1 or counts["arrivals"] != counts["admitted"] + counts["rejected"]:
        raise AssertionError(f"serve_coded: {counts}")
    from repro_torch.kernels import poisson_binomial as pb
    launches = {**pb.launch_counts(), **coding_launches()}
    if launches["matmul_gf_cuda"] < 1:
        raise AssertionError(f"serve_coded never launched B3: {launches}")
    log("serving_example", wall_s=f"{wall:.3f}", counts=json.dumps(counts),
        launches=json.dumps(launches))
    return {k: v for k, v in launches.items() if v}


def serving_path() -> dict[str, int]:
    """Phase 12: the streaming serving layer at the paper's pool.  The
    counts are set to 0 before each part's own work; returns the launches
    of one 2 000-round grid call (B1, the allocation) and of the entry
    points."""
    t0 = time.perf_counter()
    serving_bench()
    launches = serving_stream()
    serving_agree()
    for name, count in serving_entry_points().items():
        launches[name] = launches.get(name, 0) + count
    log("serving_path", launches=json.dumps(launches),
        wall_s=f"{time.perf_counter() - t0:.1f}")
    return launches


# -- phase 13: observability ------------------------------------------------------

def obs_fig3() -> tuple:
    """Phase 13a: the fig3 sweep (256 rows x 20 000 rounds) with telemetry
    and taps on, on phase 3's group and generator seed, against the
    flags-off call; returns the group and its successes."""
    from repro_torch import obs, sweeps
    from repro_torch.core.throughput import allocator_strategies

    group, = sweeps.build_groups(sweeps.expand("fig3"), seeds=64)
    off, wall_off = timed(lambda: sweeps.run_group(group))
    with obs.capture_taps() as events:
        (on, frame), wall_on = timed(lambda: sweeps.run_group(group, telemetry=True, tap=True,
                                                              tap_stride=2500))
    if not np.array_equal(off, on):
        raise AssertionError("fig3: the successes with telemetry and taps on differ")
    oracle = allocator_strategies(group.strategies).index("oracle")
    if frame.est_err[..., oracle].any():
        raise AssertionError("fig3: oracle's estimator error is not exactly 0")
    rows, rounds = on.shape[0], on.shape[1]
    per_row: dict[int, list] = {}
    for e in events:
        obs.validate_event(e)
        per_row.setdefault(int(e["row"]), []).append(e)
    bounds = list(range(2500, rounds + 1, 2500))
    for r in range(rows):
        es = per_row.get(r, [])
        if ([int(e["block"]) for e in es] != list(range(len(bounds)))
                or [int(e["rounds_done"]) for e in es] != bounds):
            raise AssertionError(f"fig3 row {r}: tap events out of order: "
                                 f"{[(int(e['block']), int(e['rounds_done'])) for e in es]}")
        if not np.array_equal(es[-1]["succ_so_far"], on[r].sum(axis=0)):
            raise AssertionError(f"fig3 row {r}: last tap event is not the row's successes")
    log("obs_fig3", rows=rows, rounds=rounds, events=len(events), tap_stride=2500,
        bit_equal=True, oracle_est_err=0.0,
        est_err_lea_mean=f"{float(frame.est_err[..., 0].mean()):.5f}",
        frame_bytes=sum(x.nbytes for x in frame), wall_off_s=f"{wall_off:.3f}",
        wall_on_s=f"{wall_on:.3f}", gpu=json.dumps(nvidia_smi_line()))
    return group, on


def obs_faults() -> None:
    """Phase 13b: phase 11a's packet_erasure grid (72 rows x 20 000 rounds)
    with telemetry and taps on against the flags-off call."""
    from repro_torch import faults, obs, sweeps
    from repro_torch.random import torch_draws

    args, geometry = fault_grid(sweeps.expand("packet_erasure", rounds=20_000), 8, "cuda")
    off, wall_off = timed(lambda: faults.sweep_faults(torch_draws(11), *args, **geometry))
    with obs.capture_taps() as events:
        (on, tel), wall_on = timed(lambda: faults.sweep_faults(
            torch_draws(11), *args, **geometry, telemetry=True, tap=True, tap_stride=2500))
    for field, a, b in zip(faults.FaultOutcomes._fields, off, on):
        if not torch.equal(a, b):
            raise AssertionError(f"faults: {field} with telemetry and taps on differs")
    if not bool((tel.received_conserve >= tel.received_aon).all()):
        raise AssertionError("faults: a conserving received count below all-or-nothing's")
    rows = on.full_aon.shape[0]
    last = {int(e["row"]): e for e in events}
    pre, lost = tel.preempted.sum(dim=1).cpu(), tel.packets_lost.sum(dim=1).cpu()
    con = on.full_conserve.sum(dim=1).cpu()
    for r in range(rows):
        e = last[r]
        obs.validate_event(e)
        if (int(e["preempted_so_far"]) != int(pre[r]) or int(e["packets_lost_so_far"])
                != int(lost[r]) or not np.array_equal(e["recovered_conserve_so_far"],
                                                      con[r].numpy())):
            raise AssertionError(f"faults row {r}: tap totals differ from the telemetry")
    log("obs_faults", rows=rows, rounds=geometry["rounds"], events=len(events),
        bit_equal=True, conserve_ge_aon=True, tap_totals_equal=True,
        preempted=int(pre.sum()), packets_lost=int(lost.sum()),
        wall_off_s=f"{wall_off:.3f}", wall_on_s=f"{wall_on:.3f}")


def obs_serving() -> None:
    """Phase 13c: the arrival grid (96 rows x 2 000 rounds), admit-all and
    controlled, with telemetry and taps every 250 rounds, the round loop
    under the sync check, against the flags-off call."""
    from repro_torch import obs, serving, sweeps
    from repro_torch.random import torch_draws

    scenarios = sweeps.expand("arrival_grid")
    rounds = scenarios[0].rounds
    for mode in ("admit_all", "controlled"):
        args, kwargs = serving_grid(scenarios, SERVING_SEEDS, "cuda", mode == "controlled")
        off, wall_off = timed(lambda: serving.sweep_serving(torch_draws(22), *args, **kwargs))
        undo = strict_round_loop()
        try:
            with obs.capture_taps() as events:
                (on, tel), wall_on = timed(lambda: serving.sweep_serving(
                    torch_draws(22), *args, **kwargs, telemetry=True, tap=True,
                    tap_stride=250))
        finally:
            undo()
        for field, a, b in zip(serving.ServingOutcomes._fields, off, on):
            if not torch.equal(a, b):
                raise AssertionError(f"serving {mode}: {field} with the flags on differs")
        if not conserved(on):
            raise AssertionError(f"serving {mode}: a row does not conserve its requests")
        rows, strategies = on.arrivals.shape
        if len(events) != (rounds // 250) * rows * strategies:
            raise AssertionError(f"serving {mode}: {len(events)} tap events, not "
                                 f"{rounds // 250} x {rows} x {strategies}")
        for e in events:
            obs.validate_event(e)
        if not (torch.equal(tel.admitted_t + tel.rejected_t,
                            tel.arrivals_t[:, None, :].expand_as(tel.admitted_t))
                and torch.equal(tel.occupancy[..., -1], on.in_flight)):
            raise AssertionError(f"serving {mode}: telemetry does not reconcile")
        log("obs_serving", mode=mode, rows=rows, rounds=rounds, events=len(events),
            tap_stride=250, bit_equal=True, conservation=True,
            sync_in_round_loop="none (set_sync_debug_mode error, every segment)",
            ms_per_round_off=f"{wall_off / rounds * 1e3:.4f}",
            ms_per_round_on=f"{wall_on / rounds * 1e3:.4f}",
            wall_off_s=f"{wall_off:.3f}", wall_on_s=f"{wall_on:.3f}")


ENGINE_SPANS = ("repro.trajectory", "repro.policy_replay", "repro.allocate", "repro.score",
                "repro.decode")


def span_times(trace_path: Path) -> dict[str, dict[str, float]]:
    """Host ms and calls of each ``repro.*`` (and ``phase13.*``) span in a
    Chrome trace, and the device ms of the kernels (and copies) launched
    inside it, matched through the launch's correlation id."""
    import bisect

    events = json.loads(trace_path.read_text())["traceEvents"]
    spans: dict[str, list[tuple[float, float]]] = {}
    launch_ts: dict[int, float] = {}
    device = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat", ""), e.get("args") or {}
        if cat == "user_annotation" and e.get("name", "").startswith(("repro.", "phase13.")):
            spans.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launch_ts[args["correlation"]] = e["ts"]
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset") and "correlation" in args:
            device.append((args["correlation"], e["dur"]))
    out = {}
    for name, ivals in spans.items():
        ivals.sort()
        starts = [a for a, _ in ivals]
        dev_us, kernels = 0.0, 0
        for corr, dur in device:
            ts = launch_ts.get(corr)
            if ts is None:
                continue
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and ts <= ivals[i][1]:
                dev_us += dur
                kernels += 1
        out[name] = {"calls": len(ivals),
                     "host_ms": round(sum(b - a for a, b in ivals) / 1e3, 3),
                     "device_ms": round(dev_us / 1e3, 3), "device_ops": kernels}
    return out


def obs_trace(tmp: Path) -> dict:
    """Phase 13d: fig3 (256 rows x 2 000 rounds) and 50 exact deg-2 rounds
    under ``profile_trace`` with REPRO_PROFILE set: every engine phase span
    in the trace, each with its host time and its kernels' device time."""
    import os

    from repro_torch import obs, sweeps
    from repro_torch.core import coded_ops as co
    from repro_torch.core import lagrange as lg
    from repro_torch.core import throughput
    from repro_torch.core.lea import LoadParams

    group, = sweeps.build_groups(sweeps.expand("fig3", rounds=2000), seeds=64)
    spec = lg.CodeSpec(15, 10, 50, 2)
    rng = np.random.default_rng(62)
    x = rng.integers(0, P, size=(spec.k, 60, 3000), dtype=np.int32)
    y = rng.integers(0, P, size=(spec.k, 60), dtype=np.int32)
    w = torch.as_tensor(rng.integers(0, P, size=(3000,), dtype=np.int32), device="cuda")
    states, loads, _ = throughput.rollout(22, LoadParams(15, 99, 10, 3), [0.8] * 15,
                                          [0.533] * 15, 2000, strategies=("lea",),
                                          device="cuda")
    masks = co.chunk_on_time(states, loads[0], 10.0, 3.0, 1.0, spec.r)
    rounds = _feasible_rounds(masks, spec.recovery_threshold)[:50]
    coded = co.encode_dataset_modp(spec, x, y, device="cuda")
    sweeps.run_group(group)                                # warm: allocator, caches
    co.coded_linear_gradient_modp(coded, w, masks[rounds[0]])
    out_dir = tmp / "profile"
    saved = os.environ.get(obs.PROFILE_ENV)
    os.environ[obs.PROFILE_ENV] = str(out_dir)
    walls = {}
    try:
        with obs.profile_trace("phase13"):
            with torch.profiler.record_function("phase13.fig3"):
                _, walls["fig3"] = timed(lambda: sweeps.run_group(group))
            with torch.profiler.record_function("phase13.exact_deg2"):
                _, walls["exact_deg2"] = timed(lambda: [co.coded_linear_gradient_modp(
                    coded, w, masks[m]) for m in rounds])
    finally:
        if saved is None:
            del os.environ[obs.PROFILE_ENV]
        else:
            os.environ[obs.PROFILE_ENV] = saved
    trace, = out_dir.glob("phase13.*.trace.json")
    spans = span_times(trace)
    missing = [name for name in ENGINE_SPANS if name not in spans]
    if missing:
        raise AssertionError(f"the trace lacks the spans {missing}: {sorted(spans)}")
    log("obs_trace", fig3_rows=group.batch.rows, fig3_rounds=2000,
        fig3_wall_ms=f"{walls['fig3'] * 1e3:.3f}", exact_deg2_rounds=len(rounds),
        exact_deg2_ms_per_round=f"{walls['exact_deg2'] / len(rounds) * 1e3:.3f}",
        trace_mib=f"{trace.stat().st_size / 2**20:.1f}", gpu=json.dumps(nvidia_smi_line()))
    for name in ENGINE_SPANS:
        log("obs_span", span=name, **spans[name])
    # what each window spent outside its engine spans
    for window, inner in (("phase13.fig3", ENGINE_SPANS[:4]),
                          ("phase13.exact_deg2", ENGINE_SPANS[4:])):
        whole = spans[window]
        log("obs_span", span=window, **whole, outside_spans_host_ms=round(
            whole["host_ms"] - sum(spans[n]["host_ms"] for n in inner), 3),
            outside_spans_device_ms=round(
                whole["device_ms"] - sum(spans[n]["device_ms"] for n in inner), 3))
    return spans


def obs_provenance(tmp: Path, group, succ) -> None:
    """Phase 13e: a manifest of 13a's results written with its history
    record into ``tmp``; the provenance names the card, CUDA and the power
    limit; nothing is written at the repo root."""
    import os

    from repro_torch import obs, sweeps
    from repro_torch.obs import history

    before = sorted(p.name for p in ROOT.iterdir())
    hist = tmp / "history.jsonl"
    saved = os.environ.get(history.HISTORY_ENV)
    os.environ[history.HISTORY_ENV] = str(hist)
    try:
        results = sweeps.summarize([group], [succ])
        doc = sweeps.manifest(results, bench="obs_fig3", device="cuda",
                              extra={"rows": int(succ.shape[0]), "rounds": int(succ.shape[1])})
        path = tmp / "BENCH_obs_fig3.json"
        sweeps.write_manifest(path, doc)
    finally:
        if saved is None:
            del os.environ[history.HISTORY_ENV]
        else:
            os.environ[history.HISTORY_ENV] = saved
    prov = json.loads(path.read_text())["provenance"]
    if (prov["device"] != torch.cuda.get_device_name(0) or prov["cuda"] != torch.version.cuda
            or prov["backend"] != "cuda" or prov["power_limit_w"] is None):
        raise AssertionError(f"provenance does not name the card: {prov}")
    recs = history.read_history(hist)
    if len(recs) != 1 or not history.valid_record(recs[0]) or recs[0]["bench"] != "obs_fig3" \
            or recs[0]["provenance"]["device"] != prov["device"]:
        raise AssertionError(f"the history record does not round-trip: {recs}")
    after = sorted(p.name for p in ROOT.iterdir())
    if after != before:
        raise AssertionError(f"phase 13 wrote at the repo root: {set(after) ^ set(before)}")
    log("obs_provenance", device=json.dumps(prov["device"]), cuda=prov["cuda"],
        power_limit_w=prov["power_limit_w"], torch=prov["torch"], git_sha=prov["git_sha"],
        history_round_trip=True, repo_root_unchanged=True, scenarios=doc["scenarios"])


def obs_cli(tmp: Path) -> None:
    """Phase 13f: ``python -m repro_torch.launch.serve --progress --tap-log``
    at its defaults in a child process; every logged event valid."""
    import os

    from repro_torch import obs

    log_path = tmp / "serve_taps.jsonl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--progress",
                           "--tap-log", str(log_path)], capture_output=True, text=True,
                          timeout=600, env=env, cwd=str(tmp))
    wall = time.perf_counter() - t0
    if proc.returncode != 0 or not proc.stdout.strip().endswith("OK"):
        raise AssertionError(f"serve CLI failed ({proc.returncode}):\n{proc.stdout}\n"
                             f"{proc.stderr[-2000:]}")
    events = [json.loads(line) for line in log_path.read_text().splitlines()]
    for e in events:
        obs.validate_event(e)
    if [e["rounds_done"] for e in events] != [125 * (i + 1) for i in range(8)]:
        raise AssertionError(f"serve CLI: tap events {[e['rounds_done'] for e in events]}")
    if "[serve]" not in proc.stderr:
        raise AssertionError("serve CLI: no progress line on stderr")
    log("obs_cli", wall_s=f"{wall:.3f}", events=len(events), valid=True,
        last=json.dumps({k: events[-1][k] for k in ("rounds_done", "admitted_so_far",
                                                     "served_on_time_so_far")}))


def obs_counters(launches: dict[str, int]) -> None:
    """Phase 13g: a child process loads every kernel from build/repro_torch/
    with no nvcc run; prints this process's launches by kernel for phase 13."""
    import os

    code = ("import json\n"
            "from repro_torch.kernels import build\n"
            "from repro_torch.obs import counters\n"
            "built = build.build_all()\n"
            "print(json.dumps({'sources': len(built), 'compile_events': "
            "counters.compile_events(), 'cache_hits': counters.persistent_cache_hits()}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env=env)
    if proc.returncode != 0:
        raise AssertionError(f"counters child failed:\n{proc.stderr[-2000:]}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    if child["compile_events"] != 0 or child["cache_hits"] != child["sources"]:
        raise AssertionError(f"a warm process ran nvcc: {child}")
    from repro_torch import obs
    log("obs_counters", child=json.dumps(child), parent_compile_events=obs.compile_events(),
        launches_phase13=json.dumps(launches))


def obs_path() -> dict[str, int]:
    """Phase 13: observability threaded through the engine, fault and
    serving paths.  The launch counts are set to 0 before 13a and read
    after 13d; returns them."""
    import tempfile

    from repro_torch.obs import counters

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        counters.reset_launch_counts()
        group, succ = obs_fig3()
        obs_faults()
        obs_serving()
        obs_trace(tmp)
        launches = {k: v for k, v in counters.launch_counts().items() if v}
        obs_provenance(tmp, group, succ)
        obs_cli(tmp)
        obs_counters(launches)
    if launches.get("allocate_masked_cuda", 0) < 1 or launches.get("bmm_gf_cuda", 0) \
            + launches.get("matmul_gf_cuda", 0) < 1:
        raise AssertionError(f"phase 13 did not launch the allocation and B3: {launches}")
    log("obs_path", launches=json.dumps(launches), wall_s=f"{time.perf_counter() - t0:.1f}")
    return launches

# -- phase 14: the speed layer ----------------------------------------------------

SPEED_CHUNK = 2500           # 8 blocks of the fig3 sweep's 20 000 rounds


def fig3_against_bench(results, bench, strategies=("lea", "static", "oracle")) -> list[dict]:
    """Each fig3 scenario's per-seed mean held to ``BENCH_fig3.json``
    (|mean - value| <= 4.5 x the across-seed sd, LEA above static); returns
    each scenario's mean, sd and |z| by strategy."""
    lines = []
    for r, ref_row in zip(results, bench["results"]):
        line = {}
        for s in strategies:
            vals = np.asarray(r.per_seed[s])
            mean, sd = float(vals.mean()), float(vals.std(ddof=1))
            if not np.isfinite(vals).all() or abs(mean - ref_row[f"R_{s}"]) > 4.5 * sd:
                raise AssertionError(
                    f"{r.name} {s}: R={mean} vs BENCH_fig3 {ref_row[f'R_{s}']} "
                    f"(sd {sd})")
            line[s] = (mean, sd, abs(mean - ref_row[f"R_{s}"]) / sd)
        if not r.throughput["lea"] > r.throughput["static"]:
            raise AssertionError(f"{r.name}: LEA does not beat static")
        lines.append(line)
    return lines


def speed_fig3(bench) -> tuple[int, int]:
    """Phase 14a: fig3 (256 rows x 20 000 rounds) at ``round_chunk=2500``
    and unchunked on the group's own generator: both within 4.5 sd of
    ``BENCH_fig3.json``, 8 allocation launches a chunked call, the resampler
    launched in every call; 3 warm runs of each timed; a tapped chunked call
    gives 256 x 8 events and the same successes.  Returns the allocation's
    and the resampler's launches in 14a."""
    from repro_torch import obs, sweeps
    from repro_torch.kernels.poisson_binomial import kernel as kernel_mod
    from repro_torch.kernels.static_resample import kernel as resample_mod

    group, = sweeps.build_groups(sweeps.expand("fig3"), seeds=64)
    rows, rounds = group.batch.rows, group.rounds
    blocks = -(-rounds // SPEED_CHUNK)
    launched = resampled = 0

    def call(**kw):
        nonlocal launched, resampled
        reset_all_launch_counts()
        out, wall = timed(lambda: sweeps.run_group(group, **kw))
        n = kernel_mod.launch_counts()["allocate_masked_cuda"]
        launched += n
        tries = resample_mod.launch_counts()["static_resample_cuda"]
        resampled += tries
        if tries < 1:
            raise AssertionError(f"fig3 {kw}: the resampler never launched")
        return out, wall, n

    sync, _, n_sync = call(round_chunk=SPEED_CHUNK)
    unchunked, _, _ = call()
    if n_sync != blocks:
        raise AssertionError(f"fig3: the allocation launched {n_sync} times, not once "
                             f"a block ({blocks})")
    max_z = {mode: {s: round(max(line[s][2] for line in lines), 2) for s in lines[0]}
             for mode, succ in (("sync", sync), ("sync_unchunked", unchunked))
             for lines in [fig3_against_bench(sweeps.summarize([group], [succ]), bench)]}
    walls = {"sync": [], "sync_unchunked": []}
    for _ in range(3):
        walls["sync"].append(call(round_chunk=SPEED_CHUNK)[1])
        walls["sync_unchunked"].append(call()[1])
    with obs.capture_taps() as events:
        tapped, _, _ = call(round_chunk=SPEED_CHUNK, tap=True)
    if not np.array_equal(tapped, sync) or len(events) != rows * blocks:
        raise AssertionError(f"fig3 tapped: {len(events)} events, bit_equal="
                             f"{np.array_equal(tapped, sync)}")
    last = {}
    for e in events:
        obs.validate_event(e)
        last[int(e["row"])] = e
    for r, e in last.items():
        if int(e["rounds_done"]) != rounds or not np.array_equal(e["succ_so_far"],
                                                                  sync[r].sum(axis=0)):
            raise AssertionError(f"fig3 tapped row {r}: last event {e}")
    med = {mode: statistics.median(w) for mode, w in walls.items()}
    log("speed_fig3", rows=rows, rounds=rounds, round_chunk=SPEED_CHUNK, blocks=blocks,
        allocation_launches_per_call=n_sync, max_z=json.dumps(max_z),
        **{f"{m}_s": f"{v:.4f}" for m, v in med.items()},
        **{f"{m}_row_rounds_per_s": f"{rows * rounds / v:.0f}" for m, v in med.items()},
        walls=json.dumps({m: [round(x, 4) for x in w] for m, w in walls.items()}),
        tap_events=len(events), resampler_launches=resampled,
        gpu=json.dumps(nvidia_smi_line()))
    return launched, resampled


def speed_cache(tmp: Path) -> None:
    """Phase 14b: two child processes, one after the other, with
    ``REPRO_COMPILE_CACHE`` at one fresh directory, each running a
    2 000-round fig3 group: the cold child builds ``poisson_binomial`` and
    ``static_resample`` (two nvcc runs, no hit), the warm one builds nothing
    (0 backend compile events, hits); the repo's ``build/`` is left as it
    was."""
    import os

    code = ("import json\n"
            "from repro_torch import sweeps\n"
            "from repro_torch.launch import cache\n"
            "from repro_torch.obs import counters\n"
            "where = cache.enable_compile_cache()\n"
            "group, = sweeps.build_groups(sweeps.expand('fig3', rounds=2000), seeds=4)\n"
            "succ = sweeps.run_group(group)\n"
            "print(json.dumps({'cache_dir': where, 'rows': int(succ.shape[0]),\n"
            "    'compile_events': counters.compile_events(),\n"
            "    'backend_compile_events': counters.backend_compile_events(),\n"
            "    'nvcc_poisson_binomial': counters.compile_events('build.poisson_binomial'),\n"
            "    'nvcc_static_resample': counters.compile_events('build.static_resample'),\n"
            "    'cache_hits': counters.persistent_cache_hits(),\n"
            "    'cache_misses': cache.persistent_cache_misses()}))\n")
    where = tmp / "kernel_cache"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), REPRO_COMPILE_CACHE=str(where))
    build_dir = ROOT / "build" / "repro_torch"
    before = sorted(p.name for p in build_dir.iterdir())
    children = {}
    for name in ("cold", "warm"):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              timeout=400, env=env, cwd=str(tmp))
        if proc.returncode != 0:
            raise AssertionError(f"{name} cache child failed:\n{proc.stderr[-2000:]}")
        children[name] = dict(json.loads(proc.stdout.strip().splitlines()[-1]),
                              wall_s=round(time.perf_counter() - t0, 3))
    cold, warm = children["cold"], children["warm"]
    if (cold["cache_dir"] != str(where) or cold["compile_events"] != 2
            or cold["nvcc_poisson_binomial"] != 1 or cold["nvcc_static_resample"] != 1
            or cold["cache_hits"] != 0 or cold["cache_misses"] != 2):
        raise AssertionError(f"cold child: {cold}")
    if (warm["backend_compile_events"] != 0 or warm["compile_events"] != 0
            or warm["cache_hits"] < 1 or warm["cache_misses"] != 0):
        raise AssertionError(f"warm child: {warm}")
    if sorted(p.name for p in build_dir.iterdir()) != before:
        raise AssertionError("the cache children wrote into build/repro_torch/")
    log("speed_cache", cold=json.dumps(cold), warm=json.dumps(warm),
        cache_files=json.dumps(sorted(p.name for p in where.iterdir())),
        build_dir_unchanged=True)


MULTI_ROUNDS, MULTI_SEEDS, MULTI_CHUNK = 2000, 4, 500


def speed_multihost(tmp: Path) -> None:
    """Phase 14c: ``run_multihost("hetero_kstar")`` in two
    child processes on the one card (gloo on localhost): process 0's merged
    successes equal this process's own interleave of ``run_group`` over the
    two sub-groups, bit for bit, and so do the summaries; at world 1
    ``run_multihost`` gives ``run``'s results."""
    import os
    import socket

    from repro_torch import sweeps
    from repro_torch.launch import mesh
    from repro_torch.sweeps import executor

    kw = dict(seeds=MULTI_SEEDS, round_chunk=MULTI_CHUNK, rounds=MULTI_ROUNDS)
    spool, out = tmp / "spool", tmp / "multi"
    code = ("import json, sys\n"
            "import numpy as np, torch\n"
            "from repro_torch import sweeps\n"
            "from repro_torch.launch import mesh\n"
            "from repro_torch.sweeps import results\n"
            "spool, out, kw = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])\n"
            "pid, world = mesh.init_distributed()\n"
            "assert world == 2, world\n"
            "res = sweeps.run_multihost('hetero_kstar', spool_dir=spool, **kw)\n"
            "if pid == 0:\n"
            "    np.save(out + '_group0.npy', results.merge_row_shards(spool, 0, 2))\n"
            "    json.dump({r.name: r.per_seed for r in res}, open(out + '.json', 'w'))\n"
            "else:\n"
            "    assert res is None\n"
            "torch.distributed.destroy_process_group()\n"
            "print('rank', pid, 'ok')\n")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        coord = f"localhost:{sock.getsockname()[1]}"
    t0 = time.perf_counter()
    procs = []
    for pid in range(2):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), REPRO_COORDINATOR=coord,
                   REPRO_NUM_PROCESSES="2", REPRO_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen([sys.executable, "-c", code, str(spool), str(out),
                                       json.dumps(kw)], env=env, cwd=str(tmp),
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    try:
        logs = [proc.communicate(timeout=400)[0] for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    for proc, text in zip(procs, logs):
        if proc.returncode != 0:
            raise AssertionError(f"multihost child failed ({proc.returncode}):\n{text[-3000:]}")
    merged = np.load(f"{out}_group0.npy")
    group, = sweeps.build_groups(sweeps.expand("hetero_kstar", rounds=MULTI_ROUNDS),
                                 seeds=MULTI_SEEDS)
    mine = np.empty_like(merged)
    for pid in range(2):
        sub = executor._slice_group_rows(group, pid, 2)
        mine[pid::2] = sweeps.run_group(sub, round_chunk=MULTI_CHUNK)
    if merged.shape != (group.batch.rows, MULTI_ROUNDS, len(group.strategies)) \
            or not np.array_equal(merged, mine):
        raise AssertionError(f"multihost: merged {merged.shape} differs from the interleave "
                             f"in {int((merged != mine).any(axis=-1).sum())} rounds")
    summary = json.loads(Path(f"{out}.json").read_text())
    want = {r.name: {s: list(v) for s, v in r.per_seed.items()}
            for r in sweeps.summarize([group], [mine])}
    if summary != want:
        raise AssertionError("multihost: process 0's summary differs from the interleave's")
    if mesh.world() != (0, 1):
        raise AssertionError(f"the parent joined a group: {mesh.world()}")
    solo = sweeps.run_multihost("hetero_kstar", spool_dir=tmp / "unused", **kw)
    ref = sweeps.run("hetero_kstar", **kw)
    if [r.per_seed for r in solo] != [r.per_seed for r in ref] or (tmp / "unused").exists():
        raise AssertionError("run_multihost at world 1 is not run")
    log("speed_multihost", processes=2, rows=int(merged.shape[0]), rounds=MULTI_ROUNDS,
        round_chunk=MULTI_CHUNK, bit_equal_interleave=True, summary_equal=True,
        world1_is_run=True, wall_s=f"{wall:.3f}",
        shards=json.dumps(sorted(p.name for p in spool.iterdir())))


def speed_costs() -> None:
    """Phase 14d: the cost rows of the three pool-path entry points, counted
    on the card over their PyTorch operations and each launch's own bytes
    and operations of B1's DP (alone or in the fused allocation); every
    entry point must launch one, and the counter must see each launch."""
    from repro_torch.kernels.poisson_binomial import kernel as kernel_mod
    from repro_torch.launch import hlo_cost

    for name in hlo_cost.entry_point_names():
        kernel_mod.reset_launch_counts()
        costs = hlo_cost.entry_costs(name)
        launched = sum(kernel_mod.launch_counts().values())
        row = hlo_cost.cost_row(name, costs)
        if not (row["flops"] > 0 and row["hbm_bytes"] > 0 and row["collective_bytes"] == 0
                and costs.kernel_launches == launched > 0 and costs.kernel_bytes > 0):
            raise AssertionError(f"cost row {row}: {costs.kernel_launches} launches "
                                 f"counted, {launched} made")
        log("speed_cost", target=name, flops=row["flops"], matmul_flops=row["matmul_flops"],
            hbm_bytes=row["hbm_bytes"], flops_per_round=row["flops_per_round"],
            hbm_bytes_per_round=row["hbm_bytes_per_round"],
            arithmetic_intensity=f"{row['arithmetic_intensity']:.4f}",
            b1_launches=costs.kernel_launches, b1_flops=costs.kernel_flops,
            b1_bytes=costs.kernel_bytes, device="cuda")


def speed_path(bench) -> dict[str, int]:
    """Phase 14: the speed layer; returns the allocation's and the
    resampler's launches in 14a, the phase's main path (counts set to 0
    before each call there and summed)."""
    import tempfile

    t0 = time.perf_counter()
    launched, resampled = speed_fig3(bench)
    with tempfile.TemporaryDirectory() as tmp:
        speed_cache(Path(tmp))
        speed_multihost(Path(tmp))
    speed_costs()
    log("speed_path", allocation_launches=launched, resampler_launches=resampled,
        wall_s=f"{time.perf_counter() - t0:.1f}")
    return {"allocate_masked_cuda": launched, "static_resample_cuda": resampled}


# -- phase 19: the multi-card paths, as ranks on the one card ---------------------

SHARDED_SERVE = {"name": "yi_9b", "batch": 4, "prompt": 2048, "steps": 16, "seed": 19}
SHARDED_MOE = {"name": "olmoe_1b_7b", "batch": 4, "prompt": 2048, "steps": 8, "seed": 20}
# depth cut to 7 of 28 layers (DTensor's eager dispatch, not the card, sets
# the step's time), float32 as the JAX test whose bounds the step is held to:
# in bf16 the first Adam step's sign on near-zero gradients follows the
# summation order, and a flip moves a parameter by 2 lr (PERF.md)
SHARDED_TRAIN = {"name": "qwen3_0_6b", "batch": 4, "seq": 512, "seed": 21,
                 "overrides": {"n_layers": 7, "scan_groups": 7, "dtype": "float32"}}
# 1.1 GB: 2 layers, tied embeddings, bf16 moments (as nemotron keeps them)
SHARDED_RESHARD = {"name": "qwen3_0_6b", "seed": 22, "overrides": {
    "n_layers": 2, "tie_embeddings": True, "opt_state_dtype": "bfloat16"}}
SHARDED_PP = {"microbatches": 8, "rows": 2, "seq": 512, "seed": 23}
PP_TOL = 2e-5
WARM_TOKENS = 128


def _free_coordinator() -> str:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return f"localhost:{sock.getsockname()[1]}"


def start_ranks(task: str, world: int, work: Path) -> list:
    """Start ``world`` processes of this script (``--sharded-child task rank
    world coordinator workdir``), each a rank of a gloo group on
    ``cuda:0``."""
    import os

    coord = _free_coordinator()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--sharded-child",
                              task, str(rank), str(world), coord, str(work)],
                             env=env, cwd=str(work), stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for rank in range(world)]


def wait_ranks(procs: list, timeout: float) -> list[tuple[int, str]]:
    """Each process's (exit code, output); every process is stopped."""
    deadline = time.perf_counter() + timeout
    logs = []
    try:
        for proc in procs:
            try:
                logs.append(proc.communicate(timeout=max(1.0, deadline - time.perf_counter()))[0])
            except subprocess.TimeoutExpired:
                proc.kill()
                logs.append(proc.communicate()[0] + "\n[timed out]")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return [(proc.returncode, text) for proc, text in zip(procs, logs)]


def run_ranks(task: str, world: int, work: Path, timeout: float) -> list[tuple[int, str]]:
    return wait_ranks(start_ranks(task, world, work), timeout)


def _check_ranks(task: str, results, work: Path | None = None) -> None:
    for rank, (rc, text) in enumerate(results):
        if rc != 0:
            done = work / f"{task}_{rank}.partial.json" if work is not None else None
            if done is not None and done.exists():
                print(f"[sharded_partial] task={task} rank={rank} done={done.read_text()}",
                      flush=True)
            raise AssertionError(f"phase 19 {task}: rank {rank} exited {rc}:\n{text[-4000:]}")


# the children's side (imports only repro_torch) ----------------------------------

def _probe_case(name: str, fn, want, res: dict) -> None:
    try:
        got = fn()
        torch.cuda.synchronize()
        res[name] = "ok" if got == want else f"wrong {got} != {want}"
    except Exception as e:           # a refusal is the probe's finding, printed
        res[name] = f"error {type(e).__name__}: {str(e)[:120]}"


def child_probe(rank: int, world: int, work: Path) -> dict:
    """Each collective the slice uses, on CUDA tensors over gloo: raw, then
    through the port's helpers (the staged all-gather under DTensor, the
    staged send / recv)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.launch import mesh as lmesh
    from repro_torch.models import sharding

    dev = torch.device("cuda", 0)
    res: dict = {}
    x = torch.full((4,), float(rank + 1), device=dev)
    total = float(sum(range(1, world + 1)))

    def reduced(op):
        y = x.clone()
        dist.all_reduce(y, op=op)
        return y.tolist()

    def gathered():
        out = torch.empty(4 * world, device=dev)
        dist.all_gather_into_tensor(out, x)
        return out.tolist()

    def scattered():
        out = torch.empty(4 // world, device=dev)
        dist.reduce_scatter_tensor(out, x)
        return out.tolist()

    def exchanged():
        out = torch.empty(4, device=dev)
        dist.all_to_all_single(out, torch.arange(4.0, device=dev) + 10 * rank)
        return out.tolist()

    chunk = 4 // world
    _probe_case("all_reduce_sum", lambda: reduced(dist.ReduceOp.SUM), [total] * 4, res)
    _probe_case("all_reduce_max", lambda: reduced(dist.ReduceOp.MAX), [float(world)] * 4, res)
    _probe_case("all_gather", gathered,
                [float(r + 1) for r in range(world) for _ in range(4)], res)
    _probe_case("reduce_scatter", scattered, [total] * chunk, res)
    _probe_case("all_to_all", exchanged,
                [10.0 * r + rank * chunk + i for r in range(world) for i in range(chunk)], res)
    mesh = lmesh.make_host_mesh((1, world), ("data", "model"))      # stages the all-gather
    sharding.reset_staged_bytes()
    a = torch.arange(8.0, device=dev).reshape(4, 2)
    d = sharding.distribute(a, sharding.named_sharding(mesh, "tp", None))
    ones = torch.ones(4, 2, device=dev)
    part = DTensor.from_local(ones, mesh, [Replicate(), Partial()], run_check=False)
    _probe_case("dtensor_all_gather_staged", lambda: d.full_tensor().tolist(), a.tolist(), res)
    _probe_case("dtensor_partial_to_replicate",
                lambda: part.redistribute(mesh, [Replicate(), Replicate()]).to_local().tolist(),
                (ones * world).tolist(), res)
    _probe_case("dtensor_partial_to_shard",
                lambda: part.redistribute(mesh, [Replicate(), Shard(0)]).to_local().tolist(),
                (ones * world)[:chunk].tolist(), res)
    _probe_case("dtensor_shard_to_shard",
                lambda: d.redistribute(mesh, [Replicate(), Shard(1)]).full_tensor().tolist(),
                a.tolist(), res)
    _probe_case("helper_all_reduce_max",
                lambda: sharding.all_reduce(x.clone(), "max", mesh, "model").tolist(),
                [float(world)] * 4, res)

    def neighbour():
        got = torch.zeros(4, device=dev)
        nxt, prv = (rank + 1) % world, (rank - 1) % world
        if rank % 2 == 0:
            sharding.send_recv(x, nxt, None, None, mesh, "model")
            sharding.send_recv(None, None, got, prv, mesh, "model")
        else:
            sharding.send_recv(None, None, got, prv, mesh, "model")
            sharding.send_recv(x, nxt, None, None, mesh, "model")
        return got.tolist()

    _probe_case("send_recv_staged", neighbour, [float((rank - 1) % world + 1)] * 4, res)
    res["staged_bytes"] = sharding.staged_bytes()
    return res


def child_probe_raw(rank: int, world: int, work: Path, kind: str) -> dict:
    """The collectives the port stages, called raw on CUDA tensors: the
    functional all-gather (DTensor's) and send / recv.  A crash is the
    finding; the parent reads the exit code."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc

    x = torch.full((4,), float(rank + 1), device="cuda")
    res: dict = {}
    if kind == "all_gather":
        _probe_case("functional_all_gather_raw",
                    lambda: fc.all_gather_tensor(x, 0, dist.group.WORLD).tolist(),
                    [float(r + 1) for r in range(world) for _ in range(4)], res)
    else:
        def sent():
            y = x.clone()
            if rank == 0:
                dist.send(y, 1)
            elif rank == 1:
                dist.recv(y, 0)
            return y.tolist()
        _probe_case("send_recv_raw", sent, [1.0] * 4, res)
    return res


def _draw_in_turn(world: int, rank: int, make):
    """``make()`` on each rank in turn (a barrier between), so that one full
    copy of the seeded weights at a time lives on the card."""
    import torch.distributed as dist

    out = None
    for r in range(world):
        if r == rank:
            out = make()
            torch.cuda.empty_cache()
        dist.barrier()
    return out


def _sharded_serve(rank: int, world: int, mesh, work: Path, spec: dict) -> dict:
    """One config's flash prefill and teacher-forced decode over ``mesh``,
    held to the parent's single-card references (``serve_ref``)."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import api, sharding
    from repro_torch.models.sharding import full, use_mesh

    name, steps = spec["name"], spec["steps"]
    cfg = get_config(name, attn_impl="flash")
    ref = torch.load(work / f"{name}_ref.pt")

    def place():
        gen = torch.Generator(device="cuda")
        gen.manual_seed(spec["seed"])
        whole = api.get_model(cfg).init_params(gen, cfg, device="cuda")
        return api.distribute_tree(whole, api.param_shardings(cfg, mesh, whole))

    params = _draw_in_turn(world, rank, place)
    local_gb = sum(t.to_local().numel() * t.element_size()
                   for t in params.tensors().values()) / 1e9
    inputs = {"tokens": ref["tokens"].cuda()}
    fed = ref["fed"].cuda()
    prefill = api.make_prefill_step(cfg, max_len=spec["prompt"] + steps)
    serve = api.make_serve_step(cfg)
    with use_mesh(mesh):
        # warm-up (cuBLAS handles, the allocator) on a short prompt
        short = {"tokens": inputs["tokens"][:, :WARM_TOKENS]}
        logits, cache = api.make_prefill_step(cfg, max_len=WARM_TOKENS + 2)(params, short)
        serve(params, cache, {"next_token": fed[:, 0]})
        del logits, cache
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        dist.barrier()
        fa.reset_launch_counts()
        sharding.reset_staged_bytes()
        t0 = time.perf_counter()
        logits, cache = prefill(params, inputs)
        first = full(logits)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        launches = fa.launch_counts()["flash_attention_cuda"]
        staged_prefill = sharding.staged_bytes()
        kept = []
        t0 = time.perf_counter()
        for t in range(steps):
            logits, cache = serve(params, cache, {"next_token": fed[:, t]})
            kept.append(full(logits))
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        decode_launches = fa.launch_counts()["flash_attention_cuda"] - launches
        cache_local = {k: tuple(v.to_local().shape) for k, v in cache.items() if k in ("k", "v")}
        cache_places = str(cache["k"].placements)
    peak = torch.cuda.max_memory_allocated() / 2**30
    real = slice(0, cfg.vocab_size)
    want, err_dense = ref["want"].cuda(), ref["err_dense"]
    err = float((first[:, real] - want[:, real]).abs().max())
    tol = 2 * err_dense + 0.02
    worst, held = 0.0, {}
    for t, got in enumerate(kept):
        rows = ref["held"][t]
        if not rows:
            raise AssertionError(f"{name}: decode step {t}: no row left to hold")
        fresh = ref["fresh"][t].cuda()
        diff = float((got[rows][:, real] - fresh[rows][:, real]).abs().max())
        worst, held[t] = max(worst, diff), rows
        if not diff <= tol:
            raise AssertionError(f"{name} rank {rank}: decode step {t}: max|decode - prefill| "
                                 f"{diff} > {tol} over rows {rows}")
    if not err <= 1.5 * err_dense + 5e-3:
        raise AssertionError(f"{name} rank {rank}: sharded flash prefill max|err| {err} vs "
                             f"float32, dense bf16 {err_dense}: above 1.5 x dense + 5e-3")
    finite = all(bool(torch.isfinite(t).all()) for t in (first, *kept))
    if not finite:
        raise AssertionError(f"{name}: non-finite logits")
    return {"config": cfg.name, "prefill_ms": prefill_s * 1e3,
            "decode_ms_per_step": decode_s / steps * 1e3, "b6_launches_prefill": launches,
            "b6_launches_decode": decode_launches, "peak_memory_gib": peak,
            "local_param_gb": local_gb, "staged_bytes_prefill": staged_prefill,
            "staged_bytes": sharding.staged_bytes(), "err_vs_f32": err,
            "err_dense_single": err_dense, "err_flash_single": ref["err_flash"],
            "decode_vs_prefill_max": worst, "decode_tol": tol, "rows_held": held,
            "cache_local_shape": cache_local, "cache_placements": cache_places,
            "b6_route": fa.flash_route(torch.bfloat16, cfg.head_dim_)}


def _sharded_pp(rank: int, pod) -> dict:
    """Phase 19 [sharded_pp]: ``pipeline_forward`` over 2 stages of
    qwen3-0.6b's SwiGLU MLP at full width in float32 against
    ``reference_forward``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import layers
    from repro_torch.models import sharding
    from repro_torch.runtime.pipeline_parallel import pipeline_forward, reference_forward

    cfg = dataclasses.replace(get_config("qwen3_0_6b"), dtype="float32")
    d, f = cfg.d_model, cfg.d_ff
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SHARDED_PP["seed"])
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    params = {"w_gate": rnd(2, d, f) * 0.02, "w_up": rnd(2, d, f) * 0.02,
              "w_down": rnd(2, f, d) * 0.02}
    x = rnd(SHARDED_PP["microbatches"], SHARDED_PP["rows"], SHARDED_PP["seq"], d)
    stage = lambda p, h: layers.mlp(h, p, cfg)
    sharding.reset_staged_bytes()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = pipeline_forward(stage, params, x, pod, axis="pod")
    torch.cuda.synchronize()
    pp_s = time.perf_counter() - t0
    want = reference_forward(stage, params, x)
    err = float((got - want).abs().max())
    if not err <= PP_TOL:
        raise AssertionError(f"pipeline_forward: max|got - reference| {err} > {PP_TOL}")
    return {"stages": 2, "microbatches": x.shape[0], "microbatch": list(x.shape[1:]),
            "max_abs_err": err, "tol": PP_TOL, "ms": pp_s * 1e3,
            "staged_bytes": sharding.staged_bytes(), "ticks": x.shape[0] + 1}


def child_group_a(rank: int, world: int, work: Path) -> dict:
    """Ranks of a (1 data x 2 model) mesh: yi-9b served, olmoe-1b-7b served
    with expert parallelism, then the 2-stage pipeline."""
    from repro_torch.launch import mesh as lmesh

    mesh = lmesh.make_host_mesh((1, world), ("data", "model"))
    out = {"serve": _sharded_serve(rank, world, mesh, work, SHARDED_SERVE)}
    _partial(work, "group_a", rank, out)
    torch.cuda.empty_cache()
    out["moe"] = _sharded_serve(rank, world, mesh, work, SHARDED_MOE)
    _partial(work, "group_a", rank, out)
    torch.cuda.empty_cache()
    out["pp"] = _sharded_pp(rank, lmesh.make_host_mesh((world,), ("pod",)))
    return out


def _partial(work: Path, task: str, rank: int, out: dict) -> None:
    """The parts a rank has finished, for the parent to print if a later
    part fails."""
    (work / f"{task}_{rank}.partial.json").write_text(json.dumps(out))


def _sharded_train(rank: int, world: int, mesh, work: Path) -> dict:
    """Phase 19 [sharded_train]: one ``make_train_step(grad_shardings=)``
    step of qwen3-0.6b at full width over (2 x 2), held to the parent's
    single-card step (``train_ref.pt``)."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.models.sharding import full, use_mesh

    cfg = get_config(SHARDED_TRAIN["name"], **SHARDED_TRAIN["overrides"])
    ref = torch.load(work / "train_ref.pt")
    holder = {}

    def place():
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SHARDED_TRAIN["seed"])
        whole = api.init_state(cfg, gen, device="cuda")
        holder["sh"] = api.state_shardings(cfg, mesh, whole)
        return api.distribute_tree(whole, holder["sh"])

    state = _draw_in_turn(world, rank, place)
    sh = holder["sh"] if "sh" in holder else api.state_shardings(cfg, mesh, state)
    tokens = ref["tokens"].cuda()
    batch = api.distribute_tree({"tokens": tokens},
                                api.batch_shardings(cfg, mesh, {"tokens": tokens}))
    step = api.make_train_step(cfg, peak_lr=1e-3, warmup=1, grad_shardings=sh.params)
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    t0 = time.perf_counter()
    with use_mesh(mesh):
        state, metrics = step(state, batch)
        loss = float(full(metrics["loss"]))
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    worst_abs, worst_name, over = 0.0, "", []
    want_params = ref["params"]
    for name, t in state.params.tensors().items():
        got = full(t).detach().float()
        if tuple(t.placements) != sh.params[name].placements:
            raise AssertionError(f"{name}: placements {t.placements} after the step")
        want = want_params[name].cuda().float()
        diff = (got - want).abs()
        excess = diff - (2e-3 + 2e-2 * want.abs())
        if bool((excess > 0).any()):
            over.append(f"{name}: {int((excess > 0).sum())} of {diff.numel()}, "
                        f"worst {float(diff.max())}")
        if float(diff.max()) > worst_abs:
            worst_abs, worst_name = float(diff.max()), name
    if not abs(loss - ref["loss"]) <= 2e-3 or over:
        raise AssertionError(f"sharded train: loss {loss} vs {ref['loss']}; parameters past "
                             f"rtol 2e-2 / atol 2e-3: {over[:5]}")
    return {"config": cfg.name, "layers": f"{cfg.n_layers} of 28", "dtype": cfg.dtype,
            "loss": loss,
            "loss_single": ref["loss"],
            "loss_abs_err": abs(loss - ref["loss"]), "param_max_abs_err": worst_abs,
            "param_worst": worst_name, "step_ms": step_s * 1e3, "peak_memory_gib": peak,
            "microbatch": cfg.microbatch, "remat": cfg.remat}


def _pieces_equal_file(trees, mesh, path: Path) -> tuple[bool, int, int]:
    """Whether every rank-local piece of each tree's leaves equals the same
    slice of the checkpoint file at ``path`` (leaves in the file's order);
    returns (equal, leaves, bytes of the file's arrays)."""
    from repro_torch.checkpoint.ckpt import _named_leaves, _to_tensor
    from repro_torch.models.sharding import local_region

    meta = json.loads((path / "meta.json").read_text())
    equal, checked, nbytes = True, 0, 0
    with np.load(path / "arrays.npz") as data:
        for i, leaves in enumerate(zip(*(_named_leaves(t) for t in trees))):
            first = leaves[0][1]
            whole = _to_tensor(data[f"a{i}"], meta["dtypes"][i], first.to_local(), "cuda")
            off, size = local_region(first.shape, mesh, first.placements)
            want = whole[tuple(slice(o, o + n) for o, n in zip(off, size))]
            for _, t in leaves:
                equal &= bool(torch.equal(t.to_local(), want))
            checked += 1
            nbytes += whole.numel() * whole.element_size()
    return equal, checked, nbytes


def _sharded_reshard(rank: int, world: int, mesh22, mesh12, work: Path) -> dict:
    """Phase 19 [sharded_reshard]: a train state saved from (2 x 2), restored
    onto (1 x 2) by ``restore(shardings=)`` and moved by ``reshard_state``.
    Every rank's pieces of the saved state, and on the two ranks of the new
    mesh every piece of both results, bit-equal to the same slices of the
    file (no gather in the check)."""
    from repro_torch.checkpoint import restore, save
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.runtime.elastic import reshard_state

    cfg = get_config(SHARDED_RESHARD["name"], **SHARDED_RESHARD["overrides"])

    def place():
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SHARDED_RESHARD["seed"])
        whole = api.init_state(cfg, gen, device="cuda")
        for t in list(whole.m.values()) + list(whole.v.values()):
            t.uniform_(generator=gen)
        return api.distribute_tree(whole, api.state_shardings(cfg, mesh22, whole))

    state22 = _draw_in_turn(world, rank, place)
    like = api.abstract_state(cfg)
    sh12 = api.state_shardings(cfg, mesh12, like)
    step_dir = work / "ckpt" / "step_3"
    t0 = time.perf_counter()
    save(str(work / "ckpt"), 3, state22)
    save_s = time.perf_counter() - t0
    saved_equal, checked, nbytes = _pieces_equal_file([state22], mesh22, step_dir)
    member = mesh12.get_coordinate() is not None
    t0 = time.perf_counter()
    restored = restore(str(work / "ckpt"), 3, like, shardings=sh12)[0] if member else None
    restore_s = time.perf_counter() - t0
    moved = reshard_state(state22, sh12)
    equal = saved_equal
    if member:
        equal &= _pieces_equal_file([restored, moved], mesh12, step_dir)[0]
    if not equal:
        raise AssertionError(f"reshard rank {rank}: a piece differs from the saved file")
    return {"member": member, "leaves": checked, "bytes": nbytes, "bit_equal": equal,
            "save_s": save_s, "restore_s": restore_s, "config": cfg.name,
            "layers": cfg.n_layers}


def child_group_b(rank: int, world: int, work: Path) -> dict:
    """Ranks of a (2 data x 2 model) mesh: the train step, then the reshard
    onto (1 x 2)."""
    from repro_torch.launch import mesh as lmesh

    mesh22 = lmesh.make_host_mesh((2, 2), ("data", "model"))
    mesh12 = lmesh.make_host_mesh((1, 2), ("data", "model"))
    out = {"train": _sharded_train(rank, world, mesh22, work)}
    _partial(work, "group_b", rank, out)
    torch.cuda.empty_cache()
    out["reshard"] = _sharded_reshard(rank, world, mesh22, mesh12, work)
    return out


def sharded_child(task: str, rank: int, world: int, coord: str, work: str) -> int:
    """Entry of a phase-19 child process: one rank of a gloo group on
    ``cuda:0``; writes ``<task>_<rank>.json`` in ``work``."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as lmesh

    torch.cuda.set_device(0)
    lmesh.init_distributed(coordinator=coord, num_processes=world, process_id=rank)
    work_dir = Path(work)
    if task.startswith("probe_raw_"):
        out = child_probe_raw(rank, world, work_dir, task[len("probe_raw_"):])
    else:
        out = {"probe": child_probe, "group_a": child_group_a,
               "group_b": child_group_b}[task](rank, world, work_dir)
    (work_dir / f"{task}_{rank}.json").write_text(json.dumps(out))
    if not task.startswith("probe_raw_"):
        dist.barrier()
    dist.destroy_process_group()
    return 0


# the parent's side -------------------------------------------------------------------

def serve_ref(spec: dict, work: Path) -> None:
    """The single-card references of a sharded serve, from the same seeded
    weights: the greedy tokens of a single-card flash decode (fed to the
    ranks in turn), a float32 evaluation of the prefill and the dense bf16
    prefill's error from it, and for each decode step a fresh single-card
    flash prefill over the prompt and the tokens fed so far (MoE: the rows
    where neither prefill drops a route)."""
    import dataclasses
    import gc

    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.models import api

    name, steps, b = spec["name"], spec["steps"], spec["batch"]
    cfg = get_config(name, attn_impl="flash")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(spec["seed"])
    params = api.get_model(cfg).init_params(gen, cfg, device="cuda")
    inputs = api.make_batch(cfg, ShapeCell("serve", spec["prompt"], b, "prefill"), gen,
                            device="cuda")
    tokens = inputs["tokens"]
    prefill = api.make_prefill_step(cfg, max_len=spec["prompt"] + steps)
    serve = api.make_serve_step(cfg)
    moe = bool(cfg.n_experts)
    with MoeDrops(b) as counter:
        logits, cache = prefill(params, inputs)
    drops_main = counter.rows.tolist()
    first = logits
    fed = []
    for _ in range(steps):
        tok = logits.argmax(-1)
        fed.append(tok)
        logits, cache = serve(params, cache, {"next_token": tok})
    del cache
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    want = api.make_prefill_step(cfg32, max_len=spec["prompt"], attn_impl="ref")(
        Float32Layers(params), inputs)[0]
    torch.cuda.empty_cache()
    real = slice(0, cfg.vocab_size)
    dense = api.make_prefill_step(cfg, max_len=spec["prompt"], attn_impl="ref")(params, inputs)[0]
    err_dense = float((dense[:, real] - want[:, real]).abs().max())
    err_flash = float((first[:, real] - want[:, real]).abs().max())
    del dense
    generated = torch.stack(fed, dim=1)
    fresh, held = [], []
    for t in range(steps):
        prefix = torch.cat([tokens, generated[:, :t + 1].to(tokens.dtype)], dim=1)
        with MoeDrops(b) as counter:
            fresh.append(api.make_prefill_step(cfg)(params, {"tokens": prefix})[0].float().cpu())
        rows = list(range(b))
        if moe:
            rows = [r for r in rows if not (drops_main[r] or counter.rows[r])]
        held.append(rows)
    torch.save({"tokens": tokens.cpu(), "fed": generated.cpu(), "want": want.cpu(),
                "err_dense": err_dense, "err_flash": err_flash, "fresh": fresh, "held": held,
                "drops_main": drops_main}, work / f"{name}_ref.pt")
    del params, first, logits, want, fresh
    gc.collect()
    torch.cuda.empty_cache()


def train_ref(work: Path) -> None:
    """The single-card step the sharded one is held to: the same seeded
    state and batch, ``make_train_step(peak_lr=1e-3, warmup=1)`` (the JAX
    test's); its loss and updated parameters."""
    import gc

    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.models import api

    cfg = get_config(SHARDED_TRAIN["name"], **SHARDED_TRAIN["overrides"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SHARDED_TRAIN["seed"])
    state = api.init_state(cfg, gen, device="cuda")
    batch = api.make_batch(cfg, ShapeCell("train", SHARDED_TRAIN["seq"],
                                          SHARDED_TRAIN["batch"], "train"), gen, device="cuda")
    state, metrics = api.make_train_step(cfg, peak_lr=1e-3, warmup=1)(state, batch)
    torch.save({"tokens": batch["tokens"].cpu(), "loss": float(metrics["loss"]),
                "params": {n: t.detach().cpu() for n, t in state.params.tensors().items()}},
               work / "train_ref.pt")
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()


def _rank_results(task: str, world: int, work: Path) -> list[dict]:
    return [json.loads((work / f"{task}_{rank}.json").read_text()) for rank in range(world)]


def start_probe(work: Path) -> dict:
    """Phase 19's probe, started: each collective of the slice on CUDA
    tensors over gloo, two ranks on the card; the raw functional all-gather
    and send / recv each in a pair of their own (they may kill the
    process).  The three pairs run beside the parent's references."""
    return {task: start_ranks(task, 2, work)
            for task in ("probe", "probe_raw_all_gather", "probe_raw_send")}


def finish_probe(started: dict, work: Path) -> dict:
    results = {task: wait_ranks(procs, 240) for task, procs in started.items()}
    _check_ranks("probe", results["probe"])
    probe = _rank_results("probe", 2, work)
    line = {}
    for kind in ("all_gather", "send"):
        files = [work / f"probe_raw_{kind}_{r}.json" for r in range(2)]
        key = "functional_all_gather_raw" if kind == "all_gather" else "send_recv_raw"
        if all(f.exists() for f in files):
            line[key] = json.loads(files[0].read_text())[key]
        else:
            line[key] = ("refused (exit codes "
                         f"{[rc for rc, _ in results[f'probe_raw_{kind}']]})")
    for rank, res in enumerate(probe):
        bad = {k: v for k, v in res.items() if k != "staged_bytes" and v != "ok"}
        if bad:
            raise AssertionError(f"phase 19 probe rank {rank}: {bad}")
    from repro_torch.models.sharding import GLOO_HOST_STAGED

    log("sharded_probe", backend="gloo", device="cuda:0 (both ranks)",
        **{k: json.dumps(v) for k, v in probe[0].items() if k != "staged_bytes"},
        **{k: json.dumps(v) for k, v in line.items()},
        staged=json.dumps(sorted(GLOO_HOST_STAGED)),
        staged_bytes_probe=probe[0]["staged_bytes"], torch=torch.__version__)
    return line


def sharded_path(tmp: Path) -> dict[str, int]:
    """Phase 19: the multi-card paths on the one card, each rank a process
    (gloo on localhost, every rank on cuda:0): the probe, yi-9b and
    olmoe-1b-7b served over (1 x 2), qwen3-0.6b's train step over (2 x 2),
    the pipeline, the reshard and the dry run.  Returns B6's launches in the
    sharded serve's prefill, summed over its ranks."""
    import os

    t_phase = time.perf_counter()
    work = tmp / "sharded"
    work.mkdir()
    dry = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                            "whisper_tiny", "--shape", "decode_32k", "--out", str(work / "dry")],
                           env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), cwd=str(work),
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    probes = start_probe(work)
    for spec in (SHARDED_SERVE, SHARDED_MOE):
        serve_ref(spec, work)
    train_ref(work)
    finish_probe(probes, work)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = run_ranks("group_a", 2, work, timeout=600)
    group_a_s = time.perf_counter() - t0
    _check_ranks("group_a", results, work)
    a = _rank_results("group_a", 2, work)
    from repro_torch.configs import get_config

    for key, tag, spec in (("serve", "sharded_serve", SHARDED_SERVE),
                           ("moe", "sharded_moe", SHARDED_MOE)):
        r0, r1 = a[0][key], a[1][key]
        cfg = get_config(spec["name"])
        expected = cfg.n_layers
        if r0["b6_launches_prefill"] != expected or r1["b6_launches_prefill"] != expected:
            raise AssertionError(f"{tag}: B6 launched {r0['b6_launches_prefill']} / "
                                 f"{r1['b6_launches_prefill']} times a prefill, not {expected}")
        extra = {}
        if key == "moe":
            ref = torch.load(work / f"{spec['name']}_ref.pt")
            extra = dict(experts=f"{cfg.n_experts}top{cfg.top_k}",
                         experts_per_rank=cfg.n_experts // 2, moe_impl=cfg.moe_impl,
                         moe_dropped_main_by_row=json.dumps(ref["drops_main"]),
                         decode_rows_held=json.dumps(r0["rows_held"]))
        log(tag, config=r0["config"], mesh="1x2", ranks=2, device="cuda:0", backend="gloo",
            batch=spec["batch"], prompt=spec["prompt"], decode_steps=spec["steps"],
            decode_tokens="single-card greedy, fed in turn",
            prefill_ms=f"{max(r0['prefill_ms'], r1['prefill_ms']):.3f}",
            decode_ms_per_step=f"{max(r0['decode_ms_per_step'], r1['decode_ms_per_step']):.3f}",
            peak_memory_gib_per_rank=json.dumps([round(r0["peak_memory_gib"], 2),
                                                 round(r1["peak_memory_gib"], 2)]),
            local_param_gb_per_rank=json.dumps([round(r0["local_param_gb"], 3),
                                                round(r1["local_param_gb"], 3)]),
            gloo_staged_bytes=r0["staged_bytes"],
            gloo_staged_bytes_prefill=r0["staged_bytes_prefill"],
            b6_route=r0["b6_route"], b6_launches_prefill_per_rank=r0["b6_launches_prefill"],
            b6_launches_decode=r0["b6_launches_decode"],
            err_vs_f32=r0["err_vs_f32"], err_flash_single_vs_f32=r0["err_flash_single"],
            err_dense_single_vs_f32=r0["err_dense_single"],
            decode_vs_prefill_max=max(r0["decode_vs_prefill_max"], r1["decode_vs_prefill_max"]),
            decode_tol=r0["decode_tol"], cache_local_shape=json.dumps(r0["cache_local_shape"]),
            cache_placements=json.dumps(r0["cache_placements"]), **extra,
            gpu=json.dumps(nvidia_smi_line()))
    pp = a[0]["pp"]
    log("sharded_pp", **{k: json.dumps(v) if isinstance(v, list) else v for k, v in pp.items()})

    t0 = time.perf_counter()
    results = run_ranks("group_b", 4, work, timeout=600)
    group_b_s = time.perf_counter() - t0
    _check_ranks("group_b", results, work)
    b = _rank_results("group_b", 4, work)
    tr = b[0]["train"]
    log("sharded_train", mesh="2x2", ranks=4, device="cuda:0", backend="gloo",
        cut=json.dumps({"n_layers": f"{SHARDED_TRAIN['overrides']['n_layers']} of 28"}),
        batch=SHARDED_TRAIN["batch"], seq=SHARDED_TRAIN["seq"], attn_impl="ref",
        grad_shardings="state_shardings(...).params", loss_tol=2e-3,
        param_tol="rtol 2e-2 atol 2e-3",
        **{k: v for k, v in tr.items()},
        step_ms_per_rank=json.dumps([round(r["train"]["step_ms"], 1) for r in b]),
        gpu=json.dumps(nvidia_smi_line()))
    rs = [r["reshard"] for r in b]
    if not all(r["bit_equal"] for r in rs[:2]) or rs[0]["leaves"] == 0:
        raise AssertionError(f"reshard: {rs}")
    log("sharded_reshard", saved_on="2x2", restored_on="1x2", config=rs[0]["config"],
        layers=rs[0]["layers"], leaves=rs[0]["leaves"], bytes=rs[0]["bytes"],
        bit_equal=True, save_s=f"{rs[0]['save_s']:.2f}", restore_s=f"{rs[0]['restore_s']:.2f}",
        cut=json.dumps(SHARDED_RESHARD["overrides"]),
        ranks_outside_new_mesh=sum(1 for r in rs if not r["member"]))

    try:
        out, err = dry.communicate(timeout=300)
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait()
    if dry.returncode != 0 or "all cells ok" not in out:
        raise AssertionError(f"dry run failed ({dry.returncode}):\n{out[-2000:]}\n{err[-2000:]}")
    rec = json.loads((work / "dry" / "whisper_tiny__decode_32k__pod.json").read_text())
    log("sharded_dryrun", cell="whisper_tiny x decode_32k", mesh=rec["mesh"],
        devices=rec["devices"], all_cells_ok=True,
        wall_s=f"{rec['lower_s'] + rec['compile_s']:.1f} (place + counted run; "
               "the process ran beside the phase)",
        per_device_bytes=rec["memory"]["per_device_total"],
        flops=rec["cost"]["flops"], collective_bytes=rec["collectives"]["total_bytes"],
        dominant=rec["roofline"]["dominant"])
    launches = a[0]["serve"]["b6_launches_prefill"] + a[1]["serve"]["b6_launches_prefill"]
    log("sharded_path", b6_launches=launches, group_a_s=f"{group_a_s:.1f}",
        group_b_s=f"{group_b_s:.1f}", wall_s=f"{time.perf_counter() - t_phase:.1f}",
        note="ranks share one card over gloo: not a multi-card scaling measure")
    return launches



def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch import sweeps
    from repro_torch.core import throughput
    from repro_torch.core.lea import LoadParams
    from repro_torch.kernels import build
    from repro_torch.kernels.poisson_binomial import kernel as kernel_mod
    from repro_torch.kernels.poisson_binomial import success_tails_ref
    from repro_torch.kernels.static_resample import kernel as resample_mod
    from repro_torch.random import RecordedDraws, ReplayedDraws, torch_draws

    smi = nvidia_smi_line()
    print(smi, flush=True)
    t_start = time.perf_counter()
    walls: dict[str, float] = {}

    def phase_done(name: str) -> None:
        walls[name] = round(time.perf_counter() - t_start - sum(walls.values()), 1)

    t0 = time.perf_counter()
    builds = build.build_all()
    log("env", gpu=json.dumps(smi), torch=torch.__version__,
        cuda=torch.version.cuda, build_all_s=f"{time.perf_counter() - t0:.2f}")
    for built in builds:
        log("build", source=built.name, build_s=f"{built.seconds:.2f}",
            library=built.path.name)
        kernel = ""
        for line in built.log.splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:   # the mangled name less its namespace: flash_wgmma_kernelI13__nv_bfloat16Li128...
                kernel = re.sub(r"^_Z(N\d+_GLOBAL__N__\w+?_cu_[0-9a-f]+)?\d+", "", entry.group(1))[:60]
            elif "registers" in line or "spill" in line or "C7514" in line:
                log("ptxas", source=built.name, kernel=kernel, line=json.dumps(line.strip()))
                spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                if "C7514" in line or (kernel.startswith("flash_wgmma_kernel") and spills
                                       and spills.groups() != ("0", "0")):
                    raise AssertionError(f"ptxas on the wgmma route ({kernel}): {line.strip()}")
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    log("wgmma_smem", **{f"d{d}_bytes": fa_kernel.wgmma_smem_bytes(d)
                         for d in fa_kernel.WGMMA_HEAD_DIMS})

    record = check_kernels(kernel_mod, success_tails_ref)
    record.update(check_allocate())
    record.update(check_static_resample())
    phase_done('1-2 build, B1/B2')

    # -- phase 3: the main path ------------------------------------------------
    bench = json.loads((ROOT / "BENCH_fig3.json").read_text())
    strategies = ("lea", "static", "oracle")
    reset_all_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = sweeps.run("fig3", seeds=64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_main = {**kernel_mod.launch_counts(), **resample_mod.launch_counts()}
    if launches_main["allocate_masked_cuda"] < 1 or launches_main["static_resample_cuda"] < 1 \
            or launches_main["success_tails_cuda_w"] != 0:
        raise AssertionError(f"main path did not allocate in the fused kernel alone or "
                             f"never launched the resampler: {launches_main}")
    rounds = results[0].scenario.rounds
    rows = sum(r.seeds for r in results)
    for r, line in zip(results, fig3_against_bench(results, bench, strategies)):
        fields = {}
        for s, (mean, sd, _) in line.items():
            fields[f"R_{s}"] = f"{mean:.4f}"
            fields[f"sd_{s}"] = f"{sd:.4f}"
        log("fig3", scenario=r.name, **fields,
            lea_over_static=f"{r.throughput['lea'] / r.throughput['static']:.2f}x")
    log("main", wall_s=f"{wall:.3f}", rows=rows, rounds=rounds,
        row_rounds_per_s=f"{rows * rounds / wall:.0f}",
        dp_rows_per_s=f"{2 * rows * rounds / wall:.0f}",
        max_memory_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
        launches=json.dumps(launches_main))
    phase_done('3 fig3')

    # -- phase 4: the static-threshold entry ------------------------------------
    reset_all_launch_counts()
    t0 = time.perf_counter()
    cmp = throughput.compare(1, LoadParams(15, 99, 10, 3), [0.8] * 15,
                             [0.8] * 15, 10.0, 3.0, 1.0, 20_000)
    torch.cuda.synchronize()
    wall_cmp = time.perf_counter() - t0
    launches_static = {**kernel_mod.launch_counts(), **resample_mod.launch_counts()}
    if launches_static["success_tails_cuda"] < 1 or launches_static["static_resample_cuda"] < 1:
        raise AssertionError(f"compare never launched the static kernel or the resampler: "
                             f"{launches_static}")
    if not cmp["lea"] > cmp["static"]:
        raise AssertionError(f"compare: LEA does not beat static: {cmp}")
    log("compare", **{f"R_{s}": f"{v:.4f}" for s, v in cmp.items()},
        wall_s=f"{wall_cmp:.3f}", launches=json.dumps(launches_static))
    phase_done('4 compare')

    # -- phase 5: card and CPU agree on the same draws --------------------------
    group, = sweeps.build_groups(sweeps.expand("fig3", rounds=2000), seeds=4)
    recorder = RecordedDraws(torch_draws(7))
    on_card = sweeps.run_group(group, draws=recorder)
    on_cpu = sweeps.run_group(group, device="cpu",
                              draws=ReplayedDraws(recorder.calls))
    if on_card.shape != on_cpu.shape:
        raise AssertionError(f"shapes {on_card.shape} != {on_cpu.shape}")
    differ = int((on_card != on_cpu).any(axis=-1).sum())
    if differ > on_card.shape[0] * on_card.shape[1] // 1000:
        raise AssertionError(f"card and CPU differ in {differ} rounds")
    log("agree", rows=on_card.shape[0], rounds=on_card.shape[1],
        differing_rounds=differ)
    phase_done('5 agree')

    # -- phase 6: the coding kernels against their plain versions -------------
    record.update(check_coding_kernels())
    phase_done('6 coding kernels')

    # -- phase 7: the coded path -------------------------------------------------
    launches_coded = coded_path()
    phase_done('7 coded')

    # -- phase 8: the ported examples --------------------------------------------
    from repro_torch.examples import coded_regression, quickstart
    t0 = time.perf_counter()
    ex = coded_regression.run(device="cuda")
    torch.cuda.synchronize()
    log("example", wall_s=f"{time.perf_counter() - t0:.3f}",
        throughput=json.dumps(ex["throughput"]), loss=json.dumps(ex["loss"]),
        exact_checked=ex["exact_checked"])
    t0 = time.perf_counter()
    qs = quickstart.run(device="cuda", rounds=500, echo=lambda line: None)
    torch.cuda.synchronize()
    log("example_quickstart", wall_s=f"{time.perf_counter() - t0:.3f}",
        rows=json.dumps(qs["lines"]))
    phase_done('8 examples')

    # -- phase 9: flash attention against its plain version ----------------------
    record.update(check_flash_kernel())
    phase_done('9 flash')

    # -- phase 10: the LM serving path -------------------------------------------
    launches_lm = serve_lm()
    phase_done('10 serve')

    # -- phase 11: the fault-injection runtime ------------------------------------
    launches_faults = faults_path()
    record.update(check_packet_counts())
    phase_done('11 faults')

    # -- phase 12: the streaming serving layer -------------------------------------
    launches_serving = serving_path()
    phase_done('12 serving')

    # -- phase 13: observability ------------------------------------------------------
    launches_obs = obs_path()
    phase_done('13 obs')

    # -- phase 14: the speed layer -------------------------------------------------
    launches_speed = speed_path(bench)
    phase_done('14 speed')

    # -- phase 15: the rest of the dense family, served -----------------------------
    launches_dense = dense_serve()
    phase_done('15 dense')

    # -- phase 16: training ----------------------------------------------------------
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        launches_train = train_path(Path(tmp))
    phase_done('16 train')

    # -- phase 17: the MoE, hybrid and xLSTM families, served -------------------------
    launches_zoo = zoo_serve()
    phase_done('17 zoo')

    # -- phase 18: the enc-dec and vision-stub families, served -----------------------
    launches_frontend = frontend_serve()
    phase_done('18 frontend')

    # -- phase 19: the multi-card paths, ranks sharing the one card ---------------------
    with tempfile.TemporaryDirectory() as tmp:
        launches_sharded = sharded_path(Path(tmp))
    phase_done('19 sharded')

    kernels = []
    resampled = {"fig3": launches_main["static_resample_cuda"],
                 "compare": launches_static["static_resample_cuda"]}
    launches = {"success_tails_cuda_w": launches_main["success_tails_cuda_w"],
                "success_tails_cuda": launches_static["success_tails_cuda"],
                "allocate_masked_cuda": launches_main["allocate_masked_cuda"],
                **launches_coded, "flash_attention_cuda": launches_lm,
                "static_resample_cuda": resampled["fig3"],
                "packet_counts_cuda": launches_faults["packet_counts_cuda"]}
    by_path = {"fig3": {"success_tails_cuda_w": launches_main["success_tails_cuda_w"],
                        "allocate_masked_cuda": launches_main["allocate_masked_cuda"],
                        "static_resample_cuda": resampled["fig3"]},
               "compare": {"success_tails_cuda": launches_static["success_tails_cuda"],
                           "static_resample_cuda": resampled["compare"]},
               "coded": launches_coded, "serve": {"flash_attention_cuda": launches_lm},
               "faults": launches_faults, "serving": launches_serving, "obs": launches_obs,
               "speed": launches_speed, "dense_serve": {"flash_attention_cuda": launches_dense},
               "train": launches_train, "zoo_serve": {"flash_attention_cuda": launches_zoo},
               **{path: {"flash_attention_cuda": n} for path, n in launches_frontend.items()},
               "sharded_serve": {"flash_attention_cuda": launches_sharded}}
    for name, (source, replaces) in KERNELS.items():
        entry = record[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "launches_by_path": {path: counts[name] for path, counts in by_path.items()
                                 if name in counts},
            "max_abs_err": entry["max_abs_err"], "ms": entry["ms"],
            "plain_ms": entry["plain_ms"], "bound_ms": entry["bound_ms"],
            "bound_by": entry["bound_by"],
            "library_ms": entry.get("library_ms"),
            "ms_batched": entry["ms_batched"],
            "plain_ms_batched": entry["plain_ms_batched"],
            "library_ms_batched": entry.get("library_ms_batched"),
            "composition_ms": entry.get("composition_ms"),
            "composition": entry.get("composition"),
            "library": entry.get("library"),
            "kernel_route": entry.get("kernel_route"),
            "shape": entry["shape"],
        })
    log("phase_walls", total_s=round(time.perf_counter() - t_start, 1), **{
        f"p{k.split()[0]}": v for k, v in walls.items()})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--sharded-child":
        sys.path.insert(0, str(ROOT / "src"))
        sys.exit(sharded_child(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5],
                               sys.argv[6]))
    sys.exit(main())
