#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (afft_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:
  1. device  - the card's name and power limit (nvidia-smi), TF32 off;
  2. build   - compile afft_tpu_torch/csrc with nvcc for sm_90a; ptxas's
               report (registers, shared memory, spills) of the wgmma / TMA
               GEMM, the staged attention and the fuser attention, and the
               library's SASS must hold HGMMA (wgmma) instructions where the
               toolkit has cuobjdump;
  3. gemm    - the wgmma / TMA GEMM (ops.gemm, ops.gemm_tn) against the
               fp32 product of its upcast operands: C = A . W for W (K, N)
               under each of its six epilogues and the fp32 output, at the
               GPT-2 entries' and the fuser backward's shapes and at edge
               shapes (M 1 / 15 / 4097, N 72 / 136 / 6144, K 24 / 40 /
               2048), dropout masks bit for bit; its K-major B route (W
               read as (N, K)) under the epilogues of the fuser blocks'
               serving forward (bias, exact GELU, the residual add with an
               fp32 out or an fp32 residual) at rows 1's and 5's product
               shapes, of the fuser's training forward (exact GELU with the
               pre-activation stash, the residual add with dropout and
               drop-path into the fp32 residual stream with y's stash or
               over it) at row 7's and of the GPT-2 layer's backward dX
               (the gelu_new derivative, fp32 outs) at rows 13 + 14's and
               15's, and at the same edge shapes, dropout masks bit for bit,
               bit for bit from launch to launch; the decoder block's cross
               proj (the residual add with an fp32 residual and an fp32 out
               written into the residual, in place) at its shape and the
               edge shapes, bit for bit against a second launch and against
               the same form out of place; its TN route (the weight
               gradients) at the training entries' shapes and at edge
               shapes (M 1 / 15 / 4097, I 8 / 72 / 136, J 24 / 200 / 264),
               bit for bit from run to run, and split over M (the slices
               each training shape takes, printed; every split form at the
               shapes that split and at ragged edges, against the fp32
               product and bit for bit; timed whole, as the rule splits
               and in 4 slices); then all timed in turns against
               torch.matmul (the library yardstick), and at the rollout's
               cached-block shapes against cuBLAS addmm; the wgmma GEMM
               must keep 2x the rate, and half the time at the cross
               stage's shape, of the deleted wmma GEMM's last readings
               (WMMA_TFLOPS, WMMA_MS); every model width (ROADMAP §C.8):
               every epilogue of both weight layouts and the TN route in
               1 / 2 / 3 slices at N and K (I and J) in 1 / 5 / 12 / 20 /
               36 / 100 / 1,025 over 133 rows, operands off TMA's 16-byte
               grid packed by pack_rows, bit for bit on relaunch; and
               pack_rows alone against its plain version (a copy), timed
               beside it and F.pad;
  4. kernels - each kernel (fused_block, gpt2_attn_half, gpt2_mlp_half,
               fused_attention, fused_seq_block, fused_decoder_block; the
               fuser block's and the GPT-2 layer's training entries, forward
               and two backward halves each, and their mask kernels
               draw_masks and draw_masks_gpt2, whose masks equal the
               generator in torch integer ops bit for bit and whose
               gradients are held against fp32 autograd through the plain
               version; first the attention backward of both training
               layers alone, csrc/attention_bwd.cuh, against its plain
               version at the training edges (fuser N 1-8, GPT-2 T 1-32,
               hd 6-512, rates 0 / 0.1 / 0.5, masked or not, fp32 and bf16)
               and the flagship shapes, bit for bit on relaunch, its O bit
               for bit the forward attention kernel's, and its device time
               against its byte bound)
               against its plain PyTorch version on the card, in bf16 at the
               shapes of the served and trained paths and in fp32 at a
               reduced batch, and at edge shapes; its time beside the plain
               version's, a cuBLAS + SDPA composition of the same function,
               and the least time the card could take; a profile by kernel
               group of the entries redesigned on the wgmma / TMA GEMM and
               the sequence attention (REDESIGNED), where fused_block,
               fused_seq_block, fused_decoder_block and
               fused_block_train_fwd must launch none of the kernels they
               ran before (OFF_PATH: gemm_bf16, the one-warp-per-query
               attentions), nor fused_gpt2_train_bwd_mlp gemm_bf16, and
               every product of the six must run on gemm_sm90's (N, K)
               route or its TN route; both attention backwards
               (fused_block_train_bwd_attn, fused_gpt2_train_bwd_attn) must
               launch attention_bwd and neither the one-warp-per-query
               backward nor the forward attention; fused_attention (prefill and decode) must launch the
               sequence attention alone, and fused_decoder_block its
               products, its two attentions and its LayerNorms alone
               (ONLY_ON); the fuser attention at its edges (N 1 / 5 / 8, S
               1 to 1024, hd 6 / 12 / 256, with and without the causal
               mask) and the attention over separate q, k, v at its own
               (Nq 1 / 16 / 32 / 1024 x Nk 1 / 19 / 64 / 65 / 1024 x hd
               6 / 12 / 256 / 512, no mask, causal or the rollout's cache
               mask with NaN in the unwritten slots, q a packed slice);
               each training backward entry run twice on the same inputs
               gives the same gradients bit for bit; every model width
               (ROADMAP §C.8): rows 1-9 and 11-16 at C 20 / 36 (4 heads of
               5 / 9) and MLP 36 / 100, fp32 and bf16, on their short route
               and past it, against their plain versions, masks bit for
               bit, bit for bit on relaunch; then the training
               entries in shard mode (tensor parallelism, rows 7, 8 and
               11-15 at tp = 2, row 9 whole; first at C 36 / MLP 100, local
               18 / 50), in bf16 at the flagship's
               shapes and in fp32 at a reduced batch: each model rank's
               partial sums and stashes against the plain version on the
               same shard, the sums over the ranks against the unsharded
               kernel, rank 0's local work timed beside the plain shard
               version and its bound (the "tp" item of their entries); at
               full width off the grid, bf16: rows 1-3, 7-9 and 11-15 at a
               fuser C 1,025 (5 heads of 205, MLP 4,100, 4,096 rows of 5
               tokens) and a GPT-2 C 2,045 (5 heads of 409, MLP 8,180, B
               256, T 16) against their plain versions, each timed beside
               the same entry at C 1,024 / 2,048 ("wide_off_grid",
               "wide_aligned" items of their entries);
  5. serve   - the Server on five paths at full width (bf16, batch 256,
               seeded weights): the flagship
               expts/01_SA-Fuser_ek100_val_Swin.txt, its multi-step rollout
               (model.common.fp_output_len=4, the KV cache), and expts 02
               (SA-Fuser without token), 03 (T-SA-Fuser) and 04 (CA-Fuser).
               Each answers 4 requests through the kernels with the expected
               launch counts, and is held against the same model run through
               the plain versions, in bf16 and in fp32 at batch 32; the bf16
               top-1 flips of both paths against the plain path in fp32;
               clips/s, ms per batch and the device time by kernel group
               (torch.profiler). In fp32 the rollout also equals the full
               re-run of every step on the plain path. No path's profile
               may show a kernel the port has deleted (RETIRED);
  6. train   - the flagship training step (expts/01_SA-Fuser_ek100_train.txt,
               Runner.train_step at full width, seeded weights, synthetic
               EK100-shaped batches): three fp32 steps at batch 32 through
               the training kernels against three through their plain
               versions on the same masks; then twenty bf16 steps at batch
               256 over fp32 master weights with the launch counts of every
               step asserted (the fuser blocks' and the GPT-2 layers'
               training entries, 0 of every serving kernel), a falling loss,
               ms per step, clips/s, peak memory and one profiled step,
               which may show no kernel the port has deleted. The
               launch counts of the kernels line are those of the twenty
               bf16 steps alone; the fp32 runs are counted apart.
               draw_masks and draw_masks_gpt2 are launched by no training
               step (the masks are regenerated in registers): their entries
               say so, with 0 launches;
  7. expt 99 - the synthetic smoke expt (expts/99_synth_smoke_{val,train}.txt,
               C 24 with 2 heads of 12, GPT-2 C 32): served, and trained
               three steps, through the kernels in bf16 and fp32 against the
               plain path from the same weights, with the launch counts
               asserted; then again off the 8-column grid (the fuser at C
               25, 5 heads of 5, MLP 100; GPT-2 at C 27, 3 heads of 9, MLP
               108), whose bf16 kernel runs must launch pack_rows
               (off_grid_launches in its entry; the flagship's paths launch
               none);
  8. launcher - the port's own entry point, ``python -m afft_tpu_torch.run
               -c expts/98_synth_accept_train.txt -m train``, as
               subprocesses on a cut-down accept set at full widths
               written by afft_tpu_torch.tools.make_accept_dataset (16
               train and 1 val videos of 128 clips). First the training
               layers at the launcher's own shapes (bf16, batch 64: the
               fuser at 1024 rows of 5 tokens, the GPT-2 layer at (64, 16,
               2048)) against their plain versions; validation runs the
               serving kernels at batch 256, phase 4's shapes. Then one
               epoch, resumed for a second, and two in one run, the
               features in CUDA memory (data_on_device), and one epoch
               from the host loader (data_on_device=false: pinned
               batches; it runs beside the layer checks and the first two
               runs). Each run exits 0, the uninterrupted one with a
               finite loss that falls; checkpoint_best and checkpoint_last
               reload, and their logits through the kernels agree with the
               plain path's; the training entries are launched once per
               layer per iteration and the serving kernels once per layer
               per validation batch (launcher_launches in the kernels
               line); the resumed weights and momentum equal the
               uninterrupted run's bit for bit. Its ms per iteration (the
               epoch's window over its iterations), clips/s (valid clips
               over the window) and host ms per iteration stand beside
               the bare Runner.train_step at the same batch, timed in a
               turn just before and one just after the uninterrupted run;
               whether ml_dtypes imports on the machine;
  9. eval    - the eval CLI on phase 8's checkpoint (full width, bf16, the
               eval set in CUDA memory): ``python -m afft_tpu_torch.run -c
               expts/98_synth_accept_val.txt -m test`` in the accuracies
               mode and with ``+save_name`` (npz where h5py does not
               import); the exported logits against the plain path on the
               same checkpoint (bf16 at 5e-2 of max|logit| with the top-1
               form; the kernels against the plain path in fp32 at 1e-4),
               the accuracies mode against the challenge's numbers from the
               exported file, ``python -m afft_tpu_torch.challenge``
               packaging it, the serving kernels 6 times a batch each
               (eval_launches in the kernels line), clips/s over the eval's
               window (the export's; the accuracies mode and the challenge
               tool run beside the comparisons with the plain path); the
               reference parity tool (``python -m
               afft_tpu_torch.tools.reproduce_reference``) on the same
               checkpoint, as the port's checkpoint and written as a
               reference-layout .pth ({"model": state dict}), each expecting
               the accuracies mode's MT5R within 1e-6 (exit 0, its OK line)
               with 6 launches a batch of each serving kernel
               (reproduce_launches in the kernels line); the flagship
               training check (``python -m afft_tpu_torch.tools.train_check``,
               200 steps at B=64 on 8 synthetic batches, fp32 masters, then
               bf16 masters with --against the fp32 record): a falling loss,
               rows 7-9 and 11-15 launched 6 times a step each and no other
               kernel (rows 10 / 16: 0; train_check_launches in the kernels
               line), ms a step on a shared card, the trace_delta of the two
               runs; the training check starts after the export and the
               bf16 run and both parity runs go on beside phase 10;
 10. dp      - ``-n 1`` through torchrun over NCCL: a cut-set epoch bit for
               bit the one-process run (phase 8's host-loader run); the
               training layers at a data-parallel rank's row offset against
               their plain versions, their masks bit for bit the
               one-process masks of those rows; two processes on the one
               card over gloo (``--device cuda:0``), 32 clips each, against
               one process at 64 over the same global batches of the
               flagship: losses within 2e-2 relative, the training kernels
               launched on each rank, step times logged (one card: no
               multi-GPU number; the two processes run beside the rest);
 11. variants - the variant models at full width: expts 00
               (IndividualFuturePrediction, one GPT-2 predictor) and 05
               (CMFPScoreFusion with MATT, four predictors) served through
               Server.answer at batch 256 bf16 (6 / 24 launches of each
               GPT-2 half and nothing else; logits against the plain path
               as phase 5's); expts 00, 03 (T-SA-Fuser), 04 (CA-Fuser) and
               05 trained at their rates through Runner.train_step: two
               fp32 steps at batch 8 through the kernels against two
               through the plain versions on the same masks (gradients
               within 1e-4 of max|grad| per tensor), the kernels of the
               bf16 steps at their own shapes against their plain versions
               first (the GPT-2 training layer at (64, 10, 2048) with the
               expts' rates; fused_attention and its training route at the
               T-SA and CA attention sites), then ten bf16 steps at
               batch 64 over fp32 masters with every step's launches
               asserted (6 / 24 of each GPT-2 training entry, 0 of every
               other kernel) and a falling loss; 03 and 04 again at
               attention dropout 0, where the fuser's attention runs
               fused_attention under autograd (6 launches a step), then
               timed in turns against the same sites forced onto the plain
               ops under autograd; expt
               05's model through the launcher for one epoch on phase 8's
               cut accept set, then -m test on its checkpoint, which
               reloads with its logits through the kernels against the
               plain path (variants_launches in the kernels line);
 12. serving extras - bundles through the port's own tools
               (afft_tpu_torch.tools.export_serving / serve_bundle): the
               flagship (bf16, dense logits, buckets 8 / 64 / 256, seeded
               weights), its rollout (fp_output_len 4, bucket 256) and the
               flagship with int8 transport and top-5 (8 / 64 / 256), each
               bucket one CUDA graph (afft_tpu_torch.serving.graphs) whose
               replay equals the eager kernel forward at the same padded
               batch bit for bit and holds against the plain path on the
               same (dequantized) features (5e-2 of max|logit| and the
               top-1 form, as phase 4); the launches counted at each
               capture (6 / 6 / 6; 6 fused_block + 24 fused_attention on
               the rollout; serving_graph_launches in the kernels line), a
               profile of one replay of each bucket showing each kernel as
               often as the eager forward's; int8 + top-5 against the
               native bf16
               logits within 5% of max|logit|; per bucket the answer (pinned
               int8 in, top-5 out) and the forward on device features
               (serving_latency at 1 / 8 / 32 / 64 / 256, the rollout and
               expt 00 at 8 / 256, each graph's replay held against the
               plain path too), graph against eager in turns, the device's
               busy share, capture seconds and pool bytes; the concurrent server (serve_concurrent
               BundleServer) in a short --sweep (closed loop at 512 clients,
               open loops at 0.25 / 0.5 / 0.75 of its rate: p50 / p95 / p99,
               batch_hist), every request answered, a malformed request
               failing its batch alone. Then on phase 8's cut set and
               checkpoint: the int8 device cache (half the bf16 payload, the
               gather within half a quantization step plus bf16 rounding of
               the bf16 cache's, all-zero frames 0), ``-m test`` with
               data_on_device_dtype=int8 (exit 0, 6 / 6 / 6 a batch), and
               ``-m visualize_attention`` (exit 0, the JAX entry point's
               dump keys, attention rows summing to 1 within bf16
               rounding; it runs beside the int8 checks);
 13. options - the training options at full width: the flagship
               (expts/01_SA-Fuser_ek100_train.txt, bf16 over fp32 masters,
               B=256) at train.grad_accum 1 / 2 / 4 (the first step with
               mixup off, the expt's dropout on, its gradients per
               parameter within 2e-2 of max|grad| of one pass; then timed
               steps: ms a step, the optimizer step's ms and peak memory,
               every step's launches asserted at 6·M of each training
               entry); bf16 masters with bf16 optimizer state
               (train.master_dtype, opt.optimizer.state_dtype), SGD-nesterov
               and Adam, ten steps with a falling loss, timed beside the fp32
               masters; stochastic_round_bf16 on the card (bit for bit the
               host's, exact values unchanged, unbiased within 1e-3 ulp over
               2^24 draws); the launcher on phase 8's cut set at grad_accum=2
               with bf16 masters, one epoch resumed for a second (bf16
               checkpoint), then -m test on it against the plain path as
               phase 9; ZeRO-1 (train.zero_sharding) against plain data
               parallelism, 3 steps of expt 98, in one process through
               torchrun over NCCL (its reduce-scatter and all-gather) and
               on two processes on the one card over gloo: losses and every
               element of the weights within 1e-5, each rank holding 1/R of
               the optimizer state (options_launches in the kernels line;
               one card: no multi-GPU number; the ZeRO-1 runs beside the
               launcher's);
 14. pipeline - GPipe (train.pipeline_stages) with the stages as gloo
               processes on the one card (--device cuda:0): the GPT-2
               training layers at a stage's global layer index and a
               microbatch's first global row against their plain versions,
               every layer's masks at 2 and 4 microbatches bit for bit the
               one-process masks of those rows; the flagship at full width
               (expts/01_SA-Fuser_ek100_train.txt, bf16 over fp32 masters,
               its dropout, drop-path and mixup) on 2 stages at M 2 and 4,
               64 clips a step, 3 steps, against one unpipelined process
               over the same batches (losses within 2e-2 relative, each
               tensor's weights within 2e-2 of what the one process's
               steps moved that tensor, L/S x M launches of each GPT-2
               training entry a step on each rank, the replicated weights
               alike on both); data2 x pipe2 on four processes (expt 98)
               against one process over the same batches in bf16 (the
               same bounds) and in fp32 (losses within 1e-4, each tensor
               within 1e-3 of its update), and with ZeRO-1 against plain
               data parallelism (losses and weights within 1e-5, each
               rank's optimizer-state bytes); the launcher on
               expts/99_synth_smoke_pipe.txt (-n 2, one epoch and a resumed
               second), -m test in one process on its checkpoint, held
               against the pipelined eval of it (pipeline_launches in the
               kernels line; step times and peak memory per rank are
               one-card stand-ins, no pipeline speed; data2 x pipe2 runs
               beside the flagship's stages, the launcher's two runs
               beside the layer checks and the one-process references);
 15. tp      - tensor and sequence parallelism with the model ranks as gloo
               processes on the one card (--device cuda:0): the flagship at
               full width (expts/01_SA-Fuser_ek100_train.txt, bf16 over fp32
               masters, its dropout, drop-path and mixup) at data1 x model2,
               64 clips a step, 3 steps, against phase 14's one process over
               the same batches (losses within 1e-3 relative, each tensor
               within 2e-2 of its update), each rank's parameter and
               optimizer-state bytes (about half of one process's), peak
               memory, and the launches in shard mode of every training
               entry asserted (tp_launches in the kernels line); beside it
               ``python -m afft_tpu_torch.tools.dryrun_multichip -n 8``:
               every mode of the JAX driver's dry run on 8 processes on the
               card, the 3-axis loss within rtol 1e-3 of one process's (one
               card: no TP speed);
 16. long    - every sequence length the JAX package answers, on the long
               attention route (csrc/long_attention.cuh; past 8 fuser tokens,
               32 GPT-2 tokens, 1,024 keys): (a) the flagship served at a
               64-frame context, B 64 bf16, through serve.Server's served
               function (6 gpt2_attn_half launches a forward on the long
               route; logits against the plain path at 5e-2 of max|logit|
               with the top-1 form; a CUDA graph at bucket 64 replayed bit
               for bit the eager forward); (a') again with the predictor
               in 2 heads of 1,024 (model.common.fp_heads=2: the long
               route's streamed forms); (b) trained at 48 frames: one
               step's gradients against impl="plain" at B 8 (fp32 every
               tensor within 1e-4 of its max|grad|, bf16 every tensor
               within 2e-2, and each bf16 tensor's distances kernel /
               plain fp32, plain bf16 / plain fp32 and kernel / plain bf16
               logged, the table in build/chip_smoke/long_grad_rel.json),
               then 5 bf16 steps at B 64 with falling losses; (b') the
               one-step comparison in 2 heads of 1,024, its kernel steps
               profiled (bf16: the tensor-core long kernels, fp32: the
               CUDA-core ones); (c) its rollout in
               training (T 16, fp_output_len 20: 35 tokens in the last
               pass), 3 bf16 steps at B 32; every step's launches and long
               launches asserted; (d) every long route at full width
               against its plain version (KERNEL_TOL, gradients GRAD_TOL):
               rows 2 and 11-15 at C 2048, T 33 / 64 / 256 / 1,024 (B * T
               4,096 bf16, 512 fp32), rows 11-15 in shard mode at tp = 2, T
               64, rows 1, 7, 9 at C 1024, N 9 / 12 / 16, row 4 at 16
               queries over 1,025 / 2,048 keys, rows 5 and 6 at S 1,280 /
               2,048; past hd 768 rows 1, 2, 5-9, 11-15 at hd 1,024 /
               2,048 and the GPT-2 long attention timed at hd 1,024 /
               2,048; its keep pattern bit for bit the plain generator's
               (hd 48 and 1,024);
               each long attention timed beside its plain version, SDPA and
               its bound (``long_*`` items of its row's entry). The bf16
               forms with rounded probabilities (rows 2, 4, 5, 6, 11, 15)
               are the tensor-core kernels (long_attention_mma and its
               backward): ptxas must report no spill; (a) and (b) are
               profiled and must launch them and no CUDA-core long kernel;
               their edges (hd 12 / 24 / 256 / 512 / 768 / 1,024 / 2,048,
               Nq and Nk 33 / 65 / 1,025 / 2,048, no mask, causal, the
               cache mask with NaN in the unwritten slots; the GPT-2
               backward bit for bit on relaunch, its O the forward's; past
               hd 768 also the CUDA-core forms in fp32 and the fuser's
               chain) agree with the plain versions; each is held to a
               quarter of the CUDA-core route's time at T >= 256 and S >=
               1,280 (``LONG_CUDA_CORE_MS``);
 17. report  - each phase's seconds (phase_seconds), one JSON line of
               per-kernel numbers, then the result line.

Imports torch and afft_tpu_torch only (no JAX).
"""

import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
EXPTS = os.path.join(REPO, "expts")
FLAGSHIP = os.path.join(EXPTS, "01_SA-Fuser_ek100_val_Swin.txt")
ROLLOUT_LEN = 4
SERVE_BATCH = 256
SERVE_REQUESTS = 4
FP32_BATCH = 32

# Published dense peaks of the H100 SXM (NVIDIA data sheet; its device name
# reads "NVIDIA H100 80GB HBM3"): bf16 tensor-core FLOP/s, HBM bytes/s.
PEAKS = {"H100": {"bf16": 989e12, "bytes": 3.35e12}}

# bf16 kernel vs plain: both round the same intermediates (qkv, LN outputs,
# attention output, MLP hidden) to bf16; a different fp32 summation order
# flips some of those roundings by one ulp (2^-8 relative), which the rest
# of the block carries. Bound: 1e-2 of the output's largest magnitude
# (~2.5 ulps there). fp32: only the summation order differs.
KERNEL_TOL = {"bf16": 1e-2, "fp32": 1e-5}
# torch.profiler now and then hands back a trace without its device events,
# at times twice or three times in a row: such a trace is taken again, up to
# this many times in all
PROFILE_ATTEMPTS = 6
# Expt 99, three training steps at the base lr through the kernels vs the
# plain versions on the same masks: the largest loss difference, and per
# tensor the weights' difference over max|w| and over what the steps moved
# them (max|update|; the zero-initialised biases move by about their own
# size, so this is the bound that speaks for every tensor). fp32 as the
# flagship's three steps (summation order only; an H100 reads 0, 4.5e-7,
# 9.8e-6). bf16: the bf16 gradient bound, 2e-2, on weights and updates, and
# 1e-3 on a mean loss that one-ulp rounding flips hardly move (an H100
# reads 2.5e-5, 4.6e-3, 6.3e-3)
EXPT99_TRAIN_TOL = {
    "fp32": {"loss_rel": 1e-4, "weight_rel": 1e-4, "update_rel": 1e-3},
    "bf16": {"loss_rel": 1e-3, "weight_rel": 2e-2, "update_rel": 2e-2}}


def log(*args):
    print(*args, flush=True)


def peaks_for(name):
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    raise RuntimeError(f"no published peaks for {name!r}")


def time_ms(fn, iters=25, warmup=3):
    """Median of per-launch CUDA-event times, after a warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def errors(got, want):
    d = (got.float() - want.float()).abs()
    finite = bool(got.float().isfinite().all())
    max_abs = d.max().item()
    return finite, max_abs, max_abs / max(want.float().abs().max().item(),
                                          1e-30)


# -- inputs and yardsticks for the kernel phase -------------------------------

def _randn(gen, dt):
    import torch

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * std).to(dt)
    return rn


def _norms(p, names, C, rn):
    for norm in names:
        p[f"{norm}.weight"] = 1 + rn(C, std=0.1)
        p[f"{norm}.bias"] = rn(C, std=0.1)


def block_params(C, hidden, dt, gen, affine=True, qkv_bias=False, std=0.02):
    rn = _randn(gen, dt)
    p = {"attn.qkv.weight": rn(3 * C, C, std=std),
         "attn.proj.weight": rn(C, C, std=std),
         "attn.proj.bias": rn(C, std=0.02),
         "mlp.mlp.0.weight": rn(hidden, C, std=std),
         "mlp.mlp.0.bias": rn(hidden, std=0.02),
         "mlp.mlp.2.weight": rn(C, hidden, std=std),
         "mlp.mlp.2.bias": rn(C, std=0.02)}
    if affine:
        _norms(p, ("norm1", "norm2"), C, rn)
    if qkv_bias:
        p["attn.qkv.bias"] = rn(3 * C, std=0.02)
    return p


def decoder_params(C, hidden, dt, gen, affine=True, qkv_bias=False):
    rn = _randn(gen, dt)
    p = block_params(C, hidden, dt, gen, affine=False, qkv_bias=qkv_bias)
    for k in ("w_q", "w_k", "w_v", "proj"):
        p[f"cross_attn.{k}.weight"] = rn(C, C, std=0.02)
        if qkv_bias or k == "proj":
            p[f"cross_attn.{k}.bias"] = rn(C, std=0.02)
    if affine:
        _norms(p, ("norm_self", "norm_q", "norm_kv", "norm_mlp"), C, rn)
    return p


def gpt2_params(C, hidden, dt, gen):
    rn = _randn(gen, dt)
    return {"ln_1.weight": 1 + rn(C, std=0.1), "ln_1.bias": rn(C, std=0.1),
            "attn.c_attn.weight": rn(C, 3 * C, std=0.02),
            "attn.c_attn.bias": rn(3 * C, std=0.02),
            "attn.c_proj.weight": rn(C, C, std=0.02),
            "attn.c_proj.bias": rn(C, std=0.02),
            "ln_2.weight": 1 + rn(C, std=0.1), "ln_2.bias": rn(C, std=0.1),
            "mlp.c_fc.weight": rn(C, hidden, std=0.02),
            "mlp.c_fc.bias": rn(hidden, std=0.02),
            "mlp.c_proj.weight": rn(hidden, C, std=0.02),
            "mlp.c_proj.bias": rn(C, std=0.02)}


def rollout_operands(B, n_new, pos, t_max, H, hd, dt, gen):
    """What the cached GPT-2 block hands the attention: q as a column slice
    of the packed c_attn output, the (B, Tmax, H, hd) caches read whole, and
    the mask that hides the slots after each query's position."""
    import torch
    rn = _randn(gen, dt)
    q = rn(B, n_new, 3, H, hd)[:, :, 0]
    kc, vc = rn(B, t_max, H, hd), rn(B, t_max, H, hd)
    key_pos = torch.arange(t_max, device="cuda")[None, :]
    query_pos = pos + torch.arange(n_new, device="cuda")[:, None]
    mask = torch.zeros((n_new, t_max), device="cuda").masked_fill(
        key_pos > query_pos, float("-inf"))
    return q, kc, vc, mask


def tiled_causal_mask(frames, mods):
    from afft_tpu_torch.models.layers import neg_inf_causal_mask
    return neg_inf_causal_mask(frames, device="cuda").repeat(mods, mods)


def _sdpa(q, k, v, mask):
    """(B, N, H, hd) operands through F.scaled_dot_product_attention."""
    import torch.nn.functional as F
    keep = None if mask is None else mask == 0
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=keep).transpose(1, 2)


def library_block(x, p, H, eps, mask=None):
    """A pre-LN block as cuBLAS GEMMs + SDPA in the working dtype."""
    import torch.nn.functional as F
    R, N, C = x.shape
    h = F.layer_norm(x, (C,), p["norm1.weight"], p["norm1.bias"], eps)
    q, k, v = F.linear(h, p["attn.qkv.weight"]).view(R, N, 3, H,
                                                     C // H).unbind(2)
    y = x + F.linear(_sdpa(q, k, v, mask).reshape(R, N, C),
                     p["attn.proj.weight"], p["attn.proj.bias"])
    h = F.layer_norm(y, (C,), p["norm2.weight"], p["norm2.bias"], eps)
    h = F.gelu(F.linear(h, p["mlp.mlp.0.weight"], p["mlp.mlp.0.bias"]))
    return y + F.linear(h, p["mlp.mlp.2.weight"], p["mlp.mlp.2.bias"])


def library_decoder_block(x, mem, p, H, eps, mask):
    import torch.nn.functional as F
    B, S, C = x.shape

    def ln(t, name):
        return F.layer_norm(t, (C,), p[f"{name}.weight"], p[f"{name}.bias"],
                            eps)

    def heads(t):
        return t.view(B, S, H, C // H)
    q, k, v = F.linear(ln(x, "norm_self"), p["attn.qkv.weight"]).view(
        B, S, 3, H, C // H).unbind(2)
    x = x + F.linear(_sdpa(q, k, v, mask).reshape(B, S, C),
                     p["attn.proj.weight"], p["attn.proj.bias"])
    qn, kn = ln(x, "norm_q"), ln(mem, "norm_kv")
    cross = _sdpa(heads(F.linear(qn, p["cross_attn.w_q.weight"])),
                  heads(F.linear(kn, p["cross_attn.w_k.weight"])),
                  heads(F.linear(kn, p["cross_attn.w_v.weight"])), mask)
    x = x + F.linear(cross.reshape(B, S, C), p["cross_attn.proj.weight"],
                     p["cross_attn.proj.bias"])
    h = F.gelu(F.linear(ln(x, "norm_mlp"), p["mlp.mlp.0.weight"],
                        p["mlp.mlp.0.bias"]))
    return x + F.linear(h, p["mlp.mlp.2.weight"], p["mlp.mlp.2.bias"])


def library_attn_half(x, p, H, eps):
    import torch.nn.functional as F
    B, T, C = x.shape
    h = F.layer_norm(x, (C,), p["ln_1.weight"], p["ln_1.bias"], eps)
    qkv = h @ p["attn.c_attn.weight"] + p["attn.c_attn.bias"]
    q, k, v = qkv.view(B, T, 3, H, C // H).permute(2, 0, 3, 1, 4)
    a = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    return x + (a.transpose(1, 2).reshape(B, T, C) @ p["attn.c_proj.weight"]
                + p["attn.c_proj.bias"])


def library_mlp_half(y, p, eps):
    import torch.nn.functional as F
    C = y.shape[-1]
    h = F.layer_norm(y, (C,), p["ln_2.weight"], p["ln_2.bias"], eps)
    h = F.gelu(h @ p["mlp.c_fc.weight"] + p["mlp.c_fc.bias"],
               approximate="tanh")
    return y + h @ p["mlp.c_proj.weight"] + p["mlp.c_proj.bias"]


def work(name, shape, C, H, hidden, itemsize):
    """(flops, bytes) the function must do and move: each input read once,
    each output written once."""
    if name == "fused_block":
        R, N = shape
        M = R * N
        flops = 2 * M * C * (4 * C + 2 * hidden) + 4 * R * N * N * C
        params = 4 * C * C + 2 * C * hidden + 9 * C + hidden
        return flops, (2 * M * C + params) * itemsize
    B, T = shape
    M = B * T
    if name == "gpt2_attn_half":
        flops = 2 * M * C * 4 * C + 4 * B * T * T * C
        params = 4 * C * C + 6 * C
        return flops, (2 * M * C + params) * itemsize + T * T * 4
    flops = 2 * M * C * 2 * hidden
    params = 2 * C * hidden + hidden + 3 * C
    return flops, (2 * M * C + params) * itemsize


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def attention_work(q, k, v, mask):
    """What this mask needs: the products of the visible (query, key) pairs
    only, and the k / v rows that some query sees."""
    B, n_q, H, hd = q.shape
    visible = mask.isfinite()
    pairs = int(visible.sum())
    keys = int(visible.any(dim=0).sum())
    flops = 4 * B * H * hd * pairs
    item = q.element_size()
    return flops, (2 * B * n_q + 2 * B * keys) * H * hd * item + _nbytes(mask)


def block_work(x, p, mask, macs_per_row, n_attn, streams):
    """A block over x (B, S, C): its GEMMs (``macs_per_row`` multiply-adds a
    row in all), the visible pairs of its ``n_attn`` attention stages, and
    the bytes of its ``streams`` activation tensors (inputs and output), its
    parameters and its mask."""
    B, S, C = x.shape
    pairs = int(mask.isfinite().sum())
    flops = 2 * B * S * macs_per_row + n_attn * 4 * B * C * pairs
    return flops, streams * _nbytes(x) + _nbytes(*p.values(), mask)


# Each case builds its operands for a dtype and a size ("full": the shape of
# the served path at batch 256; "small": the reduced batch for fp32) and
# returns the three callables (kernel, plain, library) and the work.

def case_fused_block(frames, N, dt, size, gen):
    """A per-timestep fuser's block: one row of N tokens a frame."""
    from afft_tpu_torch.ops import fused_block as FB
    R, C, H, hidden, eps = ((256 if size == "full" else 32) * frames, 1024,
                            4, 4096, 1e-6)
    p = block_params(C, hidden, dt, gen)
    x = _randn(gen, dt)(R, N, C)
    return dict(
        shape=tuple(x.shape),
        kernel=lambda: FB.fused_block(x, p, None, num_heads=H, eps=eps),
        plain=lambda: FB.fused_block_plain(x, p, None, num_heads=H, eps=eps),
        library=lambda: library_block(x, p, H, eps),
        work=work("fused_block", (R, N), C, H, hidden, x.element_size()))


def _case_gpt2(half, T, dt, size, gen):
    from afft_tpu_torch.models.layers import neg_inf_causal_mask
    from afft_tpu_torch.ops import fused_gpt2 as FG
    B, C, H, hidden, eps = (256 if size == "full" else 32, 2048, 4, 8192,
                            1e-5)
    p = gpt2_params(C, hidden, dt, gen)
    mask = neg_inf_causal_mask(T, device="cuda")
    x = _randn(gen, dt)(B, T, C)
    if half == "gpt2_attn_half":
        fns = (lambda: FG.gpt2_attn_half(x, p, mask, num_heads=H, eps=eps),
               lambda: FG.gpt2_attn_half_plain(x, p, mask, num_heads=H,
                                               eps=eps),
               lambda: library_attn_half(x, p, H, eps))
    else:
        fns = (lambda: FG.gpt2_mlp_half(x, p, eps=eps),
               lambda: FG.gpt2_mlp_half_plain(x, p, eps=eps),
               lambda: library_mlp_half(x, p, eps))
    return dict(shape=tuple(x.shape), kernel=fns[0], plain=fns[1],
                library=fns[2],
                work=work(half, (B, T), C, H, hidden, x.element_size()))


def _case_attention(n_new, pos, dt, size, gen):
    """The rollout of the flagship, fp_output_len = 4: 16 frames, 19 cache
    slots, 4 heads of 512."""
    from afft_tpu_torch.ops import attention as FA
    B = 256 if size == "full" else 32
    q, kc, vc, mask = rollout_operands(B, n_new, pos, 16 + ROLLOUT_LEN - 1,
                                       4, 512, dt, gen)
    return dict(shape=(tuple(q.shape), tuple(kc.shape)),
                kernel=lambda: FA.fused_attention(q, kc, vc, mask),
                plain=lambda: FA.attention_plain(q, kc, vc, mask)[0],
                library=lambda: _sdpa(q, kc, vc, mask),
                work=attention_work(q, kc, vc, mask))


def case_seq_block(frames, dt, size, gen):
    """4 modalities x frames, C 1024, 4 heads of 256, hidden 4096."""
    from afft_tpu_torch.ops import fused_seq_block as FS
    B, S, C, H, hidden, eps = (256 if size == "full" else 32, 4 * frames,
                               1024, 4, 4096, 1e-6)
    p = block_params(C, hidden, dt, gen)
    mask = tiled_causal_mask(frames, 4)
    x = _randn(gen, dt)(B, S, C)
    return dict(
        shape=tuple(x.shape),
        kernel=lambda: FS.fused_seq_block(x, p, mask, num_heads=H, eps=eps),
        plain=lambda: FS.fused_seq_block_plain(x, p, mask, num_heads=H,
                                               eps=eps),
        library=lambda: library_block(x, p, H, eps, mask),
        work=block_work(x, p, mask, C * (4 * C + 2 * hidden), 1, 2))


def case_decoder_block(dt, size, gen):
    """expt 04: 10 frames, C 1024, 4 heads, hidden 4096."""
    from afft_tpu_torch.models.layers import neg_inf_causal_mask
    from afft_tpu_torch.ops import fused_seq_block as FS
    B, S, C, H, hidden, eps = (256 if size == "full" else 32, 10, 1024, 4,
                               4096, 1e-6)
    p = decoder_params(C, hidden, dt, gen)
    mask = neg_inf_causal_mask(S, device="cuda")
    rn = _randn(gen, dt)
    x, mem = rn(B, S, C), rn(B, S, C)
    return dict(
        shape=tuple(x.shape),
        kernel=lambda: FS.fused_decoder_block(x, mem, p, mask, num_heads=H,
                                              eps=eps),
        plain=lambda: FS.fused_decoder_block_plain(x, mem, p, mask,
                                                   num_heads=H, eps=eps),
        library=lambda: library_decoder_block(x, mem, p, H, eps, mask),
        work=block_work(x, p, mask, C * (8 * C + 2 * hidden), 2, 3))


# name, source, the TPU kernel it replaces, the case. A name with "/" is a
# further shape of the kernel before the slash: the first entry of a kernel
# is the shape of the first served path that runs it, the others are the
# shapes the other served paths give it (and, for fused_seq_block, S = 128
# at full width, 4 x 32 frames); their numbers are reported under the label
# after the slash.
KERNEL_CASES = [
    ("fused_block", "afft_tpu_torch/csrc/fused_block.cu",
     "afft_tpu/ops/pallas_block.py:120",
     lambda *a: case_fused_block(16, 5, *a)),         # flagship, rollout
    ("fused_block/expt02", None, None,
     lambda *a: case_fused_block(10, 4, *a)),         # SA-Fuser w/o token
    ("gpt2_attn_half", "afft_tpu_torch/csrc/fused_gpt2.cu",
     "afft_tpu/ops/pallas_gpt2.py:100",
     lambda *a: _case_gpt2("gpt2_attn_half", 16, *a)),
    ("gpt2_attn_half/t10", None, None,                # expts 02, 03, 04
     lambda *a: _case_gpt2("gpt2_attn_half", 10, *a)),
    ("gpt2_mlp_half", "afft_tpu_torch/csrc/fused_gpt2.cu",
     "afft_tpu/ops/pallas_gpt2.py:140",
     lambda *a: _case_gpt2("gpt2_mlp_half", 16, *a)),
    ("gpt2_mlp_half/t10", None, None,
     lambda *a: _case_gpt2("gpt2_mlp_half", 10, *a)),
    ("fused_attention", "afft_tpu_torch/csrc/attention.cu",
     "afft_tpu/ops/pallas_attn.py:42",
     lambda *a: _case_attention(16, 0, *a)),          # prefill
    ("fused_attention/decode", None, None,
     lambda *a: _case_attention(1, 16, *a)),          # first decode step
    ("fused_seq_block", "afft_tpu_torch/csrc/seq_block.cu",
     "afft_tpu/ops/pallas_seq_block.py:135",
     lambda *a: case_seq_block(10, *a)),              # expt 03, S = 40
    ("fused_seq_block/s128", None, None,
     lambda *a: case_seq_block(32, *a)),              # S = 128, hd = 256
    ("fused_decoder_block", "afft_tpu_torch/csrc/seq_block.cu",
     "afft_tpu/ops/pallas_seq_block.py:156", case_decoder_block),
]


def check_edge_shapes(gen):
    """Each kernel against its plain version at the edges of its limits:
    ragged row and column tiles, K not a multiple of the GEMM's k-tile,
    1 and the most tokens (1,024 keys for the attention and the sequence
    blocks), odd sequence lengths, Nq != Nk, head dims that are not
    multiples of 32 or of 8 (hd 12 and 6, expt 99's C 24), the optional
    LayerNorm affines, biases and mask; and
    the CrossAttention layer, whose attention is the kernel, with a memory
    stream of another length and width."""
    import torch
    from afft_tpu_torch.models.layers import (CrossAttention,
                                              cross_attention_diag_mask,
                                              neg_inf_causal_mask)
    from afft_tpu_torch.ops import (attention as FA, fused_block as FB,
                                    fused_gpt2 as FG, fused_seq_block as FS)

    n = 0
    for tag, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        rn = _randn(gen, dt)
        for R, N, C, H, hidden, diag, affine, qkv_bias in (
                (1, 1, 64, 8, 256, False, True, False),
                (37, 8, 96, 4, 384, True, False, True),
                (130, 3, 40, 5, 72, True, True, True),
                (7, 5, 24, 2, 96, False, True, False),
                (9, 3, 24, 4, 96, True, True, True)):
            p = block_params(C, hidden, dt, gen, affine, qkv_bias)
            mask = cross_attention_diag_mask(N, device="cuda") if diag \
                else None
            x = rn(R, N, C)
            got = FB.fused_block(x, p, mask, num_heads=H)
            want = FB.fused_block_plain(x, p, mask, num_heads=H)
            n += _edge_ok(f"fused_block {tag} R={R} N={N} C={C} H={H} "
                          f"hidden={hidden}", tag, got, want)
        for B, T, C, H, hidden in ((1, 1, 64, 8, 256), (3, 32, 96, 4, 200),
                                   (5, 7, 40, 5, 72), (3, 10, 24, 2, 96),
                                   (2, 7, 24, 4, 96)):
            p = gpt2_params(C, hidden, dt, gen)
            mask = neg_inf_causal_mask(T, device="cuda")
            x = rn(B, T, C)
            n += _edge_ok(f"gpt2_attn_half {tag} B={B} T={T} C={C} H={H}",
                          tag, FG.gpt2_attn_half(x, p, mask, num_heads=H),
                          FG.gpt2_attn_half_plain(x, p, mask, num_heads=H))
            n += _edge_ok(f"gpt2_mlp_half {tag} B={B} T={T} C={C} "
                          f"hidden={hidden}", tag, FG.gpt2_mlp_half(x, p),
                          FG.gpt2_mlp_half_plain(x, p))
        # attention: B, Nq, Nk, H, hd, mask kind; q, k, v strided or not
        for B, n_q, n_k, H, hd, kind in (
                (3, 1, 1, 2, 8, None), (2, 1, 128, 3, 24, "cache"),
                (5, 32, 128, 2, 256, "cache"), (2, 9, 9, 1, 512, "causal"),
                (7, 17, 33, 4, 40, None), (1, 32, 1, 2, 8, None),
                (2, 32, 1024, 2, 64, "cache"),
                (1, 1024, 1024, 2, 16, "causal")):
            if kind == "cache":
                q, k, v, mask = rollout_operands(B, n_q, n_k - n_q - 2, n_k,
                                                 H, hd, dt, gen)
            else:
                q, k, v = rn(B, n_q, H, hd), rn(B, n_k, H, hd), \
                    rn(B, n_k, H, hd)
                mask = neg_inf_causal_mask(n_q, device="cuda") if kind \
                    else None
            n += _edge_ok(f"fused_attention {tag} B={B} Nq={n_q} Nk={n_k} "
                          f"H={H} hd={hd} mask={kind}", tag,
                          FA.fused_attention(q, k, v, mask),
                          FA.attention_plain(q, k, v, mask)[0])
        # the temporal fusers' blocks: B, S (frames x mods), C, H, hidden
        for B, frames, mods, C, H, hidden, affine, qkv_bias in (
                (1, 9, 1, 64, 8, 256, True, False),
                (3, 43, 3, 96, 4, 384, False, True),
                (2, 127, 1, 40, 5, 72, True, True),
                (2, 32, 4, 1024, 4, 512, True, False),
                (1, 1024, 1, 64, 4, 128, True, True),
                (2, 5, 4, 24, 2, 96, True, False),
                (1, 7, 2, 24, 4, 96, False, True)):
            S = frames * mods
            mask = tiled_causal_mask(frames, mods)
            x, mem = rn(B, S, C), rn(B, S, C)
            p = block_params(C, hidden, dt, gen, affine, qkv_bias)
            n += _edge_ok(f"fused_seq_block {tag} B={B} S={S} C={C} H={H} "
                          f"hidden={hidden}", tag,
                          FS.fused_seq_block(x, p, mask, num_heads=H),
                          FS.fused_seq_block_plain(x, p, mask, num_heads=H))
            p = decoder_params(C, hidden, dt, gen, affine, qkv_bias)
            n += _edge_ok(f"fused_decoder_block {tag} B={B} S={S} C={C} "
                          f"H={H} hidden={hidden}", tag,
                          FS.fused_decoder_block(x, mem, p, mask,
                                                 num_heads=H),
                          FS.fused_decoder_block_plain(x, mem, p, mask,
                                                       num_heads=H))
        n += check_fuser_attention_edges(tag, dt, gen)
        n += check_attention_edges(tag, dt, gen)
        # the layer on the card (w_q / w_k / w_v / proj in cuBLAS around
        # fused_attention) against the same layer on the CPU (all plain)
        layer = CrossAttention(64, 4, mem_dim=40, qkv_bias=True)
        layer.reset_parameters(torch.Generator().manual_seed(0))
        x, mem = rn(3, 7, 64), rn(3, 11, 40)
        want = layer.to(dt)(x.cpu(), mem.cpu())
        before = FA.LAUNCHES["fused_attention"]
        got = layer.to("cuda")(x, mem)
        if FA.LAUNCHES["fused_attention"] != before + 1:
            raise AssertionError("CrossAttention did not launch the kernel")
        n += _edge_ok(f"CrossAttention {tag} N=7 M=11 mem_dim=40", tag,
                      got.cpu(), want)
    log(f"kernels: {n} edge-shape checks agree with the plain versions")


def check_fuser_attention_edges(tag, dt, gen):
    """The fuser attention (csrc/fuser_attention.cuh) at the edges of its
    limits, through the blocks that run it: fused_block at N 1 / 5 / 8,
    fused_seq_block at S 1 / 40 / 63 / 64 / 65 / 128 / 300 / 1024 (one,
    two, five and 16 key chunks; query tiles of 16 to 64), each at hd 6 / 12
    / 256 (scalar
    and 16-byte rows) with and without the (tiled) causal mask. The weights
    have std C^-1/2, so the attention's share of the block output is of the
    order of the output itself. Returns the number of checks."""
    from afft_tpu_torch.models.layers import neg_inf_causal_mask
    from afft_tpu_torch.ops import fused_block as FB, fused_seq_block as FS
    rn = _randn(gen, dt)
    n = 0
    for hd, H in ((6, 4), (12, 2), (256, 1)):
        C = hd * H
        for N in (1, 5, 8):
            for masked in (False, True):
                p = block_params(C, 2 * C, dt, gen, std=C ** -0.5)
                mask = neg_inf_causal_mask(N, device="cuda") if masked \
                    else None
                x = rn(37, N, C)
                n += _edge_ok(f"fuser attention (fused_block) {tag} R=37 "
                              f"N={N} hd={hd} H={H} masked={masked}", tag,
                              FB.fused_block(x, p, mask, num_heads=H),
                              FB.fused_block_plain(x, p, mask, num_heads=H))
        for frames, mods in ((1, 1), (10, 4), (21, 3), (16, 4), (13, 5),
                             (32, 4), (75, 4), (256, 4)):
            S = frames * mods
            B = 1 if S > 128 else 3
            for masked in (False, True):
                p = block_params(C, 2 * C, dt, gen, std=C ** -0.5)
                mask = tiled_causal_mask(frames, mods) if masked else None
                x = rn(B, S, C)
                n += _edge_ok(f"fuser attention (fused_seq_block) {tag} "
                              f"B={B} S={S} hd={hd} H={H} masked={masked}",
                              tag, FS.fused_seq_block(x, p, mask, num_heads=H),
                              FS.fused_seq_block_plain(x, p, mask,
                                                       num_heads=H))
    return n


# the attention's edges: queries, keys, head widths
ATTN_EDGE_NQ = (1, 16, 32, 1024)
ATTN_EDGE_NK = (1, 19, 64, 65, 1024)
ATTN_EDGE_HD = (6, 12, 256, 512)


def check_attention_edges(tag, dt, gen):
    """The attention over separate q, k, v (fused_attention: the sequence
    attention of csrc/fuser_attention.cuh) at the edges of its limits: Nq 1 /
    16 / 32 / 1024 against Nk 1 / 19 / 64 / 65 / 1024 (one and two key
    chunks, the rollout's 19 slots, the 1,024-key limit; query tiles of 16,
    32 and 64), each at hd 6 / 12 / 256 / 512 (rows read element by element,
    and as 16-byte copies), q a column slice of a packed qkv and k, v (B,
    Tmax, H, hd) caches, under no mask, the causal mask (query i sees keys
    j <= i) and, where Nq <= Nk, the rollout's cache mask, whose last (up to
    2) unwritten slots hold NaN in the caches the kernel reads and finite
    values in those of the plain version: a masked slot that reached either
    product would make the result NaN. Returns the number of checks."""
    import torch
    from afft_tpu_torch.ops import attention as FA
    rn = _randn(gen, dt)
    n = 0
    for n_q in ATTN_EDGE_NQ:
        for n_k in ATTN_EDGE_NK:
            B, H = (1, 1) if max(n_q, n_k) == 1024 else (2, 2)
            key = torch.arange(n_k, device="cuda")[None, :]
            query = torch.arange(n_q, device="cuda")[:, None]
            zeros = torch.zeros((n_q, n_k), device="cuda")
            kinds = [("none", None, 0),
                     ("causal", zeros.masked_fill(key > query, -math.inf),
                      0)]
            if n_q <= n_k:
                junk = min(2, n_k - n_q)
                pos = n_k - n_q - junk
                kinds.append(("cache", zeros.masked_fill(
                    key > pos + query, -math.inf), junk))
            for hd in ATTN_EDGE_HD:
                q = rn(B, n_q, 3, H, hd)[:, :, 0]
                k, v = rn(B, n_k, H, hd), rn(B, n_k, H, hd)
                for kind, mask, junk in kinds:
                    kc, vc = k, v
                    if junk:
                        kc, vc = k.clone(), v.clone()
                        kc[:, n_k - junk:] = math.nan
                        vc[:, n_k - junk:] = math.nan
                    n += _edge_ok(f"fused_attention {tag} B={B} Nq={n_q} "
                                  f"Nk={n_k} H={H} hd={hd} mask={kind} "
                                  f"(q a packed slice, {junk} NaN slots)",
                                  tag, FA.fused_attention(q, kc, vc, mask),
                                  FA.attention_plain(q, k, v, mask)[0])
    return n


def _edge_ok(what, tag, got, want):
    import torch
    torch.cuda.synchronize()
    finite, max_abs, rel = errors(got, want)
    if not (finite and rel <= KERNEL_TOL[tag]):
        raise AssertionError(f"{what}: max_abs_err={max_abs:.6g} rel_err="
                             f"{rel:.3g} (tol {KERNEL_TOL[tag]:g}) finite="
                             f"{finite}")
    return 1


# -- any model width (ROADMAP §C.8) -------------------------------------------

# The Hopper GEMM at widths off TMA's 16-byte grid: an operand whose rows
# are not a multiple of 8 columns is packed first (pack_rows), an output
# whose rows are not goes through the element-wise epilogue. Its checks: N
# and K (I and J for the TN route) from WIDTH_SET over WIDTH_M rows.
WIDTH_SET = (1, 5, 12, 20, 36, 100, 1025)
WIDTH_M = 133
# (rows, cols) of pack_rows alone: the largest operand the full-width
# off-grid fuser block packs (fc2's input: 4,096 rows of 5 tokens x MLP
# 4,100), and expt 99's fuser fc2 input at C 25 (64 clips x 10 frames x 3
# tokens x MLP 100)
PACK_SHAPES = ((20480, 4100), (1920, 100))
# (C, heads, MLP width) of the entries' checks off the grid: hd 5 and 9
WIDTH_CASES = ((20, 4, 36), (20, 4, 100), (36, 4, 36), (36, 4, 100))
# each entry on its short route and once past its short length: fuser
# tokens, GPT-2 tokens, keys
WIDTH_LENGTHS = {"fuser": (5, 12), "gpt2": (16, 40), "keys": (40, 1100)}
# the full-width off-grid layers beside the aligned ones, (C, heads, MLP):
# one fuser block over 4,096 rows of 5 tokens, one GPT-2 layer at (256, 16)
WIDE_FUSER = {"off": (1025, 5, 4100), "aligned": (1024, 4, 4096)}
WIDE_GPT2 = {"off": (2045, 5, 8180), "aligned": (2048, 4, 8192)}
WIDE_ROWS, WIDE_BATCH = (4096, 5), (256, 16)
# expt 99 with both layers off the grid: the fuser at C 25 (5 heads of 5,
# MLP 100), GPT-2 at C 27 (3 heads of 9, MLP 108)
EXPT99_OFF_GRID = ("model.common_dim=25", "model.fuser.num_heads=5",
                   "model.common.fp_inter_dim=27", "model.common.fp_heads=3")


def _check_gemm_widths(G, gen):
    """Every epilogue of both weight layouts (the (K, N) route's six and its
    fp32 out, the (N, K) route's ten forms and its in-place cross proj) and
    the TN route in 1, 2 and 3 slices of M, at every (N, K) of WIDTH_SET
    (the TN route's (I, J)) over WIDTH_M rows: against the fp32 product at
    the gemm phase's tolerances, masks bit for bit, each bit for bit on a
    second launch. Returns (checks, worst rel_err, pack_rows launches)."""
    import itertools
    import torch
    from afft_tpu_torch.ops import launch_counts
    before = launch_counts()["pack_rows"]
    n, worst = 0, 0.0
    M = WIDTH_M
    for N, K in itertools.product(WIDTH_SET, WIDTH_SET):
        rels = [_check_gemm(G, M, N, K, epi, gen)[0]
                for epi in G.ROUTE_EPILOGUES[True]]
        rels.append(_check_gemm(G, M, N, K, "bias", gen, torch.float32)[0])
        rels += [_check_gemm_nk(G, M, N, K, epi, variant, gen)
                 for epi, variant in NK_VARIANTS]
        rels.append(_check_gemm_nk_inplace(G, M, N, K, gen))
        rels += [_check_tn_split(G, M, N, K, slices, gen)
                 for slices in (1, 2, 3)]
        n += len(rels)
        worst = max(worst, *rels)
    packs = launch_counts()["pack_rows"] - before
    if not packs:
        raise AssertionError("gemm widths: no operand was packed")
    log(f"gemm widths: {n} checks at N, K (I, J) in {WIDTH_SET} over M "
        f"{M} (both weight layouts, every epilogue, the TN route in 1 / 2 / "
        f"3 slices) agree with the fp32 product (worst rel_err {worst:.3g}), "
        f"bit for bit on relaunch; {packs} pack_rows launches")
    return n, worst, packs


def _pack_rows_numbers(G, peaks, gen):
    """pack_rows alone at PACK_SHAPES: bit for bit its plain version (a
    copy into the padded rows) and on relaunch, timed beside it and F.pad
    (one PyTorch call to the same rows), and its bound (each element read
    and written once). Returns {label: numbers}, the first shape's at the
    top."""
    import torch
    import torch.nn.functional as F
    from afft_tpu_torch.ops._common import pad8
    out = {}
    rn = _randn(gen, torch.bfloat16)
    for rows, cols in PACK_SHAPES:
        x, ld = rn(rows, cols), pad8(cols)
        got, again = G.pack_rows(x), G.pack_rows(x)
        want = G.pack_rows_plain(x)
        torch.cuda.synchronize()
        if not (got.stride() == (ld, 1) and torch.equal(got, want)
                and torch.equal(got, again)):
            raise AssertionError(f"pack_rows ({rows}, {cols}): differs from "
                                 "its plain version or on relaunch")
        ms = time_ms(lambda: G.pack_rows(x))
        plain_ms = time_ms(lambda: G.pack_rows_plain(x))
        library_ms = time_ms(lambda: F.pad(x, (0, ld - cols)))
        nbytes = rows * (cols + ld) * x.element_size()
        numbers = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                       library_ms=library_ms,
                       bound_ms=nbytes / peaks["bytes"] * 1e3,
                       bound_by="bytes", bytes=nbytes, shape=(rows, cols),
                       ld=ld)
        log(f"kernel pack_rows bf16 ({rows}, {cols}) -> ld {ld}: kernel_ms="
            f"{ms:.4f} plain_ms={plain_ms:.4f} library_ms (F.pad)="
            f"{library_ms:.4f} bound_ms={numbers['bound_ms']:.4f} (bytes: "
            f"{nbytes / 1e6:.1f} MB) achieved {nbytes / ms / 1e6:.1f} GB/s; "
            "bit for bit its plain version")
        out[f"{rows}x{cols}"] = numbers
    return out


def _same_twice(what, run):
    """``run()`` twice gives the same tensors bit for bit."""
    import torch
    first, second = run(), run()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError(f"{what}: two launches differ")


def check_width_entries(gen):
    """Rows 1-6 at every WIDTH_CASES width, in fp32 and bf16, on their
    short route and once past it (WIDTH_LENGTHS), against their plain
    versions (KERNEL_TOL), each bit for bit on a second launch. Returns the
    number of checks."""
    import torch
    from afft_tpu_torch.models.layers import (cross_attention_diag_mask,
                                              neg_inf_causal_mask)
    from afft_tpu_torch.ops import (attention as FA, fused_block as FB,
                                    fused_gpt2 as FG, fused_seq_block as FS)
    n = 0

    def hold(what, tag, kernel, plain):
        _same_twice(what, lambda: [kernel()])
        return _edge_ok(what, tag, kernel(), plain())

    for tag, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        rn = _randn(gen, dt)
        for C, H, hidden in WIDTH_CASES:
            label = f"{tag} C={C} H={H} hidden={hidden}"
            p = block_params(C, hidden, dt, gen, True, True)
            for N in WIDTH_LENGTHS["fuser"]:
                x, mask = rn(37, N, C), cross_attention_diag_mask(
                    N, device="cuda")
                n += hold(f"fused_block {label} N={N}", tag,
                          lambda: FB.fused_block(x, p, mask, num_heads=H),
                          lambda: FB.fused_block_plain(x, p, mask,
                                                       num_heads=H))
            g = gpt2_params(C, hidden, dt, gen)
            for T in WIDTH_LENGTHS["gpt2"]:
                x, mask = rn(5, T, C), neg_inf_causal_mask(T, device="cuda")
                n += hold(f"gpt2_attn_half {label} T={T}", tag,
                          lambda: FG.gpt2_attn_half(x, g, mask, num_heads=H),
                          lambda: FG.gpt2_attn_half_plain(x, g, mask,
                                                          num_heads=H))
                n += hold(f"gpt2_mlp_half {label} T={T}", tag,
                          lambda: FG.gpt2_mlp_half(x, g),
                          lambda: FG.gpt2_mlp_half_plain(x, g))
            d = decoder_params(C, hidden, dt, gen, True, True)
            hd = C // H
            for S in WIDTH_LENGTHS["keys"]:
                x, mem = rn(2, S, C), rn(2, S, C)
                mask = tiled_causal_mask(S, 1)
                n += hold(f"fused_seq_block {label} S={S}", tag,
                          lambda: FS.fused_seq_block(x, p, mask, num_heads=H),
                          lambda: FS.fused_seq_block_plain(x, p, mask,
                                                           num_heads=H))
                n += hold(f"fused_decoder_block {label} S={S}", tag,
                          lambda: FS.fused_decoder_block(x, mem, d, mask,
                                                         num_heads=H),
                          lambda: FS.fused_decoder_block_plain(
                              x, mem, d, mask, num_heads=H))
                q, k, v = (rn(2, n_, H, hd) for n_ in (16, S, S))
                n += hold(f"fused_attention {label} Nq=16 Nk={S}", tag,
                          lambda: FA.fused_attention(q, k, v, None),
                          lambda: FA.attention_plain(q, k, v, None)[0])
    log(f"kernels widths: {n} checks of rows 1-6 at (C, H, hidden) in "
        f"{WIDTH_CASES}, fp32 and bf16, short and long routes, agree with "
        "the plain versions, each bit for bit on relaunch")
    return n


def _train_grads(fn, x, p, dout):
    """The output, dx and every parameter gradient of one forward and
    backward of ``fn(x, p)`` from fresh leaves."""
    xk = x.detach().clone().requires_grad_(True)
    pk = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    out = fn(xk, pk)
    out.backward(dout)
    return [out.detach(), xk.grad] + [pk[k].grad for k in sorted(pk)]


def check_width_train(gen):
    """Rows 7-10 and 11-16 at every WIDTH_CASES width, in fp32 and bf16, on
    the short route and once past it: the masks bit for bit the plain
    generator's, the forward against the plain version on those masks, dx
    and every gradient against fp32 autograd (check_train_block,
    check_gpt2_train_layer), then forward and backward again bit for bit.
    Returns the number of checks."""
    import torch
    from afft_tpu_torch.models.layers import neg_inf_causal_mask
    from afft_tpu_torch.ops import fused_block_train as FT
    from afft_tpu_torch.ops import fused_gpt2_train as FGT
    n = 0
    for tag, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        for C, H, hidden in WIDTH_CASES:
            for N in WIDTH_LENGTHS["fuser"]:
                case = check_train_block(tag, dt, 37, N, C, H, hidden, gen)
                _same_twice(case["what"], lambda: _train_grads(
                    lambda x, p: FT.fused_block_train(
                        x, p, None, TRAIN_SEEDS, num_heads=H, block_idx=5,
                        **TRAIN_RATES), case["x"], case["p"], case["dout"]))
                n += 1
            for T in WIDTH_LENGTHS["gpt2"]:
                case = check_gpt2_train_layer(tag, dt, 5, T, C, H, hidden,
                                              gen)
                mask = neg_inf_causal_mask(T, device="cuda")
                _same_twice(case["what"], lambda: _train_grads(
                    lambda x, p: FGT.fused_gpt2_block_train(
                        x, p, mask, TRAIN_SEEDS, num_heads=H, layer_idx=3,
                        **GPT2_RATES), case["x"], case["p"], case["dout"]))
                n += 1
    log(f"kernels widths: {n} checks of rows 7-10 and 11-16 at (C, H, "
        f"hidden) in {WIDTH_CASES}, fp32 and bf16, short and long routes: "
        "masks bit for bit, forward, dx and gradients within their "
        "tolerances, bit for bit on relaunch")
    return n


def _time_train_entries(fn, x, p, dout):
    """The three training entries of one layer, timed alone (CUDA events,
    time_ms) on the forward's own stashes."""
    import torch
    from afft_tpu_torch.ops import fused_block_train as FT
    R, N, C = x.shape
    dflat = dout.reshape(R * N, C)
    out = fn(x.detach().clone().requires_grad_(True),
             {k: v.detach().clone().requires_grad_(True)
              for k, v in p.items()})
    saved = out.grad_fn.saved_tensors
    y, qkv, pre1, mask32 = saved[1:5]
    tensors, cfg = list(saved[5:]), out.grad_fn.cfg
    grads = FT.new_grads(tensors)
    dy = FT.block_train_bwd_mlp(x, y, dflat, pre1, tensors, grads, cfg)
    with torch.no_grad():
        ms = {"fwd": time_ms(lambda: fn(x, p)),
              "bwd_mlp": time_ms(lambda: FT.block_train_bwd_mlp(
                  x, y, dflat, pre1, tensors, grads, cfg)),
              "bwd_attn": time_ms(lambda: FT.block_train_bwd_attn(
                  x, dy, qkv, mask32, tensors, grads, cfg))}
    del out, saved, y, qkv, pre1, dy, grads
    return ms


def check_full_width_off_grid(gen):
    """At full width off the grid, in bf16: one fuser block at C 1,025 (5
    heads of 205, MLP 4,100) over 4,096 rows of 5 tokens and one GPT-2
    layer at C 2,045 (5 heads of 409, MLP 8,180) at (256, 16): the serving
    rows 1-3 against their plain versions, the training rows 7-9 and 11-15
    (masks, forward, gradients) as the kernel phase holds them; each entry
    timed (CUDA events) beside the same entry at C 1,024 / 2,048 in this
    call (no floor), the serving rows profiled by kernel group (where the
    off-grid time goes: pack_rows, the products, the attention). Returns
    {entry: {"off": ..., "aligned": ...}}."""
    import torch
    from afft_tpu_torch.models.layers import neg_inf_causal_mask
    from afft_tpu_torch.ops import fused_block as FB
    from afft_tpu_torch.ops import fused_block_train as FT
    from afft_tpu_torch.ops import fused_gpt2 as FG
    from afft_tpu_torch.ops import fused_gpt2_train as FGT
    dt = torch.bfloat16
    rn = _randn(gen, dt)
    out = {}

    def put(name, key, **numbers):
        out.setdefault(name, {})[key] = numbers

    R, N = WIDE_ROWS
    B, T = WIDE_BATCH
    mask = neg_inf_causal_mask(T, device="cuda")
    for key in ("off", "aligned"):
        C, H, hidden = WIDE_FUSER[key]
        p, x = block_params(C, hidden, dt, gen), rn(R, N, C)
        with torch.no_grad():
            got = FB.fused_block(x, p, num_heads=H)
            torch.cuda.synchronize()
            finite, max_abs, rel = errors(got, FB.fused_block_plain(
                x, p, num_heads=H))
            if not (finite and rel <= KERNEL_TOL["bf16"]):
                raise AssertionError(f"fused_block bf16 C={C}: rel_err="
                                     f"{rel:.3g}")
            put("fused_block", key, shape=(R, N, C), hidden=hidden,
                max_abs_err=max_abs,
                ms=time_ms(lambda: FB.fused_block(x, p, num_heads=H)),
                profile_ms=profile_forward(
                    lambda: FB.fused_block(x, p, num_heads=H),
                    f"fused_block bf16 C {C}")["groups_ms"])
        del got
        case = check_train_block("bf16", dt, R, N, C, H, hidden, gen)
        _log_case(case, "bf16")
        ms = _time_train_entries(
            lambda x, p: FT.fused_block_train(x, p, None, TRAIN_SEEDS,
                                              num_heads=H, block_idx=5,
                                              **TRAIN_RATES),
            case["x"], case["p"], case["dout"])
        for entry, t in ms.items():
            put(f"fused_block_train_{entry}", key, shape=(R, N, C),
                hidden=hidden, max_abs_err=case["errs"][entry], ms=t)
        del case, p, x
        torch.cuda.empty_cache()

        C, H, hidden = WIDE_GPT2[key]
        g, x = gpt2_params(C, hidden, dt, gen), rn(B, T, C)
        with torch.no_grad():
            for name, kernel, plain in (
                    ("gpt2_attn_half",
                     lambda: FG.gpt2_attn_half(x, g, mask, num_heads=H),
                     lambda: FG.gpt2_attn_half_plain(x, g, mask,
                                                     num_heads=H)),
                    ("gpt2_mlp_half", lambda: FG.gpt2_mlp_half(x, g),
                     lambda: FG.gpt2_mlp_half_plain(x, g))):
                got = kernel()
                torch.cuda.synchronize()
                finite, max_abs, rel = errors(got, plain())
                if not (finite and rel <= KERNEL_TOL["bf16"]):
                    raise AssertionError(f"{name} bf16 C={C}: rel_err="
                                         f"{rel:.3g}")
                put(name, key, shape=(B, T, C), hidden=hidden,
                    max_abs_err=max_abs, ms=time_ms(kernel),
                    profile_ms=profile_forward(
                        kernel, f"{name} bf16 C {C}")["groups_ms"])
        case = check_gpt2_train_layer("bf16", dt, B, T, C, H, hidden, gen)
        _log_case(case, "bf16")
        ms = _time_train_entries(
            lambda x, p: FGT.fused_gpt2_block_train(
                x, p, mask, TRAIN_SEEDS, num_heads=H, layer_idx=3,
                **GPT2_RATES), case["x"], case["p"], case["dout"])
        for entry, t in ms.items():
            put(f"fused_gpt2_train_{entry}", key, shape=(B, T, C),
                hidden=hidden, max_abs_err=case["errs"][entry], ms=t)
        del case, g, x
        torch.cuda.empty_cache()
    for name, pair in out.items():
        pair["off_over_aligned"] = pair["off"]["ms"] / pair["aligned"]["ms"]
        log(f"kernel {name} bf16 off the grid {pair['off']['shape']} hidden "
            f"{pair['off']['hidden']}: {pair['off']['ms']:.4f} ms beside "
            f"{pair['aligned']['ms']:.4f} ms at {pair['aligned']['shape']} "
            f"hidden {pair['aligned']['hidden']} "
            f"({pair['off_over_aligned']:.3f}x)")
    return out


# -- the training kernels (fused_block_train forward, two backward halves,
#    draw_masks) --------------------------------------------------------------

# The flagship trains with dropout 0.1 at the three fuser sites and drop-path
# 0.1, which the last block of the stack gets in full (a linear schedule).
TRAIN_RATES = dict(attn_rate=0.1, drop_rate=0.1, dp_rate=0.1)
TRAIN_SEEDS = (20240607, 1234567)
# Gradients against fp32 autograd through the plain version on the same
# masks, per tensor, as a share of the reference's largest magnitude. bf16:
# the kernels round dh2, dpre1, dproj and dqkv and take the GELU from the
# rounded pre1, as the TPU kernels do (each one bf16 ulp, 2^-8), and the
# parameter gradients sum 20,480 such rows in fp32: 2e-2 covers a few ulps of
# the largest entry. fp32: only the summation order differs, over up to 4,096
# terms a product and 2,560 rows a gradient: 1e-4.
GRAD_TOL = {"bf16": 2e-2, "fp32": 1e-4}
GRAD_KEYS_MLP = ("norm2.weight", "norm2.bias", "mlp.mlp.0.weight",
                 "mlp.mlp.0.bias", "mlp.mlp.2.weight", "mlp.mlp.2.bias")
# The GPT-2 layers train with attn_pdrop and resid_pdrop 0.1 (the expt's).
GPT2_RATES = dict(attn_rate=0.1, resid_rate=0.1)
GPT2_GRAD_KEYS_MLP = ("ln_2.weight", "ln_2.bias", "mlp.c_fc.weight",
                      "mlp.c_fc.bias", "mlp.c_proj.weight", "mlp.c_proj.bias")


def _rel_err(got, want):
    finite, max_abs, rel = errors(got, want)
    if not finite:
        return float("inf"), max_abs
    return rel, max_abs


def _check_masks(what, masks, plain_masks, rates):
    """A mask kernel's output against the generator in torch integer ops,
    bit for bit, and each mask's keep share within 4 binomial sigmas."""
    import torch
    torch.cuda.synchronize()
    for site, (got, want) in enumerate(zip(masks, plain_masks)):
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: mask {site} differs from the "
                                 "plain generator's")
    for got, rate in zip(masks, rates):
        n, kept = got.numel(), float((got > 0).float().mean())
        sigma = (rate * (1 - rate) / n) ** 0.5
        if abs(kept - (1 - rate)) > 4 * sigma + 1e-12:
            raise AssertionError(f"{what}: keep fraction {kept} of {n}, "
                                 f"expected {1 - rate} +- {4 * sigma:.3g}")


def _check_train_layer(what, tag, x, p, dout, masks, mlp_keys, kernel, plain):
    """A training layer's forward entry (out and the stashed y, qkv, pre1)
    against its plain version on the same masks, and its two backward
    entries (dx and every parameter gradient) against fp32 autograd through
    the plain version. ``kernel(x, p)`` runs the wrapper, ``plain(x, p,
    **kw)`` the plain version. Returns the operands and the largest absolute
    errors by entry."""
    import torch
    xk = x.clone().requires_grad_(True)
    pk = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    out = kernel(xk, pk)
    torch.cuda.synchronize()
    y, qkv, pre1 = out.grad_fn.saved_tensors[1:4]
    with torch.no_grad():
        want = plain(x, p, return_residuals=True)
    errs = {"fwd": 0.0, "bwd_mlp": 0.0, "bwd_attn": 0.0}
    for name, got, ref in zip(("out", "y", "qkv", "pre1"),
                              (out, y, qkv, pre1), want):
        rel, max_abs = _rel_err(got.reshape(ref.shape), ref)
        errs["fwd"] = max(errs["fwd"], max_abs)
        if not rel <= KERNEL_TOL[tag]:
            raise AssertionError(f"{what}: forward {name} rel_err={rel:.3g} "
                                 f"(tol {KERNEL_TOL[tag]:g})")
    del want

    out.backward(dout)
    torch.cuda.synchronize()
    x32 = x.float().requires_grad_(True)
    p32 = {k: v.float().requires_grad_(True) for k, v in p.items()}
    ref = plain(x32, p32)
    ref.backward(dout.float())
    torch.cuda.synchronize()
    worst = ("", 0.0)
    for name, got, want in [("dx", xk.grad, x32.grad)] + [
            (k, pk[k].grad, p32[k].grad) for k in p]:
        if got is None:
            raise AssertionError(f"{what}: no gradient for {name}")
        rel, max_abs = _rel_err(got, want)
        half = "bwd_mlp" if name in mlp_keys else "bwd_attn"
        errs[half] = max(errs[half], max_abs)
        if rel > worst[1]:
            worst = (name, rel)
        if not rel <= GRAD_TOL[tag]:
            raise AssertionError(f"{what}: gradient {name} rel_err={rel:.3g} "
                                 f"(tol {GRAD_TOL[tag]:g} of max|ref|)")
    return dict(x=x, p=p, dout=dout, masks=masks, errs=errs, worst=worst,
                what=what)


def check_train_block(tag, dt, R, N, C, H, hidden, gen, *, rates=None,
                      affine=True, qkv_bias=False, diag_mask=False,
                      block_idx=5, row0=0):
    """One shape of the training block on the card: kernel 10 against
    draw_masks_plain bit for bit, kernel 7's out / y / qkv / pre1 against the
    plain version on those masks, kernels 8 + 9's dx and parameter gradients
    against fp32 autograd through the plain version. ``row0``: the rows are
    those of a data-parallel rank from the global batch's row0 on."""
    from afft_tpu_torch.models.layers import cross_attention_diag_mask
    from afft_tpu_torch.ops import fused_block_train as FT

    rates = TRAIN_RATES if rates is None else rates
    what = (f"fused_block_train {tag} R={R} N={N} C={C} H={H} hidden={hidden} "
            f"rates={tuple(rates.values())} affine={affine} qkv_bias="
            f"{qkv_bias} mask={diag_mask}" + (f" row0={row0}" if row0 else ""))
    p = block_params(C, hidden, dt, gen, affine, qkv_bias)
    rn = _randn(gen, dt)
    x, dout = rn(R, N, C), rn(R, N, C)
    mask = cross_attention_diag_mask(N, device="cuda") if diag_mask else None
    args = (R, N, C, H, TRAIN_SEEDS, block_idx, *rates.values())
    masks = FT.draw_masks(*args, device="cuda", row0=row0)
    _check_masks(what, masks, FT.draw_masks_plain(*args, device="cuda",
                                                  row0=row0),
                 [rates[k] for k in ("attn_rate", "drop_rate", "dp_rate",
                                     "drop_rate", "dp_rate")])
    return _check_train_layer(
        what, tag, x, p, dout, masks, GRAD_KEYS_MLP,
        lambda x, p: FT.fused_block_train(x, p, mask, TRAIN_SEEDS,
                                          num_heads=H, block_idx=block_idx,
                                          row0=row0, **rates),
        lambda x, p, **kw: FT.fused_block_train_plain(x, p, mask, masks,
                                                      num_heads=H, **kw))


def check_gpt2_train_layer(tag, dt, B, T, C, H, hidden, gen, *, rates=None,
                           layer_idx=3, row0=0):
    """One shape of the GPT-2 training layer on the card: row 16
    (draw_masks_gpt2) against draw_masks_gpt2_plain bit for bit, the forward
    entry (rows 11 + 12) against the plain version on those masks, the MLP
    (rows 13 + 14) and attention (row 15) backward entries' dx and parameter
    gradients against fp32 autograd through the plain version."""
    from afft_tpu_torch.models.layers import neg_inf_causal_mask
    from afft_tpu_torch.ops import fused_gpt2_train as FGT

    rates = GPT2_RATES if rates is None else rates
    what = (f"fused_gpt2_train {tag} B={B} T={T} C={C} H={H} hidden={hidden} "
            f"rates={tuple(rates.values())}" + (f" row0={row0}" if row0
                                                else ""))
    p = gpt2_params(C, hidden, dt, gen)
    rn = _randn(gen, dt)
    x, dout = rn(B, T, C), rn(B, T, C)
    mask = neg_inf_causal_mask(T, device="cuda")
    args = (B, T, C, H, TRAIN_SEEDS, layer_idx, *rates.values())
    masks = FGT.draw_masks_gpt2(*args, device="cuda", row0=row0)
    _check_masks(what, masks, FGT.draw_masks_gpt2_plain(*args, device="cuda",
                                                        row0=row0),
                 [rates["attn_rate"], rates["resid_rate"],
                  rates["resid_rate"]])
    return _check_train_layer(
        what, tag, x, p, dout, masks, GPT2_GRAD_KEYS_MLP,
        lambda x, p: FGT.fused_gpt2_block_train(
            x, p, mask, TRAIN_SEEDS, num_heads=H, layer_idx=layer_idx,
            row0=row0, **rates),
        lambda x, p, **kw: FGT.fused_gpt2_block_train_plain(
            x, p, mask, masks, num_heads=H, **kw))


# -- the drop passes: rows 10 and 16's mask kernel and drop_grad, on the one
#    Philox draw of csrc/common.cuh --------------------------------------------

# row0 values that put the fuser's / GPT-2 layer's proj and MLP indices past
# 2^32 (their per-row elements N * C: 5,120 / 32,768), the first of each
# pair with its range across a 2^32 boundary
MASK_ROW0 = {"fuser": (838860, 2 ** 31 - 1), "gpt2": (131071, 2 ** 31 - 1)}
MASK_EDGE_RATES = (0.0, 0.5, 0.999)
# the numbers of the drop passes (check_drop_grad), logged with their
# integer bounds once the library's SASS is read (drop_pass_bounds)
DROP_PASSES = {}


def check_mask_edges():
    """Rows 10 and 16's mask kernel (draw_masks, draw_masks_gpt2, and
    draw_site_mask on the same kernel) against the plain generator bit for
    bit at its edges: indices past 2^32 (row0 from MASK_ROW0) and a range
    across a 2^32 boundary; the tensor-parallel span / gap remap of the
    attention site at tp = 2 (each rank's mask equal to the whole mask's
    heads, kernel and plain); ragged sizes (no multiple of the 4-element
    vector, below one block); rates 0 and 0.999."""
    import torch
    from afft_tpu_torch.ops import fused_block_train as FT
    from afft_tpu_torch.ops import fused_gpt2_train as FGT
    n = 0

    def fuser(R, N, C, H, rate, row0=0, block=5):
        args = (R, N, C, H, TRAIN_SEEDS, block, rate, rate, rate)
        _check_masks(f"draw_masks edge R={R} N={N} C={C} H={H} rate={rate} "
                     f"row0={row0}", FT.draw_masks(*args, row0=row0),
                     FT.draw_masks_plain(*args, device="cuda", row0=row0),
                     [rate] * 5)

    def gpt2(B, T, C, H, rate, row0=0, layer=3):
        args = (B, T, C, H, TRAIN_SEEDS, layer, rate, rate)
        _check_masks(f"draw_masks_gpt2 edge B={B} T={T} C={C} H={H} rate="
                     f"{rate} row0={row0}", FGT.draw_masks_gpt2(
                         *args, row0=row0), FGT.draw_masks_gpt2_plain(
                         *args, device="cuda", row0=row0), [rate] * 3)

    for row0 in MASK_ROW0["fuser"]:
        fuser(8, 5, 1024, 4, 0.1, row0)
        n += 1
    for row0 in MASK_ROW0["gpt2"]:
        gpt2(4, 16, 2048, 4, 0.1, row0)
        n += 1
    for rate in MASK_EDGE_RATES:
        for shape in ((1, 1, 3, 1), (3, 7, 13, 1), (1001, 5, 1023, 3)):
            fuser(*shape, rate)
            gpt2(*shape, rate)
            n += 2
    # the remap: rank r of 2 holds heads r * H .. of the layer's 2 H
    for label, (R, N, C, H), whole in (
            ("fuser", (256, 5, 1024, 4), lambda row0: FT.draw_masks(
                256, 5, 1024, 4, TRAIN_SEEDS, 5, 0.1, 0.1, 0.1,
                row0=row0)[0]),
            ("gpt2", (256, 16, 2048, 4), lambda row0: FGT.draw_masks_gpt2(
                256, 16, 2048, 4, TRAIN_SEEDS, 3, 0.1, 0.1, row0=row0)[0])):
        block = 5 if label == "fuser" else 3
        local, nn = H // TP, N * N
        thr, inv = (v[0] for v in FT.rates_operands(0.1, 0.1, 0.1))
        for row0 in (0, MASK_ROW0[label][1]):
            full = whole(row0)
            for rank in range(TP):
                kw = dict(offset=row0 * H * nn + rank * local * nn,
                          span=local * nn, gap=(H - local) * nn)
                got = FT.draw_site_mask(R * local * nn, TRAIN_SEEDS, block,
                                        0, 0.1, **kw)
                plain = FT.site_mask_plain(R * local * nn, TRAIN_SEEDS,
                                           block, 0, thr, inv,
                                           device="cuda", **kw)
                want = full[:, rank * local:(rank + 1) * local].reshape(-1)
                if not (torch.equal(got, want) and torch.equal(plain, want)):
                    raise AssertionError(
                        f"draw_site_mask {label} tp={TP} rank {rank} row0="
                        f"{row0}: the remapped mask differs from the whole "
                        "mask's heads")
                n += 1
    log(f"kernels: {n} mask-kernel edge checks bit for bit (indices past "
        "2^32, the tp = 2 remap, ragged sizes, rates 0 / 0.5 / 0.999)")
    return n


# (label, R, N, C, drop_rate, dp_rate): the drop pass at both layers'
# flagship shapes and off the vector grid (C 1,025 / 2,045: the scalar
# route), at the training rates (the GPT-2 layer has no drop-path)
DROP_GRAD_SHAPES = (("fuser", 4096, 5, 1024, 0.1, 0.1),
                    ("gpt2", 256, 16, 2048, 0.1, 0.0),
                    ("fuser off-grid", 4096, 5, 1025, 0.1, 0.1),
                    ("gpt2 off-grid", 256, 16, 2045, 0.1, 0.0))


def check_drop_grad(peaks, gen):
    """The backward entries' drop pass alone (FT.drop_grad) against
    drop_grad_plain, d x row multiplier x element multiplier rounded to
    the dtype, bit for bit: DROP_GRAD_SHAPES in bf16 and fp32, both
    branches, row0 0 and one past 2^32 (across a 2^32 boundary for the
    fuser); timed in bf16 at each shape beside the plain version and the
    bytes' bound (the draw's integer bound joins it from the SASS:
    drop_pass_bounds). Fills DROP_PASSES."""
    import torch
    from afft_tpu_torch.ops import fused_block_train as FT
    n = 0
    for label, R, N, C, drop, dp in DROP_GRAD_SHAPES:
        layer = label.split()[0]
        for tag, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
            d = _randn(gen, dt)(R, N, C)
            for branch in ("attn", "mlp"):
                for row0 in (0, MASK_ROW0[layer][0]):
                    kw = dict(branch=branch, row0=row0)
                    got = FT.drop_grad(d, TRAIN_SEEDS, 5, drop, dp, **kw)
                    want = FT.drop_grad_plain(d, TRAIN_SEEDS, 5, drop, dp,
                                              **kw)
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"drop_grad {label} {tag} {branch} row0={row0}: "
                            "differs from d x row x element multiplier")
                    n += 1
            if tag != "bf16":
                continue
            kw = dict(branch="mlp")
            def run():
                return FT.drop_grad(d, TRAIN_SEEDS, 5, drop, dp, **kw)
            ms = time_ms(run)
            device_ms = _device_ms(run, what=f"drop_grad {label}")
            plain_ms = time_ms(lambda: FT.drop_grad_plain(
                d, TRAIN_SEEDS, 5, drop, dp, **kw), iters=5)
            nbytes = 2 * d.numel() * d.element_size()
            DROP_PASSES[label] = dict(
                name="drop_grad", shape=[R, N, C], dtype=tag,
                route="vector" if C % 8 == 0 else "scalar", ms=ms,
                device_ms=device_ms, plain_ms=plain_ms, bytes=nbytes,
                byte_bound_ms=nbytes / peaks["bytes"] * 1e3,
                elements=d.numel(), library_ms=None)
            log(f"kernel drop_grad bf16 {label} {(R, N, C)} kernel_ms="
                f"{ms:.4f} device_ms={device_ms:.4f} plain_ms="
                f"{plain_ms:.4f} byte_bound_ms="
                f"{DROP_PASSES[label]['byte_bound_ms']:.4f}")
            del d
    log(f"kernels: {n} drop_grad checks bit for bit")
    return n


def drop_pass_bounds(sass, kernels):
    """The draw's integer bound from the library's SASS
    (afft_tpu_torch.tools.philox_bound): rows 10 and 16's kernels-line
    bound becomes the larger of it and their bytes' (bound_by then
    "operations"), and each timed drop pass's joins its byte bound; logs the
    drop passes' line."""
    from afft_tpu_torch.tools import philox_bound as PB
    hz = PB.max_sm_clock_hz()
    # an IMAD.WIDE's issue slots on the FMA-heavy pipe, measured here
    wide, probe = PB.wide_slots()
    counted = PB.bounds(sass, hz, 0, wide)
    per_sm = 1e3 / (PB.SMS * hz)
    for name, row in (("draw_masks", "10 draw_masks"),
                      ("draw_masks_gpt2", "16 draw_masks_gpt2")):
        e, t_int = kernels[name], counted["rows"][row]["integer_bound_ms"]
        e["integer_bound_ms"] = t_int
        if t_int > e["bound_ms"]:
            e["bound_ms"], e["bound_by"] = t_int, "operations"
    clocks = counted["kernels"]["drop_grad bf16"]["sm_clocks_per_element"]
    for entry in DROP_PASSES.values():
        entry["integer_bound_ms"] = (entry["elements"] * clocks * per_sm
                                     if entry["route"] == "vector" else None)
        t_int = entry["integer_bound_ms"] or 0.0
        entry["bound_ms"] = max(t_int, entry["byte_bound_ms"])
        entry["bound_by"] = ("operations" if t_int > entry["byte_bound_ms"]
                             else "bytes")
    log(json.dumps({"philox_bound": {
        k: {"per_element": v["per_element"],
            "sm_clocks_per_element": v["sm_clocks_per_element"]}
        for k, v in counted["kernels"].items() if v is not None},
        "max_sm_clock_mhz": hz / 1e6, "imad_wide_slots": wide,
        "probe": probe}))
    log(json.dumps({"drop_passes": DROP_PASSES}))


def check_train_edge_shapes(gen):
    """The training kernels at the edges of their limits: for the fuser
    block 1 to 8 tokens, row counts that fill no tile, head widths 6 / 8 /
    12 / 64 / 256, rates 0 and 0.5, biases and affines on and off, with and
    without the additive mask, and what drop-path promises (a row dropped in
    both branches passes x and its gradient through untouched); for the GPT-2
    layer 1, 5, 7, 16, 19 (a rollout pass) and 32 tokens, batches 1, 2, 3, 5
    and 33, head widths 6 / 8 / 12 / 64 / 512, rates 0, 0.1 and 0.5."""
    import torch
    from afft_tpu_torch.ops import fused_block_train as FT
    n = 0
    half = dict(attn_rate=0.5, drop_rate=0.5, dp_rate=0.5)
    zero = dict(attn_rate=0.0, drop_rate=0.0, dp_rate=0.0)
    gpt2_half = dict(attn_rate=0.5, resid_rate=0.5)
    gpt2_zero = dict(attn_rate=0.0, resid_rate=0.0)
    for tag, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        for R, N, C, H, hidden, rates, affine, qkv_bias, diag in (
                (1, 1, 64, 8, 256, None, True, False, False),
                (33, 8, 64, 1, 128, half, False, True, True),
                (1000, 3, 40, 5, 72, zero, True, True, True),
                (33, 2, 512, 2, 64, half, True, False, False),
                (130, 5, 96, 4, 384, None, False, False, True),
                (7, 4, 256, 4, 1024, zero, True, True, False),
                (64, 6, 128, 2, 512, None, True, False, True),
                (5, 7, 48, 6, 96, half, True, True, False),
                (33, 5, 24, 2, 96, None, True, False, False),
                (7, 3, 24, 4, 96, half, True, True, True)):
            check_train_block(tag, dt, R, N, C, H, hidden, gen, rates=rates,
                              affine=affine, qkv_bias=qkv_bias,
                              diag_mask=diag, block_idx=n % 6)
            n += 1
        # drop-path: rows whose two multipliers are both 0
        R, N, C, H, hidden = 512, 5, 64, 4, 256
        rates = dict(attn_rate=0.1, drop_rate=0.1, dp_rate=0.5)
        p = block_params(C, hidden, dt, gen)
        x = _randn(gen, dt)(R, N, C).requires_grad_(True)
        dout = _randn(gen, dt)(R, N, C)
        masks = FT.draw_masks(R, N, C, H, TRAIN_SEEDS, 2, *rates.values())
        dropped = (masks[2] == 0) & (masks[4] == 0)
        out = FT.fused_block_train(x, p, None, TRAIN_SEEDS, num_heads=H,
                                   block_idx=2, **rates)
        out.backward(dout)
        torch.cuda.synchronize()
        if not (int(dropped.sum()) > R // 8
                and torch.equal(out[dropped], x[dropped])
                and torch.equal(x.grad[dropped], dout[dropped])):
            raise AssertionError(f"drop-path {tag}: a row dropped in both "
                                 "branches must give out == x and dx == dout")
        n += 1
        for B, T, C, H, hidden, rates in (
                (1, 1, 64, 8, 256, None), (3, 5, 128, 2, 512, gpt2_half),
                (33, 16, 64, 8, 128, gpt2_zero), (3, 19, 512, 1, 256, None),
                (1, 32, 128, 2, 512, gpt2_half), (33, 32, 256, 4, 1024, None),
                (5, 7, 40, 5, 72, gpt2_half),
                (2, 16, 1024, 2, 4096, gpt2_zero),
                (3, 10, 24, 2, 96, None), (5, 7, 24, 4, 96, gpt2_half)):
            check_gpt2_train_layer(tag, dt, B, T, C, H, hidden, gen,
                                   rates=rates, layer_idx=n % 6)
            n += 1
    log(f"kernels: {n} training edge-shape checks agree with the plain "
        "versions (masks bit for bit)")


# The attention backward of both training layers (csrc/attention_bwd.cuh,
# inside rows 9 and 15) at the training edges: the fuser's token counts with
# its arithmetic, the GPT-2 layer's (causal, p * keep and ds rounded) with
# its, each head width at a head count that keeps C % 8 == 0
ATTN_BWD_EDGE_N = {False: (1, 2, 3, 5, 8), True: (1, 5, 7, 16, 19, 32)}
ATTN_BWD_EDGE_HD = {6: 4, 8: 3, 12: 2, 64: 3, 256: 2, 512: 2}  # hd: H
ATTN_BWD_RATES = (0.0, 0.1, 0.5)
# the flagship shapes: (label, R, N, H, hd, gpt2, causal)
ATTN_BWD_SHAPES = (("row 9", 4096, 5, 4, 256, False, False),
                   ("row 15", 256, 16, 4, 512, True, True))


def _check_attention_bwd(R, N, H, hd, dt, gpt2, rate, causal, gen):
    """The attention backward kernel against its plain version (O and dqkv
    within KERNEL_TOL of max|ref|), bit for bit on a second launch, and its
    O bit for bit the forward attention kernel's output on the same qkv and
    seeds (the entries' dWproj takes it in place of the forward's). Returns
    the largest absolute error."""
    import torch
    from afft_tpu_torch.models.layers import neg_inf_causal_mask
    from afft_tpu_torch.ops import fused_block_train as FT
    C = H * hd
    rn = _randn(gen, dt)
    qkv = rn(R * N, 3 * C)
    dao = _randn(gen, torch.float32)(R * N, C)
    mask = neg_inf_causal_mask(N, device="cuda") if causal else None
    kw = dict(n_tokens=N, num_heads=H, block_idx=4, attn_rate=rate,
              gpt2=gpt2)
    (o, dqkv), (o2, dqkv2) = (FT.attention_drop_bwd(qkv, mask, dao,
                                                    TRAIN_SEEDS, **kw)
                              for _ in range(2))
    fwd = FT.attention_drop(qkv, mask, TRAIN_SEEDS, **kw)
    torch.cuda.synchronize()
    mattn = FT.draw_masks_plain(R, N, C, H, TRAIN_SEEDS, 4, rate, 0.0, 0.0,
                                device="cuda")[0]
    want = FT.attention_drop_bwd_plain(qkv, mask, mattn, dao, N, H,
                                       dt if gpt2 else None)
    tag = "bf16" if dt == torch.bfloat16 else "fp32"
    what = (f"attention_bwd {tag} R={R} N={N} H={H} hd={hd} "
            f"{'gpt2' if gpt2 else 'fuser'} rate={rate} causal={causal}")
    worst = 0.0
    for name, got, ref in zip(("O", "dqkv"), (o, dqkv), want):
        finite, max_abs, rel = errors(got, ref)
        worst = max(worst, max_abs)
        if not (finite and rel <= KERNEL_TOL[tag]):
            raise AssertionError(f"{what}: {name} rel_err={rel:.3g} "
                                 f"finite={finite}")
    if not (torch.equal(o, o2) and torch.equal(dqkv, dqkv2)):
        raise AssertionError(f"{what}: two launches differ")
    if not torch.equal(o, fwd):
        raise AssertionError(f"{what}: O differs from the forward attention "
                             "kernel's output")
    return worst


def check_attention_bwd(peaks, gen):
    """The attention backward kernel at its edges and at the flagship
    shapes (bf16, and fp32 at an eighth of the rows) against its plain
    version, bit for bit on relaunch and O against the forward kernel; then
    its device time a launch at the flagship shapes against its byte bound
    (qkv and the fp32 dao read once, dqkv and O written once). Returns the
    numbers."""
    import itertools
    import torch
    from afft_tpu_torch.models.layers import neg_inf_causal_mask
    from afft_tpu_torch.ops import fused_block_train as FT
    n, worst = 0, 0.0
    for dt in (torch.float32, torch.bfloat16):
        for gpt2, Ns in ATTN_BWD_EDGE_N.items():
            for N in Ns:
                for (hd, H), rate in itertools.product(
                        ATTN_BWD_EDGE_HD.items(), ATTN_BWD_RATES):
                    causal = rate == 0.1 or (gpt2 and rate == 0.0)
                    worst = max(worst, _check_attention_bwd(
                        5 + N % 3, N, H, hd, dt, gpt2, rate, causal, gen))
                    n += 1
    numbers = {}
    for label, R, N, H, hd, gpt2, causal in ATTN_BWD_SHAPES:
        for dt, rows in ((torch.bfloat16, R), (torch.float32, R // 8)):
            worst = max(worst, _check_attention_bwd(
                rows, N, H, hd, dt, gpt2, 0.1, causal, gen))
            n += 1
        C = H * hd
        qkv = _randn(gen, torch.bfloat16)(R * N, 3 * C)
        dao = _randn(gen, torch.float32)(R * N, C)
        mask = neg_inf_causal_mask(N, device="cuda") if causal else None
        kw = dict(n_tokens=N, num_heads=H, block_idx=4, attn_rate=0.1,
                  gpt2=gpt2)
        ms = _device_ms(lambda: FT.attention_drop_bwd(qkv, mask, dao,
                                                      TRAIN_SEEDS, **kw),
                        what=f"attention_drop_bwd {label}")
        fwd_ms = _device_ms(lambda: FT.attention_drop(qkv, mask,
                                                      TRAIN_SEEDS, **kw),
                            what=f"attention_drop {label}")
        nbytes = _nbytes(qkv, dao) + _nbytes(qkv) + R * N * C * 2
        bound = nbytes / peaks["bytes"] * 1e3
        numbers[label] = {"device_ms": ms, "bound_ms": bound, "bytes": nbytes,
                          "forward_attention_device_ms": fwd_ms}
        log(f"kernel attention_bwd {label} bf16 (R, N, H, hd)=({R}, {N}, {H}, "
            f"{hd}): device {ms:.4f} ms a launch against the byte bound "
            f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB, {nbytes / ms / 1e6:.1f} "
            f"GB/s); the forward attention alone {fwd_ms:.4f} ms")
        del qkv, dao
    log(f"kernel attention_bwd: {n} checks against the plain version agree "
        f"(largest abs err {worst:.3g}; tol {KERNEL_TOL['bf16']:g} / "
        f"{KERNEL_TOL['fp32']:g} of max|ref|), each bit for bit on a second "
        "launch, O bit for bit the forward attention kernel's output")
    torch.cuda.empty_cache()
    return {"checks": n, "worst_abs_err": worst, "flagship": numbers}


def library_train_halves(p, H, eps, rates, dp_masks, mask=None):
    """The training block as cuBLAS GEMMs + SDPA + F.layer_norm + F.dropout
    under autograd, in two halves; used nowhere in the port."""
    import torch.nn.functional as F
    dp1, dp2 = dp_masks

    def attn_half(x):
        R, N, C = x.shape
        h = F.layer_norm(x, (C,), p["norm1.weight"], p["norm1.bias"], eps)
        q, k, v = (F.linear(h, p["attn.qkv.weight"])
                   .view(R, N, 3, H, C // H).permute(2, 0, 3, 1, 4))
        a = F.scaled_dot_product_attention(
            q, k, v, attn_mask=None if mask is None else mask == 0,
            dropout_p=rates["attn_rate"])
        a = F.linear(a.transpose(1, 2).reshape(R, N, C),
                     p["attn.proj.weight"], p["attn.proj.bias"])
        return x + dp1 * F.dropout(a, rates["drop_rate"])

    def mlp_half(y):
        C = y.shape[-1]
        h = F.layer_norm(y, (C,), p["norm2.weight"], p["norm2.bias"], eps)
        h = F.gelu(F.linear(h, p["mlp.mlp.0.weight"], p["mlp.mlp.0.bias"]))
        h = F.linear(h, p["mlp.mlp.2.weight"], p["mlp.mlp.2.bias"])
        return y + dp2 * F.dropout(h, rates["drop_rate"])
    return attn_half, mlp_half


def library_gpt2_train_halves(p, H, eps, rates):
    """The GPT-2 training layer as cuBLAS GEMMs + SDPA (causal, with
    dropout) + F.layer_norm + F.dropout under autograd, in two halves; used
    nowhere in the port."""
    import torch.nn.functional as F

    def attn_half(x):
        B, T, C = x.shape
        h = F.layer_norm(x, (C,), p["ln_1.weight"], p["ln_1.bias"], eps)
        q, k, v = ((h @ p["attn.c_attn.weight"] + p["attn.c_attn.bias"])
                   .view(B, T, 3, H, C // H).permute(2, 0, 3, 1, 4))
        a = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                           dropout_p=rates["attn_rate"])
        a = (a.transpose(1, 2).reshape(B, T, C) @ p["attn.c_proj.weight"]
             + p["attn.c_proj.bias"])
        return x + F.dropout(a, rates["resid_rate"])

    def mlp_half(y):
        C = y.shape[-1]
        h = F.layer_norm(y, (C,), p["ln_2.weight"], p["ln_2.bias"], eps)
        h = F.gelu(h @ p["mlp.c_fc.weight"] + p["mlp.c_fc.bias"],
                   approximate="tanh")
        h = h @ p["mlp.c_proj.weight"] + p["mlp.c_proj.bias"]
        return y + F.dropout(h, rates["resid_rate"])
    return attn_half, mlp_half


def train_kernel_work(R, N, C, H, hidden, item, pairs, row_masks):
    """(flops, bytes) of a training layer's four kernels (forward, MLP
    backward, attention backward, masks) over R rows of N tokens: each input
    read once, each output written once, the stashed residuals counted where
    they are written and where they are read; parameter gradients are fp32.
    ``pairs``: the (query, key) pairs the mask leaves visible; ``row_masks``:
    the masks' per-row elements (the fuser's two drop-path masks)."""
    M = R * N
    wa, wm = 4 * C * C, 2 * C * hidden            # attention / MLP weights
    small_a, small_m = 6 * C, 3 * C + hidden      # their biases and affines
    fwd = (2 * M * C * (4 * C + 2 * hidden) + 4 * R * pairs * C,
           (M * (2 * C + C + 3 * C + hidden) + wa + wm + small_a
            + small_m) * item + N * N * 4)
    bwd_mlp = (8 * M * C * hidden,
               (M * (2 * C + hidden + C) + wm + 2 * C) * item
               + (wm + small_m) * 4)
    bwd_attn = (16 * M * C * C + 12 * R * pairs * C,
                (M * (2 * C + 3 * C + C) + wa + 2 * C) * item
                + (wa + small_a) * 4 + N * N * 4)
    masks = (0, (2 * M * C + row_masks + R * H * N * N) * 4)
    return fwd, bwd_mlp, bwd_attn, masks


# the four kernels of each training layer: name, the TPU kernel it replaces
TRAIN_KERNELS = {
    "fused_block_train": (
        ("fused_block_train_fwd", "afft_tpu/ops/pallas_block_train.py:759"),
        ("fused_block_train_bwd_mlp",
         "afft_tpu/ops/pallas_block_train.py:242"),
        ("fused_block_train_bwd_attn",
         "afft_tpu/ops/pallas_block_train.py:303"),
        ("draw_masks", "afft_tpu/ops/pallas_block_train.py:670")),
    # rows 11 + 12, 13 + 14 and 15 of the kernel table: a TPU split into
    # two kernels is one entry here, reported against its first kernel
    "fused_gpt2_train": (
        ("fused_gpt2_train_fwd", "afft_tpu/ops/pallas_gpt2_train.py:84"),
        ("fused_gpt2_train_bwd_mlp",
         "afft_tpu/ops/pallas_gpt2_train.py:167"),
        ("fused_gpt2_train_bwd_attn",
         "afft_tpu/ops/pallas_gpt2_train.py:216"),
        ("draw_masks_gpt2", "afft_tpu/ops/pallas_gpt2_train.py:311")),
}


def time_train_layer(peaks, case, layer):
    """One training layer's four kernels at the case's shape (bf16, the
    flagship's): their times beside the plain versions', a library
    composition's and the bound, and the forward + backward of the whole
    layer. ``layer`` gives the callables; returns the kernels' entries of
    the kernels line."""
    import torch
    from afft_tpu_torch.ops import fused_block_train as FT
    x, p, dout, errs = (case[k] for k in ("x", "p", "dout", "errs"))
    label, mlp_keys = layer["label"], layer["mlp_keys"]
    names = [n for n, _ in TRAIN_KERNELS[label]]
    R, N, C = x.shape
    dflat = dout.reshape(R * N, C)

    def leaves():
        return (x.clone().requires_grad_(True),
                {k: v.clone().requires_grad_(True) for k, v in p.items()})

    # the kernels, through the wrapper and the backward entries' wrappers
    xk, pk = leaves()
    out = layer["kernel"](xk, pk)
    saved = out.grad_fn.saved_tensors
    y, qkv, pre1, mask32 = saved[1:5]
    tensors, cfg = list(saved[5:]), out.grad_fn.cfg
    grads = FT.new_grads(tensors)
    dy = FT.block_train_bwd_mlp(x, y, dflat, pre1, tensors, grads, cfg)

    def bwd_mlp():
        return FT.block_train_bwd_mlp(x, y, dflat, pre1, tensors, grads, cfg)
    with torch.no_grad():
        ms = [time_ms(lambda: layer["kernel"](x, p)),
              time_ms(bwd_mlp),
              time_ms(lambda: FT.block_train_bwd_attn(x, dy, qkv, mask32,
                                                      tensors, grads, cfg)),
              time_ms(layer["draw"])]
        # every gradient the same from run to run: each backward entry
        # twice on the same inputs into zeroed buffers, bit for bit
        for name, bwd, args in (
                (names[1], FT.block_train_bwd_mlp, (x, y, dflat, pre1)),
                (names[2], FT.block_train_bwd_attn, (x, dy, qkv, mask32))):
            runs = []
            for _ in range(2):
                g = [None if t is None else torch.zeros(
                    t.shape, dtype=torch.float32, device="cuda")
                    for t in tensors]
                runs.append([bwd(*args, tensors, g, cfg)]
                            + [t for t in g if t is not None])
            if not all(torch.equal(a, b) for a, b in zip(*runs)):
                raise AssertionError(f"{name}: two runs on the same inputs "
                                     "give different gradients")
            del runs, g

    def fwd_bwd():
        layer["kernel"](xk, pk).backward(dout)
    whole_ms = time_ms(fwd_bwd, iters=10)

    # the plain versions: forward on the masks, autograd through each half
    xp, pp = leaves()
    attn_plain, mlp_plain = layer["plain_halves"]
    yp = attn_plain(xp, pp)
    yl = yp.detach().requires_grad_(True)
    op = mlp_plain(yl, pp)
    mlp_in = [yl] + [pp[k] for k in mlp_keys]
    attn_in = [xp] + [pp[k] for k in p if k not in mlp_keys]
    dy_plain = torch.randn_like(yp)
    with torch.no_grad():
        plain_ms = [time_ms(lambda: layer["plain"](x, p), iters=10)]
    plain_ms += [time_ms(lambda: torch.autograd.grad(
                     op, mlp_in, dflat, retain_graph=True), iters=10),
                 time_ms(lambda: torch.autograd.grad(
                     yp, attn_in, dy_plain, retain_graph=True), iters=10)]
    with torch.no_grad():
        plain_ms.append(time_ms(layer["draw_plain"], iters=5))
    del yp, yl, op, xp, pp, mlp_in, attn_in, dy_plain
    torch.cuda.empty_cache()

    # the library yardstick
    xl, pl = leaves()
    attn_half, mlp_half = layer["library"](pl)
    ya = attn_half(xl)
    yb = ya.detach().requires_grad_(True)
    ob = mlp_half(yb)
    redesign = {}
    if names[0] in REDESIGNED:
        redesign[names[0]] = redesigned_numbers(
            names[0], tuple(x.shape), lambda: layer["kernel"](x, p),
            lambda: mlp_half(attn_half(x)))
    if names[1] in REDESIGNED:
        redesign[names[1]] = redesigned_numbers(
            names[1], tuple(x.shape), bwd_mlp,
            lambda: torch.autograd.grad(
                ob, [yb] + [pl[k] for k in mlp_keys], dout,
                retain_graph=True))
    if names[2] in REDESIGNED:
        redesign[names[2]] = redesigned_numbers(
            names[2], tuple(x.shape),
            lambda: FT.block_train_bwd_attn(x, dy, qkv, mask32, tensors,
                                            grads, cfg),
            lambda: torch.autograd.grad(
                ya, [xl] + [pl[k] for k in p if k not in mlp_keys], dout,
                retain_graph=True))
    for name, numbers in redesign.items():
        if name in OFF_PATH:
            check_off_path(name, numbers["profile"])
    del out, saved, y, qkv, pre1, dy, grads
    with torch.no_grad():
        library_ms = [time_ms(lambda: mlp_half(attn_half(x)))]
    library_ms += [
        time_ms(lambda: torch.autograd.grad(
            ob, [yb] + [pl[k] for k in mlp_keys], dout, retain_graph=True)),
        time_ms(lambda: torch.autograd.grad(
            ya, [xl] + [pl[k] for k in p if k not in mlp_keys], dout,
            retain_graph=True)),
        None]

    def lib_fwd_bwd():
        mlp_half(attn_half(xl)).backward(dout)
    lib_whole_ms = time_ms(lib_fwd_bwd, iters=10)
    del ya, yb, ob, xl, pl
    with torch.no_grad():
        ones = torch.ones(R * N, C, device="cuda")
        bernoulli_ms = time_ms(lambda: torch.nn.functional.dropout(ones, 0.1))
    torch.cuda.empty_cache()

    max_abs = (errs["fwd"], errs["bwd_mlp"], errs["bwd_attn"], 0.0)
    # the mask kernel's device time alone (its CUDA-event time above holds
    # the wrapper's host work, which is longer than the kernel)
    draw_device_ms = _device_ms(layer["draw"], what=names[3])
    results = {}
    for i, (name, replaces) in enumerate(TRAIN_KERNELS[label]):
        flops, nbytes = layer["work"][i]
        t_ops = flops / peaks["bf16"] * 1e3
        t_bytes = nbytes / peaks["bytes"] * 1e3
        results[name] = dict(
            name=name, route="cuda", source=layer["source"],
            replaces=replaces, max_abs_err=max_abs[i], ms=ms[i],
            plain_ms=plain_ms[i], library_ms=library_ms[i],
            bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            flops=flops, bytes=nbytes)
        if i == 3:
            results[name]["device_ms"] = draw_device_ms
        lib = library_ms[i]
        log(f"kernel {name} bf16 {tuple(x.shape)} kernel_ms={ms[i]:.4f} "
            f"plain_ms={plain_ms[i]:.4f} library_ms="
            f"{'null' if lib is None else format(lib, '.4f')} bound_ms="
            f"{results[name]['bound_ms']:.4f} ({results[name]['bound_by']}: "
            f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB) achieved="
            f"{flops / ms[i] / 1e9:.1f} TFLOP/s "
            f"{nbytes / ms[i] / 1e6:.1f} GB/s")
    log(f"kernel {label} bf16 {tuple(x.shape)}: forward + backward of one "
        f"layer {whole_ms:.4f} ms through the kernels, {lib_whole_ms:.4f} ms "
        f"through the library composition; one F.dropout mask of (rows, C) "
        f"{bernoulli_ms:.4f} ms beside {names[3]}' masks")
    results[names[0]]["block_fwd_bwd_ms"] = whole_ms
    for name, numbers in redesign.items():
        results[name]["redesign"] = numbers
    results[names[0]]["library_block_fwd_bwd_ms"] = lib_whole_ms
    return results


def _log_case(case, tag):
    log(f"kernel {case['what']}: forward and masks ok, worst gradient "
        f"{case['worst'][0]} rel_err={case['worst'][1]:.3g} (tol "
        f"{GRAD_TOL[tag]:g})")


def phase_train_kernels(peaks, gen):
    """Kernels 7-10 (the fuser block: R = 4096 rows of 5 tokens, C 1024) and
    11-16 (the GPT-2 layer: B = 256 samples of 16 tokens, C 2048) at the
    flagship shape in bf16 and at a reduced batch in fp32, the edge shapes,
    then their times beside the plain versions', a library composition's
    and the bound."""
    import torch
    from afft_tpu_torch.models.layers import neg_inf_causal_mask
    from afft_tpu_torch.ops import fused_block_train as FT
    from afft_tpu_torch.ops import fused_gpt2_train as FGT

    log(json.dumps({"attention_bwd": check_attention_bwd(peaks, gen)}))
    check_train_edge_shapes(gen)
    check_width_train(gen)
    check_mask_edges()
    check_drop_grad(peaks, gen)
    torch.cuda.empty_cache()
    results = {}

    # the fuser block
    N, C, H, hidden, eps = 5, 1024, 4, 4096, 1e-6
    _log_case(check_train_block("fp32", torch.float32, 512, N, C, H, hidden,
                                gen), "fp32")
    torch.cuda.empty_cache()
    R, rates = 4096, TRAIN_RATES
    case = check_train_block("bf16", torch.bfloat16, R, N, C, H, hidden, gen)
    _log_case(case, "bf16")
    masks, dt = case["masks"], case["x"].dtype
    results.update(time_train_layer(peaks, case, dict(
        label="fused_block_train", mlp_keys=GRAD_KEYS_MLP,
        source="afft_tpu_torch/csrc/fused_block_train.cu",
        kernel=lambda x, p: FT.fused_block_train(
            x, p, None, TRAIN_SEEDS, num_heads=H, block_idx=5, **rates),
        plain=lambda x, p: FT.fused_block_train_plain(x, p, None, masks,
                                                      num_heads=H),
        plain_halves=(
            lambda x, p: FT.attn_half_train_plain(x, p, None, masks,
                                                  num_heads=H)[0],
            lambda y, p: FT.mlp_half_train_plain(y, p, masks, dt, N)[0]),
        library=lambda p: library_train_halves(
            p, H, eps, rates, (masks[2].to(dt).reshape(R, 1, 1),
                               masks[4].to(dt).reshape(R, 1, 1))),
        draw=lambda: FT.draw_masks(R, N, C, H, TRAIN_SEEDS, 5,
                                   *rates.values()),
        draw_plain=lambda: FT.draw_masks_plain(
            R, N, C, H, TRAIN_SEEDS, 5, *rates.values(), device="cuda"),
        work=train_kernel_work(R, N, C, H, hidden, dt.itemsize, N * N,
                               2 * R))))
    del case, masks
    torch.cuda.empty_cache()

    # the GPT-2 layer
    T, C, H, hidden, eps = 16, 2048, 4, 8192, 1e-5
    _log_case(check_gpt2_train_layer("fp32", torch.float32, 32, T, C, H,
                                     hidden, gen), "fp32")
    torch.cuda.empty_cache()
    B, rates = 256, GPT2_RATES
    case = check_gpt2_train_layer("bf16", torch.bfloat16, B, T, C, H, hidden,
                                  gen)
    _log_case(case, "bf16")
    masks, dt = case["masks"], case["x"].dtype
    mask = neg_inf_causal_mask(T, device="cuda")
    results.update(time_train_layer(peaks, case, dict(
        label="fused_gpt2_train", mlp_keys=GPT2_GRAD_KEYS_MLP,
        source="afft_tpu_torch/csrc/fused_gpt2_train.cu",
        kernel=lambda x, p: FGT.fused_gpt2_block_train(
            x, p, mask, TRAIN_SEEDS, num_heads=H, layer_idx=3, **rates),
        plain=lambda x, p: FGT.fused_gpt2_block_train_plain(
            x, p, mask, masks, num_heads=H),
        plain_halves=(
            lambda x, p: FGT.gpt2_attn_half_train_plain(
                x, p, mask, masks, num_heads=H)[0],
            lambda y, p: FGT.gpt2_mlp_half_train_plain(y, p, masks)[0]),
        library=lambda p: library_gpt2_train_halves(p, H, eps, rates),
        draw=lambda: FGT.draw_masks_gpt2(B, T, C, H, TRAIN_SEEDS, 3,
                                         *rates.values()),
        draw_plain=lambda: FGT.draw_masks_gpt2_plain(
            B, T, C, H, TRAIN_SEEDS, 3, *rates.values(), device="cuda"),
        work=train_kernel_work(B, T, C, H, hidden, dt.itemsize,
                               T * (T + 1) // 2, 0))))
    del case, masks
    torch.cuda.empty_cache()
    return results


# -- the training kernels in shard mode (tensor parallelism) ------------------

# the flagship's model ranks in the shard checks and phase 15
TP = 2


def _tp_local(p, prefix, rank, count=TP):
    """Model rank ``rank``'s tensors of a layer's ``p`` (its names under the
    state-dict ``prefix`` decide the split: parallel.sharding.TP_RULES)."""
    from afft_tpu_torch.parallel import sharding as SH
    out = {}
    for k, v in p.items():
        spec = SH.spec_for_path(prefix + k)
        out[k] = v if spec is None else SH.shard_tensor(v, spec, rank, count)
    return out


def tp_kernel_work(R, N, C, H, hidden, item, pairs, tp, heads):
    """(flops, bytes) of one model rank's shard-mode entries (forward, MLP
    backward, attention backward) over R rows of N tokens: the attention
    width A = C / tp where the heads split (the GPT-2 layer's), else C;
    hidden / tp MLP columns; each input read once, each output written
    once (the partial sums fp32), the stashes where written and read, the
    parameter gradients fp32. The fuser's attention backward runs whole
    (train_kernel_work's)."""
    M = R * N
    A, h = (C // tp if heads else C), hidden // tp
    wa, wm = 4 * C * A, 2 * C * h
    small = 6 * C + 3 * C + h
    fwd_flops = 2 * M * C * (4 * A + 2 * h) + 4 * R * pairs * A
    if heads:
        # both halves: x, qkv, y's partial, y, pre1, the output's partial
        fwd_bytes = (M * (C + 3 * A + C + h) + wa + wm + small) * item \
            + 2 * M * C * 4 + N * N * 4
    else:
        fwd_bytes = (M * (C + C + 3 * A + h) + wa + wm + small) * item \
            + M * C * 4 + N * N * 4
    bwd_mlp = (8 * M * C * h,
               (M * (2 * C + h) + wm + 2 * C) * item + M * C * 4
               + (wm + 3 * C + h) * 4)
    bwd_attn = (16 * M * C * A + 12 * R * pairs * A,
                (M * (2 * C + 3 * A) + wa + 2 * C) * item + M * C * 4
                + (wa + 6 * C) * 4 + N * N * 4)
    return (fwd_flops, fwd_bytes), bwd_mlp, bwd_attn


def _tp_hold(what, label, got, want, tol, errs, key):
    rel, max_abs = _rel_err(got, want)
    errs[key] = max(errs.get(key, 0.0), max_abs)
    errs[f"{key}_rel"] = max(errs.get(f"{key}_rel", 0.0), rel)
    if not rel <= tol:
        raise AssertionError(f"{what}: {label} rel_err={rel:.3g} (tol "
                             f"{tol:g})")


def check_tp_layer(tag, dt, gpt2, R, N, C, H, hidden, gen, peaks=None):
    """A training layer's three entries in shard mode at TP model ranks
    (no process group: each rank's launch in turn): each rank's partial
    sums and stashes against the plain version on the same shard (the
    forward at KERNEL_TOL, the partial dy / dx and the shard's gradients
    against fp32 autograd through the plain shard halves at GRAD_TOL), and
    the sum of the partials over the ranks against the unsharded kernel
    (the forward's y and output, dy, dx and each gradient: the shards'
    concatenation, the norms' partial sums, the whole biases, at
    KERNEL_TOL). With ``peaks``, rank 0's entries are timed beside the plain
    shard version and the bound of the local work. Returns (largest
    absolute errors by entry, timings or None)."""
    import torch
    from afft_tpu_torch.models.layers import neg_inf_causal_mask
    from afft_tpu_torch.ops import fused_block as FB
    from afft_tpu_torch.ops import fused_block_train as FT
    from afft_tpu_torch.ops import fused_gpt2_train as FGT
    from afft_tpu_torch.ops._common import Shard
    from afft_tpu_torch.parallel import sharding as SH

    name = "fused_gpt2_train" if gpt2 else "fused_block_train"
    what = (f"{name} shard mode tp={TP} {tag} R={R} N={N} C={C} H={H} "
            f"hidden={hidden}")
    rn = _randn(gen, dt)
    x, dout = rn(R, N, C), rn(R, N, C)
    dflat = dout.reshape(R * N, C)
    if gpt2:
        p = gpt2_params(C, hidden, dt, gen)
        rates, prefix = GPT2_RATES, "gpt_model.h.3."
        mask = neg_inf_causal_mask(N, device="cuda")
        masks = FGT.draw_masks_gpt2(R, N, C, H, TRAIN_SEEDS, 3,
                                    *rates.values(), device="cuda")
        arrays = FT.rate_arrays(TRAIN_SEEDS, 3, rates["attn_rate"],
                                rates["resid_rate"], 0.0)
        kernel = lambda x, p: FGT.fused_gpt2_block_train(  # noqa: E731
            x, p, mask, TRAIN_SEEDS, num_heads=H, layer_idx=3, **rates)
        layer, heads, mlp_keys = FGT.GPT2, H // TP, GPT2_GRAD_KEYS_MLP
    else:
        p = block_params(C, hidden, dt, gen)
        rates, prefix, mask = TRAIN_RATES, "fuser.blocks.5.", None
        masks = FT.draw_masks(R, N, C, H, TRAIN_SEEDS, 5, *rates.values(),
                              device="cuda")
        arrays = FT.rate_arrays(TRAIN_SEEDS, 5, *rates.values())
        kernel = lambda x, p: FT.fused_block_train(  # noqa: E731
            x, p, mask, TRAIN_SEEDS, num_heads=H, block_idx=5, **rates)
        layer, heads, mlp_keys = FT.FUSER, H, GRAD_KEYS_MLP
    mask32 = None if mask is None else mask.float().contiguous()
    cfg = (heads, hidden // TP, 1e-5 if gpt2 else 1e-6, arrays, layer)
    ftol, gtol = KERNEL_TOL[tag], GRAD_TOL[tag]

    # the unsharded kernel: output, gradients, its stashes and its dy
    xk = x.clone().requires_grad_(True)
    pk = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    out_ref = kernel(xk, pk)
    saved = out_ref.grad_fn.saved_tensors
    y_ref, pre1_ref, full_cfg = saved[1], saved[3], out_ref.grad_fn.cfg
    full_tensors = list(saved[5:])
    dy_ref = FT.block_train_bwd_mlp(x, y_ref, dflat, pre1_ref, full_tensors,
                                    FT.new_grads(full_tensors), full_cfg)
    out_ref.backward(dout)
    torch.cuda.synchronize()

    def operands(pm):
        if gpt2:
            return FGT.gpt2_operands(name, x, pm, heads, TP)[0]
        return FB.block_operands(name, x, pm, H, differentiable=True)[0]

    errs, locals_, runs = {}, [], []
    for m in range(TP):
        pm = _tp_local(p, prefix, m)
        locals_.append((pm, operands(pm), Shard(m, TP)))
    # the forward: each rank's partials against the plain shard version
    if gpt2:
        ysum = None
        for m, (pm, tensors, shard) in enumerate(locals_):
            a = FT.train_fwd_shard(x, mask32, cfg, tensors, shard,
                                   FT.PART_ATTN)
            with torch.no_grad():
                part, qkv = FGT.gpt2_attn_half_shard_plain(
                    x, pm, mask, masks, num_heads=H, rank=m)
            _tp_hold(what, f"rank {m} y partial", a["part"], part, ftol,
                     errs, "fwd")
            _tp_hold(what, f"rank {m} qkv", a["qkv"], qkv, ftol, errs, "fwd")
            ysum = a["part"] if ysum is None else ysum + a["part"]
            runs.append({"qkv": a["qkv"]})
        y = ysum.to(dt)
        _tp_hold(what, "y summed over the ranks", y, y_ref, ftol, errs,
                 "fwd")
        osum = None
        for m, (pm, tensors, shard) in enumerate(locals_):
            b = FT.train_fwd_shard(x, mask32, cfg, tensors, shard,
                                   FT.PART_MLP, y)
            with torch.no_grad():
                part = FGT.gpt2_mlp_half_shard_plain(y, pm, masks, rank=m)
            _tp_hold(what, f"rank {m} output partial", b["part"], part, ftol,
                     errs, "fwd")
            osum = b["part"] if osum is None else osum + b["part"]
            runs[m].update(pre1=b["pre1"], y=y)
    else:
        osum = None
        for m, (pm, tensors, shard) in enumerate(locals_):
            a = FT.train_fwd_shard(x, mask32, cfg, tensors, shard,
                                   FT.PART_BOTH)
            with torch.no_grad():
                y32, qkv = FT.attn_half_train_plain(x, pm, mask, masks,
                                                    num_heads=H)
                part = FT.mlp_half_shard_plain(y32, pm, masks, dt, N, m)
            _tp_hold(what, f"rank {m} output partial", a["part"], part, ftol,
                     errs, "fwd")
            _tp_hold(what, f"rank {m} y", a["y"], y32, ftol, errs, "fwd")
            osum = a["part"] if osum is None else osum + a["part"]
            runs.append(a)
        y = runs[0]["y"]
    _tp_hold(what, "output summed over the ranks", osum.to(dt).reshape(
        out_ref.shape), out_ref, ftol, errs, "fwd")

    # the MLP backward: each rank's partial dy and MLP gradients against
    # autograd through the plain shard half, the sum against the unsharded
    grads, dysum = [], None
    for m, (pm, tensors, shard) in enumerate(locals_):
        g = FT.new_grads(tensors)
        dy = FT.block_train_bwd_mlp(x, runs[m]["y"], dflat, runs[m]["pre1"],
                                    tensors, g, cfg, shard)
        y32 = runs[m]["y"].detach().float().clone().requires_grad_(True)
        p32 = {k: v.detach().float().clone().requires_grad_(True)
               for k, v in pm.items()}
        part = (FGT.gpt2_mlp_half_shard_plain(y32, p32, masks, rank=m)
                if gpt2 else FT.mlp_half_shard_plain(y32, p32, masks,
                                                     torch.float32, N, m))
        part.backward(dflat.float())
        _tp_hold(what, f"rank {m} dy partial", dy, y32.grad, gtol, errs,
                 "bwd_mlp")
        keys = [k for k in mlp_keys if k in pm]
        for k, got in zip(FGT.KEYS if gpt2 else FB_KEYS, g):
            if k in keys:
                _tp_hold(what, f"rank {m} gradient {k}", got, p32[k].grad,
                         gtol, errs, "bwd_mlp")
        grads.append(g)
        dysum = dy if dysum is None else dysum + dy
    _tp_hold(what, "dy summed over the ranks", dysum, dy_ref, ftol, errs,
             "bwd_mlp")
    dy = dysum.to(dt)

    # the attention backward: the GPT-2 layer's on each rank's heads, the
    # fuser's whole on the summed dy
    if gpt2:
        dxsum = None
        for m, (pm, tensors, shard) in enumerate(locals_):
            dx = FT.block_train_bwd_attn(x, dy, runs[m]["qkv"], mask32,
                                         tensors, grads[m], cfg, shard)
            x32 = x.detach().float().clone().requires_grad_(True)
            p32 = {k: v.detach().float().clone().requires_grad_(True)
                   for k, v in pm.items()}
            part, _ = FGT.gpt2_attn_half_shard_plain(x32, p32, mask, masks,
                                                     num_heads=H, rank=m)
            part.backward(dy.float())
            _tp_hold(what, f"rank {m} dx partial", dx.reshape(x.shape),
                     x32.grad, gtol, errs, "bwd_attn")
            for k, got in zip(FGT.KEYS, grads[m]):
                if k not in mlp_keys:
                    _tp_hold(what, f"rank {m} gradient {k}", got,
                             p32[k].grad, gtol, errs, "bwd_attn")
            dxsum = dx if dxsum is None else dxsum + dx
        dx = dxsum
    else:
        pm, tensors, _ = locals_[0]
        dx = FT.block_train_bwd_attn(x, dy, runs[0]["qkv"], mask32, tensors,
                                     grads[0], cfg)
        for g in grads[1:]:
            for i in range(len(g)):
                if FB_KEYS[i] not in mlp_keys:
                    g[i] = grads[0][i]
    _tp_hold(what, "dx summed over the ranks", dx.reshape(x.shape),
             xk.grad, ftol, errs, "bwd_attn")
    # every gradient: the shards joined, the norms' partials summed
    keys = FGT.KEYS if gpt2 else FB_KEYS
    for i, k in enumerate(keys):
        if grads[0][i] is None:
            continue
        spec = SH.spec_for_path(prefix + k)
        if spec is not None:
            got = SH.unshard_tensor([g[i] for g in grads], spec)
        elif k.startswith(("ln_", "norm")) and (gpt2 or k.startswith(
                "norm2")):
            got = sum(g[i] for g in grads)
        else:
            got = grads[0][i]
        _tp_hold(what, f"gradient {k} over the ranks", got, pk[k].grad,
                 ftol, errs, "bwd_mlp" if k in mlp_keys else "bwd_attn")
    log(f"kernel {what}: each rank against the plain shard version and the "
        f"sums against the unsharded kernel ok; max_abs_err {errs}")
    if peaks is None:
        return errs, None

    # rank 0's local work: its entries' times, the plain shard version's
    pm, tensors, shard = locals_[0]
    r0 = runs[0]
    with torch.no_grad():
        if gpt2:
            fwd = lambda: (FT.train_fwd_shard(  # noqa: E731
                x, mask32, cfg, tensors, shard, FT.PART_ATTN),
                FT.train_fwd_shard(x, mask32, cfg, tensors, shard,
                                   FT.PART_MLP, y))
            fwd_plain = lambda: (FGT.gpt2_attn_half_shard_plain(  # noqa
                x, pm, mask, masks, num_heads=H, rank=0),
                FGT.gpt2_mlp_half_shard_plain(y, pm, masks, rank=0))
        else:
            fwd = lambda: FT.train_fwd_shard(  # noqa: E731
                x, mask32, cfg, tensors, shard, FT.PART_BOTH)
            fwd_plain = lambda: FT.mlp_half_shard_plain(  # noqa: E731
                FT.attn_half_train_plain(x, pm, mask, masks,
                                         num_heads=H)[0], pm, masks, dt, N, 0)
        g = FT.new_grads(tensors)
        ms = [time_ms(fwd),
              time_ms(lambda: FT.block_train_bwd_mlp(
                  x, r0["y"], dflat, r0["pre1"], tensors, g, cfg, shard)),
              time_ms(lambda: FT.block_train_bwd_attn(
                  x, dy, r0["qkv"], mask32, tensors, g, cfg,
                  shard if gpt2 else None))]
        plain_ms = [time_ms(fwd_plain, iters=10)]
    yl = r0["y"].detach().float().requires_grad_(True)
    pl = {k: v.detach().requires_grad_(True) for k, v in pm.items()}
    part = (FGT.gpt2_mlp_half_shard_plain(yl, pl, masks, rank=0) if gpt2
            else FT.mlp_half_shard_plain(yl, pl, masks, dt, N, 0))
    xl = x.detach().requires_grad_(True)
    if gpt2:
        apart, _ = FGT.gpt2_attn_half_shard_plain(xl, pl, mask, masks,
                                                  num_heads=H, rank=0)
    else:
        apart, _ = FT.attn_half_train_plain(xl, pl, mask, masks, num_heads=H)
    plain_ms += [time_ms(lambda: torch.autograd.grad(
                     part, [yl] + [pl[k] for k in mlp_keys if k in pl],
                     dflat.float(), retain_graph=True), iters=10),
                 time_ms(lambda: torch.autograd.grad(
                     apart, [xl] + [pl[k] for k in pl if k not in mlp_keys],
                     dy.float().reshape(apart.shape), retain_graph=True),
                     iters=10)]
    pairs = N * (N + 1) // 2 if gpt2 else N * N
    work = tp_kernel_work(R, N, C, H, hidden, dt.itemsize, pairs, TP, gpt2)
    if not gpt2:
        work = work[:2] + (train_kernel_work(R, N, C, H, hidden, dt.itemsize,
                                             pairs, 2 * R)[2],)
    max_abs = (errs["fwd"], errs["bwd_mlp"], errs["bwd_attn"])
    out = {}
    for i, (entry, _) in enumerate(TRAIN_KERNELS[name][:3]):
        flops, nbytes = work[i]
        t_ops = flops / peaks["bf16"] * 1e3
        t_bytes = nbytes / peaks["bytes"] * 1e3
        out[entry] = dict(max_abs_err=max_abs[i], ms=ms[i],
                          plain_ms=plain_ms[i], library_ms=None,
                          bound_ms=max(t_ops, t_bytes),
                          bound_by="operations" if t_ops >= t_bytes
                          else "bytes", flops=flops, bytes=nbytes,
                          shape=[R, N, C], heads_local=heads,
                          hidden_local=hidden // TP,
                          whole=not gpt2 and i == 2)
        log(f"kernel {entry} shard mode tp={TP} rank 0 {tag} {(R, N, C)}: "
            f"kernel_ms={ms[i]:.4f} plain_ms={plain_ms[i]:.4f} bound_ms="
            f"{out[entry]['bound_ms']:.4f} ({out[entry]['bound_by']}: "
            f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB), "
            f"{out[entry]['bound_ms'] / ms[i]:.2f} of the bound"
            + (" (the fuser's attention backward runs whole)"
               if out[entry]["whole"] else ""))
    return errs, out


FB_KEYS = ("norm1.weight", "norm1.bias", "attn.qkv.weight", "attn.qkv.bias",
           "attn.proj.weight", "attn.proj.bias", "norm2.weight",
           "norm2.bias", "mlp.mlp.0.weight", "mlp.mlp.0.bias",
           "mlp.mlp.2.weight", "mlp.mlp.2.bias")


def phase_tp_kernels(peaks, gen):
    """The training entries in shard mode (rows 7, 8 and 11-15 at tp = 2;
    row 9 runs whole): the fuser block at R = 4096 rows of 5 tokens, C 1024,
    hidden 4096 and the GPT-2 layer at B = 256 samples of 16 tokens, C 2048,
    4 heads, hidden 8192, in bf16 (timed: rank 0's local work) and in fp32
    at a reduced batch (check_tp_layer); first both off the 8-column grid
    (C 36, 4 heads of 9, hidden 100) in fp32 and bf16. Returns {entry:
    numbers}."""
    import torch
    out = {}
    # off the 8-column grid: C 36, hidden 100 (local 18 / 50 for the GPT-2
    # layer, hidden 50 for the fuser)
    C, H, hidden = WIDTH_CASES[-1]
    for tag, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        check_tp_layer(tag, dt, False, 37, 5, C, H, hidden, gen)
        check_tp_layer(tag, dt, True, 5, 16, C, H, hidden, gen)
    for gpt2, shape, small in ((False, (4096, 5, 1024, 4, 4096), 512),
                               (True, (256, 16, 2048, 4, 8192), 32)):
        R, N, C, H, hidden = shape
        check_tp_layer("fp32", torch.float32, gpt2, small, N, C, H, hidden,
                       gen)
        torch.cuda.empty_cache()
        _, timed = check_tp_layer("bf16", torch.bfloat16, gpt2, R, N, C, H,
                                  hidden, gen, peaks)
        out.update(timed)
        torch.cuda.empty_cache()
    return out


# the entries redesigned on the wgmma / TMA GEMM and the sequence attention:
# their one-call profile by kernel group is printed beside their times, and
# their times back to back
REDESIGNED = ("gpt2_attn_half", "gpt2_mlp_half", "fused_gpt2_train_fwd",
              "fused_block_train_bwd_mlp", "fused_block", "fused_seq_block",
              "fused_block_train_fwd", "fused_gpt2_train_bwd_mlp",
              "fused_gpt2_train_bwd_attn", "fused_attention",
              "fused_attention/decode", "fused_decoder_block",
              "fused_block_train_bwd_attn")
# the entries whose one-call profile must show none of the kernels they ran
# before, and their products on gemm_sm90's (N, K) route (the weight
# gradients on its TN route; KN_PRODUCTS: the (K, N) route too): the fuser
# blocks' serving forward (rows 1, 5, 6) and the fuser's training forward
# (row 7) with their attention on fuser_attention.cuh, the GPT-2 layer's
# backward dX (rows 13 + 14, 15), the attention over separate q, k, v (row 4,
# prefill and decode), and both attention backwards (rows 9, 15) on
# attention_bwd.cuh, which also gives dWproj the forward's output: neither
# the one-warp-per-query backward nor the forward attention again
OFF_PATH = {
    "fused_block": ("gemm_bf16", "small_attention", "strided_attention"),
    "fused_seq_block": ("gemm_bf16", "small_attention", "strided_attention"),
    "fused_block_train_fwd": ("gemm_bf16", "small_attention_drop"),
    "fused_gpt2_train_bwd_mlp": ("gemm_bf16",),
    "fused_gpt2_train_bwd_attn": ("gemm_bf16", "small_attention_drop_bwd",
                                  "staged_attention"),
    "fused_block_train_bwd_attn": ("gemm_bf16", "small_attention_drop_bwd",
                                   "fuser_attention_rows"),
    "fused_attention": ("strided_attention",),
    "fused_attention/decode": ("strided_attention",),
    "fused_decoder_block": ("gemm_bf16", "strided_attention"),
}
# the entries whose products read W as (K, N) too: the fuser's backward dX
KN_PRODUCTS = ("fused_block_train_bwd_attn",)
# kernels an entry's one-call profile must show besides gemm_sm90
SHOWS = {"fused_block_train_bwd_attn": ("attention_bwd",),
         "fused_gpt2_train_bwd_attn": ("attention_bwd",)}
# the entries whose one-call profile may show only these kernel groups
# (prefixes), each of which it must show
ONLY_ON = {
    "fused_attention": ("fuser_attention_seq_mma",),
    "fused_attention/decode": ("fuser_attention_seq_mma",),
    "fused_decoder_block": ("gemm_sm90<", "fuser_attention_seq_mma",
                            "layernorm_rows"),
}
# kernels deleted from the port: no served path's profile, nor the profiled
# training step, may show them
RETIRED = ("gemm_bf16", "strided_attention", "small_attention",
           "small_attention_drop", "small_attention_drop_bwd")


def check_off_path(name, profile):
    """Fail if the one-call profile of ``name`` shows a kernel of its
    OFF_PATH or a product off gemm_sm90's (N, K) route (but for
    KN_PRODUCTS), or (ONLY_ON) a kernel outside its list or not every kernel
    of it; an entry off ONLY_ON must show gemm_sm90 and its SHOWS."""
    groups = profile["groups_ms"]
    bad = [g for g in groups if g.split("<")[0] in OFF_PATH[name]
           or (g.startswith("gemm_sm90<") and "W(N,K)" not in g
               and name not in KN_PRODUCTS)]
    need = ONLY_ON.get(name, ("gemm_sm90<",) + SHOWS.get(name, ()))
    if name in ONLY_ON:
        bad += [g for g in groups if not g.startswith(need) and g not in bad]
    missing = [k for k in need if not any(g.startswith(k) for g in groups)]
    if bad or missing:
        raise AssertionError(f"{name}: one call's profile shows {sorted(groups)}"
                             f"; {bad} are off its path, {missing} missing")
    log(f"kernel {name}: one call launches {sorted(groups)}, none of "
        f"{OFF_PATH[name]}")


def redesigned_numbers(name, shape, kernel, library):
    """A redesigned entry beside its library composition: the one-call
    profile by kernel group, both timed back to back in turns (the host
    enqueues ahead, as a serving or training loop does), and the host's
    time to enqueue one call of each (the wrapper's checks, allocations and
    launches, no synchronisation)."""
    import torch
    with torch.no_grad():
        profile = profile_forward(kernel, what=f"{name} bf16 {shape}")
        b2b = _in_turns({"kernel": kernel, "library": library})
        host = {}
        for key, fn in (("kernel", kernel), ("library", library)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                fn()
            host[key] = (time.perf_counter() - t0) / 50 * 1e3
            torch.cuda.synchronize()
    log(f"kernel {name} bf16 {shape}: back to back (mean of 20, in turns) "
        f"kernel {b2b['kernel']:.4f} ms, library {b2b['library']:.4f} ms; "
        f"device busy of one call {profile['busy_ms']:.4f} ms; host enqueue "
        f"a call: kernel {host['kernel']:.4f} ms, library "
        f"{host['library']:.4f} ms")
    return {"profile": profile, "back_to_back_ms": b2b, "host_ms": host}


def phase_kernels(peaks):
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    with torch.no_grad():
        check_edge_shapes(gen)
        check_width_entries(gen)
    results = {}
    for name, source, replaces, make in KERNEL_CASES:
        numbers = {}
        for tag, dt, size in (("fp32", torch.float32, "small"),
                              ("bf16", torch.bfloat16, "full")):
            case = make(dt, size, gen)
            kernel, plain, library = (case["kernel"], case["plain"],
                                      case["library"])
            with torch.no_grad():
                got = kernel()
                torch.cuda.synchronize()
                want = plain()
            finite, max_abs, rel = errors(got, want)
            ok = finite and rel <= KERNEL_TOL[tag]
            log(f"kernel {name} {tag} shape={case['shape']}: max_abs_err="
                f"{max_abs:.6g} rel_err={rel:.3g} (tol {KERNEL_TOL[tag]:g} "
                f"of max|ref|) finite={finite} -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} {tag} disagrees with its plain "
                                     "version")
            if tag != "bf16":
                continue
            with torch.no_grad():
                ms = time_ms(kernel)
                plain_ms = time_ms(plain, iters=20)
                library_ms = time_ms(library)
            flops, nbytes = case["work"]
            t_ops = flops / peaks["bf16"] * 1e3
            t_bytes = nbytes / peaks["bytes"] * 1e3
            numbers.update(
                max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                flops=flops, bytes=nbytes)
            log(f"kernel {name} bf16 kernel_ms={ms:.4f} plain_ms="
                f"{plain_ms:.4f} library_ms={library_ms:.4f} bound_ms="
                f"{numbers['bound_ms']:.4f} ({numbers['bound_by']}: "
                f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB) "
                f"achieved={flops / ms / 1e9:.1f} TFLOP/s "
                f"{nbytes / ms / 1e6:.1f} GB/s")
            if name in REDESIGNED:
                numbers["redesign"] = redesigned_numbers(
                    name, case["shape"], kernel, library)
                if name in OFF_PATH:
                    check_off_path(name, numbers["redesign"]["profile"])
        if "/" in name:
            main, shape = name.split("/")
            results[main][shape] = numbers
        else:
            results[name] = dict(name=name, route="cuda", source=source,
                                 replaces=replaces, **numbers)
    return results


# -- the build and the GEMM of the GPT-2 entries ------------------------------

# the kernels whose ptxas report the build phase prints
REPORTED_KERNELS = ("gemm_sm90", "gemm_tn_sm90", "sum_slices", "pack_rows",
                    "staged_attention", "fuser_attention", "attention_bwd",
                    "long_attention", "long_attention_mma")
# kernels whose ptxas report must show no spill
NO_SPILL_KERNELS = ("long_attention_mma",)


def report_build(lib_path):
    """ptxas's report of the wgmma / TMA GEMM and the staged, fuser and long
    attentions (registers, shared memory, spills), the compiler's warnings
    and no spill in the tensor-core long route (``NO_SPILL_KERNELS``); fails
    otherwise. The proof that the wgmma path compiled (``start_sass_check``)
    runs beside the phases that follow."""
    import re
    from afft_tpu_torch.ops import _build
    seen = set()
    for src in _build.sources():
        name = os.path.basename(src)
        with open(_build.build_log(name)) as f:
            lines = f.read().splitlines()
        for i, line in enumerate(lines):
            if "warning" in line.lower():
                log(f"build: {name}: {line.strip()}")
            entry = line.split("'")[1] if "Compiling entry" in line else ""
            if any(k in entry for k in REPORTED_KERNELS) and \
                    entry not in seen:
                seen.add(entry)
                props = " ".join(x.strip() for x in lines[i + 2:i + 4])
                log(f"build: ptxas {entry}: {props}")
                spilled = [int(n) for n in re.findall(r"(\d+) bytes spill",
                                                      props)]
                if any(k in entry for k in NO_SPILL_KERNELS) and \
                        (not spilled or any(spilled)):
                    raise AssertionError(f"ptxas: {entry} spills ({props})")
    for kernel in REPORTED_KERNELS:
        if not any(kernel in e for e in seen):
            raise AssertionError(f"no ptxas report of {kernel} in the build "
                                 "log")


def start_sass_check(lib_path):
    """cuobjdump's SASS of the library, started (``_start_run``) to run
    beside the next phases (it takes tens of seconds of one CPU core);
    None where the toolkit has no cuobjdump."""
    import shutil
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cuobjdump = shutil.which("cuobjdump") or os.path.join(home, "bin",
                                                          "cuobjdump")
    if not os.path.exists(cuobjdump):
        log("build: no cuobjdump in the toolkit: the SASS is not checked")
        return None
    return _start_run([cuobjdump, "--dump-sass", lib_path],
                      os.path.dirname(lib_path), "sass")


def finish_sass_check(run, kernels):
    """The proof that the wgmma path compiled: the library's SASS (from
    ``start_sass_check``) holds HGMMA instructions. Fails otherwise. The
    same SASS gives the drop passes' integer bounds (drop_pass_bounds)."""
    if run is None:
        return None
    sass, _ = _finish_run(run, 600)
    drop_pass_bounds(sass, kernels)
    hgmma = sass.count("HGMMA")
    log(f"build: {hgmma} HGMMA (wgmma) instructions in the library's SASS")
    if hgmma == 0:
        raise AssertionError("the library's SASS holds no HGMMA instruction: "
                             "the wgmma path did not compile")
    return hgmma


# (M, N, K) of the GPT-2 entries' products at the flagship shape (B 256,
# T 16, C 2048, hidden 8192): c_attn, c_proj, c_fc, the MLP's c_proj
GEMM_SHAPES = ((4096, 6144, 2048), (4096, 2048, 2048), (4096, 8192, 2048),
               (4096, 2048, 8192))
# the fuser's MLP backward dX products (row 8: R 4096 x 5 tokens, C 1024,
# hidden 4096): dpre1 (gelu_bwd) and dg (fp32 out)
ROW8_SHAPES = ((20480, 4096, 1024), (20480, 1024, 4096))
GEMM_EDGES = ((1, 15, 4097), (72, 136, 6144), (24, 40, 2048))  # M, N, K
# (M, I, J) of the weight gradients: row 8's dW2 (C, hidden) and dW1
# (hidden, C), row 9's dWqkv and dWproj over M 20,480; the GPT-2 layer's
# (rows 13-15) dW_fc, dW_proj (MLP), dW_attn, dW_proj over M 4,096
TN_SHAPES = ((20480, 1024, 4096), (20480, 4096, 1024), (20480, 3072, 1024),
             (20480, 1024, 1024), (4096, 2048, 8192), (4096, 8192, 2048),
             (4096, 2048, 6144), (4096, 2048, 2048))
TN_EDGES = ((1, 15, 4097), (8, 72, 136), (24, 200, 264))  # M, I, J
# the TN route split over M (tn_slices; 4 slices for row 9's dWproj on an
# H100): ragged row counts, each also forced to 2 and 3 slices
TN_SPLIT_EDGES = ((8200, 1024, 1024), (20481, 3072, 1024), (4160, 256, 512))
# the split route against the fp32 product: a sum over up to 20,481 rows in
# fp32 in another order, far inside one bf16 ulp of the largest entry
TN_SPLIT_TOL = 2.0 ** -7
# the rollout's cached GPT-2 block (cuBLAS addmm): prefill and decode rows
CACHED_SHAPES = ((4096, 6144, 2048), (4096, 2048, 2048), (256, 6144, 2048),
                 (256, 2048, 2048))
GEMM_RATES = dict(drop_rate=0.1, dp_rate=0.1, tokens=16, seeds=TRAIN_SEEDS,
                  block_idx=3)
# the fuser blocks' serving products on the (N, K) route (C 1024, hidden
# 4096): (label, N, K, epilogue, variant) at the rows of rows 1 (R 4096 x 5
# tokens) and 5 (B 256 x S 40). proj writes the fp32 residual stream y over
# the bf16 x, fc2 adds y in fp32; the served qkv has no bias.
NK_PRODUCTS = (("qkv", 3072, 1024, "bias", None),
               ("proj", 1024, 1024, "bias_res", "out32"),
               ("fc1", 4096, 1024, "gelu_erf", None),
               ("fc2", 1024, 4096, "bias_res", "res32"))
NK_ROWS = (20480, 10240)
# the training entries' products on the (N, K) route, (label, M, N, K,
# epilogue, variant): row 7's (the fuser's training forward at R 4096 x 5
# tokens; qkv is the serving one's) with dropout, drop-path and the stashes
# of y and pre1, and the GPT-2 layer's backward dX at B 256 x T 16 (C 2048,
# hidden 8192; no bias): rows 13 + 14's dpre1 and dg, row 15's dattn and dxn
NK_TRAIN_PRODUCTS = (
    ("row7 proj", 20480, 1024, 1024, "res_drop", "out32"),
    ("row7 fc1", 20480, 4096, 1024, "pre_gelu", None),
    ("row7 fc2", 20480, 1024, 4096, "res_drop", "res32"),
    ("row13 dpre1", 4096, 8192, 2048, "gelu_tanh_bwd", None),
    ("row14 dg", 4096, 2048, 8192, "bias", "out32"),
    ("row15 dattn", 4096, 2048, 2048, "bias", "out32"),
    ("row15 dxn", 4096, 2048, 6144, "bias", "out32"))
# every (epilogue, variant) the route takes, for the edge shapes
NK_VARIANTS = (("bias", None), ("gelu_erf", None), ("bias_res", None),
               ("bias_res", "out32"), ("bias_res", "res32"),
               ("bias", "out32"), ("pre_gelu", None),
               ("gelu_tanh_bwd", None), ("res_drop", "out32"),
               ("res_drop", "res32"))
# the (N, K) route's dropout: the fuser's training forward, 5 tokens a row
NK_RATES = dict(GEMM_RATES, tokens=5)
# the decoder block's cross stage (row 6, expt 04: B 256 x S 10, C 1024): q,
# k and v (bias) and the cross proj (bias_res, fp32 residual and out, in
# place), each (M, N, K) = (2560, 1024, 1024)
CROSS_SHAPE = (2560, 1024, 1024)
# The deleted wmma GEMM (gemm_bf16) at the cross stage's q / k / v, its last
# caller, in that caller's profile (device time a launch): its last
# readings, commit 6260448, NVIDIA H100 80GB HBM3 at 700 W. The wgmma GEMM
# must keep 2x its rate at the GPT-2 entries' shapes and half its time at
# CROSS_SHAPE.
WMMA_TFLOPS, WMMA_MS = 78.3, 0.0686


def _check_gemm(G, M, N, K, epi, gen, out_dtype=None):
    """One GEMM against the fp32 product of its upcast operands (bf16
    tolerance: 1e-2 of max|ref|, out and out2, the fp32 out too; for
    gelu_bwd the residual is the stashed pre-activation). For res_drop also
    with a zero residual, twice: with the bias shifted by 64 (so no kept
    element is 0) the output's zeros must be the masks' bit for bit; with
    the bias as drawn every dropped element must be 0, and a kept element
    may be 0 only where acc + bias is 0 within the fp32 rounding of the
    K-term sum (bound K * 2^-24 * (sum |a w| + |bias|), from the fp64
    product). A second launch must give out and out2 bit for bit.
    Returns (worst rel_err, kept elements that were 0)."""
    import torch
    rn = _randn(gen, torch.bfloat16)
    a, w, b, r = rn(M, K), rn(K, N, std=K ** -0.5), rn(N, std=0.1), rn(M, N)
    got = G.gemm(a, w, epi, b, r, stash=True, out_dtype=out_dtype,
                 **GEMM_RATES)
    again = G.gemm(a, w, epi, b, r, stash=True, out_dtype=out_dtype,
                   **GEMM_RATES)
    masks = G.drop_masks(M, N, GEMM_RATES["tokens"], TRAIN_SEEDS, 3,
                         GEMM_RATES["drop_rate"], GEMM_RATES["dp_rate"],
                         "cuda") if epi == "res_drop" else None
    want = G.gemm_plain(a, w, epi, b, r, masks, stash=True,
                        out_dtype=out_dtype)
    torch.cuda.synchronize()
    worst, kept_zeros = 0.0, 0
    what = f"gemm {epi} ({M}, {N}, {K})"
    if got[0].dtype != want[0].dtype:
        raise AssertionError(f"{what}: out is {got[0].dtype}, not "
                             f"{want[0].dtype}")
    for which, g, ref in zip(("out", "out2"), got, want):
        if (g is None) != (ref is None):
            raise AssertionError(f"{what}: {which} missing")
        if g is None:
            continue
        finite, _, rel = errors(g, ref)
        worst = max(worst, rel)
        if not (finite and rel <= KERNEL_TOL["bf16"]):
            raise AssertionError(f"{what}: {which} rel_err={rel:.3g} "
                                 f"finite={finite}")
    if not all(torch.equal(g, h) for g, h in zip(got, again)
               if g is not None):
        raise AssertionError(f"{what}: two launches differ")
    if epi == "res_drop":
        dropped = (masks[0] * masks[1]) == 0
        zero = torch.zeros_like(r)
        out, _ = G.gemm(a, w, epi, (b.float() + 64).to(b.dtype), zero,
                        **GEMM_RATES)
        if not torch.equal(out == 0, dropped):
            raise AssertionError(f"{what}: the dropped elements differ from "
                                 "the masks'")
        out, _ = G.gemm(a, w, epi, b, zero, **GEMM_RATES)
        if bool((out[dropped] != 0).any()):
            raise AssertionError(f"{what}: a dropped element is not 0")
        kept = (out == 0) & ~dropped
        kept_zeros = int(kept.sum())
        if kept_zeros:
            a64, w64, b64 = a.double(), w.double(), b.double()
            exact = (a64 @ w64 + b64)[kept].abs()
            bound = (K * 2.0 ** -24) * (a64.abs() @ w64.abs()
                                        + b64.abs())[kept]
            if not bool((exact <= bound).all()):
                raise AssertionError(f"{what}: a kept element is 0 where acc "
                                     "+ bias is not")
            log(f"{what}: with the bias as drawn, {kept_zeros} kept elements "
                f"are 0; at each |acc + bias| (fp64) <= K * 2^-24 * "
                f"(sum |a w| + |bias|); {int((exact == 0).sum())} exactly 0")
            del a64, w64, b64, exact, bound
    return worst, kept_zeros


def _nk_operands(M, N, K, epi, variant, gen, bias=True):
    """Operands of the (N, K) route: a (M, K), w (N, K), the bias, the
    residual (fp32 for ``res32``; for gelu_tanh_bwd the stashed
    pre-activation) and the keywords (an fp32 out for ``out32``; the
    dropout rates and y's stash for res_drop)."""
    import torch
    rn = _randn(gen, torch.bfloat16)
    a, w = rn(M, K), rn(N, K, std=K ** -0.5)
    b = rn(N, std=0.1) if bias else None
    res = None
    if epi in ("bias_res", "res_drop", "gelu_tanh_bwd"):
        res = (torch.randn(M, N, generator=gen, device="cuda")
               if variant == "res32" else rn(M, N))
    kw = dict(out_dtype=torch.float32 if variant == "out32" else None,
              w_in_out=False)
    if epi == "res_drop":
        kw.update(NK_RATES, stash=True)
    return a, w, b, res, kw


def _check_gemm_nk(G, M, N, K, epi, variant, gen, bias=True):
    """The (N, K) route against the fp32 product of its upcast operands
    (1e-2 of max|ref|, out and the stash out2), and a second launch on the
    same operands bit for bit. For res_drop also with a zero residual and
    the bias shifted by 64 (so no kept element is 0): the output's zeros
    must be the masks' bit for bit. Returns the rel_err."""
    import torch
    a, w, b, res, kw = _nk_operands(M, N, K, epi, variant, gen, bias)
    got = G.gemm(a, w, epi, b, res, **kw)
    again = G.gemm(a, w, epi, b, res, **kw)
    masks = None
    if epi == "res_drop":
        masks = G.drop_masks(M, N, NK_RATES["tokens"], TRAIN_SEEDS,
                             NK_RATES["block_idx"], NK_RATES["drop_rate"],
                             NK_RATES["dp_rate"], "cuda")
    want = G.gemm_plain(a, w, epi, b, res, masks,
                        stash=kw.get("stash", False),
                        out_dtype=kw["out_dtype"], w_in_out=False)
    torch.cuda.synchronize()
    what = (f"gemm W(N,K) {epi}{'' if variant is None else ' ' + variant} "
            f"({M}, {N}, {K}){'' if bias else ' no bias'}")
    worst = 0.0
    for which, g, ref in zip(("out", "out2"), got, want):
        if (g is None) != (ref is None):
            raise AssertionError(f"{what}: {which} missing")
        if g is None:
            continue
        finite, _, rel = errors(g, ref)
        worst = max(worst, rel)
        if not (g.dtype == ref.dtype and finite
                and rel <= KERNEL_TOL["bf16"]):
            raise AssertionError(f"{what}: {which} rel_err={rel:.3g} "
                                 f"finite={finite} dtype={g.dtype}")
    if not all(torch.equal(g, h) for g, h in zip(got, again)
               if g is not None):
        raise AssertionError(f"{what}: two launches differ")
    if epi == "res_drop":
        out, _ = G.gemm(a, w, epi, (b.float() + 64).to(b.dtype),
                        torch.zeros_like(res), **kw)
        if not torch.equal(out == 0, (masks[0] * masks[1]) == 0):
            raise AssertionError(f"{what}: the dropped elements differ from "
                                 "the masks'")
    return worst


def _check_gemm_nk_inplace(G, M, N, K, gen):
    """The (N, K) route's bias_res with an fp32 residual and an fp32 out
    written into the residual itself (the decoder block's cross proj, y +=
    cross . Wcproj^T + b) against the fp32 product of its upcast operands
    (1e-2 of max|ref|), and against the same form out of place and a second
    launch on a fresh copy of y, both bit for bit. Returns the rel_err."""
    import torch
    a, w, b, y, kw = _nk_operands(M, N, K, "bias_res", "res32", gen)
    kw["out_dtype"] = torch.float32
    want, _ = G.gemm_plain(a, w, "bias_res", b, y, **kw)
    apart, _ = G.gemm(a, w, "bias_res", b, y, **kw)
    runs = []
    for _ in range(2):
        yy = y.clone()
        got, _ = G.gemm(a, w, "bias_res", b, yy, out=yy, **kw)
        if got.data_ptr() != yy.data_ptr():
            raise AssertionError("gemm: out= was not written in place")
        runs.append(yy)
    torch.cuda.synchronize()
    what = f"gemm W(N,K) bias_res fp32 res and out, in place ({M}, {N}, {K})"
    finite, _, rel = errors(runs[0], want)
    if not (finite and rel <= KERNEL_TOL["bf16"]):
        raise AssertionError(f"{what}: rel_err={rel:.3g} finite={finite}")
    if not (torch.equal(runs[0], runs[1]) and torch.equal(runs[0], apart)):
        raise AssertionError(f"{what}: two launches, or in place and out of "
                             "place, differ")
    return rel


def _check_gemm_tn(G, M, I, J, gen):
    """The TN route (out = a^T . b, fp32) against the fp32 product of its
    upcast operands (1e-2 of max|ref|), and a second launch on the same
    operands bit for bit. Returns the rel_err."""
    import torch
    rn = _randn(gen, torch.bfloat16)
    a, b = rn(M, I), rn(M, J)
    got, again = G.gemm_tn(a, b), G.gemm_tn(a, b)
    want = G.gemm_tn_plain(a, b)
    torch.cuda.synchronize()
    what = f"gemm_tn (M, I, J)=({M}, {I}, {J})"
    finite, _, rel = errors(got, want)
    if not (got.dtype == torch.float32 and finite
            and rel <= KERNEL_TOL["bf16"]):
        raise AssertionError(f"{what}: rel_err={rel:.3g} finite={finite} "
                             f"dtype={got.dtype}")
    if not torch.equal(got, again):
        raise AssertionError(f"{what}: two launches differ")
    return rel


def _check_tn_split(G, M, I, J, slices, gen):
    """The TN route over ``slices`` slices of M against the fp32 product
    (TN_SPLIT_TOL of max|ref|), bit for bit on a second launch. Returns the
    rel_err."""
    import torch
    rn = _randn(gen, torch.bfloat16)
    a, b = rn(M, I), rn(M, J)
    got, again = (G.gemm_tn(a, b, slices=slices) for _ in range(2))
    want = G.gemm_tn_plain(a, b)
    torch.cuda.synchronize()
    what = f"gemm_tn (M, I, J)=({M}, {I}, {J}) over {slices} slices"
    finite, _, rel = errors(got, want)
    if not (finite and rel <= TN_SPLIT_TOL):
        raise AssertionError(f"{what}: rel_err={rel:.3g} finite={finite}")
    if not torch.equal(got, again):
        raise AssertionError(f"{what}: two launches differ")
    return rel


def _in_turns(fns, iters=20):
    """Each callable's mean ms over ``iters`` back-to-back calls, timed in
    the order a, b, ..., ..., b, a; the mean of its two turns."""
    import torch
    times = {k: [] for k in fns}
    for k in list(fns) + list(fns)[::-1]:
        fn = fns[k]
        for _ in range(3):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times[k].append(start.elapsed_time(end) / iters)
    return {k: sum(v) / len(v) for k, v in times.items()}


def _device_ms(fn, calls=20, what="a timed call"):
    """The device's time a call of ``fn``: every kernel it launches in
    ``calls`` calls, summed (torch.profiler), over ``calls``. A trace that
    comes back without its device events (see ``profile_forward``) is
    taken again after a short pause, up to ``PROFILE_ATTEMPTS`` times in
    all; after the last empty one the calls are timed with CUDA events
    instead (launch gaps included), and the log says so."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        for attempt in range(PROFILE_ATTEMPTS):
            if attempt:
                time.sleep(0.5 * attempt)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            us = [e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
            if us:
                return sum(us) / calls / 1e3
            log(f"device ms: {what}: the trace holds no device events "
                f"(attempt {attempt + 1} of {PROFILE_ATTEMPTS})")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
    ms = start.elapsed_time(end) / calls
    log(f"device ms: {what}: timed with CUDA events instead: {ms:.4f} ms")
    return ms


def _time_gemm_rows(peaks, label, shapes, fns_of, extra=None,
                    extra_label=None):
    """Each shape's callables timed in turns: ms, TFLOP/s and share of the
    bf16 peak, logged and returned by row."""
    import torch
    rows = {}
    for shape in shapes:
        ms = _in_turns(fns_of(*shape))
        if extra and shape in extra:
            ms[extra_label] = extra[shape]
        M, N, K = shape
        flops = 2 * M * N * K
        rate = {k: flops / v / 1e9 for k, v in ms.items()}
        rows[f"{label} {shape}"] = {
            "ms": ms, "tflops": rate,
            "share_of_peak": {k: v * 1e12 / peaks["bf16"]
                              for k, v in rate.items()}}
        log(f"gemm {label} bf16 {shape}: " + ", ".join(
            f"{k} {ms[k]:.4f} ms {rate[k]:.1f} TFLOP/s "
            f"({rate[k] * 1e12 / peaks['bf16']:.1%} of 989)" for k in ms))
        torch.cuda.empty_cache()
    return rows


def phase_gemm(peaks, gen):
    """The wgmma / TMA GEMM: checks at the entries' and edge shapes for its
    six (K, N) epilogues and the fp32 output, its (N, K) route's serving and
    training epilogues (and the decoder block's cross proj, bias_res with an
    fp32 residual and out, in place), and its TN route; then their rates
    beside the library's in one call, held to the deleted wmma GEMM's last
    readings. Returns the numbers."""
    import itertools
    import torch
    from afft_tpu_torch.ops import gemm as G
    n, worst, kept_zeros = 0, 0.0, {}
    shapes = (list(GEMM_SHAPES) + list(ROW8_SHAPES)
              + list(itertools.product(*GEMM_EDGES)))
    variants = [(epi, None) for epi in G.ROUTE_EPILOGUES[True]] + [
        ("bias", torch.float32)]
    for (M, N, K), (epi, out_dtype) in itertools.product(shapes, variants):
        rel, zeros = _check_gemm(G, M, N, K, epi, gen, out_dtype)
        worst = max(worst, rel)
        if zeros:
            kept_zeros[f"({M}, {N}, {K})"] = zeros
        n += 1
    tn_worst, n_tn = 0.0, 0
    for M, I, J in list(TN_SHAPES) + list(itertools.product(*TN_EDGES)):
        tn_worst = max(tn_worst, _check_gemm_tn(G, M, I, J, gen))
        n_tn += 1
    # the split over M: the slices each training shape takes, then every
    # split form at the shapes that split and at ragged edges
    tn_slices = {f"({M}, {I}, {J})": G.tn_slices(I, J, M, "cuda")
                 for M, I, J in TN_SHAPES}
    split_worst, n_split = 0.0, 0
    for M, I, J in [sh for sh in TN_SHAPES
                    if G.tn_slices(sh[1], sh[2], sh[0], "cuda") > 1] \
            + list(TN_SPLIT_EDGES):
        for slices in sorted({G.tn_slices(I, J, M, "cuda"), 2, 3}):
            split_worst = max(split_worst,
                              _check_tn_split(G, M, I, J, slices, gen))
            n_split += 1
    log(f"gemm: the TN route's slices over M by (M, I, J): {tn_slices}; "
        f"{n_split} split checks against the fp32 product (worst rel_err "
        f"{split_worst:.3g}, tol {TN_SPLIT_TOL:g} of max|ref|), each bit "
        "for bit on a second launch")
    nk_worst, n_nk = 0.0, 0
    nk_cases = [(M, N, K, epi, variant, label != "qkv")
                for M in NK_ROWS
                for label, N, K, epi, variant in NK_PRODUCTS]
    nk_cases += [(M, N, K, epi, variant, label.startswith("row7"))
                 for label, M, N, K, epi, variant in NK_TRAIN_PRODUCTS]
    nk_cases += [(M, N, K, epi, variant, True)
                 for (M, N, K), (epi, variant) in itertools.product(
                     itertools.product(*GEMM_EDGES), NK_VARIANTS)]
    for M, N, K, epi, variant, bias in nk_cases:
        nk_worst = max(nk_worst, _check_gemm_nk(G, M, N, K, epi, variant,
                                                gen, bias))
        n_nk += 1
    ip_worst, n_ip = 0.0, 0
    for M, N, K in [CROSS_SHAPE] + list(itertools.product(*GEMM_EDGES)):
        ip_worst = max(ip_worst, _check_gemm_nk_inplace(G, M, N, K, gen))
        n_ip += 1
    log(f"gemm: {n} checks of C = A . W (6 epilogues + the fp32 out), "
        f"{n_nk} of the (N, K) route ({len(NK_VARIANTS)} epilogue forms: "
        "bias with a bf16 / fp32 out, gelu_erf, pre_gelu, gelu_tanh_bwd, "
        "bias_res and res_drop with a bf16 / fp32 residual and out), "
        f"{n_ip} of its bias_res with an fp32 residual and out in place, and "
        f"{n_tn} of the TN route against the "
        f"fp32 product agree (worst rel_err {worst:.3g}, {nk_worst:.3g}, "
        f"{ip_worst:.3g} and {tn_worst:.3g}, tol {KERNEL_TOL['bf16']:g} of "
        "max|ref|; res_drop masks bit for bit; the (N, K) and TN routes bit "
        "for bit from launch to launch, in place as out of place)")
    width_checks, width_worst, width_packs = _check_gemm_widths(G, gen)
    pack_rows = _pack_rows_numbers(G, peaks, gen)
    torch.cuda.empty_cache()

    rn = _randn(gen, torch.bfloat16)

    def kn(yardstick, epi="bias", out_dtype=None):
        # the fuser's dX products (gelu_bwd, the fp32 out) take no bias
        def fns(M, N, K):
            a, w, b = rn(M, K), rn(K, N, std=K ** -0.5), rn(N, std=0.1)
            r = rn(M, N) if epi == "gelu_bwd" else None
            bias = b if epi == "bias" and out_dtype is None else None
            lib = ((lambda: a @ w) if yardstick == "matmul"
                   else (lambda: torch.addmm(b, a, w)))
            return {"sm90": lambda: G.gemm(a, w, epi, bias, r,
                                           out_dtype=out_dtype),
                    yardstick: lib}
        return fns

    def tn(M, I, J):
        a, b = rn(M, I), rn(M, J)
        # as the slice rule says, whole, and in four slices of M (what the
        # rule declines for every shape but row 9's dWproj)
        return {"sm90": lambda: G.gemm_tn(a, b),
                "sm90 one slice": lambda: G.gemm_tn(a, b, slices=1),
                "sm90 4 slices": lambda: G.gemm_tn(a, b, slices=4),
                "matmul (a.t() @ b, bf16 out)": lambda: a.t() @ b}

    def nk(epi, variant, bias):
        def fns(M, N, K):
            a, w, b, res, kw = _nk_operands(M, N, K, epi, variant, gen, bias)
            return {"sm90 W(N,K)": lambda: G.gemm(a, w, epi, b, res, **kw),
                    "matmul (a @ w.t())": lambda: a @ w.t()}
        return fns

    rows = _time_gemm_rows(peaks, "entries", GEMM_SHAPES, kn("matmul"))
    for label, N, K, epi, variant in NK_PRODUCTS:
        rows.update(_time_gemm_rows(
            peaks, f"nk {label} {epi}{'' if variant is None else ' ' + variant}",
            [(M, N, K) for M in NK_ROWS], nk(epi, variant, label != "qkv")))
    for label, M, N, K, epi, variant in NK_TRAIN_PRODUCTS:
        rows.update(_time_gemm_rows(
            peaks, f"nk {label} {epi}{'' if variant is None else ' ' + variant}",
            [(M, N, K)], nk(epi, variant, label.startswith("row7"))))
    # at the cross stage's shape a launch takes less device time than the
    # host needs to launch one, so every column there is the device's time a
    # call (torch.profiler)
    a, w, b, y, kw = _nk_operands(*CROSS_SHAPE, "bias_res", "res32", gen)
    kw["out_dtype"] = torch.float32
    cross_fns = {
        "q/k/v bias": nk("bias", None, True)(*CROSS_SHAPE),
        "proj bias_res fp32 res and out, in place": {
            "sm90 W(N,K)": lambda: G.gemm(a, w, "bias_res", b, y, out=y,
                                          **kw),
            "matmul (a @ w.t())": lambda: a @ w.t()}}
    flops = 2 * CROSS_SHAPE[0] * CROSS_SHAPE[1] * CROSS_SHAPE[2]
    for label, fns in cross_fns.items():
        ms = {k: _device_ms(fn) for k, fn in fns.items()}
        rate = {k: flops / v / 1e9 for k, v in ms.items()}
        rows[f"nk cross {label} {CROSS_SHAPE}"] = {
            "ms": ms, "tflops": rate, "device_time": True,
            "share_of_peak": {k: v * 1e12 / peaks["bf16"]
                              for k, v in rate.items()}}
        log(f"gemm nk cross {label} bf16 {CROSS_SHAPE}, device ms a call: "
            + ", ".join(f"{k} {ms[k]:.4f} ms {rate[k]:.1f} TFLOP/s"
                        for k in ms))
    del a, w, b, y
    rows.update(_time_gemm_rows(peaks, "cached_block", CACHED_SHAPES,
                                kn("addmm")))
    rows.update(_time_gemm_rows(peaks, "row8 dpre1 gelu_bwd",
                                ROW8_SHAPES[:1], kn("matmul", "gelu_bwd")))
    rows.update(_time_gemm_rows(peaks, "row8 dg fp32 out", ROW8_SHAPES[1:],
                                kn("matmul", "bias", torch.float32)))
    rows.update(_time_gemm_rows(
        peaks, "tn (I, J, M)", [(I, J, M) for M, I, J in TN_SHAPES],
        lambda I, J, M: tn(M, I, J)))
    # held to the deleted wmma GEMM's last readings (WMMA_TFLOPS, WMMA_MS)
    for shape in ((4096, 6144, 2048), (4096, 8192, 2048)):
        new = rows[f"entries {shape}"]["tflops"]["sm90"]
        if not new >= 2 * WMMA_TFLOPS:
            raise AssertionError(f"gemm: {new:.1f} TFLOP/s at {shape}, not "
                                 f"2x the wmma GEMM's {WMMA_TFLOPS}")
    cross = rows[f"nk cross q/k/v bias {CROSS_SHAPE}"]["ms"]["sm90 W(N,K)"]
    if not cross <= WMMA_MS / 2:
        raise AssertionError(f"gemm: the (N, K) route takes {cross:.4f} ms "
                             f"at {CROSS_SHAPE}, not half of the wmma "
                             f"GEMM's {WMMA_MS}")
    # the rollout's cached block stays on addmm: gemm_sm90's speed there
    cached = {str(shape): rows[f"cached_block {shape}"]["ms"]["addmm"]
              / rows[f"cached_block {shape}"]["ms"]["sm90"]
              for shape in CACHED_SHAPES}
    log(f"gemm cached_block: gemm_sm90 runs at {cached} of addmm's speed "
        "(addmm ms / sm90 ms)")
    return {"checks": n, "tn_checks": n_tn, "nk_checks": n_nk,
            "worst_rel_err": worst, "tn_worst_rel_err": tn_worst,
            "tn_slices": tn_slices, "tn_split_checks": n_split,
            "tn_split_worst_rel_err": split_worst,
            "nk_worst_rel_err": nk_worst, "res_drop_kept_zeros": kept_zeros,
            "inplace_checks": n_ip, "inplace_worst_rel_err": ip_worst,
            "width_checks": width_checks,
            "width_worst_rel_err": width_worst,
            "width_pack_launches": width_packs, "pack_rows": pack_rows,
            "wmma_floor": {"tflops": WMMA_TFLOPS, "ms": WMMA_MS},
            "cached_block_sm90_over_addmm": cached,
            "timings": rows}


# -- the main path ------------------------------------------------------------

def profile_forward(fn, what="one bf16 forward", grad=False, want=None):
    """Device ms by kernel group over one call of ``fn`` (torch.profiler),
    the device's busy share of the call's host wall time, and the call's
    launches of each afft kernel (``kernels``, by full name). The profiler
    now and then hands back a trace without its device events, or without
    some of them; such a call is traced again after a pause that grows with
    each attempt, up to ``PROFILE_ATTEMPTS`` times in all, and the last
    such trace fails. A trace counts as whole when it holds device events
    and, where ``want`` ({afft kernel name: launches}) is given, its afft
    kernels are exactly ``want``."""
    import re
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    attempts = PROFILE_ATTEMPTS
    for attempt in range(attempts):
        if attempt:
            time.sleep(0.5 * attempt)
        with torch.set_grad_enabled(grad), profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        # device work only: a record_function range (the optimizer's step)
        # is mirrored on the device timeline and would count its kernels
        # twice
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and "#" not in e.name]
        counts = {}
        for e in kernels:
            if "afft::" in e.name:
                counts[e.name] = counts.get(e.name, 0) + 1
        if kernels and (want is None or counts == want):
            break
        if kernels:
            lost = {k[:60]: n - counts.get(k, 0) for k, n in want.items()
                    if counts.get(k, 0) != n}
            log(f"profile: {what}: the trace's afft kernels are "
                f"{sum(counts.values())} launches, not the "
                f"{sum(want.values())} wanted; short by {lost}, names not "
                f"wanted {[k[:60] for k in counts if k not in want]} "
                f"(attempt {attempt + 1} of {attempts})")
        else:
            log(f"profile: {what}: the trace holds no device events "
                f"(attempt {attempt + 1} of {attempts})")
    else:
        raise RuntimeError(f"{what}: no whole trace from the profiler")
    groups, names = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        # gemm_sm90<EPI, B_NK, TRes, TOut>: the wgmma / TMA GEMM, W read as
        # (K, N) (the GPT-2 entries' forward products, the fuser's dX
        # products) or, named W(N,K), as (N, K) (the fuser blocks' forward
        # products, the GPT-2 layer's dX products); EPI 0 bias, 1 bias +
        # residual, 2 exact GELU, 3 gelu_new, 4 residual + dropout +
        # drop-path, 5 stash + GELU, 6 GELU backward, 7 / 8 the same two
        # with gelu_new; gemm_tn_sm90: its TN route, the weight gradients.
        # An fp32 TRes / TOut is named in the group. A kernel of the fp32
        # path (gemm_f32<EPI, ...>) is grouped the same way.
        m = re.search(r"afft::(\w+)(?:<([^()]*)>)?\(", e.name)
        args = [] if m is None or m.group(2) is None else [
            a.strip() for a in m.group(2).split(",")]
        if m is None:
            group = "other (PyTorch ops)"
        elif not args or not args[0].isdigit() or \
                not m.group(1).startswith("gemm"):
            group = m.group(1)
        else:
            out = ", fp32 out" if args[-1] == "float" else ""
            if m.group(1) == "gemm_sm90":  # <EPI, B_NK, TRes, TOut>
                out = (", W(N,K)" if args[1] == "true" else "") + (
                    ", fp32 res" if args[2] == "float" else "") + out
            group = f"{m.group(1)}<epi {args[0]}{out}>"
        groups[group] = groups.get(group, 0.0) + us
        names[e.name[:80]] = names.get(e.name[:80], 0.0) + us
    busy = sum(groups.values())
    log(f"profile: {what}, device busy {busy / 1e3:.3f} ms of "
        f"{wall_us / 1e3:.3f} ms host wall (busy share "
        f"{busy / wall_us:.3f}, profiler on)")
    for group, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"profile:   {us / 1e3:9.3f} ms  {us / busy:6.1%}  {group}")
    other = sorted(((n, us) for n, us in names.items() if "afft::" not in n),
                   key=lambda kv: -kv[1])[:6]
    for n, us in other:
        log(f"profile:     other {us / 1e3:8.3f} ms  {n}")
    return {"busy_ms": busy / 1e3, "wall_ms": wall_us / 1e3,
            "busy_share": busy / wall_us,
            "groups_ms": {g: us / 1e3 for g, us in groups.items()},
            "kernels": counts}


def top1_report(logits, plain, need_decided=True):
    """The three-part bf16 top-1 form on (rows, classes) logits: agreement
    on the rows whose plain top-1 leads by more than 2 bf16 ulps, the kernel
    path's pick within 2 ulps of the plain top-1 on every row, and (with
    ``need_decided``) enough decided rows. Returns (ok, text)."""
    import torch
    agree = logits.argmax(-1) == plain.argmax(-1)
    # the logits are bf16 values: a row whose plain top-1 leads its top-2
    # by at most 2 ulps of the top logit is a tie at the output's own
    # resolution, where either answer is right
    top2 = plain.topk(2, dim=-1).values
    ulp = torch.exp2(torch.floor(torch.log2(top2[:, 0].abs())) - 7)
    margin = top2[:, 0] - top2[:, 1]
    decided = margin > 2 * ulp
    top1_all = agree.float().mean().item()
    top1_decided = agree[decided].float().mean().item()
    picked = plain.gather(1, logits.argmax(-1, keepdim=True))[:, 0]
    top1_tied = (picked >= top2[:, 0] - 2 * ulp).float().mean().item()
    rows = len(plain)
    text = (f"top1_agree all rows={top1_all:.4f}, {int(decided.sum())} of "
            f"{rows} rows with a top-1 margin > 2 bf16 ulps="
            f"{top1_decided:.4f} (>= 0.99), all rows up to a 2-ulp tie="
            f"{top1_tied:.4f} (>= 0.99); ties within 1 ulp: "
            f"{int((margin <= ulp).sum())}, within 2 ulps: "
            f"{int((~decided).sum())}")
    ok = ((top1_decided >= 0.99 or not decided.any()) and top1_tied >= 0.99
          and (int(decided.sum()) >= rows // 2 or not need_decided))
    return ok, text


# label, expt file, overrides, kernel launches one forward must make as a
# function of (fuser depth, GPT-2 layers, modalities); every other kernel's
# count must be 0
SERVED_PATHS = [
    ("flagship", "01_SA-Fuser_ek100_val_Swin.txt", [],
     lambda d, n, m: {"fused_block": d, "gpt2_attn_half": n,
                      "gpt2_mlp_half": n}),
    # the KV cache: a prefill and ROLLOUT_LEN - 1 decode steps, each one
    # fused_attention a layer; the cached block uses no GPT-2 kernel
    ("rollout", "01_SA-Fuser_ek100_val_Swin.txt",
     [f"model.common.fp_output_len={ROLLOUT_LEN}"],
     lambda d, n, m: {"fused_block": d, "fused_attention": n * ROLLOUT_LEN}),
    ("expt02_sa_wo_token", "02_SA-Fuser_wo_token_ek100_train.txt", [],
     lambda d, n, m: {"fused_block": d, "gpt2_attn_half": n,
                      "gpt2_mlp_half": n}),
    ("expt03_t_sa", "03_T-SA-Fuser_ek100_train.txt", [],
     lambda d, n, m: {"fused_seq_block": d, "gpt2_attn_half": n,
                      "gpt2_mlp_half": n}),
    ("expt04_ca", "04_CA-Fuser_ek100_train.txt", [],
     lambda d, n, m: {"fused_decoder_block": m - 1, "gpt2_attn_half": n,
                      "gpt2_mlp_half": n}),
]


def serve_path(label, expt, overrides, expected_fn):
    """Drive one served path at full width and hold it against the plain
    path; returns (launches of its one counted run, its numbers)."""
    import torch
    from afft_tpu_torch import serve
    from afft_tpu_torch.ops import launch_counts, reset_launches

    cfg = serve.load_config(os.path.join(EXPTS, expt), overrides)
    num_classes = {"action": 3806}
    modal_dims = {m: int(d) for m, d in
                  cfg.model.modal_dims.to_container().items()}
    T = int(cfg.data_eval.num_frames)
    out_len = int(cfg.model.common.fp_output_len)
    t0 = time.perf_counter()
    server = serve.Server(cfg, num_classes, "bfloat16", "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in server.model.parameters())
    cmfp = server.model.future_predictor
    fuser = getattr(cmfp, "fuser", None)
    log(f"serve {label}: {expt} {overrides} built in "
        f"{time.perf_counter() - t0:.2f} s, {type(cmfp).__name__} + "
        f"{type(fuser).__name__}, {len(cmfp.predictors())} predictor(s), "
        f"{n_params / 1e6:.1f} M params, T={T}, output_len={out_len}, bf16, "
        f"weights {server.weights_source}")
    requests = serve.random_requests(modal_dims, T, SERVE_BATCH,
                                     SERVE_REQUESTS)

    # the main path: counts set to 0 just before, read just after
    reset_launches()
    answers = server.answer(requests)
    torch.cuda.synchronize()
    launches = launch_counts()
    expected = dict.fromkeys(launches, 0)
    expected.update(expected_fn(len(getattr(fuser, "blocks", ())),
                                int(cfg.model.common.fp_layers),
                                len(modal_dims)))
    log(f"serve {label}: {len(answers)} requests answered, launches "
        f"{launches} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"{label}: the serving forward did not run "
                             "every kernel the expected number of times")
    if len(answers) != SERVE_REQUESTS:
        raise AssertionError("wrong number of answers")
    for (values, indices), req in zip(answers, requests):
        b = len(next(iter(req.values())))
        shape = (b, 5) if out_len == 1 else (b, out_len, 5)
        if values.shape != shape or indices.shape != shape:
            raise AssertionError(f"answer shape {tuple(values.shape)}, "
                                 f"expected {shape}")
        if not bool(values.isfinite().all()):
            raise AssertionError("non-finite top-k scores")
        if int(indices.min()) < 0 or int(indices.max()) >= 3806:
            raise AssertionError("class index out of range")

    def rows(lg):  # every anticipated step is a row of its own
        return lg.reshape(-1, lg.shape[-1])

    host_feats = {m: torch.cat([r[m] for r in requests]) for m in requests[0]}
    feats = server.to_device(host_feats)
    with torch.no_grad():
        logits = rows(server.head_logits(server.model(feats)))
        plain = rows(server.head_logits(server.model(feats, impl="plain")))
    torch.cuda.synchronize()
    finite = bool(logits.isfinite().all())
    max_abs = (logits - plain).abs().max().item()
    scale = plain.abs().max().item()
    # bf16: ~40 rounded layers between the features and the logits, each of
    # which may flip a bf16 rounding by one ulp (2^-8 relative); the logits
    # themselves are a bf16 GEMM output. Bound: 5e-2 of max|logit|.
    tol_bf16 = 5e-2 * scale
    top1_ok, top1_text = top1_report(logits, plain)
    log(f"serve {label} bf16 B={SERVE_BATCH}: logits finite={finite} "
        f"max_abs_diff={max_abs:.6g} (tol {tol_bf16:.6g} = 5e-2 * "
        f"max|logit| {scale:.4g}); {top1_text}")
    bf16_ok = finite and max_abs <= tol_bf16 and top1_ok

    # throughput: the whole answer (host features in, top-k out), and the
    # model's forward on device-resident features
    with torch.no_grad():
        for _ in range(3):
            server.answer(requests)
        torch.cuda.synchronize()
        iters = 10
        t0 = time.perf_counter()
        for _ in range(iters):
            server.answer(requests)
        torch.cuda.synchronize()
        answer_ms = (time.perf_counter() - t0) / iters * 1e3
        forward_ms = time_ms(lambda: server.model(feats), iters=10)
    clips_s = SERVE_BATCH / answer_ms * 1e3
    log(f"serve {label} bf16 B={SERVE_BATCH}: answer_ms_per_batch="
        f"{answer_ms:.3f} clips_per_s={clips_s:.1f} "
        f"forward_ms_on_device_feats={forward_ms:.3f} forward_clips_per_s="
        f"{SERVE_BATCH / forward_ms * 1e3:.1f} peak_mem_GB="
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    profile = profile_forward(lambda: server.model(feats))
    retired = [g for g in profile["groups_ms"] if g.split("<")[0] in RETIRED]
    if retired:
        raise AssertionError(f"{label}: one forward launches {retired}, "
                             "kernels the port no longer has")
    del server, feats

    # witness for the bf16 top-1 flips: the same weights (the bf16 model is
    # the seeded fp32 init, rounded) and clips through the plain path in
    # fp32. If the kernel path's flips are bf16 rounding at near-ties, the
    # plain path in bf16 flips against this reference about as often, and
    # its logits lie about as far from it.
    server = serve.Server(cfg, num_classes, "float32", "cuda")
    with torch.no_grad():
        ref = rows(server.head_logits(server.model(
            server.to_device(host_feats), impl="plain")))
    top1 = {"kernel_bf16": logits.argmax(-1), "plain_bf16": plain.argmax(-1),
            "ref": ref.argmax(-1)}
    witness = {path: {"top1_flip": (top1[path] != top1["ref"]).float()
                      .mean().item(),
                      "rms_err": (lg - ref).square().mean().sqrt().item(),
                      "max_abs_err": (lg - ref).abs().max().item()}
               for path, lg in (("kernel_bf16", logits),
                                ("plain_bf16", plain))}
    split = top1["kernel_bf16"] != top1["plain_bf16"]
    sides = {path: int((split & (top1["ref"] == top1[path])).sum())
             for path in ("kernel_bf16", "plain_bf16")}
    # 0.03: about two standard errors of the difference of two flip rates
    # near 4% over 256 clips
    log(f"serve {label} bf16 B={SERVE_BATCH} witness, against the plain "
        f"path in fp32 (top-1 flips: kernel <= plain + 0.03): "
        f"{json.dumps(witness)}; of the {int(split.sum())} rows where "
        f"kernel and plain bf16 differ, fp32 sides with {sides}")
    bf16_ok = bf16_ok and (witness["kernel_bf16"]["top1_flip"]
                           <= witness["plain_bf16"]["top1_flip"] + 0.03)

    # fp32 at a reduced batch: only the summation order differs
    small = serve.random_requests(modal_dims, T, FP32_BATCH, 1, seed=1)[0]
    feats = server.to_device(small)
    with torch.no_grad():
        logits = rows(server.head_logits(server.model(feats)))
        plain = rows(server.head_logits(server.model(feats, impl="plain")))
    max_abs = (logits - plain).abs().max().item()
    scale = plain.abs().max().item()
    top1 = (logits.argmax(-1) == plain.argmax(-1)).float().mean().item()
    tol_fp32 = 1e-4 * scale
    log(f"serve {label} fp32 B={FP32_BATCH}: max_abs_diff={max_abs:.6g} "
        f"(tol {tol_fp32:.6g} = 1e-4 * max|logit| {scale:.4g}) top1_agree="
        f"{top1:.4f}")
    if not (bool(logits.isfinite().all()) and max_abs <= tol_fp32):
        raise AssertionError(f"{label}: fp32 serving disagrees with the "
                             "plain path")
    if out_len > 1:
        # the KV-cache rollout against the full re-run of every step on the
        # plain path, which a model built with fp_output_attentions takes
        rerun_cfg = serve.load_config(
            os.path.join(EXPTS, expt),
            overrides + ["model.common.fp_output_attentions=true"])
        rerun = serve.Server(rerun_cfg, num_classes, "float32", "cuda",
                             weights=server.model.state_dict())
        with torch.no_grad():
            full = rows(rerun.head_logits(rerun.model(feats, impl="plain")))
        del rerun
        max_abs = (logits - full).abs().max().item()
        log(f"serve {label} fp32 B={FP32_BATCH}: rollout vs the plain full "
            f"re-run max_abs_diff={max_abs:.6g} (tol {tol_fp32:.6g})")
        if not max_abs <= tol_fp32:
            raise AssertionError(f"{label}: the KV-cache rollout disagrees "
                                 "with the full re-run")
    if not bf16_ok:
        raise AssertionError(f"{label}: bf16 serving disagrees with the "
                             "plain path")
    return launches, {"answer_ms": answer_ms, "clips_per_s": clips_s,
                      "forward_ms": forward_ms,
                      "bf16_vs_fp32": witness,
                      "profile": profile}


def phase_serve():
    """Every served path in turn; returns ({kernel: launches on the path
    that runs it}, {path: numbers})."""
    import torch
    launches, numbers = {}, {}
    for label, expt, overrides, expected_fn in SERVED_PATHS:
        counted, numbers[label] = serve_path(label, expt, overrides,
                                             expected_fn)
        for name, n in counted.items():
            # a kernel's count comes from the first path that launches it
            if n and name not in launches:
                launches[name] = n
        torch.cuda.empty_cache()
    return launches, numbers


# -- the training path --------------------------------------------------------

TRAIN_EXPT = "01_SA-Fuser_ek100_train.txt"
TRAIN_CLASSES = {"action": 3806, "verb": 97, "noun": 300}
TRAIN_BATCH = 256
TRAIN_STEPS = 20
TRAIN_DISTINCT_BATCHES = 8


def synthetic_batches(cfg, batch, n, seed, classes=TRAIN_CLASSES):
    """``n`` distinct training batches of the expt's shape on the card:
    N(0, 1) features of each modality over its frames, action / verb / noun
    targets, per-frame past targets (a tenth of the rows carry ignored
    frames and are left out of the mixup, as in the real data)."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    T = int(cfg.data_train.num_frames)
    dims = {m: int(d) for m, d in cfg.model.modal_dims.to_container().items()}
    out = []
    for _ in range(n):
        sub = {t: torch.randint(0, c, (batch, T, 1), generator=gen,
                                device="cuda")
               for t, c in classes.items()}
        ignored = torch.rand(batch, generator=gen, device="cuda") < 0.1
        for t in sub:
            sub[t][ignored, :4] = -1
        out.append({
            "data_dict": {m: torch.randn(batch, T, d, generator=gen,
                                         device="cuda")
                          for m, d in dims.items()},
            "target": {t: torch.randint(0, c, (batch,), generator=gen,
                                        device="cuda")
                       for t, c in classes.items()},
            "target_subclips": sub})
    return out


def phase_train():
    """The flagship training step through ``Runner.train_step``; returns
    (launches of the twenty bf16 steps alone, numbers). The fp32 runs
    through the kernels and through the plain versions are counted each on
    its own and reported in the numbers, never merged into the former."""
    import torch
    from afft_tpu_torch import serve
    from afft_tpu_torch.ops import launch_counts, reset_launches
    from afft_tpu_torch.train.runner import Runner

    cfg = serve.load_config(os.path.join(EXPTS, TRAIN_EXPT))
    depth, layers = int(cfg.model.fuser.depth), int(cfg.model.common.fp_layers)
    train_names = [n for n, _ in TRAIN_KERNELS["fused_block_train"][:3]]
    gpt2_names = [n for n, _ in TRAIN_KERNELS["fused_gpt2_train"][:3]]
    # the lr of the iterations after the warmup (with one iteration an
    # epoch the expt's 20 warmup epochs are 20 iterations): the base lr
    # 1e-3 on its way down the cosine
    warmup = int(cfg.opt.warmup.num_epochs)

    # (a) fp32: the kernels against their plain versions, same masks
    t0 = time.perf_counter()
    kernel = Runner.from_config(cfg, TRAIN_CLASSES, device="cuda",
                                iters_per_epoch=1, compute_dtype="float32")
    plain = Runner.from_config(cfg, TRAIN_CLASSES, device="cuda",
                               iters_per_epoch=1, compute_dtype="float32",
                               impl="plain",
                               weights=kernel.model.state_dict())
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in kernel.model.parameters())
    fuser = kernel.model.future_predictor.fuser
    log(f"train: {TRAIN_EXPT} built twice in {time.perf_counter() - t0:.2f} "
        f"s, {n_params / 1e6:.1f} M params, optimizer "
        f"{type(kernel.optimizer).__name__} nesterov="
        f"{kernel.optimizer.defaults['nesterov']}, mixup alpha "
        f"{kernel.mixup.alpha}, fuser dropout {fuser.drop_rate} / "
        f"{fuser.attn_drop_rate}, drop-path up to {fuser.dpr[-1]}, seeded "
        f"random weights")
    batches = synthetic_batches(cfg, FP32_BATCH, 3, seed=1)
    fp32 = {}
    zero = dict.fromkeys(launch_counts(), 0)
    # each run is counted on its own: the kernel run launches the training
    # entries of the fuser blocks (7-9) and of the GPT-2 layers (11-15) and
    # never a mask kernel, the plain run launches the mask kernels alone
    for key, run, expected in (
            ("kernel", kernel, {**dict.fromkeys(train_names, 3 * depth),
                                **dict.fromkeys(gpt2_names, 3 * layers)}),
            ("plain", plain, {"draw_masks": 3 * depth,
                              "draw_masks_gpt2": 3 * layers})):
        reset_launches()
        fp32[f"loss_{key}"] = [
            float(run.train_step(batch, run.lr_schedule(warmup + i,
                                                        run.base_lr),
                                 run.base_lr)[0]["total_loss"])
            for i, batch in enumerate(batches)]
        counts = launch_counts()
        if counts != {**zero, **expected}:
            raise AssertionError(f"train fp32 {key}: launches {counts}, "
                                 f"expected {expected} and 0 of the others")
        fp32[f"launches_{key}"] = {k: n for k, n in counts.items() if n}
    rel = max(abs(a - b) / abs(b) for a, b in zip(fp32["loss_kernel"],
                                                  fp32["loss_plain"]))
    worst = ("", 0.0)
    sd_k, sd_p = kernel.model.state_dict(), plain.model.state_dict()
    for name, w in sd_p.items():
        d = float((sd_k[name] - w).abs().max()) / max(float(w.abs().max()),
                                                      1e-30)
        if d > worst[1]:
            worst = (name, d)
    fp32.update(loss_rel_diff=rel, weight_rel_diff=worst[1])
    log(f"train fp32 B={FP32_BATCH}: 3 steps through the kernels and 3 "
        f"through the plain versions on the same masks: losses "
        f"{fp32['loss_kernel']} vs {fp32['loss_plain']} (rel diff {rel:.3g}, "
        f"tol 1e-4); weights after 3 steps differ by at most {worst[1]:.3g} "
        f"of max|w| ({worst[0]}, tol 1e-4)")
    if not (all(map(lambda v: v == v and abs(v) < 1e30, fp32["loss_kernel"]))
            and rel <= 1e-4 and worst[1] <= 1e-4):
        raise AssertionError("train fp32: the kernel path disagrees with "
                             "the plain path")
    del kernel, plain, run, sd_k, sd_p, batches
    torch.cuda.empty_cache()

    # (b) bf16 compute over fp32 masters, B = 256
    runner = Runner.from_config(cfg, TRAIN_CLASSES, device="cuda",
                                iters_per_epoch=1, compute_dtype="bfloat16")
    batches = synthetic_batches(cfg, TRAIN_BATCH, TRAIN_DISTINCT_BATCHES,
                                seed=2)
    torch.cuda.reset_peak_memory_stats()
    per_step = {**zero, **dict.fromkeys(train_names, depth),
                **dict.fromkeys(gpt2_names, layers)}
    # No host synchronisation inside the loop: the host enqueues ahead of
    # the card as a training loop does, each step's events lie on the
    # stream, and the losses are read back after the last step.
    losses, events, host_ms = [], [], []
    # the main path: counts set to 0 just before, read just after
    reset_launches()
    for i in range(TRAIN_STEPS):
        before = launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        step_losses, _ = runner.train_step(
            batches[i % len(batches)],
            runner.lr_schedule(warmup + i, runner.base_lr), runner.base_lr)
        end.record()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        events.append((start, end))
        losses.append(step_losses["total_loss"])
        delta = {k: v - before[k] for k, v in launch_counts().items()}
        if delta != per_step:
            raise AssertionError(f"train step {i + 1}: launches {delta}, "
                                 f"expected {per_step}")
    torch.cuda.synchronize()
    launches = launch_counts()
    if launches != {k: n * TRAIN_STEPS for k, n in per_step.items()}:
        raise AssertionError(f"train bf16: launches {launches} over "
                             f"{TRAIN_STEPS} steps, expected {per_step} a "
                             "step")
    losses = [float(v) for v in losses]
    step_ms = [a.elapsed_time(b) for a, b in events]
    # the last ten steps as one window: start of step 11 to end of step 20
    window_ms = events[-10][0].elapsed_time(events[-1][1]) / 10
    host = statistics.median(host_ms[-10:])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms = statistics.median(step_ms[-10:])
    n = len(batches)
    first, last = sum(losses[:4]) / 4, sum(losses[-4:]) / 4
    log(f"train bf16 B={TRAIN_BATCH}: {TRAIN_STEPS} steps over {n} batches, "
        f"launches per step "
        f"{dict((k, per_step[k]) for k in train_names + gpt2_names)} "
        f"and 0 of every serving kernel; total loss by step "
        f"{[round(v, 4) for v in losses]}; mean of steps 1-4 {first:.4f}, of "
        f"steps {TRAIN_STEPS - 3}-{TRAIN_STEPS} (the same batches) "
        f"{last:.4f}")
    log(f"train bf16 B={TRAIN_BATCH}: ms_per_step={ms:.3f} (CUDA events "
        f"around each step, median of the last 10) clips_per_s="
        f"{TRAIN_BATCH / ms * 1e3:.1f}; the last 10 steps as one window "
        f"{window_ms:.3f} ms a step; host_enqueue_ms_per_step={host:.3f} "
        f"(host clock, no synchronisation); peak_mem_GB={peak_gb:.2f}")
    if not all(v == v and abs(v) < 1e30 for v in losses):
        raise AssertionError("train bf16: non-finite loss")
    if not (last < first and losses[-1] < losses[0]):
        raise AssertionError("train bf16: the loss did not fall")
    batch = batches[TRAIN_STEPS % n]
    lr = runner.lr_schedule(warmup + TRAIN_STEPS, runner.base_lr)
    profile = profile_forward(
        lambda: runner.train_step(batch, lr, runner.base_lr),
        what="one bf16 training step", grad=True)
    retired = [g for g in profile["groups_ms"] if g.split("<")[0] in RETIRED]
    if retired:
        raise AssertionError(f"train bf16: the profiled step shows {retired}"
                             ", which the port has deleted")
    del runner, batches
    torch.cuda.empty_cache()
    return launches, {
        "expt": TRAIN_EXPT, "params": n_params,
        "gpt2_layers": "fused_gpt2_block_train: the forward, MLP-backward "
                       "and attention-backward CUDA entries of "
                       "csrc/fused_gpt2_train.cu (rows 11-15)", "fp32": fp32,
        "bf16": {"batch": TRAIN_BATCH, "steps": TRAIN_STEPS,
                 "ms_per_step": ms, "clips_per_s": TRAIN_BATCH / ms * 1e3,
                 "window_ms_per_step": window_ms,
                 "host_enqueue_ms_per_step": host,
                 "peak_mem_GB": peak_gb, "losses": losses,
                 "launches_per_step": {k: per_step[k]
                                       for k in train_names + gpt2_names},
                 "profile": profile}}


# -- the synthetic smoke expt -------------------------------------------------

SMOKE_EXPTS = ("99_synth_smoke_val.txt", "99_synth_smoke_train.txt")
SMOKE_CLASSES = {"action": 106, "verb": 19, "noun": 51}  # EGTEA's counts
SMOKE_BATCH = 64


def _counts_ok(what, counts, expected):
    want = {**dict.fromkeys(counts, 0), **expected}
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want}")


def phase_expt99():
    """expts/99_synth_smoke_{val,train}.txt on the card: the fuser at C 24
    with 2 heads of 12 and the GPT-2 predictor at C 32 with 2 heads of 16;
    then again with both off the 8-column grid (EXPT99_OFF_GRID: the fuser
    at C 25, 5 heads of 5, MLP 100; GPT-2 at C 27, 3 heads of 9, MLP 108).
    Each served in bf16 and fp32 against the plain path (one answer's
    launch counts asserted), and trained: three steps through the kernels
    against three through the plain versions on the same masks, in fp32
    and in bf16, with the launch counts of every step. The bf16 kernel runs
    off the grid must launch pack_rows (the same count every step), no
    other run may. Returns the numbers, and the off-grid runs' pack_rows
    launches."""
    numbers = _expt99(())
    numbers["off_grid"] = _expt99(EXPT99_OFF_GRID)
    return numbers, numbers["off_grid"].pop("pack_rows_launches")


def _packs_ok(what, counts, off_grid, dtype, per_call=None):
    """pop pack_rows from ``counts``: some in a bf16 kernel run off the grid
    (``per_call`` of them, where given), else none. Returns the count."""
    n = counts.pop("pack_rows")
    if (n > 0) != (off_grid and dtype in ("bfloat16", "bf16")) or (
            per_call is not None and n != per_call):
        raise AssertionError(f"{what}: {n} pack_rows launches")
    return n


def _expt99(overrides):
    """phase_expt99 at the expt's widths with ``overrides``."""
    import torch
    from afft_tpu_torch import serve
    from afft_tpu_torch.ops import launch_counts, reset_launches
    from afft_tpu_torch.train.runner import Runner

    numbers, packs = {"overrides": list(overrides)}, {}
    off = bool(overrides)
    tag = "expt 99" + (" off the grid" if off else "")
    cfg = serve.load_config(os.path.join(EXPTS, SMOKE_EXPTS[0]), overrides)
    depth, layers = int(cfg.model.fuser.depth), int(cfg.model.common.fp_layers)
    modal_dims = {m: int(d) for m, d in
                  cfg.model.modal_dims.to_container().items()}
    T = int(cfg.data_eval.num_frames)
    requests = serve.random_requests(modal_dims, T, SMOKE_BATCH, 2, seed=3)
    serving = {"fused_block": depth, "gpt2_attn_half": layers,
               "gpt2_mlp_half": layers}
    weights = None
    # bf16: ~20 rounded layers between features and logits; fp32: only the
    # summation order differs (the flagship's bounds)
    for dtype, tol in (("bfloat16", 5e-2), ("float32", 1e-4)):
        server = serve.Server(cfg, {"action": SMOKE_CLASSES["action"]}, dtype,
                              "cuda", weights=weights)
        weights = server.model.state_dict() if weights is None else weights
        reset_launches()
        answers = server.answer(requests)
        torch.cuda.synchronize()
        counts = launch_counts()
        packs[f"serve_{dtype}"] = _packs_ok(f"{tag} serve {dtype}", counts,
                                            off, dtype)
        _counts_ok(f"{tag} serve {dtype}", counts, serving)
        feats = server.to_device({m: torch.cat([r[m] for r in requests])
                                  for m in requests[0]})
        with torch.no_grad():
            logits = server.head_logits(server.model(feats))
            plain = server.head_logits(server.model(feats, impl="plain"))
        torch.cuda.synchronize()
        finite, max_abs, rel = errors(logits, plain)
        log(f"{tag} serve {dtype} B={SMOKE_BATCH}: {len(answers)} answers, "
            f"launches {serving}, pack_rows {packs[f'serve_{dtype}']}, "
            f"logits max_abs_diff={max_abs:.6g} "
            f"rel={rel:.3g} (tol {tol:g} of max|logit|) finite={finite}")
        if not (finite and rel <= tol and len(answers) == 2):
            raise AssertionError(f"{tag} serve {dtype}: the kernel path "
                                 "disagrees with the plain path")
        numbers[f"serve_{dtype}_rel"] = rel
        del server

    cfg = serve.load_config(os.path.join(EXPTS, SMOKE_EXPTS[1]), overrides)
    train_names = [n for n, _ in TRAIN_KERNELS["fused_block_train"][:3]]
    gpt2_names = [n for n, _ in TRAIN_KERNELS["fused_gpt2_train"][:3]]
    per_step = {**dict.fromkeys(train_names, depth),
                **dict.fromkeys(gpt2_names, layers)}
    batches = synthetic_batches(cfg, SMOKE_BATCH, 3, seed=4,
                                classes=SMOKE_CLASSES)
    kernel = Runner.from_config(cfg, SMOKE_CLASSES, device="cuda",
                                iters_per_epoch=1, compute_dtype="float32")
    plain = Runner.from_config(cfg, SMOKE_CLASSES, device="cuda",
                               iters_per_epoch=1, compute_dtype="float32",
                               impl="plain", weights=kernel.model.state_dict())
    bf16 = Runner.from_config(cfg, SMOKE_CLASSES, device="cuda",
                              iters_per_epoch=1, compute_dtype="bfloat16",
                              weights=kernel.model.state_dict())
    bf16_plain = Runner.from_config(cfg, SMOKE_CLASSES, device="cuda",
                                    iters_per_epoch=1,
                                    compute_dtype="bfloat16", impl="plain",
                                    weights=kernel.model.state_dict())
    start = {k: v.clone() for k, v in kernel.model.state_dict().items()}
    masks = {"draw_masks": depth, "draw_masks_gpt2": layers}
    losses = {}
    for key, run, expected in (
            ("fp32_kernel", kernel, per_step),
            ("fp32_plain", plain, masks),
            ("bf16_kernel", bf16, per_step),
            ("bf16_plain", bf16_plain, masks)):
        losses[key] = []
        for i, batch in enumerate(batches):
            reset_launches()
            # the base lr on every step: the expt's one-epoch cosine reaches
            # 0 one iteration after its warmup, where no step moves a weight
            step, _ = run.train_step(batch, run.base_lr, run.base_lr)
            losses[key].append(float(step["total_loss"]))
            counts = launch_counts()
            packs[key] = _packs_ok(
                f"{tag} train {key} step {i + 1}", counts,
                off and key.endswith("kernel"), key.split("_")[0],
                packs.get(key))
            _counts_ok(f"{tag} train {key} step {i + 1}", counts, expected)
    diffs = {}
    for dtype, run_k, run_p in (("fp32", kernel, plain),
                                ("bf16", bf16, bf16_plain)):
        got, want = losses[f"{dtype}_kernel"], losses[f"{dtype}_plain"]
        sd_k, sd_p = run_k.model.state_dict(), run_p.model.state_dict()
        # per tensor: the weights, and what the three steps moved them
        upd = {k: float((sd_k[k] - w).abs().max())
               / max(float((w - start[k]).abs().max()), 1e-30)
               for k, w in sd_p.items()}
        worst = max(upd, key=upd.get)
        moved = sum(not torch.equal(w, start[k]) for k, w in sd_p.items())
        d = diffs[dtype] = {
            "finite": all(v == v and abs(v) < 1e30 for v in got),
            "loss_rel": max(abs(a - b) / abs(b) for a, b in zip(got, want)),
            "weight_rel": max(float((sd_k[k] - w).abs().max())
                              / max(float(w.abs().max()), 1e-30)
                              for k, w in sd_p.items()),
            "update_rel": upd[worst], "worst_update": worst,
            "moved": moved}
        tol = EXPT99_TRAIN_TOL[dtype]
        log(f"{tag} train {dtype} B={SMOKE_BATCH}: 3 steps through the "
            f"kernels {got} vs the plain versions {want}: loss rel diff "
            f"{d['loss_rel']:.3g} (tol {tol['loss_rel']:g}), weights "
            f"{d['weight_rel']:.3g} of max|w| (tol {tol['weight_rel']:g}), "
            f"updates {d['update_rel']:.3g} of max|update| (tol "
            f"{tol['update_rel']:g}; {worst}), per tensor; the steps moved "
            f"{moved} of {len(sd_p)} tensors; launches per step {per_step}, "
            f"pack_rows {packs[f'{dtype}_kernel']} a step")
        if not (d["finite"] and moved > len(sd_p) // 2
                and all(d[k] <= t for k, t in tol.items())):
            raise AssertionError(f"{tag} train {dtype}: the kernel path "
                                 "disagrees with the plain path")
    numbers.update(train_losses=losses, train_diffs=diffs,
                   launches_per_step=per_step, pack_rows_launches={
                       k: n for k, n in packs.items() if n})
    del kernel, plain, bf16, bf16_plain, start
    torch.cuda.empty_cache()
    return numbers


# -- the launcher: the flagship trained through the port's entry point ------

LAUNCH_EXPT = "98_synth_accept_train.txt"
# the accept set at full widths (rgb 1024 / objects 352 / audio 1024 / flow
# 1024, T 16, 3,806 actions, 64 active), cut to fewer videos and clips
LAUNCH_SET = {"n_train_videos": 16, "n_val_videos": 1, "clips_per_video": 128}
# 1, then resumed for the second; and 2 in one run (3 before the variants
# phase joined the smoke: cut to keep the whole near 600 s)
LAUNCH_EPOCHS = 2
LAUNCH_TIMEOUT = 600   # seconds a launcher run may take
LAUNCH_OVERRIDES = ("workers=4", "use_wandb=false")
BARE_STEPS = 20
SERVE_NAMES = ("fused_block", "gpt2_attn_half", "gpt2_mlp_half")


# the runs of _start_run not yet finished: main() stops them if a phase
# fails
RUNNING = []


def _start_run(cmd, workdir, name):
    """Start ``cmd`` in ``workdir`` with its output in
    ``<workdir>/<name>.log``; returns the handle ``_finish_run`` takes."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p)}
    out = open(os.path.join(workdir, f"{name}.log"), "w")
    proc = subprocess.Popen(cmd, cwd=workdir, env=env, stdout=out,
                            stderr=subprocess.STDOUT)
    run = (proc, out, os.path.join(workdir, f"{name}.log"), name,
           time.perf_counter())
    RUNNING.append(run)
    return run


def _stop_runs():
    """Kill every run of ``_start_run`` still going."""
    while RUNNING:
        proc, out = RUNNING.pop()[:2]
        proc.kill()
        proc.wait()
        out.close()


def _finish_run(run, timeout):
    """Wait for a run of ``_start_run`` (killed past ``timeout`` seconds
    from its start); a failed run fails the phase. Returns (log text,
    seconds from its start)."""
    proc, out, path, name, t0 = run
    try:
        proc.wait(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
    except BaseException:
        proc.kill()
        proc.wait()
        raise
    finally:
        out.close()
        RUNNING.remove(run)
    seconds = time.perf_counter() - t0
    with open(path) as f:
        text = f.read()
    if proc.returncode != 0:
        raise AssertionError(f"{name}: exit code {proc.returncode}\n"
                             f"{text[-4000:]}")
    return text, seconds


def _logged_run(cmd, workdir, name, timeout):
    """Run ``cmd`` in ``workdir`` with its output in ``<workdir>/<name>.log``;
    a failed run fails the phase. Returns (log text, seconds)."""
    return _finish_run(_start_run(cmd, workdir, name), timeout)


def _launch_cmd(overrides):
    """``python -m afft_tpu_torch.run -c expts/<LAUNCH_EXPT> -m train`` with
    ``overrides``."""
    return [sys.executable, "-m", "afft_tpu_torch.run", "-c",
            os.path.join(EXPTS, LAUNCH_EXPT), "-m", "train",
            *LAUNCH_OVERRIDES, *overrides]


def _launch(workdir, name, overrides):
    """One run of ``_launch_cmd(overrides)`` in ``workdir``; returns (its
    checkpoint directory, its epochs' metrics, its run record, seconds). Its
    output goes to ``<workdir>/<name>.log``; a failed run fails the
    phase."""
    _, seconds = _logged_run(_launch_cmd(overrides), workdir, name,
                             LAUNCH_TIMEOUT)
    return _launch_record(workdir, name, overrides, seconds)


def _launch_record(workdir, name, overrides, seconds):
    """A finished launcher run's (checkpoint directory, epochs' metrics, run
    record, seconds), logged."""
    exp = [l for l in overrides if l.startswith("experiment_name=")][0]
    ckpt_dir = os.path.join(workdir, "checkpoints",
                            "CMFPEarly_ModalTokenCMFuser_rgb_objects_audio_"
                            f"flow_{exp.split('=', 1)[1]}")
    with open(os.path.join(ckpt_dir, "metrics.jsonl")) as f:
        epochs = [json.loads(line) for line in f]
    with open(os.path.join(ckpt_dir, "summary.jsonl")) as f:
        run = [json.loads(line) for line in f][-1]["run"]
    log(f"launcher {name}: {' '.join(overrides)}: exit 0 in {seconds:.1f} s, "
        f"{run['train_iters']} iterations, {run['val_batches']} validation "
        f"batches on {run['device']}; by epoch: window ms per iteration "
        f"{[round(_window_ms(e), 3) for e in epochs]} median ms_per_iter "
        f"{[round(e['ms_per_iter'], 3) for e in epochs]} host_ms_per_iter "
        f"{[round(e['host_ms_per_iter'], 3) for e in epochs]} clips_per_s "
        f"{[round(e['clips_per_s'], 1) for e in epochs]}")
    return ckpt_dir, epochs, run, seconds


def _window_ms(epoch):
    """An epoch's ms per iteration over its whole window, stalls
    included."""
    return epoch["window_ms"] / epoch["iters"]


def _bare_turn(runner, batches):
    """BARE_STEPS of the bare Runner.train_step on batches already on the
    card, no host synchronisation between them; returns the median step
    between CUDA events around each step, the last ten steps' window per
    step (the launcher's measure: start to start, gaps included) and the
    median host time of a step's call, over the last ten steps."""
    import torch
    events, host_ms = [], []
    for i in range(BARE_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        runner.train_step(batches[i % len(batches)],
                          runner.lr_schedule(i, runner.base_lr),
                          runner.base_lr)
        end.record()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        events.append((start, end))
    torch.cuda.synchronize()
    return {"ms_per_step": statistics.median(
                a.elapsed_time(b) for a, b in events[-10:]),
            "window_ms_per_step":
                events[-10][0].elapsed_time(events[-1][1]) / 10,
            "host_enqueue_ms": statistics.median(host_ms[-10:])}


def _launch_counts_ok(name, run, depth, layers):
    """Training entries once per layer per iteration, serving kernels once
    per layer per validation batch, nothing else."""
    train = [n for n, _ in TRAIN_KERNELS["fused_block_train"][:3]]
    gpt2 = [n for n, _ in TRAIN_KERNELS["fused_gpt2_train"][:3]]
    expected = {**dict.fromkeys(train, depth * run["train_iters"]),
                **dict.fromkeys(gpt2, layers * run["train_iters"]),
                "fused_block": depth * run["val_batches"],
                "gpt2_attn_half": layers * run["val_batches"],
                "gpt2_mlp_half": layers * run["val_batches"]}
    _counts_ok(f"launcher {name}", run["launches"], expected)
    return {k: n for k, n in run["launches"].items() if n}


def _checkpoint_logits_ok(cfg, num_classes, state, where, seed=5):
    """A reloaded checkpoint's logits through the kernels against the plain
    path on seeded features of the expt's shape: bf16 at the eval batch as
    validation runs it (5e-2 of max|logit| and the top-1 form; a model
    trained to chance gives near-flat logits, most rows ties at bf16's
    resolution, so the decided rows are few and their share is not asked
    for), and fp32 at FP32_BATCH (1e-4: only the summation order differs,
    the sharp check)."""
    import torch
    from afft_tpu_torch import serve
    eval_batch = int(cfg.eval.batch_size)
    T = int(cfg.data_eval.num_frames)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    val_feats = {m: torch.randn(eval_batch, T, int(v), generator=gen,
                                device="cuda")
                 for m, v in cfg.model.modal_dims.to_container().items()}
    for dtype, n, rel in (("bfloat16", eval_batch, 5e-2),
                          ("float32", FP32_BATCH, 1e-4)):
        server = serve.Server(cfg, num_classes, dtype, "cuda",
                              weights=state)
        feats = server.to_device({m: v[:n] for m, v in val_feats.items()})
        with torch.no_grad():
            logits = server.head_logits(server.model(feats))
            plain = server.head_logits(server.model(feats, impl="plain"))
        max_abs = (logits - plain).abs().max().item()
        scale = plain.abs().max().item()
        ok = bool(logits.isfinite().all()) and max_abs <= rel * scale
        agree = (logits.argmax(-1) == plain.argmax(-1)).float().mean()
        text = f"top1_agree={agree.item():.4f}"
        if dtype == "bfloat16":
            top1_ok, text = top1_report(logits, plain, need_decided=False)
            ok = ok and top1_ok
        log(f"launcher: {where} reloads; {dtype} B={n} logits through "
            f"the kernels vs the plain path: max_abs_diff={max_abs:.6g} "
            f"(tol {rel * scale:.6g} = {rel:g} * max|logit| "
            f"{scale:.4g}); {text}")
        if not ok:
            raise AssertionError(f"launcher: {where}: the kernels' "
                                 f"{dtype} logits disagree with the "
                                 "plain path's")
        del server, feats
    torch.cuda.empty_cache()


def phase_launcher():
    """The port's own entry point trains the full-width flagship on a
    cut-down accept set: the port's generator writes the set, the training
    layers are held against their plain versions at the launcher's shapes,
    then ``python -m afft_tpu_torch.run -c expts/98_synth_accept_train.txt
    -m train`` runs as a subprocess for one epoch, again with
    train.resume=true for a second, once for two epochs in one run (with a
    turn of the bare Runner.train_step at the same batch just before and
    one just after it), and for one epoch from the host loader
    (data_on_device=false), which runs beside the layer checks and the
    first two runs (so its window is a shared card's). Asserted: exit 0, a
    finite loss that falls, checkpoint_best / checkpoint_last that reload
    and whose logits through the kernels agree with the plain path's, the
    launch counts per iteration and per validation batch, the feature
    cache in CUDA memory, and the resumed weights equal to the
    uninterrupted run's. Returns (the uninterrupted run's launches,
    numbers)."""
    import shutil
    import torch
    from afft_tpu_torch import serve
    from afft_tpu_torch.tools.make_accept_dataset import (N_CLASSES,
                                                          make_accept_dataset)
    from afft_tpu_torch.train.checkpoint import load_checkpoint
    from afft_tpu_torch.train.runner import Runner

    ml = subprocess.run([sys.executable, "-c", "import ml_dtypes"],
                        capture_output=True, timeout=120).returncode == 0
    log(f"launcher: ml_dtypes {'imports' if ml else 'does not import'} on "
        "this machine (the port uses neither it nor lmdb)")
    workdir = os.path.join(REPO, "build", "launcher")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    t0 = time.perf_counter()
    make_accept_dataset(os.path.join(workdir, ".accept_data"), **LAUNCH_SET)
    gen_s = time.perf_counter() - t0
    cfg = serve.load_config(os.path.join(EXPTS, LAUNCH_EXPT))
    depth, layers = int(cfg.model.fuser.depth), int(cfg.model.common.fp_layers)
    batch = int(cfg.train.batch_size)
    log(f"launcher: {LAUNCH_EXPT} at full width on a cut accept set: "
        f"{LAUNCH_SET['n_train_videos']} train / "
        f"{LAUNCH_SET['n_val_videos']} val videos of "
        f"{LAUNCH_SET['clips_per_video']} clips (the full set: 32 / 2 of "
        f"256), written by afft_tpu_torch.tools.make_accept_dataset in "
        f"{gen_s:.1f} s; {LAUNCH_EPOCHS} epochs (the expt: 15), batch "
        f"{batch}, data_on_device={cfg.get('data_on_device')}")

    # the host loader's path (pinned batches from its producer thread)
    host = ("experiment_name=launch-host", "train.num_epochs=1",
            "data_on_device=false")
    host_run = _start_run(_launch_cmd(host), workdir, "host-loader")

    # the training layers at the launcher's own shapes: a batch of clips
    # of T frames gives the fuser batch * T rows of its tokens (one a
    # modality, and the fusion token) and the GPT-2 layers (batch, T, C)
    fuser, common = cfg.model.fuser, cfg.model.common
    T, C = int(cfg.data_train.num_frames), int(cfg.model.common_dim)
    n_tokens = len(cfg.model.modal_dims.to_container()) + 1
    inter = int(common.fp_inter_dim)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    for tag, case in (
            ("bf16", check_train_block(
                "bf16", torch.bfloat16, batch * T, n_tokens, C,
                int(fuser.num_heads), 4 * C, gen, rates=dict(
                    attn_rate=float(fuser.attn_drop_rate),
                    drop_rate=float(fuser.drop_rate),
                    dp_rate=float(fuser.drop_path_rate)))),
            ("bf16", check_gpt2_train_layer(
                "bf16", torch.bfloat16, batch, T, inter,
                int(common.fp_heads), 4 * inter, gen, rates=dict(
                    attn_rate=float(common.attn_pdrop),
                    resid_rate=float(common.resid_pdrop))))):
        _log_case(case, tag)
        log(f"launcher shapes: {case['what']}: max_abs_err {case['errs']}")
        del case
    torch.cuda.empty_cache()

    parts = ("experiment_name=launch-parts",)
    part_dir, part_epochs, run_a, _ = _launch(workdir, "parts", parts + (
        f"train.num_epochs={LAUNCH_EPOCHS - 1}",))
    _, resumed, run_b, _ = _launch(workdir, "resume", parts + (
        f"train.num_epochs={LAUNCH_EPOCHS}", "train.resume=true"))
    _, host_epochs, run_h, _ = _launch_record(
        workdir, "host-loader", host, _finish_run(host_run,
                                                  LAUNCH_TIMEOUT)[1])
    # the bare step at the same batch (seeded weights, batches on the card)
    # in a turn just before and one just after the uninterrupted run
    num_classes = {"action": N_CLASSES}
    runner = Runner.from_config(cfg, num_classes, device="cuda",
                                iters_per_epoch=part_epochs[-1]["iters"])
    batches = synthetic_batches(cfg, batch, TRAIN_DISTINCT_BATCHES, seed=6,
                                classes=num_classes)
    bare = [_bare_turn(runner, batches)]
    torch.cuda.empty_cache()
    whole_dir, epochs, run, whole_s = _launch(
        workdir, "whole", ("experiment_name=launch-whole",
                           f"train.num_epochs={LAUNCH_EPOCHS}"))
    bare.append(_bare_turn(runner, batches))
    del runner, batches
    torch.cuda.empty_cache()
    _launch_counts_ok("host-loader", run_h, depth, layers)
    for name, r in (("parts", run_a), ("resume", run_b), ("whole", run)):
        counts = _launch_counts_ok(name, r, depth, layers)
        cache = r.get("device_cache_bytes")
        if not (r["device"].startswith("cuda") and cache
                and cache["train"] > 0):
            raise AssertionError(f"launcher {name}: no feature cache in "
                                 f"CUDA memory ({r})")
    # the resumed run appends its epoch to the first run's log
    if [e["_step"] for e in resumed] != list(range(1, LAUNCH_EPOCHS + 1)):
        raise AssertionError(f"launcher resume: epochs logged "
                             f"{[e['_step'] for e in resumed]}")
    log(f"launcher: the features sit in {run['device']} memory: "
        f"{run['device_cache_bytes']['train']} bytes (train) + "
        f"{run['device_cache_bytes']['val']} (val); launches of the "
        f"uninterrupted run {counts} = {depth} / {layers} per iteration "
        f"({run['train_iters']}) and per validation batch "
        f"({run['val_batches']})")

    losses = [e["train_total_loss"] for e in epochs]
    mt5r = [e.get("val_mt5r_action_all-fused") for e in epochs]
    log(f"launcher whole: train loss by epoch {losses}, val MT5R {mt5r} "
        "(chance 7.81; the cut run is too short to leave it, the accept "
        "chain is the convergence record)")
    if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"launcher: the loss did not fall: {losses}")

    # checkpoints reload, their logits through the kernels agree with the
    # plain path's, and the resumed run equals the uninterrupted one
    ckpts = {}
    for d, name in ((whole_dir, "checkpoint_best"),
                    (whole_dir, "checkpoint_last"),
                    (part_dir, "checkpoint_last")):
        ckpts[(d, name)] = load_checkpoint(os.path.join(d, name))
    for (d, name), ck in ckpts.items():
        _checkpoint_logits_ok(cfg, num_classes, ck["model"],
                              f"{os.path.basename(d)}/{name}")
    a = ckpts[(part_dir, "checkpoint_last")]
    b = ckpts[(whole_dir, "checkpoint_last")]
    diff = {k: float((a["model"][k].double() - v.double()).abs().max())
            for k, v in b["model"].items()}
    equal = sum(torch.equal(a["model"][k], v) for k, v in b["model"].items())
    moms = [(a["optimizer"]["state"][i]["momentum_buffer"],
             st["momentum_buffer"]) for i, st in b["optimizer"]["state"]
            .items()]
    mom_equal = sum(torch.equal(x, y) for x, y in moms)
    log(f"launcher: resumed ({LAUNCH_EPOCHS - 1} + 1 epochs) vs "
        f"uninterrupted ({LAUNCH_EPOCHS}): "
        f"{equal} of {len(diff)} tensors bit for bit, max abs diff "
        f"{max(diff.values()):.3g}; momentum {mom_equal} of {len(moms)} bit "
        f"for bit; epoch / step {a['epoch']} / {a['step']} vs "
        f"{b['epoch']} / {b['step']}")
    if not (equal == len(diff) and mom_equal == len(moms)
            and (a["epoch"], a["step"]) == (b["epoch"], b["step"])):
        raise AssertionError("launcher: the resumed run differs from the "
                             "uninterrupted one")
    del ckpts, a, b
    torch.cuda.empty_cache()

    last = epochs[-1]
    log(f"launcher whole: epoch {LAUNCH_EPOCHS}: window_ms="
        f"{last['window_ms']:.3f} over {last['iters']} iterations "
        f"({_window_ms(last):.3f} ms an iteration, stalls included) "
        f"clips_per_s={last['clips_per_s']:.1f} (valid clips over the "
        f"window) median ms_per_iter={last['ms_per_iter']:.3f} (CUDA events "
        f"at each iteration's start) host_ms_per_iter="
        f"{last['host_ms_per_iter']:.3f} (median host time of a step's "
        f"call); the run took {whole_s:.1f} s in all")
    for turn, t in zip(("before", "after"), bare):
        log(f"launcher: bare Runner.train_step B={batch}, the turn {turn} "
            f"the uninterrupted run: window_ms_per_step="
            f"{t['window_ms_per_step']:.3f} (the last 10 of {BARE_STEPS} "
            f"as one window) ms_per_step={t['ms_per_step']:.3f} (CUDA "
            f"events around each step, median) clips_per_s="
            f"{batch / t['window_ms_per_step'] * 1e3:.1f} host_enqueue_ms="
            f"{t['host_enqueue_ms']:.3f}")
    ratios = [[_window_ms(e) / t["window_ms_per_step"] for t in bare]
              for e in epochs]
    log(f"launcher: window ms an iteration over the bare step's window, by "
        f"epoch (against the turn before, after): "
        f"{[[round(r, 3) for r in pair] for pair in ratios]}")
    return run["launches"], {
        "expt": LAUNCH_EXPT, "set": LAUNCH_SET, "epochs": LAUNCH_EPOCHS,
        "generate_s": gen_s, "ml_dtypes_imports": ml,
        "train_loss_by_epoch": losses, "val_mt5r_by_epoch": mt5r,
        "window_ms_per_iter_by_epoch": [_window_ms(e) for e in epochs],
        "ms_per_iter_by_epoch": [e["ms_per_iter"] for e in epochs],
        "host_ms_per_iter_by_epoch": [e["host_ms_per_iter"] for e in epochs],
        "clips_per_s_by_epoch": [e["clips_per_s"] for e in epochs],
        "host_loader_window_ms_per_iter": _window_ms(host_epochs[-1]),
        "host_loader_host_ms_per_iter": host_epochs[-1]["host_ms_per_iter"],
        "run_s": whole_s, "device_cache_bytes": run["device_cache_bytes"],
        "bare_turns": bare, "ratio_to_bare_by_epoch": ratios,
        "resume_bit_for_bit": True}


# -- the eval CLI: the launcher's checkpoint evaluated and exported ----------

EVAL_EXPT = "98_synth_accept_val.txt"
EVAL_MODEL = "CMFPEarly_ModalTokenCMFuser_rgb_objects_audio_flow_launch-whole"
EVAL_TIMEOUT = 300  # seconds an eval or challenge run may take


def _eval_cmd(overrides, expt=None):
    """``python -m afft_tpu_torch.run -c expts/<EVAL_EXPT> -m test`` (or
    ``-c expt``) with ``overrides``."""
    return [sys.executable, "-m", "afft_tpu_torch.run", "-c",
            expt or os.path.join(EXPTS, EVAL_EXPT), "-m", "test",
            *LAUNCH_OVERRIDES, *overrides]


def _eval_run(workdir, name, overrides, expt=None):
    """``_eval_cmd`` run in ``workdir``; returns the run's ``eval run:``
    record."""
    return _eval_record(name, *_logged_run(_eval_cmd(overrides, expt),
                                           workdir, name, EVAL_TIMEOUT))


def _eval_record(name, text, seconds):
    """The ``eval run:`` record of an eval run's log, with its seconds."""
    lines = [l for l in text.splitlines() if "eval run: " in l]
    if len(lines) != 1:
        raise AssertionError(f"{name}: no eval run record\n{text[-4000:]}")
    run = json.loads(lines[0].split("eval run: ", 1)[1])
    run["seconds"] = seconds
    log(f"eval {name}: exit 0 in {seconds:.1f} s on {run['device']}: "
        f"{run['clips']} clips in {run['batches']} batches, window_ms="
        f"{run['window_ms']:.3f} clips_per_s={run['clips_per_s']:.1f} "
        "(valid clips over the window from the first batch's start to the "
        "last logits read back)")
    return run


# the flagship training check (afft_tpu_torch.tools.train_check) beside
# phases 9 and 10: its command line's flagship at B=64, fp32 then bf16
# masters over the same seed and batches
TRAIN_CHECK_DIR = os.path.join(REPO, "build", "train_check")
TRAIN_CHECK_STEPS = 200
TRAIN_CHECK_BATCH = 64
TRAIN_CHECK_TIMEOUT = 400  # seconds a run may take (the card is shared)
# the reference parity tool on phase 8's checkpoint expects the accuracies
# mode's MT5R within REPRODUCE_TOL
REPRODUCE_METRIC = "amt5r"
REPRODUCE_TOL = 1e-6


def _train_check_cmd(master_dtype, against=None):
    """``python -m afft_tpu_torch.tools.train_check`` at the smoke's steps
    and batch, its record in ``TRAIN_CHECK_DIR/<master_dtype>.json``."""
    cmd = [sys.executable, "-m", "afft_tpu_torch.tools.train_check",
           "--steps", str(TRAIN_CHECK_STEPS), "--batch",
           str(TRAIN_CHECK_BATCH), "--master-dtype", master_dtype, "--out",
           os.path.join(TRAIN_CHECK_DIR, f"{master_dtype}.json")]
    return cmd + (["--against", against] if against else [])


def _train_check_record(master_dtype, seconds):
    """A finished train_check run's record, held: a falling loss, and the
    training entries of rows 7-9 and 11-15 launched 6 times a step each,
    no other kernel (the masks of rows 10 / 16 are drawn in registers)."""
    with open(os.path.join(TRAIN_CHECK_DIR, f"{master_dtype}.json")) as f:
        rec = json.load(f)
    names = [n for layer in TRAIN_KERNELS.values() for n, _ in layer[:3]]
    want = dict.fromkeys(names, 6 * TRAIN_CHECK_STEPS)
    if rec["launches"] != want:
        raise AssertionError(f"train_check {master_dtype}: launches "
                             f"{rec['launches']}, expected {want} and 0 of "
                             "every other kernel")
    if not (rec["loss_decreased"] and math.isfinite(rec["loss_last"])):
        raise AssertionError(f"train_check {master_dtype}: the loss did not "
                             f"fall: {rec['loss_first']} -> "
                             f"{rec['loss_last']}")
    rec["seconds"] = seconds
    delta = rec.get("trace_delta")
    log(f"train_check {master_dtype} masters: {rec['steps']} steps at B="
        f"{rec['batch']}, {rec['model_params'] / 1e6:.1f} M params, loss "
        f"{rec['loss_first']:.4f} -> {rec['loss_last']:.4f}, every 50 steps "
        f"{[round(v, 4) for v in rec['loss_every_50']]}, ms_per_step="
        f"{rec['ms_per_step']:.3f} (CUDA events, the card shared with phases "
        f"9-10) host_ms_per_step={rec['host_ms_per_step']:.3f}, 6 launches "
        "a step of each training entry"
        f"{'; trace_delta ' + json.dumps(delta) if delta else ''} "
        f"({seconds:.1f} s)")
    return rec


def _reproduce_cmd(ckpt, expect):
    """``python -m afft_tpu_torch.tools.reproduce_reference`` on the eval
    expt and ``ckpt``, expecting ``expect`` of ``REPRODUCE_METRIC``."""
    return [sys.executable, "-m", "afft_tpu_torch.tools.reproduce_reference",
            "--expt", os.path.join(EXPTS, EVAL_EXPT), "--ckpt", ckpt,
            "--metric", REPRODUCE_METRIC, "--expect", repr(expect),
            "--tolerance", repr(REPRODUCE_TOL),
            *(f"--override={o}" for o in LAUNCH_OVERRIDES)]


def _reproduce_record(name, text, seconds, per_batch):
    """A finished reference parity run: exit 0 (``_finish_run``), its
    report line ``-> OK`` (the measured metric within ``REPRODUCE_TOL`` of
    the expected one), and the serving kernels launched ``per_batch`` times
    a batch each. Returns its ``eval run:`` record with the measured metric
    (as the report prints it)."""
    run = _eval_record(name, text, seconds)
    lines = [l for l in text.splitlines() if "[reproduce_reference]" in l]
    if len(lines) != 1 or not lines[0].endswith("-> OK"):
        raise AssertionError(f"{name}: no OK report\n{text[-4000:]}")
    _counts_ok(name, run["launches"], {k: n * run["batches"]
                                       for k, n in per_batch.items()})
    log(f"{name}: {lines[0]}")
    run["measured"] = float(lines[0].split(" measured ")[1].split()[0])
    return run


def _eval_logits(cfg, dataset, state, impl, dtype):
    """The eval set's logits through ``Runner.eval_step`` on the card from
    ``state``, through ``impl`` in ``dtype``."""
    import torch
    from afft_tpu_torch.eval import evaluate as PE
    from afft_tpu_torch.train.runner import Runner
    classes = {k: len(v) for k, v in dataset.classes.items()}
    runner = Runner.from_config(cfg, classes, device="cuda", impl=impl,
                                compute_dtype=dtype,
                                class_mappings=dataset.class_mappings)
    runner.load_model_state(state)
    logits, idx, _ = PE.collect_logits(runner, PE.eval_loader(cfg, dataset,
                                                              "cuda"))
    del runner
    torch.cuda.empty_cache()
    return torch.from_numpy(logits), idx


def phase_eval():
    """The eval CLI on the launcher's checkpoint (phase 8's uninterrupted
    run, full width, bf16, the eval set in CUDA memory): ``python -m
    afft_tpu_torch.run -c expts/98_synth_accept_val.txt -m test`` in the
    accuracies mode and with ``+save_name`` (the logits file: npz, as this
    machine has no h5py); the exported logits against the plain path on
    the same checkpoint (bf16 at 5e-2 of max|logit| with the top-1 form,
    and the kernels against the plain path in fp32 at 1e-4); the accuracies
    mode against the challenge's numbers from the exported file; the
    challenge tool (``python -m afft_tpu_torch.challenge``) packages it; the
    serving kernels launched 6 times a batch each. The export runs alone
    (its clips/s is the eval CLI's); the accuracies mode, the challenge
    tool and the fp32-master training check run beside the comparisons with
    the plain path, so the accuracies run's clips/s is a shared card's. At
    its end it starts the reference parity tool on the checkpoint (as the
    port's checkpoint and as a reference-layout .pth, each expecting the
    accuracies mode's MT5R) and the bf16-master training check against the
    fp32 one. Returns (the export run's launches, numbers, ``finish``: a
    function that waits for those runs and holds them, to call after
    phase 10)."""
    import numpy as np
    import torch
    from afft_tpu_torch import challenge as PCHALLENGE
    from afft_tpu_torch import serve
    from afft_tpu_torch.config import read_expt_file
    from afft_tpu_torch.data.loader import get_dataset
    from afft_tpu_torch.eval import challenge as PC
    from afft_tpu_torch.train.checkpoint import load_checkpoint
    from afft_tpu_torch.train.loop import get_transforms

    workdir = os.path.join(REPO, "build", "launcher")
    init = f"init_from_model={EVAL_MODEL}/checkpoint_best"
    export = _eval_run(workdir, "eval-export", (init, "save_name=test.h5"))
    # the flagship training check beside the rest (fp32 masters first)
    os.makedirs(TRAIN_CHECK_DIR, exist_ok=True)
    check_fp32 = _start_run(_train_check_cmd("float32"), TRAIN_CHECK_DIR,
                            "train-check-fp32")
    overrides = [l for l in read_expt_file(os.path.join(EXPTS, EVAL_EXPT))
                 if l.startswith("dataset")]
    accs_h = _start_run(_eval_cmd((init, "save_name=null")), workdir,
                        "eval-accuracies")
    chall_h = _start_run(
        [sys.executable, "-m", "afft_tpu_torch.challenge", "--prefix_h5",
         "test", "--models", EVAL_MODEL, "--weights", "1", "--override",
         *overrides], workdir, "challenge")
    path = export["logits_file"]
    (res,) = PC.gen_load_resfiles(os.path.dirname(path), "test")
    exported = torch.from_numpy(res["logits/action_all-fused"])
    log(f"eval: exported {tuple(exported.shape)} logits to "
        f"{os.path.relpath(path, REPO)}")

    cfg = serve.load_config(os.path.join(EXPTS, EVAL_EXPT),
                            (f"cwd={workdir}", init, *LAUNCH_OVERRIDES))
    depth, layers = int(cfg.model.fuser.depth), int(cfg.model.common.fp_layers)
    batches = export["batches"]
    _counts_ok("eval export", export["launches"], {
        "fused_block": depth * batches, "gpt2_attn_half": layers * batches,
        "gpt2_mlp_half": layers * batches})
    dataset = get_dataset(cfg.dataset_eval, cfg.data_eval,
                          get_transforms(cfg, train=False))
    state = load_checkpoint(os.path.join(workdir, "checkpoints", EVAL_MODEL,
                                         "checkpoint_best"))["model"]
    # the same weights as a reference-layout .pth ({"model": state dict})
    pth = os.path.join(workdir, "checkpoints", "reference_layout.pth")
    torch.save({"model": state}, pth)
    numbers = {}
    plain, idx = _eval_logits(cfg, dataset, state, "plain", "bfloat16")
    if not (len(idx) == len(exported) and
            (idx == np.arange(len(idx))).all()):
        raise AssertionError("eval: the exported rows are not the eval set "
                             "in dataset order")
    for dtype, rel, got in (("bfloat16", 5e-2, exported),
                            ("float32", 1e-4, None)):
        if got is None:
            got = _eval_logits(cfg, dataset, state, "kernel", dtype)[0]
            plain = _eval_logits(cfg, dataset, state, "plain", dtype)[0]
        max_abs = (got - plain).abs().max().item()
        scale = plain.abs().max().item()
        ok = bool(got.isfinite().all()) and max_abs <= rel * scale
        text = ""
        if dtype == "bfloat16":
            top1_ok, text = top1_report(got, plain, need_decided=False)
            ok = ok and top1_ok
        log(f"eval: {dtype} logits of {len(got)} clips, "
            f"{'the exported file' if dtype == 'bfloat16' else 'kernels'} "
            f"vs the plain path on the same checkpoint: max_abs_diff="
            f"{max_abs:.6g} (tol {rel * scale:.6g} = {rel:g} * max|logit| "
            f"{scale:.4g}) {text}")
        if not ok:
            raise AssertionError(f"eval: {dtype} logits disagree with the "
                                 "plain path's")
        numbers[f"{dtype}_max_abs_diff"] = max_abs
    del plain, state
    torch.cuda.empty_cache()

    accs_run = _eval_record("eval-accuracies",
                            *_finish_run(accs_h, EVAL_TIMEOUT))
    _, chall_s = _finish_run(chall_h, EVAL_TIMEOUT)

    # the accuracies mode equals the challenge's numbers from the file
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        ds = PCHALLENGE.get_dataset(overrides, "test")
    finally:
        os.chdir(cwd)
    from_file, _ = PC.marginalize_verb_noun(
        exported.numpy(), ds, compute_manyshot_unseen_tail=True)
    accs = accs_run["accuracies"]
    for k, v in from_file.items():
        same = (math.isnan(v) and math.isnan(accs[k])) or \
            abs(accs[k] - v) <= 1e-6 * max(1.0, abs(v))
        if not same:
            raise AssertionError(f"eval: the accuracies mode's {k} "
                                 f"{accs[k]} differs from the file's {v}")
    with open(os.path.join(workdir, "logits", "test.json")) as f:
        sub = json.load(f)
    n_total = len(ds) + (0 if ds.discarded_df is None
                         else len(ds.discarded_df))
    if len(sub["results"]) != n_total or not os.path.exists(
            os.path.join(workdir, "logits", "submit.zip")):
        raise AssertionError("eval: the challenge tool's submission is not "
                             "whole")
    keys = ("vtop1", "vtop5", "ntop1", "ntop5", "atop1", "atop5", "amt5r")
    log(f"eval: accuracies mode = the challenge's numbers from the exported "
        f"file: {{{', '.join(f'{k}: {accs[k]:.2f}' for k in keys)}}}; "
        f"the challenge tool packaged {len(sub['results'])} results in "
        f"{chall_s:.1f} s; serving launches of the export "
        f"{ {k: n for k, n in export['launches'].items() if n} } = "
        f"{depth} / {layers} a batch over {batches} batches")
    numbers.update({
        "clips": export["clips"], "batches": batches,
        "clips_per_s_export": export["clips_per_s"],
        "clips_per_s_accuracies": accs_run["clips_per_s"],
        "window_ms_export": export["window_ms"],
        "run_s": {"accuracies": accs_run["seconds"],
                  "export": export["seconds"], "challenge": chall_s},
        "accuracies": {k: accs[k] for k in keys}})

    # the reference parity tool on the checkpoint, as the port's checkpoint
    # and as the reference-layout .pth, expecting the accuracies mode's
    # metric; then the bf16-master training check against the fp32 one.
    # They run beside phase 10 (``finish`` waits for them).
    expected = accs[REPRODUCE_METRIC]
    repro = {label: _start_run(_reproduce_cmd(ckpt, expected), workdir,
                               f"reproduce-{label}")
             for label, ckpt in (("checkpoint",
                                  f"{EVAL_MODEL}/checkpoint_best"),
                                 ("pth", pth))}
    checks = {"float32": _train_check_record(
        "float32", _finish_run(check_fp32, TRAIN_CHECK_TIMEOUT)[1])}
    check_bf16 = _start_run(
        _train_check_cmd("bfloat16", os.path.join(TRAIN_CHECK_DIR,
                                                  "float32.json")),
        TRAIN_CHECK_DIR, "train-check-bf16")
    per_batch = {"fused_block": depth, "gpt2_attn_half": layers,
                 "gpt2_mlp_half": layers}

    def finish():
        """Wait for the runs started above; returns ({label: the parity
        run's launches}, {master dtype: the training check's launches},
        their numbers)."""
        runs = {label: _reproduce_record(f"reproduce-{label}",
                                         *_finish_run(h, EVAL_TIMEOUT),
                                         per_batch)
                for label, h in repro.items()}
        os.remove(pth)
        checks["bfloat16"] = _train_check_record(
            "bfloat16", _finish_run(check_bf16, TRAIN_CHECK_TIMEOUT)[1])
        out = {
            "reproduce": {label: {"metric": REPRODUCE_METRIC,
                                  "measured": r["measured"],
                                  "expected": expected,
                                  "seconds": r["seconds"],
                                  "launches": {k: n for k, n in
                                               r["launches"].items() if n}}
                          for label, r in runs.items()},
            "train_check": {dt: {k: rec[k] for k in (
                "steps", "batch", "model_params", "ms_per_step",
                "host_ms_per_step", "loss_first", "loss_last",
                "loss_every_50", "seconds", "device") + (
                    ("trace_delta",) if "trace_delta" in rec else ())}
                for dt, rec in checks.items()}}
        return ({label: r["launches"] for label, r in runs.items()},
                {dt: rec["launches"] for dt, rec in checks.items()}, out)

    return export["launches"], numbers, finish


# -- data parallelism: torchrun on the card ----------------------------------

DP_GLOBAL_BATCH, DP_STEPS = 64, 3
DP_CLASSES = {"action": 3806}


def _rounded(values, digits=1):
    return [round(v, digits) for v in values]


def _dp_torchrun(nproc, module_args):
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc_per_node={nproc}", "-m", *module_args]


def phase_dp():
    """Data parallelism on the one card. (i) ``-n 1`` through torchrun on
    NCCL: a cut-set epoch (phase 8's host-loader run, data_on_device=false)
    equals, bit for bit, the one-process run without torchrun (weights and
    momentum). (ii) two processes on the card over gloo (``--device
    cuda:0``; NCCL refuses two ranks on one device), 32 clips each, against
    one process at 64, over the same global batches of the full-width
    flagship with its dropout, drop-path and mixup: losses within 2e-2
    relative, the training kernels launched on each rank; before it the
    training layers at rank 1's row offset against their plain versions
    and their masks against the one-process masks of those rows, bit for
    bit; (ii)'s two processes run beside the rest. One card measures no
    multi-GPU scaling: the step times are logged as what they are."""
    import torch
    from afft_tpu_torch import serve
    from afft_tpu_torch.config import read_expt_file
    from afft_tpu_torch.ops import fused_block_train as FT
    from afft_tpu_torch.ops import fused_gpt2_train as FGT
    from afft_tpu_torch.tools import dp_check as D
    from afft_tpu_torch.train import optim as O
    from afft_tpu_torch.train.checkpoint import load_checkpoint

    workdir = os.path.join(REPO, "build", "launcher")
    expt = os.path.join(EXPTS, LAUNCH_EXPT)
    cfg = serve.load_config(expt)
    depth, layers = int(cfg.model.fuser.depth), int(cfg.model.common.fp_layers)
    fuser, common = cfg.model.fuser, cfg.model.common
    numbers = {}

    # (ii) two processes on the one card over gloo against one process,
    # started first
    sched = O.build_schedule(cfg.opt, 2, 1)
    job = {"kind": "train", "name": "flagship", "expt": expt,
           "overrides": list(LAUNCH_OVERRIDES), "classes": DP_CLASSES,
           "batch": DP_GLOBAL_BATCH, "steps": DP_STEPS, "seed": 9,
           "lrs": [sched(i, float(cfg.opt.lr)) for i in range(DP_STEPS)],
           "invalid": [DP_GLOBAL_BATCH - 1], "keep_state": False}
    out = os.path.join(workdir, "dp-out")
    spec = os.path.join(workdir, "dp-spec.json")
    with open(spec, "w") as f:
        json.dump({"device": "cuda:0", "out": out, "jobs": [job]}, f)
    gloo = _start_run(_dp_torchrun(2, ["afft_tpu_torch.tools.dp_check",
                                       spec]), workdir, "dp-gloo")

    # (i) one process through torchrun on NCCL against phase 8's run
    text, secs = _logged_run(
        _dp_torchrun(1, ["afft_tpu_torch.train", "--device", "cuda",
                         *read_expt_file(expt), *LAUNCH_OVERRIDES,
                         "experiment_name=launch-torchrun",
                         "train.num_epochs=1", "data_on_device=false"]),
        workdir, "torchrun-n1", LAUNCH_TIMEOUT)
    if "process 0 of 1 on cuda:0 (nccl)" not in text:
        raise AssertionError("dp: torchrun -n 1 did not join an NCCL group")
    ckpts = os.path.join(workdir, "checkpoints", "CMFPEarly_ModalTokenCMFuser"
                         "_rgb_objects_audio_flow_")
    a = load_checkpoint(ckpts + "launch-torchrun/checkpoint_last")
    b = load_checkpoint(ckpts + "launch-host/checkpoint_last")
    equal = sum(torch.equal(a["model"][k], v) for k, v in b["model"].items())
    moms = [(a["optimizer"]["state"][i]["momentum_buffer"],
             st["momentum_buffer"]) for i, st in b["optimizer"]["state"]
            .items()]
    mom_equal = sum(torch.equal(x, y) for x, y in moms)
    log(f"dp (i): torchrun -n 1 over NCCL, one cut-set epoch in {secs:.1f} "
        f"s: {equal} of {len(b['model'])} tensors and {mom_equal} of "
        f"{len(moms)} momentum buffers bit for bit the one-process run's "
        f"(phase 8, host loader); epoch / step {a['epoch']} / {a['step']} "
        f"vs {b['epoch']} / {b['step']}")
    if not (equal == len(b["model"]) and mom_equal == len(moms)
            and (a["epoch"], a["step"]) == (b["epoch"], b["step"])):
        raise AssertionError("dp: torchrun -n 1 differs from one process")
    del a, b, moms
    numbers["n1_bit_for_bit"] = True
    numbers["n1_run_s"] = secs

    # the training layers at rank 1's rows of the (ii) global batch
    half = DP_GLOBAL_BATCH // 2
    T, C = int(cfg.data_train.num_frames), int(cfg.model.common_dim)
    n_tokens = len(cfg.model.modal_dims.to_container()) + 1
    inter = int(common.fp_inter_dim)
    rates = dict(attn_rate=float(fuser.attn_drop_rate),
                 drop_rate=float(fuser.drop_rate),
                 dp_rate=float(fuser.drop_path_rate))
    g_rates = dict(attn_rate=float(common.attn_pdrop),
                   resid_rate=float(common.resid_pdrop))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(10)
    R = half * T
    for what, full, part in (
            ("draw_masks", FT.draw_masks(
                2 * R, n_tokens, C, int(fuser.num_heads), TRAIN_SEEDS, 5,
                *rates.values(), device="cuda"),
             FT.draw_masks(R, n_tokens, C, int(fuser.num_heads), TRAIN_SEEDS,
                           5, *rates.values(), device="cuda", row0=R)),
            ("draw_masks_gpt2", FGT.draw_masks_gpt2(
                2 * half, T, inter, int(common.fp_heads), TRAIN_SEEDS, 3,
                *g_rates.values(), device="cuda"),
             FGT.draw_masks_gpt2(half, T, inter, int(common.fp_heads),
                                 TRAIN_SEEDS, 3, *g_rates.values(),
                                 device="cuda", row0=half))):
        for m_full, m_part in zip(full, part):
            rows = m_part.shape[0]
            if not torch.equal(m_full[m_full.shape[0] - rows:], m_part):
                raise AssertionError(f"dp: {what} at a row offset differs "
                                     "from the one-process masks")
    for case in (check_train_block("bf16", torch.bfloat16, R, n_tokens, C,
                                   int(fuser.num_heads), 4 * C, gen,
                                   rates=rates, row0=R),
                 check_gpt2_train_layer("bf16", torch.bfloat16, half, T,
                                        inter, int(common.fp_heads),
                                        4 * inter, gen, rates=g_rates,
                                        row0=half)):
        log(f"dp: {case['what']}: masks bit for bit the one-process "
            f"masks of those rows; max_abs_err {case['errs']}")
        del case
    torch.cuda.empty_cache()

    _, secs = _finish_run(gloo, LAUNCH_TIMEOUT)
    ranks = [torch.load(os.path.join(out, f"flagship.rank{r}.pt"),
                        weights_only=False) for r in (0, 1)]
    one = D.run_train(job, torch.device("cuda"))
    torch.cuda.empty_cache()
    worst = 0.0
    for i, (got, want) in enumerate(zip(ranks[0]["losses"], one["losses"])):
        for k, v in want.items():
            worst = max(worst, abs(got[k] - v) / max(abs(v), 1e-12))
    expected = {n: depth * DP_STEPS for n, _ in
                TRAIN_KERNELS["fused_block_train"][:3]}
    expected.update({n: layers * DP_STEPS for n, _ in
                     TRAIN_KERNELS["fused_gpt2_train"][:3]})
    for rec in ranks:
        _counts_ok(f"dp rank {rec['rank']}", rec["launches"], expected)
    log(f"dp (ii): 2 processes over gloo on cuda:0, {half} clips each, vs "
        f"one at {DP_GLOBAL_BATCH}, {DP_STEPS} steps: total loss by step "
        f"{[round(l['total_loss'], 5) for l in ranks[0]['losses']]} vs "
        f"{[round(l['total_loss'], 5) for l in one['losses']]}, largest "
        f"relative difference of any loss {worst:.3g} (tol 2e-2); "
        f"training launches on each rank {expected}; step ms (host, to "
        f"the device's end) rank 0 {_rounded(ranks[0]['step_ms'])} rank 1 "
        f"{_rounded(ranks[1]['step_ms'])}, one process "
        f"{_rounded(one['step_ms'])}: two processes on one "
        "card through host copies, not a multi-GPU number")
    if not worst <= 2e-2:
        raise AssertionError(f"dp: two processes' losses differ from one "
                             f"process's by {worst:.3g}")
    numbers.update({
        "gloo_two_ranks_run_s": secs, "loss_rel_diff": worst,
        "step_ms_rank0": ranks[0]["step_ms"],
        "step_ms_rank1": ranks[1]["step_ms"],
        "step_ms_one_process": one["step_ms"],
        "launches_per_rank": expected})
    return numbers


# -- the variant models: expts 00 and 05 served and trained, 03 and 04 trained

# label, expt file, overrides, launches of one forward as a function of
# (fuser depth, GPT-2 layers, modalities): one GPT-2 per modality
VARIANT_SERVED = [
    ("expt00_individual", "00_RGB_TSN_ek100_train.txt", [],
     lambda d, n, m: {"gpt2_attn_half": n * m, "gpt2_mlp_half": n * m}),
    ("expt05_matt", "05_MATT_ek100_train.txt", [],
     lambda d, n, m: {"gpt2_attn_half": n * m, "gpt2_mlp_half": n * m}),
]
VARIANT_TRAINED = ("00_RGB_TSN_ek100_train.txt",
                   "03_T-SA-Fuser_ek100_train.txt",
                   "04_CA-Fuser_ek100_train.txt", "05_MATT_ek100_train.txt")
VARIANT_FP32_BATCH = 8
VARIANT_BATCH = 64
VARIANT_STEPS = 10
VARIANT_DISTINCT_BATCHES = 2
# fp32, kernels vs plain on the same masks: only the summation order
# differs; per tensor, over the tensor's own max|gradient|
VARIANT_GRAD_TOL = 1e-4
# expt 05's model on the launcher's expt (its block fuser's lines dropped:
# MATT takes none of them)
VARIANT_LAUNCH_MODEL = ("model/fuser=MATT", "model/CMFP=scorefusion",
                        "model.common.share_classifiers=false",
                        "model.common.share_predictors=false",
                        "model.common.modality_cls=true",
                        "model.common.fusion_cls=false",
                        "model.fuser.drop_rate=0.8")
VARIANT_LAUNCH_DIR = "CMFPScoreFusion_MATT_rgb_objects_audio_flow_variant05"


# the attention-route timing: turns in this order (ABBA twice), each of
# VARIANT_TURN_STEPS bf16 steps, timed by the median of its last 6
VARIANT_TURNS = ("kernel", "plain", "plain", "kernel") * 2
VARIANT_TURN_STEPS = 8


def _variant_layer_checks(cfgs):
    """The kernels of the variants' bf16 training steps at those steps' own
    shapes (batch VARIANT_BATCH, the expts' frames): the GPT-2 training
    layer (rows 11-16) at each distinct (T, C, H, attn / resid pdrop) of
    ``cfgs``, as phase 8 holds the launcher's; row 4 (``fused_attention``,
    bf16 and fp32, KERNEL_TOL of max|ref|) against ``attention_plain`` at
    the T-SA-Fuser's self-attention (n*T tokens under the causal mask tiled
    over the modalities, q, k, v slices of one packed qkv) and the
    CA-Fuser's self-attention (T tokens, packed) and cross-attention (T
    tokens, separate q, k, v), both under the causal mask; there also the
    gradients of its training route (``FusedAttentionFn``: the kernel's
    forward, the plain formula's backward) against fp32 autograd through
    the plain version (GRAD_TOL of max|ref|). Returns the numbers."""
    import torch
    from afft_tpu_torch.models.layers import neg_inf_causal_mask
    from afft_tpu_torch.ops import attention as FA

    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    B, numbers = VARIANT_BATCH, {"gpt2_train": [], "attention": []}
    gpt2 = sorted({(int(c.data_train.num_frames),
                    int(c.model.common.fp_inter_dim),
                    int(c.model.common.fp_heads),
                    float(c.model.common.attn_pdrop),
                    float(c.model.common.resid_pdrop)) for c in cfgs})
    for T, C, H, attn, resid in gpt2:
        case = check_gpt2_train_layer(
            "bf16", torch.bfloat16, B, T, C, H, 4 * C, gen,
            rates=dict(attn_rate=attn, resid_rate=resid))
        _log_case(case, "bf16")
        log(f"variants shapes: {case['what']}: max_abs_err {case['errs']}")
        numbers["gpt2_train"].append({"what": case["what"],
                                      "max_abs_err": case["errs"],
                                      "worst_grad": case["worst"]})
        del case
    sites = []
    for c in cfgs:
        kind = c.model.fuser._target_.split(".")[-1] if "fuser" in c.model \
            else None
        n, T = len(c.model.modal_dims.to_container()), \
            int(c.data_train.num_frames)
        if kind == "TemporalCMFuser":
            sites.append(("T-SA self", n * T, True,
                          neg_inf_causal_mask(T, device="cuda").repeat(n, n),
                          c))
        elif kind == "TemporalCrossAttentFuser":
            causal = neg_inf_causal_mask(T, device="cuda")
            sites += [("CA self", T, True, causal, c),
                      ("CA cross", T, False, causal, c)]
    for site, S, packed, mask, c in sites:
        H = int(c.model.fuser.num_heads)
        hd = int(c.model.fuser.dim) // H
        for tag, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
            rn = _randn(gen, dt)
            if packed:   # leaves: one (B, S, 3, H, hd) qkv
                leaves = [rn(B, S, 3, H, hd)]

                def split(ins):
                    return ins[0][:, :, 0], ins[0][:, :, 1], ins[0][:, :, 2]
            else:
                leaves = [rn(B, S, H, hd) for _ in range(3)]

                def split(ins):
                    return ins
            what = (f"fused_attention {tag} {site} B={B} N={S} H={H} "
                    f"hd={hd} (causal mask{', tiled' if S > T else ''}; "
                    f"q, k, v {'packed' if packed else 'separate'})")
            q, k, v = split(leaves)
            _edge_ok(what, tag, FA.fused_attention(q, k, v, mask),
                     FA.attention_plain(q, k, v, mask)[0])
            dout = rn(B, S, H, hd)
            ins = [t.clone().requires_grad_(True) for t in leaves]
            FA.FusedAttentionFn.apply(*split(ins), mask).backward(dout)
            ref_ins = [t.float().requires_grad_(True) for t in leaves]
            FA.attention_plain(*split(ref_ins), mask)[0].backward(
                dout.float())
            torch.cuda.synchronize()
            worst = max(_rel_err(a.grad, b.grad)[0]
                        for a, b in zip(ins, ref_ins))
            log(f"variants shapes: {what}: forward within "
                f"{KERNEL_TOL[tag]:g}; FusedAttentionFn gradients worst "
                f"rel_err {worst:.3g} (tol {GRAD_TOL[tag]:g} of max|ref|)")
            if not worst <= GRAD_TOL[tag]:
                raise AssertionError(f"{what}: FusedAttentionFn gradients "
                                     f"rel_err {worst:.3g}")
            numbers["attention"].append({"what": what, "grad_rel": worst})
            del leaves, ins, ref_ins, dout
    torch.cuda.empty_cache()
    return numbers


def _attn_route_turns(cfg0, label, classes, sites):
    """``cfg0`` (attention dropout 0) at VARIANT_BATCH bf16 on one runner,
    timed in VARIANT_TURNS after two untimed steps:
    "kernel" as shipped (the fuser's attention sites through
    ``FusedAttentionFn``: row 4's forward, the plain formula's fp32
    backward), "plain" with ``ops.attention.uses_kernel`` forced to say no
    (the same sites as the plain ops under autograd, the same arithmetic at
    rate 0). Each turn VARIANT_TURN_STEPS steps; its ms (CUDA events over
    a step) and host enqueue ms are the medians of its last 6. Launches of
    row 4 asserted: ``sites`` a step, 0 when forced plain. Returns the
    numbers."""
    import torch
    from afft_tpu_torch.ops import (attention as FA, launch_counts,
                                    reset_launches)
    from afft_tpu_torch.train.runner import Runner
    runner = Runner.from_config(cfg0, classes, device="cuda",
                                iters_per_epoch=1, compute_dtype="bfloat16")
    batches = synthetic_batches(cfg0, VARIANT_BATCH, VARIANT_DISTINCT_BATCHES,
                                seed=13, classes=classes)
    warmup = int(cfg0.opt.warmup.num_epochs)
    lr = runner.lr_schedule(warmup, runner.base_lr)
    shipped, step = FA.uses_kernel, 0

    def forced_plain(**_):
        return False

    turns = {"kernel": [], "plain": []}
    for route in ("warm-up",) + VARIANT_TURNS:
        FA.uses_kernel = forced_plain if route == "plain" else shipped
        try:
            reset_launches()
            ms, host = [], []
            for _ in range(2 if route == "warm-up" else VARIANT_TURN_STEPS):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                runner.train_step(batches[step % len(batches)], lr,
                                  runner.base_lr)
                end.record()
                host.append((time.perf_counter() - t0) * 1e3)
                ms.append((start, end))
                step += 1
            torch.cuda.synchronize()
            got = launch_counts()["fused_attention"]
        finally:
            FA.uses_kernel = shipped
        if route == "warm-up":
            continue
        want = sites * VARIANT_TURN_STEPS if route == "kernel" else 0
        if got != want:
            raise AssertionError(f"variants {label} {route} turn: "
                                 f"fused_attention launched {got} times, "
                                 f"expected {want}")
        turns[route].append({
            "ms": statistics.median(a.elapsed_time(b) for a, b in ms[-6:]),
            "host_ms": statistics.median(host[-6:])})
    log(f"variants train {label} B={VARIANT_BATCH} bf16, the attention "
        f"sites' route in turns {'/'.join(VARIANT_TURNS)} (ms a step, "
        f"CUDA events / host enqueue, median of the last 6 of "
        f"{VARIANT_TURN_STEPS}): kernel "
        f"{[(round(t['ms'], 3), round(t['host_ms'], 3)) for t in turns['kernel']]}"
        f", plain "
        f"{[(round(t['ms'], 3), round(t['host_ms'], 3)) for t in turns['plain']]}")
    del runner, batches
    torch.cuda.empty_cache()
    return turns


def _gpt2_per_step(cfg):
    """GPT-2 layers a training step runs: every layer of every
    predictor."""
    common = cfg.model.common
    shared = common.share_predictors or \
        cfg.model.CMFP._target_.endswith("CMFPEarly")
    preds = 1 if shared else len(cfg.model.modal_dims.to_container())
    return int(common.fp_layers) * preds


def _grad_rels(run_k, run_p):
    """Per tensor max|g_k - g_p| over max|g_p| of two runners' last steps
    (their fp32 masters' gradients), by name."""
    rels = {}
    for (name, pk), pp in zip(run_k.model.named_parameters(),
                              run_p.masters):
        if pp.grad is None:
            if pk.grad is not None:
                raise AssertionError(f"{name}: a gradient on one path only")
            continue
        rels[name] = float((pk.grad - pp.grad).abs().max()) / max(
            float(pp.grad.abs().max()), 1e-30)
    return rels


def _grad_rel(run_k, run_p):
    """The worst (value, tensor) of ``_grad_rels``."""
    return max(((v, k) for k, v in _grad_rels(run_k, run_p).items()),
               default=(0.0, ""))


def _variant_fp32(cfg, label, classes, expected_kernel, expected_plain):
    """Two fp32 steps at VARIANT_FP32_BATCH through the kernels and two
    through their plain versions on the same masks: losses, gradients after
    each step (per tensor, VARIANT_GRAD_TOL of max|grad|), launch counts of
    each run. Returns the numbers."""
    import torch
    from afft_tpu_torch.ops import launch_counts, reset_launches
    from afft_tpu_torch.train.runner import Runner
    kernel = Runner.from_config(cfg, classes, device="cuda",
                                iters_per_epoch=1, compute_dtype="float32")
    plain = Runner.from_config(cfg, classes, device="cuda",
                               iters_per_epoch=1, compute_dtype="float32",
                               impl="plain",
                               weights=kernel.model.state_dict())
    batches = synthetic_batches(cfg, VARIANT_FP32_BATCH, 2, seed=11,
                                classes=classes)
    warmup = int(cfg.opt.warmup.num_epochs)
    out = {"loss_kernel": [], "loss_plain": [], "grad_rel": []}
    for i, batch in enumerate(batches):
        lr = kernel.lr_schedule(warmup + i, kernel.base_lr)
        for key, run, expected in (("kernel", kernel, expected_kernel),
                                   ("plain", plain, expected_plain)):
            reset_launches()
            loss = float(run.train_step(batch, lr, run.base_lr)[0]
                         ["total_loss"])
            _counts_ok(f"variants train {label} fp32 {key} step {i + 1}",
                       launch_counts(), expected)
            out[f"loss_{key}"].append(loss)
        out["grad_rel"].append(_grad_rel(kernel, plain))
    rel = max(abs(a - b) / abs(b) for a, b in zip(out["loss_kernel"],
                                                  out["loss_plain"]))
    worst = max(out["grad_rel"])
    log(f"variants train {label} fp32 B={VARIANT_FP32_BATCH}: 2 steps "
        f"through the kernels {out['loss_kernel']} vs the plain versions "
        f"{out['loss_plain']} on the same masks (loss rel diff {rel:.3g}); "
        f"gradients per tensor, worst by step "
        f"{[(f'{v:.3g}', n) for v, n in out['grad_rel']]} of max|grad| "
        f"(tol {VARIANT_GRAD_TOL:g}); launches a step {expected_kernel} / "
        f"plain {expected_plain}")
    if not (all(math.isfinite(v) for v in out["loss_kernel"])
            and rel <= VARIANT_GRAD_TOL and worst[0] <= VARIANT_GRAD_TOL):
        raise AssertionError(f"variants train {label} fp32: the kernel path "
                             "disagrees with the plain path")
    del kernel, plain, batches
    torch.cuda.empty_cache()
    return {"loss_rel": rel, "grad_rel_worst": worst[0],
            "grad_rel_tensor": worst[1], "losses": out["loss_kernel"]}


def _variant_bf16(cfg, label, classes, per_step):
    """VARIANT_STEPS bf16 steps at VARIANT_BATCH over fp32 masters, every
    step's launches asserted, a falling loss over VARIANT_DISTINCT_BATCHES
    batches; returns (launches, numbers)."""
    import torch
    from afft_tpu_torch.ops import launch_counts, reset_launches
    from afft_tpu_torch.train.runner import Runner
    runner = Runner.from_config(cfg, classes, device="cuda",
                                iters_per_epoch=1, compute_dtype="bfloat16")
    n_params = sum(p.numel() for p in runner.model.parameters())
    batches = synthetic_batches(cfg, VARIANT_BATCH, VARIANT_DISTINCT_BATCHES,
                                seed=12, classes=classes)
    warmup = int(cfg.opt.warmup.num_epochs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, events, host_ms = [], [], []
    # the main path: counts set to 0 just before, read just after
    reset_launches()
    for i in range(VARIANT_STEPS):
        before = launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        step, _ = runner.train_step(
            batches[i % len(batches)],
            runner.lr_schedule(warmup + i, runner.base_lr), runner.base_lr)
        end.record()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        events.append((start, end))
        losses.append(step["total_loss"])
        delta = {k: v - before[k] for k, v in launch_counts().items()}
        _counts_ok(f"variants train {label} bf16 step {i + 1}", delta,
                   per_step)
    torch.cuda.synchronize()
    launches = launch_counts()
    losses = [float(v) for v in losses]
    k = VARIANT_DISTINCT_BATCHES
    first, last = sum(losses[:k]) / k, sum(losses[-k:]) / k
    ms = statistics.median(a.elapsed_time(b) for a, b in events[-5:])
    host = statistics.median(host_ms[-5:])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"variants train {label} bf16 B={VARIANT_BATCH}: {n_params / 1e6:.1f}"
        f" M params, {VARIANT_STEPS} steps over {k} batches, launches per "
        f"step { {n: c for n, c in per_step.items()} } and 0 of every other "
        f"kernel; total loss by step {[round(v, 4) for v in losses]} (mean "
        f"of the first {k} {first:.4f}, of the last {k} {last:.4f}); "
        f"ms_per_step={ms:.3f} (CUDA events, median of the last 5) "
        f"clips_per_s={VARIANT_BATCH / ms * 1e3:.1f} host_enqueue_ms="
        f"{host:.3f} peak_mem_GB={peak_gb:.2f}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"variants train {label} bf16: non-finite loss")
    if not last < first:
        raise AssertionError(f"variants train {label} bf16: the loss did not "
                             "fall")
    del runner, batches
    torch.cuda.empty_cache()
    return launches, {"params": n_params, "ms_per_step": ms,
                      "clips_per_s": VARIANT_BATCH / ms * 1e3,
                      "host_enqueue_ms": host, "peak_mem_GB": peak_gb,
                      "losses": losses}


def _variant_expt_file(src, dst, drop_prefix, extra):
    """``src``'s lines without those starting with ``drop_prefix``, then
    ``extra``, written to ``dst``."""
    from afft_tpu_torch.config import expt_lines_without
    with open(dst, "w") as f:
        f.write("\n".join(expt_lines_without(src, (drop_prefix,))
                          + list(extra)) + "\n")
    return dst


def _variant_launcher():
    """Expt 05's model through ``python -m afft_tpu_torch.run -c
    <98_synth_accept_train with expt 05's model lines> -m train`` for one
    epoch on phase 8's cut accept set, then ``-m test`` on its
    checkpoint_best; the checkpoint reloads and its logits through the
    kernels agree with the plain path's. Returns (the training run's
    launches, numbers)."""
    from afft_tpu_torch import serve
    from afft_tpu_torch.tools.make_accept_dataset import (N_CLASSES,
                                                          make_accept_dataset)
    from afft_tpu_torch.train.checkpoint import load_checkpoint
    workdir = os.path.join(REPO, "build", "launcher")
    if not os.path.isdir(os.path.join(workdir, ".accept_data")):
        os.makedirs(workdir, exist_ok=True)
        make_accept_dataset(os.path.join(workdir, ".accept_data"),
                            **LAUNCH_SET)
    train_expt = _variant_expt_file(
        os.path.join(EXPTS, LAUNCH_EXPT),
        os.path.join(workdir, "variant05_train.txt"), "model.fuser.",
        VARIANT_LAUNCH_MODEL)
    val_expt = _variant_expt_file(
        os.path.join(EXPTS, EVAL_EXPT),
        os.path.join(workdir, "variant05_val.txt"), "model.fuser.",
        VARIANT_LAUNCH_MODEL)
    _, seconds = _logged_run(
        [sys.executable, "-m", "afft_tpu_torch.run", "-c", train_expt, "-m",
         "train", *LAUNCH_OVERRIDES, "experiment_name=variant05",
         "train.num_epochs=1", "+overwrite=true"], workdir, "variant05-train",
        LAUNCH_TIMEOUT)
    ckpt_dir = os.path.join(workdir, "checkpoints", VARIANT_LAUNCH_DIR)
    with open(os.path.join(ckpt_dir, "metrics.jsonl")) as f:
        epoch = [json.loads(line) for line in f][-1]
    with open(os.path.join(ckpt_dir, "summary.jsonl")) as f:
        run = [json.loads(line) for line in f][-1]["run"]
    cfg = serve.load_config(train_expt, [f"cwd={workdir}"])
    layers = _gpt2_per_step(cfg)
    _counts_ok("variants launcher", run["launches"], {
        **{n: layers * run["train_iters"]
           for n, _ in TRAIN_KERNELS["fused_gpt2_train"][:3]},
        "gpt2_attn_half": layers * run["val_batches"],
        "gpt2_mlp_half": layers * run["val_batches"]})
    loss = epoch["train_total_loss"]
    log(f"variants launcher: expt 05's model ({' '.join(VARIANT_LAUNCH_MODEL)}"
        f") on {LAUNCH_EXPT}: one epoch, exit 0 in {seconds:.1f} s, "
        f"{run['train_iters']} iterations and {run['val_batches']} "
        f"validation batches on {run['device']}; train loss {loss}, window "
        f"{_window_ms(epoch):.3f} ms an iteration, median ms_per_iter="
        f"{epoch['ms_per_iter']:.3f} host_ms_per_iter="
        f"{epoch['host_ms_per_iter']:.3f} clips_per_s="
        f"{epoch['clips_per_s']:.1f}; launches {run['launches']}")
    if not math.isfinite(loss):
        raise AssertionError("variants launcher: non-finite loss")
    test = _eval_run(workdir, "variant05-test", (
        f"init_from_model={VARIANT_LAUNCH_DIR}/checkpoint_best",
        "save_name=null"), expt=val_expt)
    _counts_ok("variants launcher -m test", test["launches"], {
        "gpt2_attn_half": layers * test["batches"],
        "gpt2_mlp_half": layers * test["batches"]})
    state = load_checkpoint(os.path.join(ckpt_dir, "checkpoint_best"))
    _checkpoint_logits_ok(cfg, {"action": N_CLASSES}, state["model"],
                          f"{VARIANT_LAUNCH_DIR}/checkpoint_best")
    return run["launches"], {
        "train_s": seconds, "train_loss": loss,
        "window_ms_per_iter": _window_ms(epoch),
        "ms_per_iter": epoch["ms_per_iter"],
        "host_ms_per_iter": epoch["host_ms_per_iter"],
        "clips_per_s": epoch["clips_per_s"], "test_s": test["seconds"],
        "test_clips_per_s": test["clips_per_s"],
        "accuracies": {k: test["accuracies"][k] for k in
                       ("atop1", "atop5", "amt5r")}}


def phase_variants():
    """Expts 00 (IndividualFuturePrediction) and 05 (CMFPScoreFusion with
    MATT) served at full width through ``Server.answer``; expts 00, 03,
    04 and 05 trained through ``Runner.train_step`` (fp32 kernels against
    plain, then bf16 steps), 03 and 04 again at attention dropout 0 (row 4
    under autograd, both again); expt 05's model trained and tested through
    the launcher. Returns ({kernel: launches summed over the phase's
    counted runs: the served answers, the bf16 steps and the launcher's
    training run; not the fp32 comparisons}, numbers)."""
    import torch
    from afft_tpu_torch import serve

    launches, numbers = {}, {}

    def add(counts):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n

    for label, expt, overrides, expected_fn in VARIANT_SERVED:
        counted, numbers[label] = serve_path(label, expt, overrides,
                                             expected_fn)
        add(counted)
        torch.cuda.empty_cache()

    gpt2 = [n for n, _ in TRAIN_KERNELS["fused_gpt2_train"][:3]]
    classes = TRAIN_CLASSES
    cfgs = {expt: serve.load_config(os.path.join(EXPTS, expt))
            for expt in VARIANT_TRAINED}
    numbers["shapes"] = _variant_layer_checks(list(cfgs.values()))
    for expt, cfg in cfgs.items():
        label = expt.split("_ek100")[0]
        per_step = dict.fromkeys(gpt2, _gpt2_per_step(cfg))
        plain_step = {"draw_masks_gpt2": _gpt2_per_step(cfg)}
        t0 = time.perf_counter()
        fp32 = _variant_fp32(cfg, label, classes, per_step, plain_step)
        counted, bf16 = _variant_bf16(cfg, label, classes, per_step)
        add(counted)
        numbers[label] = {"fp32": fp32, "bf16": bf16}
        if "fuser" in cfg.model and cfg.model.fuser._target_.split(".")[-1] \
                in ("TemporalCMFuser", "TemporalCrossAttentFuser"):
            # attention dropout 0: row 4's kernel at every attention site
            # of the fuser, its backward the plain formula
            cfg0 = serve.load_config(os.path.join(EXPTS, expt),
                                     ["model.fuser.attn_drop_rate=0.0"])
            sites = (int(cfg0.model.fuser.depth) if "depth" in cfg0.model.fuser
                     else 2 * (len(cfg0.model.modal_dims.to_container()) - 1))
            with_attn = {**per_step, "fused_attention": sites}
            numbers[label]["attn_drop_0"] = {
                "fp32": _variant_fp32(cfg0, f"{label} attn_drop 0", classes,
                                      with_attn, plain_step),
                "fused_attention_a_step": sites}
            counted, numbers[label]["attn_drop_0"]["bf16"] = _variant_bf16(
                cfg0, f"{label} attn_drop 0", classes, with_attn)
            add(counted)
            numbers[label]["attn_drop_0"]["turns"] = _attn_route_turns(
                cfg0, f"{label} attn_drop 0", classes, sites)
        numbers[label]["seconds"] = time.perf_counter() - t0
    counted, numbers["launcher"] = _variant_launcher()
    add(counted)
    return launches, numbers


# -- serving extras: CUDA graphs per bucket, the concurrent server, int8 -----

GRAPH_BUCKETS = (8, 64, 256)
ROLLOUT_BUCKET = 256
LATENCY_BATCHES = (1, 8, 32, 64, 256)
LATENCY_ITERS = 10
EXPT00_BATCHES = (8, 256)
ROLLOUT_BATCHES = (8, 256)
ANSWER_ITERS = 10
SWEEP_SECONDS = 2.0
SERVING_DIR = os.path.join(REPO, "build", "serving")
# int8 transport + top-k against the native bf16 path's dense logits, per
# clip: max |top-k score - the dense logit of its class| over max|logit|,
# the bound tests/test_serve_concurrent.py:180 holds the JAX bundle to
INT8_REL_TOL = 0.05
# softmax rows of a bf16 model: each weight is rounded to bf16 (at most
# 2^-8 of itself), so a row's sum is 1 within 2^-8 of the weights' sum
ATTN_ROW_TOL = 2.0 ** -8


def _pinned(batch):
    return tuple({m: x.pin_memory() for m, x in part.items()}
                 for part in batch)


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _host_turns(fns, iters):
    """Each callable's mean host ms over ``iters`` calls (each ends with its
    result on the host), in turns a, b, b, a; the mean of its two turns."""
    times = {k: [] for k in fns}
    for k in list(fns) + list(fns)[::-1]:
        fns[k]()
        t0 = time.perf_counter()
        for _ in range(iters):
            fns[k]()
        times[k].append((time.perf_counter() - t0) / iters * 1e3)
    return {k: sum(v) / len(v) for k, v in times.items()}


def _hold_plain(label, server, feats, out):
    """Hold a served output against the plain path's logits on the same
    device features ({mod: (B, T, F)} in the serving dtype), as
    ``serve_path`` holds the served forward: finite, within 5e-2 of
    max|logit|, and the bf16 top-1 form. ``out`` is the dense fp32 logits,
    or the top-k (values, indices): its values are held against the plain
    logits of the classes it names, and its first index is its pick. A
    batch of fewer than 64 rows is too small to ask that half its rows be
    decided; every row's pick must still lie within 2 ulps of the plain
    top-1. Returns the numbers."""
    import torch
    with torch.no_grad():
        plain = server.head_logits(server.model(feats, impl="plain"))
    plain = plain.reshape(-1, plain.shape[-1])
    if isinstance(out, tuple):
        vals, idx = (o.reshape(-1, o.shape[-1]) for o in out)
        ref = plain.gather(1, idx)
        # the top-k as dense rows, -inf elsewhere: their argmax is the pick
        dense = torch.full_like(plain, float("-inf")).scatter(1, idx, vals)
    else:
        vals = dense = out.reshape(-1, out.shape[-1])
        ref = plain
    finite = bool(vals.isfinite().all())
    max_abs = (vals - ref).abs().max().item()
    tol = 5e-2 * plain.abs().max().item()
    top1_ok, text = top1_report(dense, plain, need_decided=len(plain) >= 64)
    log(f"{label}: vs the plain path on the same features, {len(plain)} "
        f"rows: finite={finite} max_abs_diff={max_abs:.6g} (tol {tol:.6g} "
        f"= 5e-2 * max|logit|); {text}")
    if not (finite and max_abs <= tol and top1_ok):
        raise AssertionError(f"{label}: the served output strays from the "
                             "plain path")
    return {"max_abs_diff": max_abs, "tol": tol}


def _hold_graphs_plain(label, graphs):
    """Every bucket of a ``GraphServer`` whose static inputs hold a batch
    already (``serving_latency.measure``'s): one replay held against the
    plain path on those inputs (``_hold_plain``)."""
    import torch
    held = {}
    for b in graphs.buckets:
        with graphs.stream_context():
            out = tuple(o.clone() for o in _as_tuple(graphs.replay(b)))
        graphs.stream.synchronize()
        out = out if len(out) > 1 else out[0]
        held[str(b)] = _hold_plain(f"{label} B={b}", graphs.server,
                                   graphs.inputs[b][0], out)
    torch.cuda.synchronize()
    return held


def _graph_bundle(label, lines, buckets, expected, **kw):
    """Export a bundle of ``lines`` at ``buckets`` (bf16, seeded weights
    unless ``weights``), load it on the card (one CUDA graph a bucket) and
    hold every bucket's replay against the eager kernel forward at the same
    padded batch, bit for bit, and against the plain path on the same
    (dequantized) features (``_hold_plain``); the launches counted at each
    capture must be ``expected``, and a profile of one replay of each bucket
    must show the afft kernels of a profile of one eager forward, each as
    often. The two profiles give the device's busy share of each. Returns
    (graph server, eager server, meta, numbers)."""
    import shutil
    import torch
    from afft_tpu_torch import serve
    from afft_tpu_torch.ops import launch_counts, reset_launches
    from afft_tpu_torch.serving.graphs import EagerBucketServer
    from afft_tpu_torch.tools.export_serving import export_bundle
    from afft_tpu_torch.tools.serve_bundle import (load_bundle_buckets,
                                                   random_batch)

    out = os.path.join(SERVING_DIR, label)
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    export_bundle(lines, out, {"action": 3806}, list(buckets), "bfloat16",
                  log=log, device="cuda", **kw)
    export_s = time.perf_counter() - t0
    # the main path: counts set to 0 just before the load (build, warm-up,
    # capture), read just after
    reset_launches()
    t0 = time.perf_counter()
    runner, meta = load_bundle_buckets(out, "cuda", log=log)
    load_s = time.perf_counter() - t0
    counted = launch_counts()
    eager = EagerBucketServer(runner.server, runner.buckets,
                              input_dtype=runner.input_dtype,
                              topk=runner.topk)
    full = dict.fromkeys(counted, 0)
    full.update(expected)
    numbers = {"export_s": export_s, "cold_start_s": load_s,
               "capture_s": dict(runner.capture_s),
               "pool_bytes": dict(runner.pool_bytes),
               "capture_launches": dict(runner.capture_launches),
               "load_launches": {k: n for k, n in counted.items() if n},
               "plain": {}, "busy": {}}
    for b in runner.buckets:
        got = dict.fromkeys(counted, 0)
        got.update(runner.capture_launches[b])
        if got != full:
            raise AssertionError(f"{label} bucket {b}: launches counted at "
                                 f"capture {runner.capture_launches[b]}, "
                                 f"expected {expected}")
        batch = _pinned(random_batch(meta, b, seed=b))
        with runner.stream_context():
            graph = tuple(o.clone() for o in _as_tuple(runner.run(b, *batch)))
        runner.stream.synchronize()
        with torch.no_grad():
            ref = _as_tuple(eager.run(b, *batch))
        torch.cuda.synchronize()
        same = all(torch.equal(g, e) for g, e in zip(graph, ref))
        log(f"{label} bucket {b}: replay vs the eager kernel forward at the "
            f"same padded batch: bit for bit {same}; outputs "
            f"{[tuple(o.shape) for o in graph]}, finite "
            f"{bool(graph[0].float().isfinite().all())}")
        if not same or not bool(graph[0].float().isfinite().all()):
            raise AssertionError(f"{label} bucket {b}: graph replay differs "
                                 "from the eager forward")
        feats = {m: x.to("cuda") for m, x in batch[0].items()}
        if runner.int8:
            feats = {m: serve.dequantize(q, batch[1][m].to("cuda"),
                                         runner.server.dtype)
                     for m, q in feats.items()}
        numbers["plain"][str(b)] = _hold_plain(
            f"{label} bucket {b}", runner.server, feats,
            graph if len(graph) > 1 else graph[0])
        prof = _graph_profiles(lambda: eager.fn(*runner.inputs[b]),
                               lambda: runner.replay(b), f"{label} b{b}")
        numbers["busy"][str(b)] = {
            k: {"busy_ms": v["busy_ms"], "wall_ms": v["wall_ms"],
                "busy_share": v["busy_share"]} for k, v in prof.items()}
        numbers["replay_kernels"] = {
            k[:80]: n for k, n in prof["graph"]["kernels"].items()}
        log(f"{label} bucket {b}: a profile of one replay shows the eager "
            f"forward's {sum(prof['graph']['kernels'].values())} launches "
            f"of {len(prof['graph']['kernels'])} afft kernels")
    return runner, eager, meta, numbers


def _graph_profiles(eager_fn, replay_fn, what, attempts=3):
    """The eager forward's profile and the graph replay's, whose afft
    launches must be the eager trace's exactly. The profiler now and then
    drops the first device events of a trace, the eager one's too (a
    replay held to a partial eager trace can never match it), so a replay
    that matches no trace of ``profile_forward``'s retakes is held to a
    new eager trace, up to ``attempts`` eager traces in all."""
    for attempt in range(attempts):
        prof = {"eager": profile_forward(eager_fn, f"{what} eager forward")}
        try:
            prof["graph"] = profile_forward(replay_fn, f"{what} graph replay",
                                            want=prof["eager"]["kernels"])
            return prof
        except RuntimeError:
            if attempt + 1 == attempts:
                raise
            log(f"profile: {what}: no replay trace matched the eager trace "
                f"of {sum(prof['eager']['kernels'].values())} launches; the "
                f"eager forward is traced again (attempt {attempt + 2} of "
                f"{attempts})")


def phase_serving_graphs():
    """Bundles on the card: the flagship (dense logits, buckets 8 / 64 /
    256), its rollout (``fp_output_len`` 4, one bucket) and the flagship
    with int8 transport and top-5 (8 / 64 / 256), each bucket a CUDA graph
    held against the eager kernel forward and the plain path; int8 against
    the native bf16 path; per bucket the answer (host in, top-k out) and
    the forward on device features, graph against eager in turns, the
    device's busy share, capture seconds and pool bytes; ``serving_latency``
    at 1 / 8 / 32 / 64 / 256 (the rollout and expt 00 at 8 / 256), each of
    its graphs held against the plain path; the concurrent server's sweep
    and a malformed request. Returns
    ({kernel: {graph: launches counted at its capture}}, numbers)."""
    import numpy as np
    import torch
    from afft_tpu_torch import serve
    from afft_tpu_torch.config import read_expt_file
    from afft_tpu_torch.data.readers import PackedFeatureStore
    from afft_tpu_torch.tools import serve_concurrent as SC
    from afft_tpu_torch.tools import serving_latency
    from afft_tpu_torch.tools.export_serving import BUNDLE_WEIGHTS
    from afft_tpu_torch.tools.serve_bundle import random_batch

    lines = read_expt_file(FLAGSHIP)
    cfg = serve.load_config(FLAGSHIP)
    dims = (int(cfg.model.fuser.depth), int(cfg.model.common.fp_layers),
            len(cfg.model.modal_dims.to_container()))
    numbers, graph_launches = {}, {}

    def record(label, runner):
        for b, counts in runner.capture_launches.items():
            for k, n in counts.items():
                graph_launches.setdefault(k, {})[f"{label} b{b}"] = n

    flag, flag_eager, _, numbers["flagship"] = _graph_bundle(
        "flagship", lines, GRAPH_BUCKETS, SERVED_PATHS[0][3](*dims))
    record("flagship", flag)
    roll, _, _, numbers["rollout"] = _graph_bundle(
        "rollout", lines + [f"model.common.fp_output_len={ROLLOUT_LEN}"],
        (ROLLOUT_BUCKET,), SERVED_PATHS[1][3](*dims))
    record("rollout", roll)
    numbers["rollout_latency_ms"], lat = serving_latency.measure(
        roll.server, ROLLOUT_BATCHES, LATENCY_ITERS, log=log)
    numbers["rollout_latency_plain"] = _hold_graphs_plain("rollout latency",
                                                          lat)
    del roll, lat
    torch.cuda.empty_cache()
    weights = torch.load(os.path.join(SERVING_DIR, "flagship",
                                      BUNDLE_WEIGHTS), map_location="cpu")
    i8, i8_eager, i8_meta, numbers["int8_top5"] = _graph_bundle(
        "int8_top5", lines, GRAPH_BUCKETS, SERVED_PATHS[0][3](*dims),
        input_dtype="int8", topk=5, weights=weights)
    record("int8_top5", i8)

    # int8 transport against the native bf16 path, the same weights and clips
    b = GRAPH_BUCKETS[-1]
    rng = np.random.default_rng(11)
    x = {m: rng.standard_normal((b, i8.n_frames, d), dtype=np.float32)
         for m, d in i8.modal_dims.items()}
    q, s = {}, {}
    for m, v in x.items():
        qm, sm = PackedFeatureStore._quantize_rows(v.reshape(-1, v.shape[-1]))
        q[m] = torch.from_numpy(qm.reshape(v.shape)).pin_memory()
        s[m] = torch.from_numpy(sm.reshape(v.shape[:2])).pin_memory()
    with flag.stream_context():
        dense = flag.run(b, {m: torch.from_numpy(v).bfloat16().pin_memory()
                             for m, v in x.items()}).clone()
    with i8.stream_context():
        vals, idx = (o.clone() for o in i8.run(b, q, s))
    torch.cuda.synchronize()
    rel = ((vals - dense.gather(1, idx)).abs().amax(1)
           / dense.abs().amax(1)).max().item()
    top1 = (idx[:, 0] == dense.argmax(1)).float().mean().item()
    T, F = i8.n_frames, sum(i8.modal_dims.values())
    log(f"int8 transport + top-5 vs the native bf16 dense logits, B={b}: "
        f"max over clips of |top-k score - its dense logit| / max|logit| = "
        f"{rel:.6g} (tol {INT8_REL_TOL}, tests/test_serve_concurrent.py:180)"
        f"; top-1 agreement {top1:.4f}; feature bytes a clip over the link "
        f"{T * F + 4 * T * len(x)} (int8 + scales) vs {2 * T * F} (bf16)")
    if not rel < INT8_REL_TOL:
        raise AssertionError("int8 transport strays from the native path")
    numbers["int8_vs_native"] = {"rel": rel, "top1_agree": top1}

    # per bucket: the answer (host int8 in, top-5 out), graph vs eager
    answer = {}
    for b in i8.buckets:
        batch = _pinned(random_batch(i8_meta, b, seed=b))
        hosts = tuple(torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                      for o in i8.outputs[b])

        def graph(b=b, batch=batch, hosts=hosts):
            with i8.stream_context():
                for h, o in zip(hosts, i8.run(b, *batch)):
                    h.copy_(o, non_blocking=True)
            i8.stream.synchronize()

        def eager(b=b, batch=batch):
            with torch.no_grad():
                for o in i8_eager.run(b, *batch):
                    o.cpu()

        answer[str(b)] = _host_turns({"graph": graph, "eager": eager},
                                     ANSWER_ITERS)
        log(f"int8_top5 bucket {b}: answer ms (pinned int8 + scales in, "
            f"top-5 on the host) graph {answer[str(b)]['graph']:.3f}, eager "
            f"{answer[str(b)]['eager']:.3f}")
    numbers["answer_ms"] = answer

    # per bucket: the forward on device features, graph vs eager in turns
    # (serving_latency), and the device's busy share of one call
    latency, lat_graphs = serving_latency.measure(
        flag.server, LATENCY_BATCHES, LATENCY_ITERS, log=log)
    numbers["latency_ms"] = latency
    numbers["latency_capture_s"] = dict(lat_graphs.capture_s)
    numbers["latency_plain"] = _hold_graphs_plain("flagship latency",
                                                  lat_graphs)
    del lat_graphs
    # expt 00 (12 launches a forward, the most host-bound served path)
    _, expt00, _, expected00 = VARIANT_SERVED[0]
    cfg00 = serve.load_config(os.path.join(EXPTS, expt00))
    want00 = expected00(0, int(cfg00.model.common.fp_layers),
                        len(cfg00.model.modal_dims.to_container()))
    numbers["expt00_latency_ms"], g00 = serving_latency.measure(
        serve.Server(cfg00, {"action": 3806}, "bfloat16", "cuda"),
        EXPT00_BATCHES, LATENCY_ITERS, log=log)
    for b, counts in g00.capture_launches.items():
        if counts != want00:
            raise AssertionError(f"expt 00 bucket {b}: launches counted at "
                                 f"capture {counts}, expected {want00}")
    numbers["expt00_latency_plain"] = _hold_graphs_plain("expt00 latency",
                                                         g00)
    record("expt00", g00)
    del g00, flag, flag_eager, i8, i8_eager
    torch.cuda.empty_cache()

    # the concurrent server over the int8 + top-5 bundle
    server = SC.BundleServer(os.path.join(SERVING_DIR, "int8_top5"),
                             max_wait_ms=2.0, max_inflight=2, device="cuda",
                             log=log)
    sweep = []
    try:
        def report(res):
            res["batch_hist"] = {str(k): v for k, v in
                                 server.batch_hist.items() if v}
            for k in server.batch_hist:
                server.batch_hist[k] = 0
            # the host's seconds by stage and thread since the last report;
            # the scheduler thread's busy share of that wall
            res["host_s"] = server.take_host_times()
            res["scheduler_busy_share"] = sum(
                res["host_s"][k] for k in ("assemble", "quantize", "stage",
                                           "replay")) / res["host_s"]["wall_s"]
            log(f"serve_concurrent: {json.dumps(res)}")
            sweep.append(res)

        SC.sweep(server, SWEEP_SECONDS, report)
        rng = np.random.default_rng(12)
        good = SC._random_clip(server.meta, rng)
        first = [server.submit(good) for _ in range(5)]
        first = [f.result(timeout=120)[0] for f in first]
        bad = server.submit({m: np.zeros((server.meta["num_frames"], d + 1),
                                         np.float32)
                             for m, d in server.meta["modal_dims"].items()})
        try:
            bad.result(timeout=120)
            raise AssertionError("a malformed request was answered")
        except ValueError as e:
            log(f"serve_concurrent: the malformed request failed its batch: "
                f"{e}")
        after = [server.submit(good) for _ in range(5)]
        outs = [f.result(timeout=120)[0] for f in after]
        # one clip, ten answers around the failed batch: all the same
        same = all(np.array_equal(o[0], first[0][0]) and
                   np.array_equal(o[1], first[0][1]) for o in first + outs)
        log(f"serve_concurrent: 5 answers before and 5 after it, one clip: "
            f"top-5 {first[0][1].tolist()}, all equal {same}")
        if not same:
            raise AssertionError("the server's answers to one clip differ")
    finally:
        server.close()
    numbers["sweep"] = sweep
    return graph_launches, numbers


def _fresh_process(phase):
    """``phase()`` of this script in a process of its own (its output
    joins this one's), returning its result. Phase 12's graphs run there:
    late in a long smoke process, a trace of a graph replay came back
    without the replay's first ~30 kernels, every attempt, while every
    fresh process traced it whole."""
    import torch
    torch.cuda.empty_cache()  # the card's memory for the other process
    out = os.path.join(SERVING_DIR, f"{phase}.json")
    os.makedirs(SERVING_DIR, exist_ok=True)
    if os.path.exists(out):
        os.remove(out)
    code = ("import json, sys, torch; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke as CS; "
            "torch.backends.cuda.matmul.allow_tf32 = False; "
            "torch.backends.cudnn.allow_tf32 = False; "
            f"res = CS.{phase}(); "
            "json.dump(res, open(sys.argv[2], 'w'))")
    sys.stdout.flush()
    proc = subprocess.run([sys.executable, "-c", code, REPO, out],
                          timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"{phase}: its process exited with "
                             f"{proc.returncode}")
    with open(out) as f:
        return json.load(f)


def phase_serving_data():
    """On phase 8's cut set and checkpoint: the int8 device cache against the
    bf16 one (half the payload; the gather within the int8 bound), ``-m
    test`` with ``data_on_device_dtype=int8`` and ``-m
    visualize_attention`` (its dumps' keys and rows), which runs beside the
    rest (so the int8 run's clips/s is a shared card's). Returns
    numbers."""
    import shutil
    import numpy as np
    import torch
    from afft_tpu_torch import serve
    from afft_tpu_torch.data.device_cache import DeviceFeatureCache
    from afft_tpu_torch.data.loader import get_dataset
    from afft_tpu_torch.train.loop import get_transforms

    workdir = os.path.join(REPO, "build", "launcher")
    init = f"init_from_model={EVAL_MODEL}/checkpoint_best"
    out_dir = os.path.join(workdir, "attention_maps")
    shutil.rmtree(out_dir, ignore_errors=True)
    vis = _start_run(
        [sys.executable, "-m", "afft_tpu_torch.run", "-c",
         os.path.join(EXPTS, EVAL_EXPT), "-m", "visualize_attention",
         *LAUNCH_OVERRIDES, init, f"+attn_out_dir={out_dir}",
         "+attn_max_batches=1"], workdir, "visualize")
    cfg = serve.load_config(os.path.join(EXPTS, EVAL_EXPT),
                            (f"cwd={workdir}", init, *LAUNCH_OVERRIDES))
    dataset = get_dataset(cfg.dataset_eval, cfg.data_eval,
                          get_transforms(cfg, train=False))
    bf16 = DeviceFeatureCache(dataset, "cuda")
    int8 = DeviceFeatureCache(dataset, "cuda", dtype="int8")
    payload = sum(f.numel() for f in int8.features.values())
    if 2 * payload != bf16.nbytes:
        raise AssertionError("the int8 payload is not half the bf16 cache")
    indices = np.arange(len(dataset))
    idx = torch.from_numpy(indices).cuda()
    host = dataset.load_batch(indices)["data_dict"]
    worst, zeros = 0.0, 0
    for m in int8.features:
        x = torch.from_numpy(np.asarray(host[m], np.float32)).cuda()
        g8, g16 = int8.take(m, idx).float(), bf16.take(m, idx).float()
        step = x.abs().amax(-1, keepdim=True) / 127.0
        bound = 0.5 * step * (1 + 1e-6) + 2.0 ** -8 * (g8.abs() + x.abs())
        worst = max(worst, ((g8 - g16).abs() / bound.clamp_min(1e-30))
                    .max().item())
        zero = (x == 0).all(-1)
        zeros += int(zero.sum())
        if bool((g8[zero] != 0).any()):
            raise AssertionError(f"{m}: an all-zero frame is not zero")
    log(f"device cache int8 on {len(dataset)} clips: {int8.nbytes} bytes "
        f"({payload} payload + scales) vs bf16 {bf16.nbytes}; worst |int8 - "
        f"bf16| over its bound (half a step + bf16 rounding) {worst:.4f} "
        "(<= 1); all-zero frames "
        f"{zeros}, each exactly 0")
    if not worst <= 1.0:
        raise AssertionError("the int8 cache strays beyond its bound")
    numbers = {"cache": {"clips": len(dataset), "int8_bytes": int8.nbytes,
                         "int8_payload_bytes": payload,
                         "bf16_bytes": bf16.nbytes,
                         "worst_over_bound": worst, "zero_frames": zeros}}
    del bf16, int8
    torch.cuda.empty_cache()
    run = _eval_run(workdir, "eval-int8",
                    (init, "save_name=null", "data_on_device_dtype=int8"))
    depth, layers = int(cfg.model.fuser.depth), int(cfg.model.common.fp_layers)
    _counts_ok("eval int8", run["launches"], {
        "fused_block": depth * run["batches"],
        "gpt2_attn_half": layers * run["batches"],
        "gpt2_mlp_half": layers * run["batches"]})
    numbers["eval_int8"] = {k: run[k] for k in ("clips", "batches",
                                                "clips_per_s", "seconds")}

    _, vis_s = _finish_run(vis, EVAL_TIMEOUT)
    dump = np.load(os.path.join(out_dir, "batch_0000.npz"),
                   allow_pickle=False)
    want = {"uids", "all-fused/modality_attns",
            "all-fused/temporal_attns/gpt2_att_0"}
    if set(dump.files) != want or dump["uids"].dtype.kind != "U":
        raise AssertionError(f"visualize: dump keys {dump.files}, expected "
                             f"{sorted(want)} with unicode uids")
    rows = {k: float(np.abs(dump[k].astype(np.float64).sum(-1) - 1).max())
            for k in want - {"uids"}}
    log(f"visualize_attention: exit 0 in {vis_s:.1f} s; dump keys "
        f"{sorted(dump.files)}, shapes "
        f"{ {k: dump[k].shape for k in dump.files} }; max |row sum - 1| "
        f"{rows} (tol {ATTN_ROW_TOL:.6g}: bf16 weights); png "
        f"{os.path.exists(os.path.join(out_dir, 'modality_attention.png'))}")
    if not all(v <= ATTN_ROW_TOL for v in rows.values()):
        raise AssertionError("visualize: attention rows do not sum to 1")
    numbers["visualize"] = {"seconds": vis_s, "max_row_err": rows}
    return numbers


# -- training options: grad_accum, bf16 masters, stochastic rounding, ZeRO-1

OPTIONS_ACCUM = (1, 2, 4)
OPTIONS_WARMUP_STEPS, OPTIONS_TIMED_STEPS = 2, 6
OPTIONS_BF16_STEPS = 10
# bf16 gradients of M microbatches against one pass: per parameter, over
# its own max|grad| (the bf16 gradient bound of PERF.md §2)
OPTIONS_GRAD_TOL = 2e-2
# the stochastic rounding's mean over SR_DRAWS draws, in ulps
SR_DRAWS, SR_TOL = 1 << 24, 1e-3
OPTIONS_ZERO_STEPS = 3


def _timed_steps(runner, batches, lrs, per_step):
    """Steps of ``runner`` with CUDA events around each and around each
    optimizer step, the launches of every step asserted against
    ``per_step``; no host synchronisation until the end. Returns (losses,
    median ms a step, median ms of the optimizer's step, peak GB)."""
    import torch
    from afft_tpu_torch.ops import launch_counts
    opt_events = []
    step = runner.optimizer.step
    gc.collect()

    def timed_step(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(*args, **kwargs)
        end.record()
        opt_events.append((start, end))
        return out
    runner.optimizer.step = timed_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, events = [], []
    for i, lr in enumerate(lrs):
        before = launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out, _ = runner.train_step(batches[i % len(batches)], lr,
                                   runner.base_lr)
        end.record()
        events.append((start, end))
        losses.append(out["total_loss"])
        delta = {k: v - before[k] for k, v in launch_counts().items()}
        _counts_ok(f"options step {i + 1}", delta, per_step)
    torch.cuda.synchronize()
    # the instance attribute goes (it would hold the optimizer, and so
    # the weights, in a reference cycle past the runner's deletion)
    del runner.optimizer.step
    skip = min(OPTIONS_WARMUP_STEPS, len(lrs) - 1)
    return ([float(v) for v in losses],
            statistics.median(a.elapsed_time(b) for a, b in events[skip:]),
            statistics.median(a.elapsed_time(b)
                              for a, b in opt_events[skip:]),
            torch.cuda.max_memory_allocated() / 1e9)


def _update_bytes(runner):
    """Bytes one optimizer step must move (its bound's): each parameter
    read and written, its fp32 gradient read, its state read and written.
    The step's own fp32 working copies and the rounding's random bits are
    not counted."""
    total = 0
    for p, st in zip(runner.optimizer.params, runner.optimizer.state):
        total += 2 * p.numel() * p.element_size() + 4 * p.numel()
        total += sum(2 * t.numel() * t.element_size() for t in st.values())
    return total


def _stochastic_rounding_on_card():
    """``stochastic_round_bf16`` on the card: bit for bit its result on the
    host from the same bits; exactly representable values unchanged
    whatever the bits; and unbiased: for values at chosen fractions of an
    ulp between two bf16 neighbours, the share of SR_DRAWS draws that round
    away lies within SR_TOL of the fraction."""
    import torch
    from afft_tpu_torch.train import optim as O
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    x = torch.randn(1 << 20, device="cuda", generator=gen) * 10
    bits = O.random_bits(x.shape, gen)
    card = O.stochastic_round_bf16(x, bits)
    host = O.stochastic_round_bf16(x.cpu(), bits.cpu())
    if not torch.equal(card.cpu().view(torch.int16), host.view(torch.int16)):
        raise AssertionError("options: stochastic rounding on the card "
                             "differs from the host's")
    exact = torch.tensor([1.0, -2.0, 0.5, 0.0, 3.0, float("inf"),
                          -float("inf"), 2.0 ** -100], device="cuda")
    many = exact.expand(4096, -1)
    if not torch.equal(O.stochastic_round_bf16(many,
                                               O.random_bits(many.shape,
                                                             gen)),
                       many.to(torch.bfloat16)):
        raise AssertionError("options: stochastic rounding changed an "
                             "exactly representable value")
    lo = torch.tensor([1.0, -3.0, 0.15625, 1000.0, 7.0, -0.01171875],
                      device="cuda")
    ulp = 2.0 ** (torch.floor(torch.log2(lo.abs())) - 7)  # bf16's spacing
    frac = torch.tensor([0.5, 0.25, 0.9, 0.01, 0.3333, 0.75],
                        device="cuda")
    value = lo + torch.sign(lo) * frac * ulp
    away = torch.zeros(len(lo), dtype=torch.int64, device="cuda")
    chunk = 1 << 21
    for _ in range(SR_DRAWS // chunk):
        rounded = O.stochastic_round_bf16(
            value.expand(chunk, -1), O.random_bits((chunk, len(lo)), gen))
        away += (rounded.float() != lo).sum(0)
    exact_frac = ((value - lo) / (torch.sign(lo) * ulp)).double().cpu()
    err = (away.double().cpu() / SR_DRAWS - exact_frac).abs()
    log(f"options: stochastic rounding on the card: 2^20 values bit for bit "
        f"the host's; 8 exact values unchanged over 4096 draws; share of "
        f"{SR_DRAWS} draws rounding away vs the fraction of an ulp "
        f"{[round(v, 6) for v in exact_frac.tolist()]}: error "
        f"{[f'{v:.2e}' for v in err.tolist()]} ulp (tol {SR_TOL:g})")
    if not (err <= SR_TOL).all():
        raise AssertionError("options: stochastic rounding is biased")
    return {"draws": SR_DRAWS, "max_err_ulp": float(err.max())}


def phase_options():
    """13. The training options through ``Runner.train_step`` and the
    launcher: gradient accumulation, bf16 masters with stochastic rounding
    and bf16 optimizer state, ZeRO-1 (its runs beside the launcher's, so
    their step times are a shared card's). Returns (the launches of its
    in-process training steps and its launcher run, numbers)."""
    import numpy as np
    import torch
    from afft_tpu_torch import serve
    from afft_tpu_torch.config import CONF_DIR, compose, expt_lines_without
    from afft_tpu_torch.data.loader import get_dataset
    from afft_tpu_torch.eval import challenge as PC
    from afft_tpu_torch.ops import launch_counts, reset_launches
    from afft_tpu_torch.train import optim as O
    from afft_tpu_torch.train.checkpoint import load_checkpoint
    from afft_tpu_torch.train.loop import get_transforms
    from afft_tpu_torch.train.runner import Runner

    numbers, launches = {}, {}
    expt = os.path.join(EXPTS, TRAIN_EXPT)
    cfg = serve.load_config(expt)
    depth, layers = int(cfg.model.fuser.depth), int(cfg.model.common.fp_layers)
    entries = [n for n, _ in TRAIN_KERNELS["fused_block_train"][:3]] + \
        [n for n, _ in TRAIN_KERNELS["fused_gpt2_train"][:3]]
    warmup = int(cfg.opt.warmup.num_epochs)
    batches = synthetic_batches(cfg, TRAIN_BATCH, 2, seed=21,
                                classes=TRAIN_CLASSES)
    reset_launches()
    zero = dict.fromkeys(launch_counts(), 0)

    def per_step(m):
        return {**zero, **{n: m * (depth if n.startswith("fused_block")
                                   else layers) for n in entries}}

    # (a) grad_accum M = 1 / 2 / 4, bf16 over fp32 masters, B = 256: the
    # first step with mixup off against M = 1's gradients (the expt's
    # dropout on: masks by the row's place in the step's batch), then
    # timed steps as the expt trains (mixup on)
    accum, first = {}, None
    for m in OPTIONS_ACCUM:
        runner = Runner.from_config(
            serve.load_config(expt, [f"train.grad_accum={m}"]),
            TRAIN_CLASSES, device="cuda", iters_per_epoch=1,
            compute_dtype="bfloat16")
        mixup, runner.mixup = runner.mixup, None
        lr = runner.lr_schedule(warmup, runner.base_lr)
        reset_launches()
        runner.train_step(batches[0], lr, runner.base_lr)
        _counts_ok(f"options grad_accum={m}", launch_counts(), per_step(m))
        grads = [p.grad.detach().to("cpu", copy=True)
                 for p in runner.masters]
        if first is None:
            first, worst = grads, (0.0, "")
        else:
            worst = (0.0, "")
            for (name, _), g, g1 in zip(runner.model.named_parameters(),
                                        grads, first):
                rel = float((g - g1).abs().max()) / max(
                    float(g1.abs().max()), 1e-30)
                worst = max(worst, (rel, name))
            if not worst[0] <= OPTIONS_GRAD_TOL:
                raise AssertionError(
                    f"options: grad_accum={m} gradients differ from one "
                    f"pass's by {worst[0]:.3g} of max|grad| ({worst[1]})")
        del grads
        runner.mixup = mixup
        reset_launches()
        steps = OPTIONS_WARMUP_STEPS + OPTIONS_TIMED_STEPS
        losses, ms, opt_ms, peak = _timed_steps(
            runner, batches, [runner.lr_schedule(warmup + 1 + i,
                                                 runner.base_lr)
                              for i in range(steps)], per_step(m))
        for k, n in launch_counts().items():
            launches[k] = launches.get(k, 0) + n
        accum[m] = {"ms_per_step": ms, "optimizer_ms": opt_ms,
                    "peak_mem_GB": peak, "grad_rel_diff_vs_M1": worst[0],
                    "launches_per_step": {n: per_step(m)[n]
                                          for n in entries}}
        if m == 1:
            accum[m]["update_bytes"] = _update_bytes(runner)
        log(f"options grad_accum={m} B={TRAIN_BATCH} (microbatches of "
            f"{TRAIN_BATCH // m}): first step's gradients vs one pass, mixup "
            f"off: max {worst[0]:.3g} of max|grad| ({worst[1] or 'M=1'}; "
            f"tol {OPTIONS_GRAD_TOL:g}); {OPTIONS_TIMED_STEPS} timed steps "
            f"after {OPTIONS_WARMUP_STEPS}: ms_per_step={ms:.3f} "
            f"optimizer_ms={opt_ms:.3f} peak_mem_GB={peak:.3f}; launches "
            f"per step {m} x {depth} / {layers} of each training entry")
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"options grad_accum={m}: non-finite loss")
        del runner
        torch.cuda.empty_cache()
    del first
    numbers["grad_accum"] = accum

    # (b) bf16 masters (and bf16 optimizer state) at M = 1: SGD-nesterov as
    # the expt, then Adam (its lr a tenth); ten steps on one batch, mixup
    # off, the loss falling
    masters = {}
    fp32 = accum[1]
    for label, drop, more in (
            ("sgd_nesterov", (), []),
            ("adam", ("opt.optimizer.nesterov",),
             ["opt/optimizer=adam", f"opt.lr={float(cfg.opt.lr) / 10}"])):
        runner = Runner.from_config(
            compose(CONF_DIR, expt_lines_without(expt, drop) + [
                "model.compute_dtype=bfloat16",
                "train.master_dtype=bfloat16",
                "opt.optimizer.state_dtype=bfloat16", *more]),
            TRAIN_CLASSES, device="cuda", iters_per_epoch=1)
        if not (runner.masters[0].dtype == torch.bfloat16
                and runner.compute is runner.masters):
            raise AssertionError("options: bf16 masters were not built")
        runner.mixup = None
        reset_launches()
        losses, ms, opt_ms, peak = _timed_steps(
            runner, batches[:1], [runner.lr_schedule(warmup + i,
                                                     runner.base_lr)
                                  for i in range(OPTIONS_BF16_STEPS)],
            per_step(1))
        for k, n in launch_counts().items():
            launches[k] = launches.get(k, 0) + n
        state = {str(t.dtype) for st in runner.optimizer.state
                 for t in st.values()}
        masters[label] = {"ms_per_step": ms, "optimizer_ms": opt_ms,
                          "peak_mem_GB": peak, "losses": losses,
                          "update_bytes": _update_bytes(runner),
                          "state_dtypes": sorted(state)}
        log(f"options bf16 masters, {label}, B={TRAIN_BATCH}: total loss by "
            f"step {[round(v, 4) for v in losses]}; ms_per_step={ms:.3f} "
            f"optimizer_ms={opt_ms:.3f} peak_mem_GB={peak:.3f} (fp32 "
            f"masters: {fp32['ms_per_step']:.3f} / "
            f"{fp32['optimizer_ms']:.3f} / {fp32['peak_mem_GB']:.3f}); "
            f"update bytes {masters[label]['update_bytes']} (fp32 masters "
            f"{fp32['update_bytes']}); state {sorted(state)}")
        if not (all(math.isfinite(v) for v in losses)
                and sum(losses[-3:]) < sum(losses[:3])
                and losses[-1] < losses[0]):
            raise AssertionError(f"options bf16 masters {label}: the loss "
                                 f"did not fall: {losses}")
        if state != {"torch.bfloat16"}:
            raise AssertionError(f"options: state dtypes {state}")
        del runner
        torch.cuda.empty_cache()
    numbers["bf16_masters"] = masters
    del batches

    # (c) stochastic rounding on the card
    numbers["stochastic_rounding"] = _stochastic_rounding_on_card()

    # (d) the launcher: phase 8's cut set, one epoch at grad_accum=2 with
    # bf16 masters, resumed for a second; -m test on its checkpoint
    workdir = os.path.join(REPO, "build", "launcher")
    lcfg = serve.load_config(os.path.join(EXPTS, LAUNCH_EXPT))
    ldepth = int(lcfg.model.fuser.depth)
    llayers = int(lcfg.model.common.fp_layers)
    # (e) ZeRO-1 against plain data parallelism over the same global
    # batches, every element of every weight compared in the process that
    # ran both: (i) one process through torchrun on NCCL (at world 1 the
    # NCCL reduce-scatter and all-gather still run); (ii) two processes on
    # the one card over gloo; both start here and run beside (d)
    sched = O.build_schedule(lcfg.opt, 2, 1)
    zero_runs = {}
    for tag, nproc, device in (("nccl-n1", 1, "cuda"),
                               ("gloo", 2, "cuda:0")):
        jobs = [{"kind": "train", "name": f"zero-{z}", "expt": os.path.join(
                     EXPTS, LAUNCH_EXPT),
                 "overrides": [*LAUNCH_OVERRIDES,
                               f"train.zero_sharding={z}"],
                 "classes": DP_CLASSES, "batch": DP_GLOBAL_BATCH,
                 "steps": OPTIONS_ZERO_STEPS, "seed": 9,
                 "lrs": [sched(i, float(lcfg.opt.lr))
                         for i in range(OPTIONS_ZERO_STEPS)],
                 "invalid": [DP_GLOBAL_BATCH - 1],
                 **({"keep_state": "host"} if z == "false" else
                    {"keep_state": False, "against": "zero-false"})}
                for z in ("false", "true")]
        out = os.path.join(workdir, f"zero-{tag}-out")
        spec = os.path.join(workdir, f"zero-{tag}-spec.json")
        with open(spec, "w") as f:
            json.dump({"device": device, "out": out, "jobs": jobs}, f)
        zero_runs[tag] = nproc, out, _start_run(_dp_torchrun(
            nproc, ["afft_tpu_torch.tools.dp_check", spec]), workdir,
            f"zero-{tag}")

    name = ("experiment_name=launch-options", "train.grad_accum=2",
            "model.compute_dtype=bfloat16", "train.master_dtype=bfloat16")
    opt_dir, _, run_a, secs_a = _launch(workdir, "options-parts", name + (
        "train.num_epochs=1",))
    _, epochs, run_b, secs_b = _launch(workdir, "options-resume", name + (
        "train.num_epochs=2", "train.resume=true"))
    for label, run in (("options-parts", run_a), ("options-resume", run_b)):
        _counts_ok(f"launcher {label}", run["launches"], {
            **{n: 2 * (ldepth if n.startswith("fused_block") else llayers)
               * run["train_iters"] for n in entries},
            "fused_block": ldepth * run["val_batches"],
            "gpt2_attn_half": llayers * run["val_batches"],
            "gpt2_mlp_half": llayers * run["val_batches"]})
        for k, n in run["launches"].items():
            launches[k] = launches.get(k, 0) + n
    ck = load_checkpoint(os.path.join(opt_dir, "checkpoint_last"))
    dtypes = {str(v.dtype) for v in ck["model"].values()
              if v.is_floating_point()}
    if ck["epoch"] != 2 or dtypes != {"torch.bfloat16"}:
        raise AssertionError(f"options launcher: checkpoint epoch "
                             f"{ck['epoch']}, dtypes {dtypes}")
    losses = [e["train_total_loss"] for e in epochs]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"options launcher: losses {losses}")
    init = "init_from_model=" + os.path.basename(opt_dir) + "/checkpoint_last"
    export = _eval_run(workdir, "options-eval", (init,
                                                 "save_name=options.h5"))
    (res,) = PC.gen_load_resfiles(os.path.dirname(export["logits_file"]),
                                  "options")
    exported = torch.from_numpy(res["logits/action_all-fused"])
    ecfg = serve.load_config(os.path.join(EXPTS, EVAL_EXPT),
                             (f"cwd={workdir}", init, *LAUNCH_OVERRIDES))
    dataset = get_dataset(ecfg.dataset_eval, ecfg.data_eval,
                          get_transforms(ecfg, train=False))
    plain, idx = _eval_logits(ecfg, dataset, ck["model"], "plain",
                              "bfloat16")
    max_abs = (exported - plain).abs().max().item()
    scale = plain.abs().max().item()
    top1_ok, text = top1_report(exported, plain, need_decided=False)
    log(f"options launcher: {LAUNCH_EXPT} at grad_accum=2 with bf16 masters "
        f"on phase 8's cut set: 1 epoch in {secs_a:.1f} s, resumed for a "
        f"second in {secs_b:.1f} s, train loss by epoch {losses}; the "
        f"checkpoint holds bf16 weights; -m test on it: {len(exported)} "
        f"clips, bf16 logits vs the plain path on the same checkpoint "
        f"max_abs_diff={max_abs:.6g} (tol {5e-2 * scale:.6g} = 5e-2 * "
        f"max|logit| {scale:.4g}) {text}")
    if not (bool(exported.isfinite().all()) and max_abs <= 5e-2 * scale
            and top1_ok and (idx == np.arange(len(idx))).all()):
        raise AssertionError("options launcher: the exported logits "
                             "disagree with the plain path's")
    numbers["launcher"] = {
        "run_s": [secs_a, secs_b], "train_loss_by_epoch": losses,
        "window_ms_per_iter_by_epoch": [_window_ms(e) for e in epochs],
        "eval_max_abs_diff": max_abs}
    del ck, plain
    torch.cuda.empty_cache()

    # (e): the ZeRO-1 runs' records
    zero1 = {}
    for tag, (nproc, out, run) in zero_runs.items():
        _, secs = _finish_run(run, LAUNCH_TIMEOUT)
        recs = {z: [torch.load(os.path.join(out, f"zero-{z}.rank{r}.pt"),
                               weights_only=False) for r in range(nproc)]
                for z in ("false", "true")}
        plain_dp, sharded = recs["false"][0], recs["true"][0]
        backend = {r["backend"] for z in recs for r in recs[z]}
        want = {"nccl"} if tag.startswith("nccl") else {"gloo"}
        if backend != want or sharded["world"] != nproc:
            raise AssertionError(f"options ZeRO-1 {tag}: backend {backend}, "
                                 f"world {sharded['world']}")
        loss_rel = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
                       for a, b in zip(sharded["losses"], plain_dp["losses"])
                       for k in b)
        weight_rel = sharded["state_diff"] / sharded["state_scale"]
        state_bytes = {z: [r["state_bytes"] for r in recs[z]] for z in recs}
        log(f"options ZeRO-1 {tag}: {nproc} process(es) over "
            f"{', '.join(sorted(backend))} on "
            f"the card, {DP_GLOBAL_BATCH // nproc} clips each, "
            f"{OPTIONS_ZERO_STEPS} steps of {LAUNCH_EXPT}, against plain data "
            f"parallelism: total loss by step "
            f"{[round(l['total_loss'], 5) for l in sharded['losses']]} vs "
            f"{[round(l['total_loss'], 5) for l in plain_dp['losses']]}, "
            f"largest relative difference of any loss {loss_rel:.3g} (tol "
            f"1e-5); weights, every element of every tensor, "
            f"{weight_rel:.3g} of max|w| (tol 1e-5); optimizer-state bytes "
            f"per rank {state_bytes['true']} vs {state_bytes['false']}; step "
            f"ms rank 0 {_rounded(sharded['step_ms'])} vs "
            f"{_rounded(plain_dp['step_ms'])} (one card: not a multi-GPU "
            f"number); {secs:.1f} s")
        if not (loss_rel <= 1e-5 and weight_rel <= 1e-5):
            raise AssertionError(f"options: ZeRO-1 ({tag}) differs from "
                                 f"plain data parallelism")
        if not (sum(state_bytes["true"]) == state_bytes["false"][0]
                and max(state_bytes["true"]) <= state_bytes["false"][0]
                // nproc + 64):
            raise AssertionError(f"options: ZeRO-1 ({tag}) state bytes "
                                 f"{state_bytes}")
        zero1[tag] = {
            "loss_rel_diff": loss_rel, "weight_rel_diff": weight_rel,
            "state_bytes_per_rank": state_bytes["true"],
            "plain_state_bytes_per_rank": state_bytes["false"],
            "step_ms_rank0": sharded["step_ms"],
            "plain_step_ms_rank0": plain_dp["step_ms"], "run_s": secs}
    numbers["zero1"] = zero1
    del recs, plain_dp, sharded
    torch.cuda.empty_cache()
    return launches, numbers


# -- pipeline parallelism: GPipe stages as processes on the one card ---------

PIPE_STAGES = 2
PIPE_MICRO = (2, 4)
PIPE_BATCH, PIPE_STEPS = 64, 3
# a pipelined step against one process over the same batches: the losses,
# and each tensor's largest difference, past what storing its fp32 weights
# rounds in the steps (an ulp of its max|w| a step), over what the one
# process's steps moved that tensor (update_rel), expt 99's
# kernels-against-plain bounds (EXPT99_TRAIN_TOL). The floor matters where
# a warmup step moves a weight by a few ulps (LayerNorm weights near 1).
# bf16: each microbatch's and each replica's gradient is rounded to bf16 on
# its own, where one pass rounds the batch's once; the losses within phase
# 10's 2e-2. fp32: the summation order only
PIPE_TOL = {"bf16": {"loss_rel": 2e-2,
                     "update_rel": EXPT99_TRAIN_TOL["bf16"]["update_rel"]},
            "fp32": {k: EXPT99_TRAIN_TOL["fp32"][k]
                     for k in ("loss_rel", "update_rel")}}
PIPE_EXPT = "99_synth_smoke_pipe.txt"
PIPE_DIR = os.path.join(REPO, "build", "pipeline")


def _pipe_job(name, expt, overrides, classes, lrs, **more):
    return {"kind": "train", "name": name, "expt": expt,
            "overrides": list(overrides), "classes": classes,
            "batch": PIPE_BATCH, "steps": PIPE_STEPS, "seed": 9, "lrs": lrs,
            "invalid": [PIPE_BATCH - 1], **more}


def _pipe_spec(name, spec_jobs):
    """Write dp_check's spec of ``spec_jobs`` (gloo on the card); returns
    (its path, the records' directory)."""
    out = os.path.join(PIPE_DIR, f"{name}-out")
    spec = os.path.join(PIPE_DIR, f"{name}-spec.json")
    with open(spec, "w") as f:
        json.dump({"device": "cuda:0", "out": out, "jobs": spec_jobs}, f)
    return spec, out


def _pipe_load(spec_jobs, nproc, out):
    """The records of a dp_check run of ``spec_jobs`` on ``nproc``
    processes: {job: [record by rank]}."""
    import torch
    return {j["name"]: [torch.load(os.path.join(out, f"{j['name']}.rank{r}"
                                                ".pt"), weights_only=False)
                        for r in range(nproc)] for j in spec_jobs}


def _pipe_records(name, spec_jobs, nproc):
    """Run ``spec_jobs`` through dp_check on ``nproc`` gloo processes on the
    card; ({job: [record by rank]}, seconds)."""
    spec, out = _pipe_spec(name, spec_jobs)
    _, secs = _logged_run(_dp_torchrun(nproc, ["afft_tpu_torch.tools.dp_check",
                                               spec]),
                          PIPE_DIR, name, LAUNCH_TIMEOUT)
    return _pipe_load(spec_jobs, nproc, out), secs


def _loss_rel(got, want):
    return max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
               for a, b in zip(got, want) for k in b)


def _one_process(job, cfg, classes, path):
    """The train ``job`` in this process, its final state saved to ``path``
    for the pipelined jobs' ``against_file``; (its record, by tensor name
    (max|update| over the job's steps, the rounding floor: ``PIPE_STEPS``
    ulps of its max|w| in fp32))."""
    import numpy as np
    import torch
    from afft_tpu_torch.tools import dp_check as D
    from afft_tpu_torch.train.runner import Runner
    init = Runner.from_config(cfg, classes, device="cuda")
    start = {k: v.detach().cpu() for k, v in init.model.state_dict().items()}
    del init
    torch.cuda.empty_cache()
    record = D.run_train(job, torch.device("cuda"))
    torch.cuda.empty_cache()
    spans = {k: (float((v.float() - start[k].float()).abs().max()),
                  PIPE_STEPS * float(np.spacing(
                      np.float32(v.float().abs().max()))))
             for k, v in record["state"].items()}
    torch.save(record.pop("state"), path)
    return record, spans


def _per_tensor(record, spans):
    """Each tensor's largest difference from the one process
    (``record["state_diffs"]``) past its rounding floor, over its own
    max|update| (``spans``: ``_one_process``'s), worst first: [(ratio,
    name), ...]. A tensor the steps left alone must not differ past it."""
    return sorted(((max(d - spans[k][1], 0.0) / max(spans[k][0], 1e-30), k)
                   for k, d in record["state_diffs"].items()), reverse=True)


def _worst(ranked, n=3):
    return ", ".join(f"{r:.3g} ({k})" for r, k in ranked[:n])


def _held(rec, ref, spans, tol):
    """Rank 0's ``rec`` of a job with ``against_file`` against the one
    process ``ref`` and its ``spans`` (``_one_process``): (whether within
    ``tol``, numbers, the log's words)."""
    loss = _loss_rel(rec["losses"], ref["losses"])
    ranked = _per_tensor(rec, spans)
    raw = max((d / max(spans[k][0], 1e-30), k)
              for k, d in rec["state_diffs"].items())
    moved = sum(u > 0 for u, _ in spans.values())
    update = max(u for u, _ in spans.values())
    ok = (loss <= tol["loss_rel"] and ranked[0][0] <= tol["update_rel"]
          and moved > len(spans) // 2)
    words = (
        f"total loss by step "
        f"{[round(l['total_loss'], 5) for l in rec['losses']]} vs one "
        f"process {[round(l['total_loss'], 5) for l in ref['losses']]}, "
        f"largest relative difference of any loss {loss:.3g} (tol "
        f"{tol['loss_rel']}); each tensor's largest difference past "
        f"{PIPE_STEPS} ulps of its max|w| over its own max|update| in the "
        f"one process, worst {_worst(ranked)} (tol {tol['update_rel']}; "
        f"without the floor {_worst([raw], 1)}; the steps moved {moved} of "
        f"{len(spans)} tensors); over all tensors the largest difference "
        f"{rec['state_diff']:.3g} = {rec['state_diff'] / update:.3g} of the "
        f"largest update element {update:.3g}")
    return ok, {"loss_rel_diff": loss, "worst_tensors_of_update": ranked[:5],
                "worst_tensor_without_floor": raw,
                "weight_diff_of_update": rec["state_diff"] / update}, words


def _stage_launches(what, rec, per_stage, depth, micro, steps):
    """A rank's launches: each of its stage's layers once a microbatch per
    training entry, the replicated fuser's depth once a step, no other
    kernel."""
    expected = {n: depth * steps for n, _ in
                TRAIN_KERNELS["fused_block_train"][:3]}
    expected.update({n: per_stage * micro * steps for n, _ in
                     TRAIN_KERNELS["fused_gpt2_train"][:3]})
    _counts_ok(what, rec["launches"], expected)
    return expected


def phase_pipeline():
    """14. GPipe (train.pipeline_stages) on the one card, ranks as stages
    over gloo (``--device cuda:0``). (i) The flagship at full width
    (expts/01_SA-Fuser_ek100_train.txt in bf16 over fp32 masters, its
    dropout, drop-path and mixup), 2 stages of 3 layers at 2 and 4
    microbatches, 64 clips a step, 3 steps, against one unpipelined process
    over the same global batches: losses within 2e-2 relative, each tensor's
    largest difference within 2e-2 of that tensor's max|update| in the one
    process, each stage's launches L/S x M a step per GPT-2 training entry,
    the replicated weights alike on both ranks; before it the GPT-2 training
    layers at a stage's global layer index and a microbatch's first global
    row against their plain versions, every stage's masks bit for bit the
    one-process masks of those rows. (ii) data2 x pipe2 on four processes:
    expt 98 against one process over the same batches in bf16 (the same
    bounds) and in fp32 (losses within 1e-4, each tensor within 1e-3 of its
    update: the summation order only, so a tensor or a microbatch left out
    shows), and with ZeRO-1 against plain data parallelism on the same grid
    (losses and every weight within 1e-5), each rank's optimizer-state
    bytes. (iii) The launcher: expts/99_synth_smoke_pipe.txt -m train -n 2
    for one epoch and resumed for a second, -m test on its checkpoint in one
    process, whose logits the pipelined eval of that checkpoint (2 gloo
    processes, with (i)'s jobs) equals within 1e-4 of max|logit|. (iii)'s
    two training runs go beside (i)'s layer checks and the one-process
    references of (i) and (ii); (ii)'s four processes run beside (i)'s two.
    Step times and peak memory per rank are one-card stand-ins: both stages
    share the H100 (and the runs beside each other share it), so they
    measure no pipeline speed.
    Returns (launches by kernel of each run, numbers)."""
    import numpy as np
    import torch
    from afft_tpu_torch import serve
    from afft_tpu_torch.eval import challenge as PC
    from afft_tpu_torch.ops import fused_gpt2_train as FGT
    from afft_tpu_torch.train import optim as O
    from afft_tpu_torch.train.checkpoint import load_checkpoint

    os.makedirs(PIPE_DIR, exist_ok=True)
    link = os.path.join(PIPE_DIR, "tests")
    if not os.path.exists(link):
        os.symlink(os.path.join(REPO, "tests"), link)
    numbers, launches = {}, {}
    bf16 = "model.compute_dtype=bfloat16"
    expt = os.path.join(EXPTS, TRAIN_EXPT)
    cfg = serve.load_config(expt, [bf16])
    depth, layers = int(cfg.model.fuser.depth), int(cfg.model.common.fp_layers)
    per = layers // PIPE_STAGES
    common = cfg.model.common
    T, inter, H = (int(cfg.data_train.num_frames), int(common.fp_inter_dim),
                   int(common.fp_heads))
    g_rates = dict(attn_rate=float(common.attn_pdrop),
                   resid_rate=float(common.resid_pdrop))

    t_phase = time.perf_counter()

    # (iii) the launcher: 2 stages, one epoch and a resumed second, beside
    # (i)'s layer checks and the one-process references; then -m test in
    # one process (the pipelined eval of that checkpoint runs with (i))
    pexpt = os.path.join(EXPTS, PIPE_EXPT)
    run = [sys.executable, "-m", "afft_tpu_torch.run", "-c", pexpt,
           *LAUNCH_OVERRIDES]
    train = run + ["-m", "train", "-n", str(PIPE_STAGES), "--device",
                   "cuda:0"]
    name = "CMFPEarly_ModalTokenCMFuser_rgb_flow_synth-smoke-pipe"
    ckpt_dir = os.path.join(PIPE_DIR, "checkpoints", name)
    pipe_run = _start_run(train + ["train.num_epochs=1", "+overwrite=true"],
                          PIPE_DIR, "launch-pipe")

    # (i) first the stages' layers at their global layer index and their
    # microbatches' first global rows
    for micro in PIPE_MICRO:
        b = PIPE_BATCH // micro
        for li in range(layers):
            full = FGT.draw_masks_gpt2(PIPE_BATCH, T, inter, H, TRAIN_SEEDS,
                                       li, *g_rates.values(), device="cuda")
            for m in range(micro):
                part = FGT.draw_masks_gpt2(b, T, inter, H, TRAIN_SEEDS, li,
                                           *g_rates.values(), device="cuda",
                                           row0=m * b)
                for m_full, m_part in zip(full, part):
                    rows = m_part.shape[0]
                    if not torch.equal(m_full[m * rows:(m + 1) * rows],
                                       m_part):
                        raise AssertionError(
                            f"pipeline: layer {li} microbatch {m} of "
                            f"{micro}: masks differ from the one-process "
                            "masks of those rows")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    for micro, li, m in ((2, per, 1), (4, layers - 1, 3)):
        b = PIPE_BATCH // micro
        case = check_gpt2_train_layer("bf16", torch.bfloat16, b, T, inter, H,
                                      4 * inter, gen, rates=g_rates,
                                      layer_idx=li, row0=m * b)
        log(f"pipeline: stage {li // per}'s layer {li}, microbatch {m} of "
            f"{micro}: {case['what']}: masks bit for bit the one-process "
            f"masks of those rows; max_abs_err {case['errs']}")
        del case
    torch.cuda.empty_cache()
    log(f"pipeline: the masks of all {layers} layers at microbatches "
        f"{PIPE_MICRO} of {PIPE_BATCH} rows bit for bit the one-process "
        "masks of those rows")

    # (i) the flagship: one process, then 2 stages at 2 and 4 microbatches
    sched = O.build_schedule(cfg.opt, 2, 1)
    lrs = [sched(i, float(cfg.opt.lr)) for i in range(PIPE_STEPS)]
    one_path = os.path.join(PIPE_DIR, "one_state.pt")
    one, spans = _one_process(
        _pipe_job("one", expt, [bf16], TRAIN_CLASSES, lrs), cfg,
        TRAIN_CLASSES, one_path)
    _, secs_a = _finish_run(pipe_run, LAUNCH_TIMEOUT)
    pipe_run = _start_run(train + ["train.resume=true"], PIPE_DIR,
                          "launch-pipe-resume")
    # (ii) data2 x pipe2 on four processes: plain data parallelism against
    # one process in bf16 (the expt's) and in fp32, ZeRO-1 against plain
    # data parallelism on the same grid: its one-process references here,
    # its four processes beside (i)'s two (so both runs' step times are a
    # shared card's)
    lexpt = os.path.join(EXPTS, LAUNCH_EXPT)
    lcfg = serve.load_config(lexpt)
    lsched = O.build_schedule(lcfg.opt, 2, 1)
    llrs = [lsched(i, float(lcfg.opt.lr)) for i in range(PIPE_STEPS)]
    fp32 = ["model.compute_dtype=float32"]
    lone, lspans, lpaths = {}, {}, {}
    for dt, more in (("bf16", []), ("fp32", fp32)):
        lpaths[dt] = os.path.join(PIPE_DIR, f"one98_{dt}_state.pt")
        lone[dt], lspans[dt] = _one_process(
            _pipe_job(f"one98-{dt}", lexpt, [*LAUNCH_OVERRIDES, *more],
                      DP_CLASSES, llrs),
            serve.load_config(lexpt, more), DP_CLASSES, lpaths[dt])
    text, secs_b = _finish_run(pipe_run, LAUNCH_TIMEOUT)
    if "Resumed from" not in text:
        raise AssertionError("pipeline launcher: the second run did not "
                             "resume")
    with open(os.path.join(ckpt_dir, "metrics.jsonl")) as f:
        epochs = [json.loads(line) for line in f]
    with open(os.path.join(ckpt_dir, "summary.jsonl")) as f:
        summary = [json.loads(line) for line in f][-1]["run"]
    losses = [e["train_total_loss"] for e in epochs]
    pcfg = serve.load_config(pexpt)
    pper = int(pcfg.model.common.fp_layers) // PIPE_STAGES
    pmicro = int(pcfg.train.get("pipeline_microbatches") or PIPE_STAGES)
    want = {n: pper * pmicro * summary["train_iters"] for n, _ in
            TRAIN_KERNELS["fused_gpt2_train"][:3]}
    want.update({n: pper * pmicro * summary["val_batches"]
                 for n in ("gpt2_attn_half", "gpt2_mlp_half")})
    got = {n: summary["launches"][n] for n in want}
    if not (len(epochs) == 2 and all(math.isfinite(v) for v in losses)
            and summary["pipeline_stages"] == PIPE_STAGES and got == want):
        raise AssertionError(f"pipeline launcher: epochs {len(epochs)}, "
                             f"losses {losses}, launches {got} vs {want}")
    launches["launcher_rank0"] = [summary["launches"]]
    ck = load_checkpoint(os.path.join(ckpt_dir, "checkpoint_last"))
    model_path = os.path.join(PIPE_DIR, "pipe_model.pt")
    torch.save(ck["model"], model_path)
    export = _eval_run(PIPE_DIR, "pipe-test",
                       (f"init_from_model={name}/checkpoint_last",
                        "+save_name=pipe.h5"), expt=pexpt)
    if export["world_size"] != 1:
        raise AssertionError("pipeline: -m test did not run in one process")
    (res,) = PC.gen_load_resfiles(os.path.dirname(export["logits_file"]),
                                  "pipe")
    exported = res["logits/action_all-fused"]

    grid = [f"train.pipeline_stages={PIPE_STAGES}", *LAUNCH_OVERRIDES]
    jobs2 = [_pipe_job("plain", lexpt, grid, DP_CLASSES, llrs,
                       keep_state="host", against_file=lpaths["bf16"]),
             _pipe_job("zero", lexpt, grid + ["train.zero_sharding=true"],
                       DP_CLASSES, llrs, keep_state=False, against="plain"),
             _pipe_job("plain-fp32", lexpt, grid + fp32, DP_CLASSES, llrs,
                       keep_state=False, against_file=lpaths["fp32"])]
    d2p_spec, d2p_out = _pipe_spec("data2xpipe2", jobs2)
    d2p = _start_run(_dp_torchrun(2 * PIPE_STAGES, [
        "afft_tpu_torch.tools.dp_check", d2p_spec]), PIPE_DIR, "data2xpipe2")

    jobs = [_pipe_job(f"flagship-m{micro}", expt,
                      [bf16, f"train.pipeline_stages={PIPE_STAGES}",
                       f"train.pipeline_microbatches={micro}"],
                      TRAIN_CLASSES, lrs, keep_state=False,
                      against_file=one_path) for micro in PIPE_MICRO]
    # with them, (iii)'s checkpoint through the pipelined eval
    recs, secs = _pipe_records("flagship", jobs + [
        {"kind": "eval", "name": "val", "expt": pexpt,
         "overrides": list(LAUNCH_OVERRIDES), "batch": 8, "seed": 0,
         "weights": model_path}], PIPE_STAGES)
    # the one process stays the reference of phase 15 (its state file too)
    reference = {"record": one, "spans": spans, "path": one_path,
                 "lrs": lrs}
    flagship = {"one_process_step_ms": one["step_ms"],
                "one_process_peak_gb": one["peak_bytes"] / 2 ** 30,
                "one_process_losses": [l["total_loss"] for l in one["losses"]],
                "largest_update": max(u for u, _ in spans.values()),
                "run_s": secs}
    for micro, job in zip(PIPE_MICRO, jobs):
        ranks = recs[job["name"]]
        ok, held, words = _held(ranks[0], one, spans, PIPE_TOL["bf16"])
        for rec in ranks:
            expected = _stage_launches(
                f"pipeline flagship M={micro} rank {rec['rank']}", rec, per,
                depth, micro, PIPE_STEPS)
            launches[f"flagship_m{micro}"] = launches.get(
                f"flagship_m{micro}", []) + [rec["launches"]]
        alike = ranks[0]["replicated_sums"] == ranks[1]["replicated_sums"]
        bubble = (PIPE_STAGES - 1) / (micro + PIPE_STAGES - 1)
        log(f"pipeline (i) flagship, {PIPE_STAGES} stages x M={micro} over "
            f"gloo on cuda:0, {PIPE_BATCH} clips a step, {PIPE_STEPS} steps: "
            f"{words} = {ranks[0]['state_diff'] / ranks[0]['state_scale']:.3g}"
            f" of max|w|; replicated weights alike on both ranks: {alike}; "
            f"launches per rank {expected}; step ms (host, to the device's "
            f"end) rank 0 {_rounded(ranks[0]['step_ms'])} rank 1 "
            f"{_rounded(ranks[1]['step_ms'])} vs one process "
            f"{_rounded(one['step_ms'])}, peak GB "
            f"{[round(r['peak_bytes'] / 2 ** 30, 2) for r in ranks]} vs "
            f"{one['peak_bytes'] / 2 ** 30:.2f}; the bubble's reckoned share "
            f"(S - 1)/(M + S - 1) = {bubble:.3f}. Both stages share one "
            "card through host copies: one-card stand-ins, no pipeline "
            "speed")
        if not (ok and alike):
            raise AssertionError(f"pipeline: the flagship at M={micro} "
                                 "differs from one process")
        flagship[f"m{micro}"] = {
            **held,
            "weight_diff_of_max_w": (ranks[0]["state_diff"]
                                     / ranks[0]["state_scale"]),
            "step_ms_by_rank": [r["step_ms"] for r in ranks],
            "peak_gb_by_rank": [r["peak_bytes"] / 2 ** 30 for r in ranks],
            "bubble_share_reckoned": bubble, "launches_per_rank": expected}
    numbers["flagship"] = flagship

    piped = recs["val"][0]["merged"]
    max_abs = float(np.abs(piped - exported).max())
    scale = float(np.abs(exported).max())
    log(f"pipeline (iii) launcher: {PIPE_EXPT} -m train -n {PIPE_STAGES} on "
        f"cuda:0, one epoch in {secs_a:.1f} s and resumed for a second in "
        f"{secs_b:.1f} s, train loss by epoch {losses}, launches on rank 0 "
        f"{got}; -m test in one process on its checkpoint_last: "
        f"{len(exported)} clips; the pipelined eval of that checkpoint on "
        f"{PIPE_STAGES} processes (with (i)) vs the exported logits: "
        f"max_abs_diff={max_abs:.3g} (tol {1e-4 * scale:.3g} = 1e-4 * "
        f"max|logit| {scale:.4g})")
    if not (np.isfinite(exported).all() and max_abs <= 1e-4 * scale
            and (recs["val"][0]["merged_idx"]
                 == np.arange(len(exported))).all()):
        raise AssertionError("pipeline: the one-process logits disagree "
                             "with the pipelined eval's")
    numbers["launcher"] = {"run_s": [secs_a, secs_b],
                           "train_loss_by_epoch": losses,
                           "launches_rank0": got,
                           "eval_max_abs_diff": max_abs,
                           "eval_run_s": export["seconds"]}
    os.remove(model_path)
    del recs
    torch.cuda.empty_cache()

    _, secs = _finish_run(d2p, LAUNCH_TIMEOUT)
    recs = _pipe_load(jobs2, 2 * PIPE_STAGES, d2p_out)
    for path in lpaths.values():
        os.remove(path)
    lper = int(lcfg.model.common.fp_layers) // PIPE_STAGES
    for job in jobs2:
        for rec in recs[job["name"]]:
            _stage_launches(f"pipeline data2xpipe2 {job['name']} rank "
                            f"{rec['rank']}", rec, lper,
                            int(lcfg.model.fuser.depth), PIPE_STAGES,
                            PIPE_STEPS)
    numbers["data2xpipe2"] = {"run_s": secs}
    for dt, name in (("bf16", "plain"), ("fp32", "plain-fp32")):
        ranks = recs[name]
        ok, held, words = _held(ranks[0], lone[dt], lspans[dt],
                                PIPE_TOL[dt])
        log(f"pipeline (ii) data2 x pipe2 {dt}, 4 processes over gloo on "
            f"cuda:0, {LAUNCH_EXPT}, {PIPE_BATCH} clips a step "
            f"({PIPE_BATCH // 2} a replica), {PIPE_STEPS} steps, plain data "
            f"parallelism vs one process over the same batches: {words}; "
            f"step ms rank 0 {_rounded(ranks[0]['step_ms'])} vs one process "
            f"{_rounded(lone[dt]['step_ms'])} (one card: not a multi-GPU "
            "number)")
        if not ok:
            raise AssertionError(f"pipeline: data2 x pipe2 in {dt} differs "
                                 "from one process")
        numbers["data2xpipe2"][f"one_process_{dt}"] = {
            **held, "step_ms_rank0": ranks[0]["step_ms"],
            "one_process_step_ms": lone[dt]["step_ms"]}
    plain, zero = recs["plain"], recs["zero"]
    worst = _loss_rel(zero[0]["losses"], plain[0]["losses"])
    weight_rel = zero[0]["state_diff"] / zero[0]["state_scale"]
    launches["data2xpipe2_zero"] = [r["launches"] for r in zero]
    bytes_plain = [r["state_bytes"] for r in plain]
    bytes_zero = [r["state_bytes"] for r in zero]
    log(f"pipeline (ii) data2 x pipe2, 4 processes over gloo on cuda:0, "
        f"{LAUNCH_EXPT}, {PIPE_BATCH} clips a step ({PIPE_BATCH // 2} a "
        f"replica), {PIPE_STEPS} steps: ZeRO-1 vs plain data parallelism on "
        f"the same grid: total loss by step "
        f"{[round(l['total_loss'], 5) for l in zero[0]['losses']]} vs "
        f"{[round(l['total_loss'], 5) for l in plain[0]['losses']]}, largest "
        f"relative difference {worst:.3g} (tol 1e-5); weights {weight_rel:.3g}"
        f" of max|w| (tol 1e-5); optimizer-state bytes by rank (stage = rank "
        f"% 2: its layers and the replicated rest) plain {bytes_plain}, "
        f"ZeRO-1 {bytes_zero}; step ms rank 0 "
        f"{_rounded(zero[0]['step_ms'])} vs {_rounded(plain[0]['step_ms'])}"
        f"; peak GB {[round(r['peak_bytes'] / 2 ** 30, 2) for r in zero]} "
        f"(one card: not a multi-GPU number); {secs:.1f} s")
    if not (worst <= 1e-5 and weight_rel <= 1e-5
            and all(2 * z <= p + 64 for z, p in zip(bytes_zero, bytes_plain))
            and [r["stage"] for r in zero] == [0, 1, 0, 1]):
        raise AssertionError("pipeline: ZeRO-1 over data2 x pipe2 differs "
                             "from plain data parallelism")
    numbers["data2xpipe2"].update({
        "loss_rel_diff": worst, "weight_rel_diff": weight_rel,
        "state_bytes_plain": bytes_plain, "state_bytes_zero1": bytes_zero,
        "step_ms_rank0": zero[0]["step_ms"],
        "plain_step_ms_rank0": plain[0]["step_ms"],
        "peak_gb_by_rank": [r["peak_bytes"] / 2 ** 30 for r in zero]})
    del recs, plain, zero
    torch.cuda.empty_cache()

    numbers["seconds"] = time.perf_counter() - t_phase
    return launches, numbers, reference


# -- 15. tensor and sequence parallelism --------------------------------------

TP_DIR = os.path.join(REPO, "build", "tp")
TP_DRYRUN_N = 8
TP_DRYRUN_TIMEOUT = 600   # seconds the dry run may take
# the flagship at data1 x model2 against one process: each tensor as phase
# 14 holds it (_held); the losses within 1e-3 relative (one rounding of
# each partial sum, in another order than one process's sum)
TP_TOL = {"loss_rel": 1e-3, "update_rel": PIPE_TOL["bf16"]["update_rel"]}
# the dry run's modes at n = 8, in the JAX driver's order
TP_DRYRUN_MODES = ("pure-DP)", "2-D data4xmodel2)", "2-D data4xmodel2+SP)",
                   "DP+ZeRO-1)", "pure-DP x grad_accum=2)",
                   "pipeline 4-stage 8-layer)",
                   "data4xpipe2 (train.pipeline_stages))",
                   "3-axis single-device reference)",
                   "3-axis data2xmodel2xpipe2)",
                   "3-axis data x model x pipe): loss matches")


def _tp_expected(depth, layers, steps):
    """A data1 x model2 rank's launches in shard mode: each GPT-2 layer's
    forward halves (2), MLP and attention backward, each fuser block's
    forward and MLP backward, a step; the fuser's attention backward runs
    whole (counted in launches, not here)."""
    return {"fused_gpt2_train_fwd": 2 * layers * steps,
            "fused_gpt2_train_bwd_mlp": layers * steps,
            "fused_gpt2_train_bwd_attn": layers * steps,
            "fused_block_train_fwd": depth * steps,
            "fused_block_train_bwd_mlp": depth * steps,
            "fused_block_train_bwd_attn": 0}


def phase_tp(reference):
    """15. Tensor and sequence parallelism on the one card, ranks as gloo
    processes (``--device cuda:0``). (i) The flagship at full width
    (expts/01_SA-Fuser_ek100_train.txt in bf16 over fp32 masters, its
    dropout, drop-path and mixup) at data1 x model2
    (``parallel.sharding.make_mesh_2d(1, 2)``), 64 clips a step, 3 steps,
    against phase 14's one process over the same global batches: losses
    within 1e-3 relative, each tensor as phase 14 holds it, every tensor a
    rank holds whole the same byte for byte on both ranks; each rank's
    parameter and optimizer-state bytes beside the one process's, its peak
    memory, and every training entry's launches in shard mode a step. The
    same run with a planted fault (``dp_check``'s ``unsummed_norm_grads``:
    the sharded layers' LayerNorm gradients left partial) must fail both
    holds; its reading stands beside the sound run's margin. (ii)
    ``python -m afft_tpu_torch.tools.dryrun_multichip -n 8`` on the card:
    every mode of the JAX driver, the 3-axis loss within rtol 1e-3 of one
    process's; it runs beside (i). Both ranks share one card through host
    copies: no TP speed. Returns (shard-mode launches by run and rank,
    numbers)."""
    import torch
    from afft_tpu_torch import serve

    t_phase = time.perf_counter()
    os.makedirs(TP_DIR, exist_ok=True)
    link = os.path.join(TP_DIR, "tests")
    if not os.path.exists(link):
        os.symlink(os.path.join(REPO, "tests"), link)
    bf16 = "model.compute_dtype=bfloat16"
    expt = os.path.join(EXPTS, TRAIN_EXPT)
    cfg = serve.load_config(expt, [bf16])
    depth, layers = int(cfg.model.fuser.depth), int(cfg.model.common.fp_layers)
    one, spans = reference["record"], reference["spans"]
    job = _pipe_job("flagship-tp2", expt, [bf16], TRAIN_CLASSES,
                    reference["lrs"], tp=2, keep_state=False,
                    against_file=reference["path"])
    planted = {**job, "name": "flagship-tp2-planted",
               "plant": "unsummed_norm_grads"}
    out = os.path.join(TP_DIR, "flagship-out")
    spec = os.path.join(TP_DIR, "flagship-spec.json")
    with open(spec, "w") as f:
        json.dump({"device": "cuda:0", "out": out, "jobs": [job, planted]},
                  f)
    # (ii)'s dry run starts first and runs beside (i)
    dry = _start_run([sys.executable, "-m",
                      "afft_tpu_torch.tools.dryrun_multichip", "-n",
                      str(TP_DRYRUN_N)], TP_DIR, "dryrun")
    _, secs = _logged_run(_dp_torchrun(2, ["afft_tpu_torch.tools.dp_check",
                                           spec]), TP_DIR, "flagship",
                          LAUNCH_TIMEOUT)
    ranks, franks = ([torch.load(os.path.join(out, f"{j['name']}.rank{r}.pt"),
                                 weights_only=False) for r in range(2)]
                     for j in (job, planted))
    os.remove(reference["path"])
    ok, held, words = _held(ranks[0], one, spans, TP_TOL)
    alike = ranks[0]["replicated_digests"] == ranks[1]["replicated_digests"]
    fok, fheld, fwords = _held(franks[0], one, spans, TP_TOL)
    parted = sorted(k for k, v in franks[0]["replicated_digests"].items()
                    if v != franks[1]["replicated_digests"][k])
    fault = {"worst_tensors_of_update": fheld["worst_tensors_of_update"],
             "loss_rel_diff": fheld["loss_rel_diff"],
             "worst_of_limit": (fheld["worst_tensors_of_update"][0][0]
                                / TP_TOL["update_rel"]),
             "whole_tensors_parted": len(parted),
             "whole_tensors": len(franks[0]["replicated_digests"]),
             "sound_margin": (TP_TOL["update_rel"]
                              / held["worst_tensors_of_update"][0][0])}
    del franks
    expected = _tp_expected(depth, layers, PIPE_STEPS)
    for rec in ranks:
        got = {k: rec["tp_launches"][k] for k in expected}
        if got != expected:
            raise AssertionError(f"tp: rank {rec['rank']} launched {got} in "
                                 f"shard mode, expected {expected}")
        # every launch: the shard-mode ones and the fuser's attention
        # backward whole, no other kernel
        _counts_ok(f"tp rank {rec['rank']}", rec["launches"], {
            **expected, "fused_block_train_bwd_attn": depth * PIPE_STEPS})
    share_params = [r["param_bytes"] / one["param_bytes"] for r in ranks]
    share_state = [r["state_bytes"] / one["state_bytes"] for r in ranks]
    log(f"tp (i) flagship, data1 x model2 over gloo on cuda:0, {PIPE_BATCH} "
        f"clips a step, {PIPE_STEPS} steps, vs one process over the same "
        f"batches: {words}; parameter bytes by rank "
        f"{[r['param_bytes'] for r in ranks]} = {_rounded(share_params, 3)} "
        f"of one process's {one['param_bytes']}, optimizer-state bytes "
        f"{[r['state_bytes'] for r in ranks]} = {_rounded(share_state, 3)} of "
        f"{one['state_bytes']}; peak GB "
        f"{[round(r['peak_bytes'] / 2 ** 30, 2) for r in ranks]} vs "
        f"{one['peak_bytes'] / 2 ** 30:.2f}; shard-mode launches per rank in "
        f"{PIPE_STEPS} steps {expected}; step ms rank 0 "
        f"{_rounded(ranks[0]['step_ms'])} vs one process "
        f"{_rounded(one['step_ms'])} (both ranks share one card through host "
        f"copies: no TP speed); whole tensors alike on both ranks: {alike} "
        f"({len(ranks[0]['replicated_digests'])} tensors); {secs:.1f} s for "
        f"this and the planted run")
    log(f"tp (i) planted fault (the sharded layers' LayerNorm gradients "
        f"left unsummed over the model group), same run: {fwords}; worst "
        f"tensor {fault['worst_of_limit']:.3g} times the limit "
        f"{TP_TOL['update_rel']}; whole tensors parted between the ranks "
        f"{len(parted)} of {fault['whole_tensors']}; the sound run's worst "
        f"tensor leaves a margin of {fault['sound_margin']:.3g} times")
    if not (ok and alike and max(share_params) < 0.6
            and max(share_state) < 0.6):
        raise AssertionError("tp: the flagship at data1 x model2 differs "
                             "from one process, its ranks' whole tensors "
                             "differ, or a rank holds more than its shards")
    if fok or not parted:
        raise AssertionError("tp: the planted fault passed a hold: the "
                             "checks cannot see it")
    numbers = {"flagship_data1xmodel2": {
        **held, "run_s": secs,
        "param_bytes_by_rank": [r["param_bytes"] for r in ranks],
        "param_share_of_one_process": share_params,
        "state_bytes_by_rank": [r["state_bytes"] for r in ranks],
        "state_share_of_one_process": share_state,
        "peak_gb_by_rank": [r["peak_bytes"] / 2 ** 30 for r in ranks],
        "step_ms_by_rank": [r["step_ms"] for r in ranks],
        "one_process_step_ms": one["step_ms"],
        "tp_launches_per_rank": expected, "whole_tensors_alike": alike,
        "planted_fault": fault}}
    launches = {"flagship_data1xmodel2": [r["tp_launches"] for r in ranks]}
    del ranks
    torch.cuda.empty_cache()

    # (ii) the dry run: every mode on 8 processes on the card
    text, dry_s = _finish_run(dry, TP_DRYRUN_TIMEOUT)
    lines = [l for l in text.splitlines()
             if l.startswith("dryrun_multichip(")]
    for line in lines:
        log(f"tp (ii) {line}")
    want = list(TP_DRYRUN_MODES)
    if len(lines) != len(want) or not all(
            m in l for l, m in zip(lines, want)):
        raise AssertionError(f"tp: dryrun_multichip -n {TP_DRYRUN_N} failed:"
                             f"\n{text[-3000:]}")
    numbers["dryrun_multichip"] = {"n": TP_DRYRUN_N, "run_s": dry_s,
                                   "lines": lines}
    log(f"tp (ii) dryrun_multichip -n {TP_DRYRUN_N} on the card: every mode "
        f"ok in {dry_s:.1f} s")
    numbers["seconds"] = time.perf_counter() - t_phase
    return launches, numbers



# -- 16. long contexts: the long attention route ------------------------------

LONG_SERVE_T = 64        # the flagship served at a 64-frame context
LONG_TRAIN_T = 48        # and trained at 48 frames
LONG_ROLLOUT = 20        # fp_output_len at T 16: 35 tokens in the last pass
LONG_BATCH = 64
LONG_ROLLOUT_BATCH = 32
LONG_STEPS = 5
LONG_ROLLOUT_STEPS = 3
LONG_GRAD_BATCH = 8
LONG_GPT2_T = (33, 64, 256, 1024)   # rows 2 and 11-15, B * T = 4096 in bf16
LONG_GPT2_ROWS = 4096
LONG_FP32_ROWS = 512               # B * T of the fp32 checks
LONG_FUSER_N = (9, 12, 16)          # rows 1, 7 and 9
LONG_FUSER_R = (1024, 128)          # rows of N tokens: bf16, fp32
LONG_KEYS = (1025, 2048)            # row 4: 16 queries over Nk cache slots
LONG_SEQ_S = (1280, 2048)           # rows 5 and 6
# the tensor-core forms' edges (bf16): the GPT-2 training attention at N
# tokens, each head width at a head count that keeps C % 8 == 0, and the
# sequence attention (row 4's route past 1,024 keys) at (Nq, Nk)
LONG_EDGE_N = (33, 65, 1025)
LONG_EDGE_HD = {12: 2, 24: 1, 256: 1, 512: 1, 768: 1, 1024: 1, 2048: 1}
LONG_RES_HD = 768   # long_attention.cuh LA_RES_HD: past it rows stream
# the CUDA-core forms past LONG_RES_HD (fp32, and the fuser's fp32
# probabilities in bf16): (dtype tag, GPT-2 chain, causal) at N tokens
LONG_EDGE_CC = (("fp32", True, True), ("fp32", False, False),
                ("bf16", False, False))
LONG_EDGE_CC_N = (33, 1025)
# (a') and (b'): the flagship with its GPT-2 predictor in 2 heads of 1,024
LONG_WIDE = ["model.common.fp_heads=2"]
LONG_EDGE_KEYS = ((33, 1025), (65, 1025), (1025, 1025), (1025, 2048))
LONG_EDGE_JUNK = 7          # unwritten cache slots (NaN) of the cache mask
# The CUDA-core long route's readings at these shapes (this phase's (d)
# before the tensor-core forms, bf16; NVIDIA H100 80GB HBM3, 700 W): the
# tensor-core forms must take at most LONG_FLOOR_SHARE of them (a floor
# against a route that was not redesigned, not a target)
LONG_CUDA_CORE_MS = {("fwd", 256): 2.226, ("fwd", 1024): 8.236,
                ("bwd", 256): 10.974, ("bwd", 1024): 40.955,
                ("row5", 1280): 5.778, ("row5", 2048): 13.861,
                ("row6", 1280): 5.233, ("row6", 2048): 13.545}
LONG_FLOOR_SHARE = 0.25
# the kernels the served and trained long paths must launch, by part of
# their name, and their launches a GPT-2 layer (the training step's forward
# kernel twice: the forward and the backward's first launch); and the
# CUDA-core long kernels they must not launch
LONG_MMA = {"serve": {"long_attention_mma<": 1},
            "train": {"long_attention_mma<": 2, "long_attention_mma_dkdv<": 1,
                      "long_attention_mma_dq<": 1}}
LONG_CUDA_CORE = "long_attention_f32rows"
# the CUDA-core long kernels a GPT-2 layer's fp32 training step launches
LONG_CC = {"train": {"long_attention_f32rows<": 2,
                     "long_attention_f32rows_dkdv<": 1,
                     "long_attention_f32rows_dq<": 1}}
# each long route's row: the kernels-line entry it stands under
LONG_ROWS = {"fused_block": "1", "gpt2_attn_half": "2",
             "fused_attention": "4", "fused_seq_block": "5",
             "fused_decoder_block": "6", "fused_block_train_fwd": "7",
             "fused_block_train_bwd_attn": "9", "fused_gpt2_train_fwd": "11",
             "fused_gpt2_train_bwd_attn": "15"}


def _long_work(B, H, pairs, Nq, Nk, hd, item, backward=False):
    """(flops, bytes) of one attention at any length: the products of the
    visible (query, key) pairs of each (sequence, head) (``pairs``); q, k,
    v read and out written once; the backward's dao (fp32) read and dq /
    dk / dv and O written once."""
    if not backward:
        return (4 * B * H * pairs * hd,
                B * H * hd * (2 * Nq + 2 * Nk) * item)
    return (8 * B * H * pairs * hd,
            B * H * hd * ((Nq + 2 * Nk) * item + 4 * Nq
                          + (Nq + 2 * Nk) * item + Nq * item))


def _long_numbers(peaks, what, fn, plain, library, work, err):
    """One long route's times (the route alone, its plain version, one
    PyTorch call computing the same function) and its bound."""
    import torch
    with torch.no_grad():
        ms = time_ms(fn, iters=10, warmup=2)
        plain_ms = time_ms(plain, iters=3, warmup=1)
    library_ms = time_ms(library, iters=10, warmup=2)
    flops, nbytes = work
    t_ops, t_bytes = flops / peaks["bf16"] * 1e3, nbytes / peaks["bytes"] * 1e3
    out = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               library_ms=library_ms, flops=flops, bytes=nbytes)
    log(f"long {what}: ms={ms:.4f} plain_ms={plain_ms:.4f} sdpa_ms="
        f"{library_ms:.4f} bound_ms={out['bound_ms']:.4f} "
        f"({out['bound_by']}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} "
        f"MB; {out['bound_ms'] / ms:.3f} of the bound) max_abs_err={err:.3g}")
    return out


def _long_floor(key, numbers, floors):
    """Hold a tensor-core form's time (``numbers["ms"]``, measured here) to
    LONG_FLOOR_SHARE of the CUDA-core route's reading of the same shape
    (``LONG_CUDA_CORE_MS[key]``, a constant); records the time, the floor
    and that reading under ``floors`` (phase 16's own JSON, not the kernels
    line)."""
    floor = LONG_FLOOR_SHARE * LONG_CUDA_CORE_MS[key]
    floors["_".join(map(str, key))] = {
        "ms": numbers["ms"], "floor_ms": floor,
        "cuda_core_constant_ms": LONG_CUDA_CORE_MS[key]}
    log(f"long floor {key}: {numbers['ms']:.4f} ms against {floor:.4f} "
        f"({LONG_FLOOR_SHARE:g} of the CUDA-core route's "
        f"{LONG_CUDA_CORE_MS[key]})")
    if not numbers["ms"] <= floor:
        raise AssertionError(f"long {key}: {numbers['ms']:.4f} ms, past "
                             f"the floor {floor:.4f} ms")


def _long_profile(fn, what, want, grad=False):
    """One call of a main path of (a) / (b) profiled from a whole trace: a
    trace that holds the tensor-core long kernels as often as the launch
    counters say (``want``: {part of a kernel's name: launches}) and whose
    afft kernels, by full name, an earlier such trace of the same call held
    each as often. The profiler now and then loses some of a trace's device
    events: in the runs seen, the served forward's first 57 launches (2 of
    its 6 long ones among them) in several traces in a row, or two of its
    GEMMs in one. A loss passes only if it spares every long launch and
    repeats exactly, so the check of the long kernels and the recorded
    profile cover a whole trace. Returns that trace's numbers."""
    seen = []
    attempts = 2 * PROFILE_ATTEMPTS
    for attempt in range(attempts):
        prof = profile_forward(fn, what, grad)
        got = {part: sum(n for name, n in prof["kernels"].items()
                         if part in name) for part in want}
        if got == want and prof["kernels"] in seen:
            return prof
        log(f"long profile {what}: {sum(prof['kernels'].values())} afft "
            f"launches, the long ones {got} of {want}; "
            f"{'a first such trace' if got == want else 'events lost'} "
            f"(attempt {attempt + 1} of {attempts})")
        if got == want:
            seen.append(prof["kernels"])
    raise AssertionError(f"long profile {what}: no whole trace")


def _long_profile_ok(what, kernels, want):
    """A main path's profile (``profile_forward``'s kernels by full name)
    shows each long kernel of ``want`` and none of the other family: no
    CUDA-core long kernel where ``want`` names the tensor-core ones, no
    tensor-core one where it names the CUDA-core ones (LONG_CC)."""
    names = list(kernels)
    missing = [w for w in want if not any(w in n for n in names)]
    other = "long_attention_mma" if any(LONG_CUDA_CORE in w for w in want) \
        else LONG_CUDA_CORE
    old = [n for n in names if other in n]
    long = {n[:60]: c for n, c in kernels.items() if "long_attention" in n}
    log(f"long profile {what}: {long}")
    if missing or old:
        raise AssertionError(f"long profile {what}: missing {missing}, "
                             f"the other family's long kernels {old}")


def _long_edges(gen):
    """The long forms at their edges: the tensor-core forms (bf16), the
    GPT-2 training attention forward and backward (``_check_attention_bwd``:
    O and dqkv against the plain version, bit for bit on relaunch, O bit for
    bit the forward kernel's output) at N 33 / 65 / 1,025 x hd 12 / 24 /
    256 / 512 / 768 / 1,024 / 2,048, causal and unmasked, at rate 0.1; past
    LONG_RES_HD also the CUDA-core forms (LONG_EDGE_CC: fp32 in both chains,
    the fuser's in bf16) at N 33 / 1,025; the sequence attention
    (``fused_attention``, row 4's route past 1,024 keys; q a packed slice,
    k / v caches) at (Nq, Nk) in LONG_EDGE_KEYS x the same head widths (past
    LONG_RES_HD in fp32 too) under no mask, the causal mask and, where Nq <
    Nk, the rollout's cache mask whose LONG_EDGE_JUNK unwritten slots hold
    NaN in the caches the kernel reads (finite in the plain version's).
    Returns (checks, worst absolute error)."""
    import torch
    from afft_tpu_torch.ops import attention as FA
    n, worst = 0, 0.0
    dt = torch.bfloat16
    for N in LONG_EDGE_N:
        for hd, H in LONG_EDGE_HD.items():
            for causal in (True, False):
                worst = max(worst, _check_attention_bwd(
                    2 if N < 1024 else 1, N, H, hd, dt, True, 0.1, causal,
                    gen))
                n += 1
    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}
    for hd in (h for h in LONG_EDGE_HD if h > LONG_RES_HD):
        for N in LONG_EDGE_CC_N:
            for tag, gpt2, causal in LONG_EDGE_CC:
                worst = max(worst, _check_attention_bwd(
                    1, N, 1, hd, dtypes[tag], gpt2, 0.1, causal, gen))
                n += 1
    for n_q, n_k in LONG_EDGE_KEYS:
        key = torch.arange(n_k, device="cuda")[None, :]
        query = torch.arange(n_q, device="cuda")[:, None]
        zeros = torch.zeros((n_q, n_k), device="cuda")
        kinds = [("none", None, 0),
                 ("causal", zeros.masked_fill(key > query, -math.inf), 0)]
        if n_q + LONG_EDGE_JUNK <= n_k:
            pos = n_k - n_q - LONG_EDGE_JUNK
            kinds.append(("cache", zeros.masked_fill(key > pos + query,
                                                     -math.inf),
                          LONG_EDGE_JUNK))
        for hd, tag in ((h, t) for h in LONG_EDGE_HD for t in dtypes
                        if t == "bf16" or h > LONG_RES_HD):
            B, H = 2, 2
            rn = _randn(gen, dtypes[tag])
            q = rn(B, n_q, 3, H, hd)[:, :, 0]
            k, v = rn(B, n_k, H, hd), rn(B, n_k, H, hd)
            for kind, mask, junk in kinds:
                kc, vc = k, v
                if junk:
                    kc, vc = k.clone(), v.clone()
                    kc[:, n_k - junk:] = math.nan
                    vc[:, n_k - junk:] = math.nan
                got = FA.fused_attention(q, kc, vc, mask)
                want = FA.attention_plain(q, k, v, mask)[0]
                n += _edge_ok(f"long fused_attention {tag} B={B} Nq={n_q} "
                              f"Nk={n_k} H={H} hd={hd} mask={kind} ({junk} "
                              "NaN slots)", tag, got, want)
                worst = max(worst, errors(got, want)[1])
    log(f"long edges: {n} checks of the tensor-core forms against their "
        f"plain versions (worst absolute error {worst:.3g})")
    return n, worst


def _sdpa_heads(q, k, v, causal, mask=None, grad=None):
    """F.scaled_dot_product_attention over (B, H, N, hd) operands (the
    yardstick); with ``grad`` the call is its backward."""
    import torch
    import torch.nn.functional as F
    keep = None if mask is None else mask == 0
    if grad is None:
        return lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=keep, is_causal=causal)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, attn_mask=keep,
                                         is_causal=causal)
    return lambda: torch.autograd.grad(out, leaves, grad,
                                       retain_graph=True)


def _long_keep_pattern(gen):
    """The long route's dropout keep pattern, read off its output: q = k =
    0 makes every probability 1 / (keys visible), v's rows are one-hot, so
    O[q][k] = p * keep(q, k) (rounded to bf16 in the bf16 GPT-2 chain, the
    tensor-core form); the pattern (and each value) equals
    draw_masks_plain's / draw_masks_gpt2_plain's at the same site bit for
    bit: the fuser's form in fp32, the GPT-2 layer's in fp32 and bf16, each
    at hd 48 and at hd 1,024 (past LONG_RES_HD: the streamed forms)."""
    import torch
    from afft_tpu_torch.models.layers import neg_inf_causal_mask
    from afft_tpu_torch.ops import fused_block_train as FT
    from afft_tpu_torch.ops import fused_gpt2_train as FGT
    n = 0
    for gpt2, N, dt, hd in ((g, n, d, h) for h in (48, 1024)
                            for g, n, d in ((False, 12, torch.float32),
                                            (True, 40, torch.float32),
                                            (True, 40, torch.bfloat16))):
        R, H = 3, 2
        C = H * hd
        qkv = torch.zeros(R * N, 3 * C, device="cuda", dtype=dt)
        eye = torch.eye(N, hd, device="cuda", dtype=dt)
        for r in range(R):
            for h in range(H):
                qkv[r * N:(r + 1) * N, 2 * C + h * hd:2 * C + (h + 1) * hd] \
                    = eye
        mask = neg_inf_causal_mask(N, device="cuda") if gpt2 else None
        out = FT.attention_drop(qkv, mask, TRAIN_SEEDS, n_tokens=N,
                                num_heads=H, block_idx=3, attn_rate=0.5,
                                gpt2=gpt2)
        if gpt2:
            mattn = FGT.draw_masks_gpt2_plain(R, N, C, H, TRAIN_SEEDS, 3,
                                              0.5, 0.0, device="cuda")[0]
        else:
            mattn = FT.draw_masks_plain(R, N, C, H, TRAIN_SEEDS, 3, 0.5,
                                        0.0, 0.0, device="cuda")[0]
        got = out.reshape(R, N, H, hd).permute(0, 2, 1, 3)[..., :N]
        visible = torch.ones(N, N, device="cuda") if mask is None \
            else mask.isfinite().float()
        p = visible / visible.sum(-1, keepdim=True)
        if not (torch.equal(got != 0, (mattn != 0) & (visible != 0))
                and torch.equal(got.float(), (p * mattn).to(dt).float())):
            raise AssertionError(f"long route keep pattern (gpt2={gpt2} "
                                 f"N={N} hd={hd} {dt}): differs from the "
                                 "plain generator's")
        n += int((mattn != 0).sum())
    log(f"long keep pattern: fuser N 12 (fp32) and GPT-2 T 40 (fp32, bf16) "
        f"at hd 48 and 1,024, rate 0.5, {n} kept elements, bit for bit "
        "draw_masks_plain / draw_masks_gpt2_plain's")
    return n


def _long_gpt2_attention(peaks, gen, B, T, H, hd):
    """The GPT-2 layer's long attention alone (bf16, causal, rate 0.1: rows
    2 / 11 forward, row 15 backward) at (B, T) in H heads of hd, checked
    (``_check_attention_bwd``) and timed beside its plain version, SDPA and
    its bound (``_long_numbers``). Returns (forward, backward) numbers."""
    import torch
    from afft_tpu_torch.models.layers import neg_inf_causal_mask
    from afft_tpu_torch.ops import fused_block_train as FT
    C = H * hd
    mask = neg_inf_causal_mask(T, device="cuda")
    pairs = T * (T + 1) // 2
    qkv = _randn(gen, torch.bfloat16)(B * T, 3 * C)
    dao = _randn(gen, torch.float32)(B * T, C)
    kw = dict(n_tokens=T, num_heads=H, block_idx=4, attn_rate=0.1, gpt2=True)
    # the attention site's mask is the same generator in both layers
    mattn = FT.draw_masks_plain(B, T, C, H, TRAIN_SEEDS, 4, 0.1, 0.0, 0.0,
                                device="cuda")[0]
    err = _check_attention_bwd(B, T, H, hd, torch.bfloat16, True, 0.1, True,
                               gen)
    q, k, v = qkv.view(B, T, 3, H, hd).permute(2, 0, 3, 1, 4)
    g = dao.to(torch.bfloat16).view(B, T, H, hd).transpose(1, 2)
    shape = f"(B, T)=({B}, {T}) H={H} hd={hd}"
    fwd = _long_numbers(
        peaks, f"row 2 / 11 attention bf16 {shape}",
        lambda: FT.attention_drop(qkv, mask, TRAIN_SEEDS, **kw),
        lambda: FT.attention_drop_plain(qkv, mask, mattn, T, H,
                                        torch.bfloat16),
        _sdpa_heads(q, k, v, True), _long_work(B, H, pairs, T, T, hd, 2),
        err)
    bwd = _long_numbers(
        peaks, f"row 15 attention backward bf16 {shape}",
        lambda: FT.attention_drop_bwd(qkv, mask, dao, TRAIN_SEEDS, **kw),
        lambda: FT.attention_drop_bwd_plain(qkv, mask, mattn, dao, T, H,
                                            torch.bfloat16),
        _sdpa_heads(q, k, v, True, grad=g),
        _long_work(B, H, pairs, T, T, hd, 2, backward=True), err)
    del qkv, dao, mattn, q, k, v, g
    torch.cuda.empty_cache()
    return fwd, bwd


# past LONG_RES_HD: the GPT-2 long attention timed at (B, T) x hd (C 2,048)
LONG_WIDE_TIMES = ((64, 64), (4, 1024))


def _long_wide_rows(peaks, gen, kernels):
    """The entries past LONG_RES_HD head columns against their plain
    versions, bf16 and fp32: row 1 (``fused_block``) and rows 7-9 (the
    training block, ``check_train_block``) at C 1,024 in one head of 1,024,
    N 9; rows 5 and 6 at C 1,024 in one head, S 1,040; row 2
    (``gpt2_attn_half``) and rows 11-15 (``check_gpt2_train_layer``) at C
    2,048 in one head of 2,048, T 40. Then the GPT-2 long attention at hd
    1,024 and 2,048 timed (``_long_gpt2_attention``) at LONG_WIDE_TIMES,
    under its rows' entries in ``kernels`` (``long_t{T}_hd{hd}``). Returns
    the checks."""
    import torch
    from afft_tpu_torch.models.layers import neg_inf_causal_mask
    from afft_tpu_torch.ops import fused_block as FB
    from afft_tpu_torch.ops import fused_gpt2 as FG
    from afft_tpu_torch.ops import fused_seq_block as FS
    n = 0
    for dt in (torch.float32, torch.bfloat16):
        tag = "bf16" if dt == torch.bfloat16 else "fp32"
        rn = _randn(gen, dt)

        def hold(what, got, want):
            fin, _, rel = errors(got, want)
            if not (fin and rel <= KERNEL_TOL[tag]):
                raise AssertionError(f"long wide {what} {tag}: rel_err="
                                     f"{rel:.3g}")
            return 1
        C, hidden, eps = 1024, 4096, 1e-6
        p = block_params(C, hidden, dt, gen)
        x = rn(64, 9, C)
        with torch.no_grad():
            n += hold("fused_block (64, 9, 1024) H=1", FB.fused_block(
                x, p, None, num_heads=1, eps=eps), FB.fused_block_plain(
                    x, p, None, num_heads=1, eps=eps))
        check_train_block(tag, dt, 64, 9, C, 1, hidden, gen)
        S = 1040
        x, mem = rn(1, S, C), rn(1, S, C)
        pd = decoder_params(C, hidden, dt, gen)
        mask = tiled_causal_mask(S // 4, 4)
        causal = neg_inf_causal_mask(S, device="cuda")
        with torch.no_grad():
            n += hold(f"fused_seq_block (1, {S}, 1024) H=1",
                      FS.fused_seq_block(x, p, mask, num_heads=1, eps=eps),
                      FS.fused_seq_block_plain(x, p, mask, num_heads=1,
                                               eps=eps))
            n += hold(f"fused_decoder_block (1, {S}, 1024) H=1",
                      FS.fused_decoder_block(x, mem, pd, causal, num_heads=1,
                                             eps=eps),
                      FS.fused_decoder_block_plain(x, mem, pd, causal,
                                                   num_heads=1, eps=eps))
        del p, pd, x, mem
        C, hidden, eps, T = 2048, 8192, 1e-5, 40
        pg = gpt2_params(C, hidden, dt, gen)
        y = rn(8, T, C)
        causal = neg_inf_causal_mask(T, device="cuda")
        with torch.no_grad():
            n += hold(f"gpt2_attn_half (8, {T}, 2048) H=1",
                      FG.gpt2_attn_half(y, pg, causal, num_heads=1, eps=eps),
                      FG.gpt2_attn_half_plain(y, pg, causal, num_heads=1,
                                              eps=eps))
        del pg, y
        check_gpt2_train_layer(tag, dt, 8, T, C, 1, hidden, gen)
        n += 2
        torch.cuda.empty_cache()
    log(f"long wide rows: rows 1, 2, 5-9, 11-15 at hd 1,024 / 2,048 in bf16 "
        f"and fp32 against their plain versions: {n} checks ok")
    for hd in (h for h in LONG_EDGE_HD if h > LONG_RES_HD):
        for B, T in LONG_WIDE_TIMES:
            fwd, bwd = _long_gpt2_attention(peaks, gen, B, T, 2048 // hd, hd)
            label = f"long_t{T}_hd{hd}"
            for name, numbers in (("gpt2_attn_half", fwd),
                                  ("fused_gpt2_train_fwd", fwd),
                                  ("fused_gpt2_train_bwd_attn", bwd)):
                kernels[name][label] = {**numbers, "shape": [B, T, 2048]}
    return n


def _long_gpt2_rows(peaks, gen, kernels, floors):
    """Rows 2, 11-15 at C 2048, 4 heads of 512 and T 33 / 64 / 256 / 1,024
    (B * T = 4,096 in bf16, 512 in fp32): the attention half and the
    training layer against their plain versions, the long attention
    forward and backward alone timed beside their plain versions, SDPA and
    their bounds, and held to their floors (``_long_floor``, into
    ``floors``); then rows 11-15 in shard mode at tp = 2, T 64."""
    import torch
    from afft_tpu_torch.models.layers import neg_inf_causal_mask
    from afft_tpu_torch.ops import fused_gpt2 as FG
    C, H, hidden, eps = 2048, 4, 8192, 1e-5
    hd = C // H
    for T in LONG_GPT2_T:
        mask = neg_inf_causal_mask(T, device="cuda")
        worst = {"attn_half": 0.0, "train": 0.0}
        for dt, rows in ((torch.float32, LONG_FP32_ROWS),
                         (torch.bfloat16, LONG_GPT2_ROWS)):
            tag = "bf16" if dt == torch.bfloat16 else "fp32"
            B = max(1, rows // T)
            p = gpt2_params(C, hidden, dt, gen)
            x = _randn(gen, dt)(B, T, C)
            with torch.no_grad():
                fin, max_abs, rel = errors(
                    FG.gpt2_attn_half(x, p, mask, num_heads=H, eps=eps),
                    FG.gpt2_attn_half_plain(x, p, mask, num_heads=H,
                                            eps=eps))
            if not (fin and rel <= KERNEL_TOL[tag]):
                raise AssertionError(f"long gpt2_attn_half {tag} T={T}: "
                                     f"rel_err={rel:.3g}")
            worst["attn_half"] = max(worst["attn_half"], max_abs)
            del p, x
            case = check_gpt2_train_layer(tag, dt, B, T, C, H, hidden, gen)
            worst["train"] = max(worst["train"], *case["errs"].values())
            log(f"long fused_gpt2_train {tag} (B, T)=({B}, {T}): forward "
                f"and masks ok, worst gradient {case['worst'][0]} rel_err="
                f"{case['worst'][1]:.3g} (tol {GRAD_TOL[tag]:g})")
            del case
            torch.cuda.empty_cache()
        B = LONG_GPT2_ROWS // T
        fwd, bwd = _long_gpt2_attention(peaks, gen, B, T, H, hd)
        if ("fwd", T) in LONG_CUDA_CORE_MS:
            _long_floor(("fwd", T), fwd, floors)
            _long_floor(("bwd", T), bwd, floors)
        label = f"long_t{T}"
        kernels["gpt2_attn_half"][label] = {
            **fwd, "max_abs_err": worst["attn_half"], "shape": [B, T, C]}
        kernels["fused_gpt2_train_fwd"][label] = {
            **fwd, "max_abs_err": worst["train"], "shape": [B, T, C]}
        kernels["fused_gpt2_train_bwd_attn"][label] = {
            **bwd, "max_abs_err": worst["train"], "shape": [B, T, C]}
        torch.cuda.empty_cache()
    # rows 11-15 in shard mode, tp = 2: the long route on 2 of 4 heads
    for dt, B in ((torch.float32, LONG_FP32_ROWS // 64),
                  (torch.bfloat16, LONG_GPT2_ROWS // 64)):
        check_tp_layer("bf16" if dt == torch.bfloat16 else "fp32", dt, True,
                       B, 64, C, H, hidden, gen)
        torch.cuda.empty_cache()
    log("long rows 11-15 shard mode tp=2 T=64: each rank against the plain "
        "shard version, the sums over the ranks against the unsharded "
        "kernel: ok")


def _long_fuser_rows(peaks, gen, kernels):
    """Rows 1, 7 and 9 at C 1024, 4 heads of 256 and N 9 / 12 / 16 (R 1,024
    rows in bf16, 128 in fp32): the serving block and the training block
    against their plain versions, the long attention (the fuser's fp32
    probabilities) forward and backward alone timed."""
    import torch
    from afft_tpu_torch.ops import fused_block as FB
    from afft_tpu_torch.ops import fused_block_train as FT
    C, H, hidden, eps = 1024, 4, 4096, 1e-6
    hd = C // H
    for N in LONG_FUSER_N:
        worst = {"block": 0.0, "train": 0.0}
        for dt, R in ((torch.float32, LONG_FUSER_R[1]),
                      (torch.bfloat16, LONG_FUSER_R[0])):
            tag = "bf16" if dt == torch.bfloat16 else "fp32"
            p = block_params(C, hidden, dt, gen)
            x = _randn(gen, dt)(R, N, C)
            with torch.no_grad():
                fin, max_abs, rel = errors(
                    FB.fused_block(x, p, None, num_heads=H, eps=eps),
                    FB.fused_block_plain(x, p, None, num_heads=H, eps=eps))
            if not (fin and rel <= KERNEL_TOL[tag]):
                raise AssertionError(f"long fused_block {tag} N={N}: "
                                     f"rel_err={rel:.3g}")
            worst["block"] = max(worst["block"], max_abs)
            del p, x
            case = check_train_block(tag, dt, R, N, C, H, hidden, gen)
            worst["train"] = max(worst["train"], *case["errs"].values())
            log(f"long fused_block_train {tag} (R, N)=({R}, {N}): forward "
                f"and masks ok, worst gradient {case['worst'][0]} rel_err="
                f"{case['worst'][1]:.3g} (tol {GRAD_TOL[tag]:g})")
            del case
            torch.cuda.empty_cache()
        R = LONG_FUSER_R[0]
        qkv = _randn(gen, torch.bfloat16)(R * N, 3 * C)
        dao = _randn(gen, torch.float32)(R * N, C)
        kw = dict(n_tokens=N, num_heads=H, block_idx=4, attn_rate=0.1,
                  gpt2=False)
        mattn = FT.draw_masks_plain(R, N, C, H, TRAIN_SEEDS, 4, 0.1, 0.0,
                                    0.0, device="cuda")[0]
        err = _check_attention_bwd(R, N, H, hd, torch.bfloat16, False, 0.1,
                                   False, gen)
        q, k, v = qkv.view(R, N, 3, H, hd).permute(2, 0, 3, 1, 4)
        g = dao.to(torch.bfloat16).view(R, N, H, hd).transpose(1, 2)
        fwd = _long_numbers(
            peaks, f"row 1 / 7 attention bf16 (R, N)=({R}, {N})",
            lambda: FT.attention_drop(qkv, None, TRAIN_SEEDS, **kw),
            lambda: FT.attention_drop_plain(qkv, None, mattn, N, H),
            _sdpa_heads(q, k, v, False),
            _long_work(R, H, N * N, N, N, hd, 2), err)
        bwd = _long_numbers(
            peaks, f"row 9 attention backward bf16 (R, N)=({R}, {N})",
            lambda: FT.attention_drop_bwd(qkv, None, dao, TRAIN_SEEDS, **kw),
            lambda: FT.attention_drop_bwd_plain(qkv, None, mattn, dao, N, H),
            _sdpa_heads(q, k, v, False, grad=g),
            _long_work(R, H, N * N, N, N, hd, 2, backward=True), err)
        label = f"long_n{N}"
        kernels["fused_block"][label] = {
            **fwd, "max_abs_err": worst["block"], "shape": [R, N, C]}
        kernels["fused_block_train_fwd"][label] = {
            **fwd, "max_abs_err": worst["train"], "shape": [R, N, C]}
        kernels["fused_block_train_bwd_attn"][label] = {
            **bwd, "max_abs_err": worst["train"], "shape": [R, N, C]}
        del qkv, dao, mattn, q, k, v, g
        torch.cuda.empty_cache()


def _long_seq_rows(peaks, gen, kernels, floors):
    """Row 4 at 16 queries over Nk 1,025 / 2,048 cache slots (B 64, 4 heads
    of 512; the rollout's cache mask) and rows 5 and 6 at S 1,280 / 2,048
    (B 4 in bf16, 1 in fp32; C 1024, 4 heads): each against its plain
    version; the attention alone (fused_attention: the same long instance
    the blocks launch) timed beside SDPA, rows 5 and 6 held to their floors
    (``_long_floor``, into ``floors``)."""
    import torch
    from afft_tpu_torch.models.layers import neg_inf_causal_mask
    from afft_tpu_torch.ops import attention as FA
    from afft_tpu_torch.ops import fused_seq_block as FS
    H = 4
    for Nk in LONG_KEYS:
        worst, hd = 0.0, 512
        for dt, B in ((torch.float32, 8), (torch.bfloat16, 64)):
            tag = "bf16" if dt == torch.bfloat16 else "fp32"
            q, kc, vc, mask = rollout_operands(B, 16, Nk - 16, Nk, H, hd, dt,
                                               gen)
            with torch.no_grad():
                fin, max_abs, rel = errors(
                    FA.fused_attention(q, kc, vc, mask),
                    FA.attention_plain(q, kc, vc, mask)[0])
            if not (fin and rel <= KERNEL_TOL[tag]):
                raise AssertionError(f"long fused_attention {tag} Nk={Nk}: "
                                     f"rel_err={rel:.3g}")
            worst = max(worst, max_abs)
        flops, nbytes = attention_work(q, kc, vc, mask)
        kernels["fused_attention"][f"long_nk{Nk}"] = {**_long_numbers(
            peaks, f"row 4 bf16 (B, Nq, Nk)=({B}, 16, {Nk})",
            lambda: FA.fused_attention(q, kc, vc, mask),
            lambda: FA.attention_plain(q, kc, vc, mask)[0],
            _sdpa_heads(q.transpose(1, 2), kc.transpose(1, 2),
                        vc.transpose(1, 2), False, mask),
            (flops, nbytes), worst), "shape": [B, 16, Nk, H, hd]}
        del q, kc, vc, mask
        torch.cuda.empty_cache()
    C, hidden, eps = 1024, 4096, 1e-6
    hd = C // H
    for S in LONG_SEQ_S:
        mask = tiled_causal_mask(S // 4, 4)
        causal = neg_inf_causal_mask(S, device="cuda")
        worst = {"seq": 0.0, "dec": 0.0}
        for dt, B in ((torch.float32, 1), (torch.bfloat16, 4)):
            tag = "bf16" if dt == torch.bfloat16 else "fp32"
            rn = _randn(gen, dt)
            x, mem = rn(B, S, C), rn(B, S, C)
            p = block_params(C, hidden, dt, gen)
            pd = decoder_params(C, hidden, dt, gen)
            with torch.no_grad():
                for key, got, want in (
                        ("seq", FS.fused_seq_block(x, p, mask, num_heads=H,
                                                   eps=eps),
                         FS.fused_seq_block_plain(x, p, mask, num_heads=H,
                                                  eps=eps)),
                        ("dec", FS.fused_decoder_block(x, mem, pd, causal,
                                                       num_heads=H, eps=eps),
                         FS.fused_decoder_block_plain(x, mem, pd, causal,
                                                      num_heads=H,
                                                      eps=eps))):
                    fin, max_abs, rel = errors(got, want)
                    if not (fin and rel <= KERNEL_TOL[tag]):
                        raise AssertionError(
                            f"long {key} block {tag} S={S}: rel_err="
                            f"{rel:.3g}")
                    worst[key] = max(worst[key], max_abs)
            del x, mem, p, pd
            torch.cuda.empty_cache()
        B = 4
        qkv = _randn(gen, torch.bfloat16)(B, S, 3, H, hd)
        q, k, v = qkv.unbind(2)          # packed rows, read in place
        for key, name, m, pairs in (
                ("seq", "fused_seq_block", mask, int(mask.isfinite().sum())),
                ("dec", "fused_decoder_block", causal, S * (S + 1) // 2)):
            numbers = _long_numbers(
                peaks, f"row {LONG_ROWS[name]} attention bf16 (B, S)=({B}, "
                f"{S})",
                lambda: FA.fused_attention(q, k, v, m),
                lambda: FA.attention_plain(q, k, v, m)[0],
                _sdpa_heads(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), False, m),
                _long_work(B, H, pairs, S, S, hd, 2), worst[key])
            _long_floor((f"row{LONG_ROWS[name]}", S), numbers, floors)
            kernels[name][f"long_s{S}"] = {**numbers, "shape": [B, S, C]}
        del qkv, q, k, v
        torch.cuda.empty_cache()


def _long_serve(over=(), label="a", graph=True):
    """(a) The flagship served at a 64-frame context, B 64 bf16, through
    ``serve.Server``'s served function: the GPT-2 attention half on the
    long route (6 launches a forward, the tensor-core forms in its
    profile); logits against the plain path; with ``graph`` one CUDA graph
    of the forward at bucket 64 replayed, bit for bit the eager kernel
    forward. ``over``: further overrides ((a'): LONG_WIDE). Returns
    (main-path long launches, numbers)."""
    import torch
    from afft_tpu_torch import serve
    from afft_tpu_torch.ops import (launch_counts, long_launch_counts,
                                    reset_launches)
    from afft_tpu_torch.serving.graphs import GraphServer
    cfg = serve.load_config(FLAGSHIP,
                            [f"data_eval.num_frames={LONG_SERVE_T}", *over])
    depth, layers = int(cfg.model.fuser.depth), int(cfg.model.common.fp_layers)
    server = serve.Server(cfg, {"action": 3806}, "bfloat16", "cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(64)
    feats = {m: torch.randn(LONG_BATCH, LONG_SERVE_T, int(d), generator=gen,
                            device="cuda").to(torch.bfloat16)
             for m, d in cfg.model.modal_dims.to_container().items()}
    fn = server.serving_fn("native", 0)
    # the main path: counts set to 0 just before, read just after
    reset_launches()
    with torch.no_grad():
        out = fn(feats)
    torch.cuda.synchronize()
    what = f"long serve ({label}) T={LONG_SERVE_T} B={LONG_BATCH} {over}"
    expected = {"fused_block": depth, "gpt2_attn_half": layers,
                "gpt2_mlp_half": layers}
    _counts_ok(what, launch_counts(), expected)
    long = long_launch_counts()
    _counts_ok(f"{what} (long route)", long, {"gpt2_attn_half": layers})
    numbers = {"plain": _hold_plain(what, server, feats, out),
               "overrides": list(over)}
    with torch.no_grad():
        numbers["forward_ms"] = time_ms(lambda: fn(feats), iters=10)
    prof = _long_profile(lambda: fn(feats), f"{what} forward",
                         {k: n * layers for k, n in LONG_MMA["serve"].items()})
    _long_profile_ok(what, prof["kernels"], LONG_MMA["serve"])
    numbers["profile"] = {k: prof[k] for k in ("busy_ms", "wall_ms",
                                                "groups_ms")}
    log(f"{what}: launches {expected} ({layers} gpt2_attn_half on the long "
        f"route), forward {numbers['forward_ms']:.3f} ms")
    if not graph:
        del server, feats
        torch.cuda.empty_cache()
        return {k: n for k, n in long.items() if n}, numbers
    graphs = GraphServer(server, [LONG_BATCH])
    if graphs.capture_launches[LONG_BATCH] != expected:
        raise AssertionError(f"long serve graph: launches at capture "
                             f"{graphs.capture_launches[LONG_BATCH]}")
    with graphs.stream_context():
        replay = graphs.run(LONG_BATCH, feats).clone()
    graphs.stream.synchronize()
    with torch.no_grad():
        eager = fn(feats)
    torch.cuda.synchronize()
    same = torch.equal(replay, eager)
    log(f"{what}: CUDA graph at bucket {LONG_BATCH}: replay bit for bit the "
        f"eager forward: {same}")
    if not same:
        raise AssertionError("long serve: graph replay differs from the "
                             "eager forward")
    numbers["graph_bit_for_bit"] = same
    del graphs, server, feats
    torch.cuda.empty_cache()
    return {k: n for k, n in long.items() if n}, numbers


def _long_grad_step(label, over, three_way=False, profile=False):
    """One step's gradients at T 48 (``over``: further overrides) through
    the kernels against ``impl="plain"`` from the same weights on the same
    masks, B LONG_GRAD_BATCH, each step's launches asserted (the GPT-2
    entries on the long route): fp32, every tensor within 1e-4 of its
    max|grad|; bf16, every tensor within 2e-2. ``three_way``: in bf16 a
    third runner, the plain path in fp32 from the same weights, and each
    tensor's three distances logged (kernel bf16 and plain bf16 against
    plain fp32, kernel against plain bf16; the table in LONG_GRAD_TABLE).
    ``profile``: one more kernel step of each dtype traced, bf16 launching
    the tensor-core long kernels (LONG_MMA), fp32 the CUDA-core ones
    (LONG_CC). Returns (the kernel steps' launches on the long route,
    numbers)."""
    import torch
    from afft_tpu_torch import serve
    from afft_tpu_torch.ops import (launch_counts, long_launch_counts,
                                    reset_launches)
    from afft_tpu_torch.train.runner import Runner
    cfg = serve.load_config(os.path.join(EXPTS, TRAIN_EXPT), [
        f"data_train.num_frames={LONG_TRAIN_T}", *over])
    depth, layers = int(cfg.model.fuser.depth), int(cfg.model.common.fp_layers)
    warmup = int(cfg.opt.warmup.num_epochs)
    expected = {**{n: depth for n, _ in TRAIN_KERNELS["fused_block_train"][:3]},
                **{n: layers for n, _ in TRAIN_KERNELS["fused_gpt2_train"][:3]}}
    expected_long = {"fused_gpt2_train_fwd": layers,
                     "fused_gpt2_train_bwd_attn": layers}
    what = f"long train ({label}) T={LONG_TRAIN_T} B={LONG_GRAD_BATCH} {over}"
    batch = synthetic_batches(cfg, LONG_GRAD_BATCH, 1, seed=48)[0]
    numbers, long_total = {"overrides": list(over)}, {}
    for dt, tol in (("float32", 1e-4), ("bfloat16", 2e-2)):
        kernel = Runner.from_config(cfg, TRAIN_CLASSES, device="cuda",
                                    iters_per_epoch=1, compute_dtype=dt)
        weights = kernel.model.state_dict()
        plain = Runner.from_config(cfg, TRAIN_CLASSES, device="cuda",
                                   iters_per_epoch=1, compute_dtype=dt,
                                   impl="plain", weights=weights)
        # the masters' state_dict is live: every runner from the same
        # weights is built before the first step
        plain32 = Runner.from_config(
            cfg, TRAIN_CLASSES, device="cuda", iters_per_epoch=1,
            compute_dtype="float32", impl="plain", weights=weights) \
            if three_way and dt == "bfloat16" else None
        lr = kernel.lr_schedule(warmup, kernel.base_lr)
        reset_launches()
        loss_k = float(kernel.train_step(batch, lr, kernel.base_lr)[0]
                       ["total_loss"])
        _counts_ok(f"{what} {dt} kernels", launch_counts(), expected)
        _counts_ok(f"{what} {dt} kernels (long route)", long_launch_counts(),
                   expected_long)
        for k, n in expected_long.items():
            long_total[k] = long_total.get(k, 0) + n
        loss_p = float(plain.train_step(batch, lr, plain.base_lr)[0]
                       ["total_loss"])
        rels = _grad_rels(kernel, plain)
        worst = max((v, k) for k, v in rels.items())
        if plain32 is not None:
            plain32.train_step(batch, lr, plain32.base_lr)
            numbers["three_way"] = _long_three_way(kernel, plain, plain32,
                                                   rels)
            del plain32
        log(f"{what} {dt}: one step through the kernels (loss {loss_k:.6f}) "
            f"and through the plain versions ({loss_p:.6f}) on the same "
            f"masks: every tensor within {worst[0]:.3g} of max|grad| "
            f"({worst[1]}; tol {tol:g})")
        if not (math.isfinite(loss_k) and worst[0] <= tol):
            raise AssertionError(f"{what} {dt}: the kernel path's gradients "
                                 "stray from the plain path's")
        numbers[f"grad_rel_{dt}"] = list(worst)
        if profile:
            forms, tag = (LONG_MMA, "tensor-core") if dt == "bfloat16" \
                else (LONG_CC, "CUDA-core")
            prof = _long_profile(
                lambda: kernel.train_step(batch, lr, kernel.base_lr),
                f"{what} {dt} step",
                {k: n * layers for k, n in forms["train"].items()}, grad=True)
            _long_profile_ok(f"{what} {dt} ({tag})", prof["kernels"],
                             forms["train"])
            numbers[f"profile_{dt}"] = {k: prof[k] for k in (
                "busy_ms", "wall_ms", "groups_ms")}
        del kernel, plain, weights
        torch.cuda.empty_cache()
    return long_total, numbers


LONG_GRAD_TABLE = os.path.join(REPO, "build", "chip_smoke",
                               "long_grad_rel.json")


def _long_three_way(kernel, plain, plain32, rels):
    """The bf16 step's three distances per tensor (``_long_grad_step``):
    kernel bf16 against plain fp32, plain bf16 against plain fp32 (a plain
    fp32 runner's step from the same weights, on the same masks: Philox of
    the element index), kernel against plain bf16 (``rels``). Logs each
    tensor, writes the table to LONG_GRAD_TABLE; returns each distance's
    worst tensor, the fuser's and the GPT-2 predictor's worst, and
    ``fuser.modal_token``'s."""
    table = {"kernel_bf16_vs_plain_fp32": _grad_rels(kernel, plain32),
             "plain_bf16_vs_plain_fp32": _grad_rels(plain, plain32),
             "kernel_bf16_vs_plain_bf16": rels}
    for name in rels:
        log(f"long grad3 {name}: " + " ".join(
            f"{key.replace('_vs_', '/')} {t[name]:.3e}"
            for key, t in table.items()))
    os.makedirs(os.path.dirname(LONG_GRAD_TABLE), exist_ok=True)
    with open(LONG_GRAD_TABLE, "w") as f:
        json.dump(table, f, indent=1)
    out = {}
    for key, t in table.items():
        out[key] = {"worst": max((v, k) for k, v in t.items()),
                    **{f"{part}_worst": max(((v, k) for k, v in t.items()
                                             if f".{part}." in k),
                                            default=None)
                       for part in ("fuser", "gpt_model")},
                    "modal_token": [v for k, v in t.items()
                                    if k.endswith(".fuser.modal_token")]}
    log(f"long grad3 worst: {out}")
    return out


def _long_train():
    """(b) The flagship trained at 48 frames: one step's gradients through
    the kernels against ``impl="plain"`` at B 8 (``_long_grad_step``: fp32
    every tensor within 1e-4 of its max|grad|, bf16 every tensor within
    2e-2, and the bf16 step's three distances per tensor), then 5 bf16
    steps at B 64 with finite, falling losses; (b') the same one-step
    comparison with the predictor in 2 heads of 1,024 (LONG_WIDE), the
    kernel steps profiled; (c) the rollout in training (T 16,
    fp_output_len 20: 35 tokens in the last pass), 3 bf16 steps at B 32.
    Every step's launches asserted. Returns (main-path long launches,
    numbers)."""
    import torch
    from afft_tpu_torch import serve
    from afft_tpu_torch.ops import (launch_counts, long_launch_counts,
                                    reset_launches)
    from afft_tpu_torch.train.runner import Runner
    expt = os.path.join(EXPTS, TRAIN_EXPT)
    cfg = serve.load_config(expt, [f"data_train.num_frames={LONG_TRAIN_T}"])
    depth, layers = int(cfg.model.fuser.depth), int(cfg.model.common.fp_layers)
    warmup = int(cfg.opt.warmup.num_epochs)
    fuser_names = [n for n, _ in TRAIN_KERNELS["fused_block_train"][:3]]
    gpt2_names = [n for n, _ in TRAIN_KERNELS["fused_gpt2_train"][:3]]

    def per_step(passes, long_passes):
        return ({**dict.fromkeys(fuser_names, depth),
                 **dict.fromkeys(gpt2_names, layers * passes)},
                {"fused_gpt2_train_fwd": layers * long_passes,
                 "fused_gpt2_train_bwd_attn": layers * long_passes})

    long_total, numbers = {}, {}
    for key, label, over, kw in (("grads", "b", [], dict(three_way=True)),
                                 ("grads_wide", "b'", LONG_WIDE,
                                  dict(profile=True))):
        long, numbers[key] = _long_grad_step(label, over, **kw)
        for k, n in long.items():
            long_total[k] = long_total.get(k, 0) + n
    for label, over, B, steps, passes, long_passes in (
            ("t48", [f"data_train.num_frames={LONG_TRAIN_T}"], LONG_BATCH,
             LONG_STEPS, 1, 1),
            ("rollout35", [f"model.common.fp_output_len={LONG_ROLLOUT}"],
             LONG_ROLLOUT_BATCH, LONG_ROLLOUT_STEPS, LONG_ROLLOUT,
             LONG_ROLLOUT + 16 - 1 - 32)):
        cfg = serve.load_config(expt, over)
        runner = Runner.from_config(cfg, TRAIN_CLASSES, device="cuda",
                                    iters_per_epoch=1,
                                    compute_dtype="bfloat16")
        batches = synthetic_batches(cfg, B, 2, seed=16)
        expected, expected_long = per_step(passes, long_passes)
        losses, events = [], []
        # the main path: counts set to 0 just before, read just after
        reset_launches()
        for i in range(steps):
            before, before_long = launch_counts(), long_launch_counts()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            losses.append(runner.train_step(
                batches[i % 2], runner.lr_schedule(warmup + i,
                                                   runner.base_lr),
                runner.base_lr)[0]["total_loss"])
            end.record()
            events.append((start, end))
            _counts_ok(f"long train {label} step {i + 1}",
                       {k: v - before[k] for k, v in launch_counts().items()},
                       expected)
            _counts_ok(f"long train {label} step {i + 1} (long route)",
                       {k: v - before_long[k]
                        for k, v in long_launch_counts().items()},
                       expected_long)
        torch.cuda.synchronize()
        for k, n in long_launch_counts().items():
            long_total[k] = long_total.get(k, 0) + n
        profile = None
        if label == "t48":  # one more step, traced: the tensor-core forms
            prof = _long_profile(
                lambda: runner.train_step(
                    batches[0], runner.lr_schedule(warmup, runner.base_lr),
                    runner.base_lr),
                f"long train T={LONG_TRAIN_T} B={B} step",
                {k: n * layers for k, n in LONG_MMA["train"].items()},
                grad=True)
            _long_profile_ok(f"train T={LONG_TRAIN_T}", prof["kernels"],
                             LONG_MMA["train"])
            profile = {k: prof[k] for k in ("busy_ms", "wall_ms",
                                            "groups_ms")}
        losses = [float(v) for v in losses]
        ms = statistics.median(a.elapsed_time(b) for a, b in events[1:])
        log(f"long train {label} bf16 B={B}: {steps} steps, launches a step "
            f"{expected} (long route {expected_long}), losses "
            f"{[round(v, 4) for v in losses]}, {ms:.2f} ms a step (median "
            f"after the first)")
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"long train {label}: non-finite loss")
        if label == "t48" and not (losses[-1] + losses[-2]) / 2 < losses[0]:
            raise AssertionError("long train t48: the loss did not fall")
        numbers[label] = {"losses": losses, "ms_per_step": ms,
                          "launches_per_step": expected,
                          "long_launches_per_step": expected_long,
                          "profile": profile}
        del runner, batches
        torch.cuda.empty_cache()
    return {k: n for k, n in long_total.items() if n}, numbers


def phase_long(peaks, kernels):
    """16. Long contexts on the long attention route (ROADMAP §C.3, §C.7,
    §B.2): (a) the flagship served at T 64, (a') again with its predictor
    in 2 heads of 1,024 (LONG_WIDE), (b) trained at T 48 (and (b') one
    step in 2 heads of 1,024), (c) its rollout in training over 35 tokens,
    each through the entry points a user calls, the profiles of (a), (a')
    and (b) showing the tensor-core forms and no CUDA-core long kernel
    ((b')'s fp32 step the CUDA-core ones); (d) every long route at full
    width against its plain version, the long forms at their edges
    (``_long_edges``, hd to 2,048), the entries past LONG_RES_HD
    (``_long_wide_rows``), its keep pattern bit for bit, each timed beside
    its plain version, SDPA and its bound, under its row's entry in
    ``kernels`` (``long_*``), the tensor-core forms held to a quarter of
    the CUDA-core route's times (``floors`` of the numbers returned: the
    times beside the constants). Each row's entry gets
    ``long_launches``: its launches on the long route in (a)-(c), the
    main paths (rows 2, 11, 15), or in (d)'s checks alone
    (``long_kernel_level_launches``, rows 1, 4-7, 9). Returns numbers."""
    import torch
    from afft_tpu_torch.ops import long_launch_counts, reset_launches
    t0 = time.perf_counter()
    serve_long, serve_numbers = _long_serve()
    wide_long, wide_numbers = _long_serve(LONG_WIDE, "a'", graph=False)
    train_long, train_numbers = _long_train()
    main = dict(serve_long)
    for k, n in (*wide_long.items(), *train_long.items()):
        main[k] = main.get(k, 0) + n
    gen = torch.Generator(device="cuda")
    gen.manual_seed(16)
    reset_launches()
    keep = _long_keep_pattern(gen)
    edges, edge_worst = _long_edges(gen)
    floors = {}
    _long_gpt2_rows(peaks, gen, kernels, floors)
    _long_fuser_rows(peaks, gen, kernels)
    _long_seq_rows(peaks, gen, kernels, floors)
    wide = _long_wide_rows(peaks, gen, kernels)
    checks = long_launch_counts()
    for name in LONG_ROWS:
        kernels[name]["long_launches"] = main.get(name, 0)
        kernels[name]["long_kernel_level_launches"] = checks.get(name, 0)
    for name in ("gpt2_attn_half", "fused_gpt2_train_fwd",
                 "fused_gpt2_train_bwd_attn"):
        if not main.get(name):
            raise AssertionError(f"long: {name} never took the long route "
                                 "on a main path")
    seconds = time.perf_counter() - t0
    log(f"long: main-path launches on the long route {main}; kernel-level "
        f"{ {k: n for k, n in checks.items() if n} }; phase {seconds:.1f} s")
    return {"serve": serve_numbers, "serve_wide": wide_numbers,
            "train": train_numbers, "keep_elements": keep,
            "edge_checks": edges, "wide_row_checks": wide,
            "edge_worst_abs_err": edge_worst, "floors": floors,
            "main_path_long_launches": main, "seconds": seconds}


def main():
    try:
        import torch
    except ImportError:
        log("FAIL: torch is not installed")
        return 2
    if not torch.cuda.is_available():
        log("FAIL: CUDA is not available; chip_smoke.py needs an NVIDIA GPU")
        return 2
    if not os.path.isdir(os.path.join(REPO, "afft_tpu_torch")):
        log("FAIL: run chip_smoke.py from a checkout of the repository")
        return 2
    sys.path.insert(0, REPO)
    try:
        # each phase's seconds (phase_seconds, logged before the report)
        seconds, t_mark = {}, [time.perf_counter()]

        def mark(phase):
            now = time.perf_counter()
            seconds[phase] = round(now - t_mark[0], 1)
            t_mark[0] = now

        # 1. device
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        log(smi)
        name = torch.cuda.get_device_name(0)
        log(f"device: {name}, count {torch.cuda.device_count()}, torch "
            f"{torch.__version__}, CUDA {torch.version.cuda}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        peaks = peaks_for(name)

        # 2. build
        from afft_tpu_torch.ops import _build
        t0 = time.perf_counter()
        _build.library()
        lib_path = _build.build()
        log(f"build: {time.perf_counter() - t0:.2f} s -> "
            f"{os.path.relpath(lib_path, REPO)}")
        report_build(lib_path)
        sass = start_sass_check(lib_path)

        mark("2 build")
        # 3. gemm
        gen = torch.Generator(device="cuda")
        gen.manual_seed(2)
        gemm_numbers = phase_gemm(peaks, gen)
        log(json.dumps({"gemm": gemm_numbers}))

        mark("3 gemm")
        # 4. kernels
        kernels = phase_kernels(peaks)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1)
        kernels.update(phase_train_kernels(peaks, gen))
        # rows 7, 8 and 11-15 in shard mode (tensor parallelism, tp = 2)
        for name, numbers in phase_tp_kernels(peaks, gen).items():
            kernels[name]["tp"] = numbers
        # every model width (ROADMAP §C.8): the pack kernel of the Hopper
        # GEMM's products off the 16-byte grid, timed at the full-width
        # fuser block's largest pack (its other shape beside it), and the
        # entries at full width off the grid beside C 1,024 / 2,048
        top, *more = gemm_numbers["pack_rows"].items()
        kernels["pack_rows"] = dict(
            name="pack_rows", route="cuda",
            source="afft_tpu_torch/csrc/gemm_sm90.cuh",
            replaces="afft_tpu/ops/pallas_block.py:69", **top[1],
            **{label: numbers for label, numbers in more})
        for name, pair in check_full_width_off_grid(gen).items():
            kernels[name]["wide_off_grid"] = pair["off"]
            kernels[name]["wide_aligned"] = pair["aligned"]

        mark("4 kernels")
        # 5. serve
        launches, serve_numbers = phase_serve()
        log(json.dumps({"serve": serve_numbers}))

        mark("5 serve")
        # 6. train
        train_launches, train_numbers = phase_train()
        launches.update({k: n for k, n in train_launches.items() if n})
        # The training step regenerates its masks in registers and never
        # launches draw_masks or draw_masks_gpt2 (nor does the TPU package's
        # training step: there too they serve only the comparisons). Their
        # counts on the main path are therefore 0, said so in their
        # entries; the launches of the plain run that feeds on them stand
        # beside them under another key.
        for name in ("draw_masks", "draw_masks_gpt2"):
            kernels[name].update(
                main_path=False, plain_path_launches=train_numbers["fp32"]
                ["launches_plain"][name])
            launches.setdefault(name, 0)
        # the flagship's widths are on the 16-byte grid: no operand is
        # packed there (the served and trained paths assert 0); phase 7's
        # runs off the grid launch it (off_grid_launches)
        kernels["pack_rows"]["main_path"] = False
        launches.setdefault("pack_rows", 0)
        for k in kernels.values():
            # KeyError if no driven path launched the kernel
            k["launches"] = launches[k["name"]]
        log(json.dumps({"train": train_numbers}))

        mark("6 train")
        # 7. expt 99 (and again at widths off the 8-column grid)
        expt99, off_grid_packs = phase_expt99()
        kernels["pack_rows"]["off_grid_launches"] = off_grid_packs
        log(json.dumps({"expt99": expt99}))

        mark("7 expt 99")
        # 8. the launcher (this slice's main path, in its own processes)
        launcher_launches, launcher_numbers = phase_launcher()
        for k in kernels.values():
            k["launcher_launches"] = launcher_launches[k["name"]]
        log(json.dumps({"launcher": launcher_numbers}))
        finish_sass_check(sass, kernels)

        mark("8 launcher")
        # 9. eval (the eval CLI on the launcher's checkpoint)
        eval_launches, eval_numbers, finish_eval = phase_eval()
        for k in kernels.values():
            k["eval_launches"] = eval_launches[k["name"]]
        log(json.dumps({"eval": eval_numbers}))

        mark("9 eval")
        # 10. dp (torchrun: -n 1 over NCCL, two processes over gloo), beside
        # phase 9's reference parity runs and bf16-master training check
        log(json.dumps({"dp": phase_dp()}))
        repro_launches, check_launches, checks = finish_eval()
        for k in kernels.values():
            k["reproduce_launches"] = {
                label: counts.get(k["name"], 0)
                for label, counts in repro_launches.items()}
            k["train_check_launches"] = {
                dt: counts.get(k["name"], 0)
                for dt, counts in check_launches.items()}
        log(json.dumps({"eval_tools": checks}))

        mark("10 dp")
        # 11. variants (expts 00 and 05 served and trained, 03 and 04
        # trained, expt 05's model through the launcher)
        t0 = time.perf_counter()
        variant_launches, variant_numbers = phase_variants()
        for k in kernels.values():
            k["variants_launches"] = variant_launches.get(k["name"], 0)
        variant_numbers["seconds"] = time.perf_counter() - t0
        log(json.dumps({"variants": variant_numbers}))

        mark("11 variants")
        # 12. serving extras (bundles as CUDA graphs per bucket, int8
        # transport and top-k, the concurrent server; the int8 device cache,
        # -m test on it and -m visualize_attention on phase 8's checkpoint)
        t0 = time.perf_counter()
        graph_launches, extras = _fresh_process("phase_serving_graphs")
        extras.update(phase_serving_data())
        for k in kernels.values():
            k["serving_graph_launches"] = graph_launches.get(k["name"], {})
        extras["seconds"] = time.perf_counter() - t0
        log(json.dumps({"serving_extras": extras}))

        mark("12 serving extras")
        # 13. training options (grad_accum, bf16 masters and optimizer
        # state, stochastic rounding, the launcher with them, ZeRO-1)
        t0 = time.perf_counter()
        options_launches, options = phase_options()
        for k in kernels.values():
            k["options_launches"] = options_launches.get(k["name"], 0)
        options["seconds"] = time.perf_counter() - t0
        log(json.dumps({"options": options}))

        mark("13 training options")
        # 14. pipeline parallelism (GPipe stages as gloo processes on the
        # card: the flagship against one process, data2 x pipe2 with
        # ZeRO-1, the launcher and -m test on its checkpoint)
        pipeline_launches, pipeline, reference = phase_pipeline()
        for k in kernels.values():
            k["pipeline_launches"] = {
                run: [counts.get(k["name"], 0) for counts in by_rank]
                for run, by_rank in pipeline_launches.items()}
        log(json.dumps({"pipeline": pipeline}))

        mark("14 pipeline")
        # 15. tensor and sequence parallelism (model ranks as gloo processes
        # on the card: the flagship at data1 x model2 against phase 14's one
        # process, the dry run of every parallel layout on 8 processes)
        tp_launches, tp = phase_tp(reference)
        for k in kernels.values():
            k["tp_launches"] = {
                run: [counts.get(k["name"], 0) for counts in by_rank]
                for run, by_rank in tp_launches.items()}
        log(json.dumps({"tp": tp}))

        mark("15 tp")
        # 16. long contexts (the long attention route: the flagship served
        # at T 64, trained at T 48 and over a 35-token rollout; every long
        # route at full width against its plain version)
        log(json.dumps({"long": phase_long(peaks, kernels)}))
        mark("16 long")
        log(json.dumps({"phase_seconds": seconds}))
    except Exception:  # noqa: BLE001 - any failure fails the smoke test
        traceback.print_exc()
        _stop_runs()
        log("FAIL")
        return 1

    # 17. report
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # a kernel's further shapes are the dict-valued items of its entry
    log(json.dumps({"kernels": [
        {**{k: e[k] for k in keys},
         **{k: e[k] for k in ("main_path", "plain_path_launches",
                              "device_ms", "integer_bound_ms",
                              "off_grid_launches",
                              "launcher_launches", "eval_launches",
                              "reproduce_launches", "train_check_launches",
                              "variants_launches", "serving_graph_launches",
                              "options_launches", "pipeline_launches",
                              "tp_launches", "long_launches",
                              "long_kernel_level_launches")
            if k in e},
         **{label: {k: sub[k] for k in keys[5:] + ("shape",) if k in sub}
            for label, sub in e.items()
            if isinstance(sub, dict)
            and label not in ("redesign", "serving_graph_launches",
                              "pipeline_launches", "tp_launches",
                              "off_grid_launches", "reproduce_launches",
                              "train_check_launches")}}
        for e in kernels.values()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
