#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cake_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels DIR   # the matmuls' and flash_decode's
                                          # times of DIR's package only (a
                                          # same-call comparison with
                                          # another tree)
    python3 chip_smoke.py --phase 10      # phases 1, 6 and 10 only; no
                                          # result line
    python3 chip_smoke.py --phase 11      # phases 1 and 11 only; no
                                          # result line
    python3 chip_smoke.py --phase 12      # phases 1 and 12 only; no
                                          # result line
    python3 chip_smoke.py --phase 13      # phases 1 and 13 only; no
                                          # result line
    python3 chip_smoke.py --phase 14      # phases 1 and 14 only; no
                                          # result line
    python3 chip_smoke.py --phase 15      # phases 1, 6 and 15 only; no
                                          # result line
    python3 chip_smoke.py --phase 16      # phase 1, the tp-local kernel
                                          # checks and phase 16 only; no
                                          # result line
    python3 chip_smoke.py --phase 17      # phase 1, the statistics forms'
                                          # checks and times and phase 17
                                          # only; no result line
    python3 chip_smoke.py --phase 18      # phases 1 and 18 only; no
                                          # result line
    python3 chip_smoke.py --phase 19      # phases 1 and 19 only; no
                                          # result line
    python3 chip_smoke.py --phase 20      # phases 1 and 20 only; no
                                          # result line

Phases, each fatal on failure:

1. the card (``nvidia-smi`` name and power limit), torch, CUDA and nvcc
   versions; the kernels are built from ``cake_tpu_torch/csrc``;
2. each kernel against its plain PyTorch version at the main path's
   shapes (Llama-3-8B: H=32, KVH=8, D=128, bf16, S=4096; prefill at
   T = 2048 and at the 2,000-token prompt; decode from pos 0 to 4095, per
   row, windowed with edges inside a tile and on its boundary, at GQA
   groups 2, 4, 6 and 7; the linears' (K, N) at M = 1 and M = 2048, ragged
   shapes in both matmul regimes), element by element and row by row;
   planted faults (both decodes one tile short at either end, the matmuls
   at M = 1 and 2048, and both prefills one tile short) must fail the same
   check; each matmul and each decode run twice on the same inputs gives
   the same bits; both decodes also in their multi-query form (the
   speculative verify: T = 2, 5, 9 and 17 query positions a stream, one
   stream and 8 at ragged frontiers, a row at S - T, a window), with its
   own planted faults; all four attention kernels again at Gemma-7B's
   head_dim 256 (H = KVH = 16), and both matmuls at Qwen2-7B's and
   Gemma-7B's linears (M = 1, 8, 2048) and the three families' heads;
   ``quant4_matmul`` at int4 groups the kernel folds inside its 64-row K
   tile (g16 and g32 at Llama-3-8B's gate/up and down, g96 at Gemma-7B's,
   M = 1, 8, 2048, and a ragged K = 192), twice on the same inputs, with a
   planted fault (each group scaled by the next group's scales);
3. kernel timings (CUDA events, L2 flushed before each call) beside the
   card's bound, the plain version and one PyTorch call as a yardstick,
   with the prefill kernels' and each matmul case's TFLOP/s, registers and
   shared memory (the matmuls at every linear, M = 1 and 2048, and at the
   verify's M = 9 and 72; the decodes at pos 2047, 4095 and four rows, and
   at T = 5 and 9 beside SDPA with a per-row causal mask; the families'
   shapes: head_dim 256 and the Qwen2/Gemma linears and heads; int4 g32,
   g16 and g96), printed as one JSON line at the end;
4. the model at full Llama-3-8B width and 2 layers, on the card (kernels)
   against the CPU (plain path), from the same weights: bf16, int8 weights
   with the int8 cache, int4 g128 weights; and codes quantized on the card
   against codes quantized on the CPU; then Qwen2-7B (bf16, int4 g128),
   Gemma-7B (bf16, and with the int8 cache) and Mixtral-8x7B (bf16 and
   int8 experts) the same way, with a decode step after the prompt, and
   Mixtral's routing compared row by row (a flip only at a near-tie);
5. the main paths: ``LlamaGenerator`` over Llama-3-8B at full width and
   8 of its 32 layers (``MAIN_LAYERS``, 32 before phase 17 came) with
   random weights, a 2,000-token prompt and 64 tokens, block 8: (a)
   bf16, greedy and sampled; (b) int8 weights with the int8 KV cache; (c)
   int4 g128 weights; each with the kernels' launch counts checked against
   the model calls, then a profiler trace of one prefill and one decode
   block for the card's kernel time and launches a decode step (and, over
   the int8 cache, no dequantizing kernel); a trace of one call of each
   decode wrapper shows one kernel launch; (d) int4 g32 weights at 4
   layers, 16 greedy tokens, launches exact;
6. the command line (``python -m cake_tpu_torch.cli``) on a tiny
   checkpoint written by the port's own writer: bf16, ``--quantize int8
   --kv-quant int8``, ``--quantize int4:g64`` and ``--quantize int4:g32``;
7. the serving engine (``BatchGenerator``) over Llama-3-8B at full width
   and 8 layers (``SERVE_LAYERS``; so are phases 8, 10, 11, 12 and 14) at 8
   slots: (a) bf16, (b) int8 weights with the int8 KV
   cache; ragged prompts of 2,000 to 5 ids (three sharing a 128-id
   prefix), a quota per stream, three arrivals admitted with ``enqueue``
   once two streams finish (the third a prefix hit); launches checked
   against the model calls, every stream identical at blocks 8 and 1 and
   equal to its single-stream run up to its first near-tie (penalized
   top-1 minus top-2 logit < MARGIN_TIE), host-clock tokens/s, arrivals'
   TTFT, and a profile of the 8-slot decode step (card ms, busy share); a
   1,024-slot window whose longest stream runs to the edge; phases 2 and
   3 also hold and time the kernels at these shapes (decode at B = 8 with
   ragged ``pos``, a row at S - 1 and one past it; ``flash_prefill`` at
   B = 8; the matmuls at M = 8);
8. the HTTP server (``cake_tpu_torch.serve``) in this process over (a):
   four concurrent SSE requests and an arrival while they run, whose ids
   must equal the engine's own; then a drain with a stream in flight;
9. the cross-host path (topology, wire, ``Worker``, ``build_runners``,
   ``DistributedGenerator``) over loopback on this card, phase 5's
   weights and prompt, 64 greedy tokens: (a) bf16 over two worker
   threads serving layers 0-4 and 5-7 (the reference's deployment of
   record, 0-19 and 20-31 of 32, at MAIN_LAYERS), the master holding
   embed, norm and head; (b) int8 weights and the int8 cache, the master
   running layers 0-1 over one worker serving 2-7. Every step's logits equal the single-device generator's
   bit for bit (the activations cross the wire as exact bf16 into the
   same kernels at the same shapes), the ids equal, the launches of
   master and workers together match the model calls, and a worker
   decoding one position late fails the check; TTFT, decode tokens/s,
   each segment's ms, wire bytes a token, serialize/deserialize ms and
   the card's busy share print beside phase 5's. Then phase 6's three
   runs over two ``--mode worker`` processes and a ``--topology``
   master: their ids must equal phase 6's;
10. structured output and lookahead on Llama-3-8B weights (seed 0,
   ``SERVE_LAYERS``) and phase 5's prompt, with
   a tokenizer whose id i decodes to ``chr(32 + i % 95)`` over all
   128,256 ids (EOS 128001): the regex ``[0-9]{1,6};`` and a two-field
   JSON schema compiled to token DFAs (timed); (i) ``LlamaGenerator``
   greedy under each guide, every token allowed at its DFA state and the
   argmax of that step's masked logits, the text matching, launches
   exact, ms a token beside an unguided stream stepping one token at a
   time; (ii) the batch engine at 8 slots, two streams guided: the six
   plain streams equal an unguided run (past a tie only, printed), masked
   single steps while a guide is live and fused blocks after; (iii)
   lookahead at block 8 on bf16 and on int8 weights with the int8 cache,
   three runs each way, bit-identical streams, tokens/s with its spread
   and the card's busy share; (iv) a ``json_schema`` and a ``regex``
   ``response_format`` request to the in-process server; (v) the command
   line's ``--lookahead`` (phase 6's ids), ``--window 8`` (an in-process
   generator's ids with that window), ``--logit-bias 7:100`` and the
   observability flags with ``--profile``;
11. the paged KV layout (``BatchGenerator(kv_layout="paged")``, page size
   16), run at the end of each of phase 7's paths over its weights once
   its engines are freed: phase 7's scenario on the slot engine and on the
   paged one, (a) three timed runs of each, (b) one, every stream of every
   run equal to phase 7's ids, at blocks 8 and 1, launches exact, pages
   shared under the prefix and all back at retirement but the prefix
   tree's; a planted fault (stream 0's page map shifted by one page) must
   change the ids; the card ms and launches of a decode step (profiler)
   beside the slot engine's, the gather and write-back ms of a dispatch,
   tokens/s, TTFT and peak memory; a minimum pool (window 1,024) under
   pressure: an arrival defers behind pinned imports, the prefix tree
   evicts, every stream equal to the slot engine's; stream 0 exported
   mid-decode (codec none, and bf16 on (a) / int8 on (b)), finished,
   imported under another id and continued, greedy and sampled, equal to
   the uninterrupted run; on (a), the in-process server with
   ``--spill-mb 256``: eight batch requests hold the slots, an
   interactive one preempts a victim, which is spilled and resumed, and
   every stream equals the engine's own ids;
12. n-gram speculation (K = 8), run at the end of each of phase 7's paths
   after phase 11, over its weights: (i) ``SpeculativeGenerator`` on phase
   5's prompt, 64 tokens, rounds 1 (the host loop) and 8 (chained on the
   card), launches exact, ids equal to the plain stream up to its first
   near-tie (MARGIN_TIE); (ii) the batch engine at 8 slots on phase 7's
   scenario, launches exact, every stream equal to phase 7's ids up to
   its first near-tie, and the card time of a verify round beside a plain
   8-slot step's; (iii) ``spec_replay_fn`` over ``corpus_tokens`` at K = 4
   and 8: tokens a round, card ms and launches a verify beside a plain
   step (random weights make live acceptance meaningless); (iv) on (a),
   one request to the in-process server on a K = 8 engine, whose ids equal
   the engine's;
13. the model families at full width, random weights (seed 0) drawn on
   the card, phase 5's prompt and 64 tokens through ``LlamaGenerator`` at
   blocks 8 and 1 (equal ids, launches exact, one profiled decode block):
   (q) Qwen2-7B, 8 of its 28 layers, bf16; (g) Gemma-7B, 8 of 28, bf16
   and with the int8 cache; (m) Mixtral-8x7B, 4 of 32, int8 experts (the
   bf16 cache); (m16) Mixtral-8x7B at 8 layers with bf16 experts (32 do
   not fit the card). On (g) and (m) the batch engine at 8 slots on phase
   7's scenario, slot and paged layouts (equal streams, launches exact), each
   stream equal to its single stream up to its first near-tie and each
   step its teacher-forced logits' greedy choice outside near-ties; on
   (g) ``--speculate 4`` (the multi-query decode at D = 256) held the same
   way;
14. disaggregated prefill/decode behind the routing gateway, Llama-3-8B at
   full width and ``SERVE_LAYERS``, random weights (seed 0), paged engines
   at 8 slots sharing one set of weights: a prefill and a decode replica
   (with a KV transfer listener) join a p2c gateway started with no
   backends by registering, and the gateway finds the tiers from their
   ``/healthz``; phase 8's five prompts through the gateway as SSE equal a
   mixed replica's greedy ids up to a near-tie (MARGIN_TIE), on (a) bf16
   under the transfer codecs none, bf16 (bit-identical to none) and int8
   (lossy: each step its teacher-forced logits' choice outside near-ties)
   and (b) int8 weights with the int8 cache; launches exact over both
   replicas' model calls, one handoff a request, no transfer left in
   flight; the handoff's parts (export, send, import), snapshot bytes,
   client TTFT beside the mixed replica's, and a 2,000-id handoff by hand
   (resume to first decoded token), and the decode replica's card ms a
   step; on (a), two mixed replicas behind a gateway they joined by
   registering: one is drained mid-stream and migrates the stream to the
   other, whose ids equal an undisturbed run's; the other then
   deregisters, leaving rotation while its ``/healthz`` still answers 200
   before its drain turns it 503. Last, the command line: ``--mode
   gateway``, a ``--role prefill`` and a ``--role decode`` replica that
   ``--register-with`` it and a mixed replica as processes over phase 6's
   checkpoint; the gateway's ids equal the mixed replica's, and SIGTERM
   drains all four to exit 0;
15. the operator's tools, the embeddable worker and the cross-host fault
   and cluster views: (a) Llama-3-8B at full width and 8 of its 32
   layers, random weights (seed 0) drawn on the card, written in bf16 by
   the port's safetensors writer, quantized on the card by
   ``tools/quantize_model`` to int8 and to int4 g128 (layer 0's seven
   linears and the head equal the CPU quantizer's codes and scales bit for
   bit; a scale with one bit flipped fails that check), the int8 copy
   split by ``tools/split_model`` over worker A (layer 0) and B (1-7),
   both started from their bundles by ``embed.spawn_worker``; a master
   (embedding, norm, head from the full directory) over them on phase 5's
   2,000-id prompt, 32 greedy tokens, the bf16 cache: every step's logits
   equal the single-device generator's over the same files bit for bit,
   the ids equal, launches exact over master and workers; then the same
   behind a port ``ChaosProxy`` per worker (kill, truncate, corrupt and a
   stall under the op deadline: 3 recoveries; a stall over a 3 s deadline:
   1), each fault in the proxies' events, the ids the clean run's up to a
   replayed step that is a near-tie there (a recovery replays the context
   in one prefill-shaped pass, which rounds otherwise than decode steps),
   each replayed step's logits near the clean step's; the clean
   run's cluster report has both workers up with forward p50/p99, RTT and
   clock offset, flags B and not A at a straggler factor of 2, and renders
   both rows; checkpoint, quantize, split and load times, TTFT, decode
   tokens/s, segment ms and the card's busy share print. (b) As processes
   over phase 6's checkpoint: ``tools.quantize_model`` (int8, int4 g64)
   and ``tools.split_model``; per tier a ``--mode worker`` and a worker
   served through the C shim (``cake_start_worker_opts``, from a process
   that loads the library with ctypes), and a ``--topology`` master with
   ``--chaos kill@7 --cluster-report --top`` printing phase 6's
   ids alone on stdout (the panel on stderr, the report naming both
   workers); SIGTERM ends every worker with exit 0.
16. the ``(dp, stage, tp)`` rank mesh on this one card, 4 ranks over gloo
   (``parallel/launch.py RankPool``; phase 2 first holds every kernel at
   the tp 2 and tp 4 local shapes against its plain version, the decodes
   also at the verify's T = 5 and 9 and the matmuls at M = 5, planted
   faults failing, and phase 3 times them there): Llama-3-8B at full
   width and 4 layers (``MESH_LAYERS``; 8 before phase 17 came) written
   by the port's writer and read shard by shard
   (``utils/sharded_load.py``); stages 2 x tp 2 in bf16 (the pipelined
   prefill in MESH_CHUNKS chunks) and with int8 weights (the checkpoint
   quantized on the card by ``tools.quantize_model``) plus the int8
   cache (phase 5's prompt, 32 greedy tokens): every
   rank's ids equal, equal to one card's up to the first near-tie
   (MARGIN_TIE), step 0's f32 logits within MESH_LOGITS_REL_L2; the batch
   engine at dp 2 x tp 2, 8 slots, every stream one card's up to a
   near-tie; the batch engine at stages 2 x tp 2, 8 slots, in the
   interleaved and the serialized schedule in turns (each must take the
   one asked for; card ms a decode dispatch and the stage hand-offs' ms,
   the idle time, of each) and speculating (K = 4, rounds chained)
   through the interleaved verify; each rank's launches exact (an
   interleaved call a launch a layer for each microbatch or prompt
   chunk). (s) ``MeshSpeculativeGenerator`` at
   stages 2 x tp 2, K = 4, one round a dispatch, in bf16 (the pipelined
   prefill) and with int8 weights plus the int8 cache: every rank's ids
   equal, equal to one
   card's ``SpeculativeGenerator`` at the same rounds up to a near-tie,
   launches exact with the verifies counted, more than one token a
   dispatch of the mesh's verify over the corpus replay (random weights
   accept almost nothing live); a verify's card ms a rank beside a plain
   step's; and ``--tp 2 --stages 2 --dist-backend gloo --speculate 4
   --prefill-chunks 2`` as a process printing (s)'s ids. (x) The
   paged batch engine at stages 2 x tp 2: the 2,000-id stream exported
   after 8 tokens (its pages gathered to rank 0), finished and imported
   into the freed slot (scattered back) continues with the uninterrupted
   ids bit for bit; the same bytes imported on one card continue with
   one card's greedy ids up to a near-tie, and the snapshot with its two
   tp halves of the kv heads swapped fails that check. Per rank: card ms
   a decode step, collective calls, ms and bytes a step per axis (and the
   snapshot's gather and scatter), TTFT and tokens/s, labelled "one
   card, 4 ranks, gloo" (no multi-card speed).
17. sequence parallelism over phase 16's 4 ranks and checkpoint, at 4
   layers (8 before phase 18 came; phase
   2 first holds the three statistics forms of the flash kernels,
   ``flash_prefill_stats``, ``flash_decode_stats`` and
   ``flash_decode_q8_stats``, against their plain versions at
   Llama-3-8B's sp-local shapes, full heads and tp 2's: a ring visit of a
   1,024-token chunk at offsets 0 and 1024, a later block, a window that
   empties rows, a block past whose end the queries lie; one stream at
   2047 of a 2,048-key shard and 8 streams of T = 5 rows at frontiers
   inside, before (-10, -3000), across (-3) and past (3000) the shard,
   with and without a window; the rows with no live key exactly m =
   -1e30, l = 0, o = 0; planted faults failing; phase 3 times them beside
   the bound and a library call): MeshGenerator at sp 2 x tp 2 and sp 4
   in bf16 and at sp 2 x tp 2 with int8 weights (the checkpoint
   quantized on the card by ``tools.quantize_model``) and the int8 cache,
   on a 2,030-id prompt (ring chunks of 1,024 and 512 tokens) whose 32
   greedy tokens cross the shard boundary at 2,048: every rank's ids equal,
   equal to one card's up to the first near-tie, step 0's f32 logits
   within MESH_LOGITS_REL_L2, each rank's launches exact (its visible
   ring visits a layer a prompt pass, one decode statistics launch a
   layer a step); the batch engine at sp 2 x tp 2, 8 slots (SP_BATCH_LENS,
   one ring pass), every stream one card's up to a near-tie, and with
   ``spec_k`` 4 at rounds 1 and 4 on periodic prompts (the verify's K +
   1 rows replicated over sp: one decode statistics launch a layer a
   verify); ``MeshSpeculativeGenerator`` at sp 2 x tp 2 on a periodic
   2,030-id prompt, its verify's card ms beside a plain step's; ``--sp 2
   --tp 2 --dist-backend gloo`` as a process printing the sp 2 x tp 2
   run's ids. Per rank: TTFT, card ms a decode step, collective calls, ms
   and bytes a step per axis (``sp``: the ring's rotations and the
   decode's statistics merge).
18. expert parallelism over phase 16's 4 ranks: Mixtral-8x7B at full
   width and MOE_LAYERS (2) layers, seed 0, written by the port's writer
   and quantized on the card by ``tools.quantize_model``; at ep 2 x tp 2
   with int8 experts (each rank its run of 4 experts, tp-local; the dense
   path at every N; one ``(ep, tp)`` all-reduce a routed MLP) and at
   stages 2 x ep 2 in bf16, on phase 5's prompt, 16 greedy tokens: every
   rank's ids equal, equal to one card's up to the first logit or router
   near-tie, step 0's logits within MESH_LOGITS_REL_L2, each rank's
   launches exact (every local expert's three products a layer a call);
   ``--ep 2 --tp 2 --quantize int8`` as a process printing the ep 2 x tp
   2 run's ids. Per rank: TTFT, card ms a decode step, the ``ep_tp`` and
   ``ep`` axes' calls, ms and bytes.
19. the tools on the card (``phase_card_tools``): ``tools.ici_probe``
   over 2 gloo ranks on this card (the payload intact after 64 hops, the
   hop host-staged); ``tools.stage_slice`` at 5 of Llama-3-70B's layers
   (hidden 8192, 64/8 heads, intermediate 28672), int8 then bf16, with
   that hop: both rows measured, the card's memory after init within 3%
   of ``utils/memory.py hbm_budget``'s layers and cache, layer 0's
   decode output at mid-window against the CPU plain path on the same
   weights (an end-to-end witness), its launches counted in the kernels
   line; the stage's kernels at its own shapes (``stage_slice
   check_stage_kernels``: the prefill at T = 2048 and the decode at
   mid-window over a random 8,192-slot cache, bf16 and int8, and the int8
   linears at M = 1 and 2048 up to K or N = 28672) against their plain
   versions within phase 2's tolerance, a planted fault refused beside
   each; ``tools.kernel_check`` as a process (exit 0, the nine
   kernels' lines, a bf16 end-to-end check); ``tools.flash_sweep`` and
   ``tools.int4_sweep`` on short grids, each row's kernel within phase
   2's tolerance of its plain version.
20. the serving plane under the load generator (``tools/loadgen.py``),
   run before phase 19 (whose stage runs profile the card): Llama-3-8B at
   SERVE_LAYERS behind phase 8's in-process server, 8 slots, bf16. (a)
   ``run_load`` closed loop, 16 requests from 4 clients, 32 tokens, prompt
   lengths 8, 128, 512 and 2,000 cycled: every request completes, each
   stream equals its prompt's single-stream greedy run up to its first
   near-tie (MARGIN_TIE) and each served id is within CHOSEN_STEPS bf16
   steps of the best of its own history's teacher-forced logits, the
   launches equal the engine's model calls';
   (b) the churn workload over the paged engine, 24 requests at 8 req/s,
   every 4th client walking away after 2 tokens: no error, 6 disconnects,
   and once it drains every page is free, the prefix tree's, or an idle
   slot's, as before the run; (c) the mixed-class workload over the paged
   engine with phase 11's spill (no request is preempted there: phase 11
   drives the spill), 16 requests at 8 req/s with TTFT and
   TPOT targets: no error, both classes reported, goodput and
   ``serve.preemptions`` printed; (d) ``python -m
   cake_tpu_torch.tools.loadgen --spawn-backends 2`` as two processes on
   this card (a tiered prefill/decode fleet; the elastic fleet grown to 3
   and drained back), each exiting 0 with no error; (e) ``python -m
   cake_tpu_torch.tools.benchdiff`` over the repo's bench ledger and
   (a)'s rows twice under this card's name exits 0, and 1 with REGRESSED
   after a planted tokens/s row at 10%. TTFT, TPOT and tokens/s are the
   host's clock.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA card,
or without the ``cake_tpu_torch`` package beside this file, it exits with
an error and prints no result. It imports no JAX.
"""

from __future__ import annotations

import ctypes
import gc
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
SEED = 0
# bf16 outputs, and the kernel sums in another order than the plain version
ATOL = RTOL = 2e-2
# That tolerance is as large as a decode output with N(0,1) inputs
# (~sqrt(e/n) at n live keys, ~0.036 at n = 2048), so a kernel that drops
# a whole 64-key tile passes it. Each case is also held to the relative L2
# error of its worst query row (one head's D values). On an H100 the right
# kernels read at most 4.7e-3 there over every case below (bf16 rounding
# of the output, max abs error at most 1.6e-2 over the int8 cache); the
# planted faults, one dropped tile, read 0.23-0.38 in decode and 0.81-0.93
# in prefill: a dropped tile of k keys moves its rows by ~sqrt(k/n) at n
# live keys.
# flash_decode_q8 is held to its plain version, which rounds the
# dequantized K and V to bf16 (as the JAX package's decode does) where the
# kernel folds the unrounded scales into the scores and into P: at one live
# key the output is that V row, off by up to |v| 2^-8 (~0.016 at |v| ~ 4),
# inside ATOL; its worst rows read ~6e-3, inside ROW_REL_L2.
# The quantized matmuls are held to the same two checks, a row being one
# output row (N values): the right kernels differ from the plain versions
# by the bf16 rounding of the output (~2^-9 an element); one dropped 64-row
# K tile of K = 4096 moves a row by ~sqrt(64 / 4096) = 0.125.
ROW_REL_L2 = 1e-2
# a bf16 chain through two full-width layers and the head, on two devices
MODEL_REL_L2 = 2e-2
# the card's timing, bounds, costs and verdict: those of
# cake_tpu_torch/tools/kernel_check.py (its bounds read utils/chips.py's
# H100 row), taken in main() once the package is found
time_ms = bound = verdict = decode_cost = prefill_cost = matmul_cost = None
H, KVH, D, S = 32, 8, 128, 4096
MAIN = (H, KVH, D)
# Gemma-7B's attention (gemma_7b): 16 query heads and 16 kv heads of 256,
# the head width the JAX kernels take and the port's built last
GEMMA = (16, 16, 256)
# prefill (T, pos, window) at full width: the timed shape, the main path's
# 2,000-token prompt (not a whole number of 128-row q tiles), a later chunk
# and a window whose lower edge falls inside KV tiles
PREFILL_CASES = ((2048, 0, None), (2000, 0, None), (256, 1000, None),
                 (512, 1000, 300))
# Phases 7, 8, 10, 11, 12 and 14 (the serving paths and the guides) run
# Llama-3-8B at full width and 8 of its 32 layers: with phase 13's
# families at full depth the whole script took 996.3 s of its 1,200 s
# limit on an H100 with them at 32, 1,157.7 s with them at 16 and phase 16
# (the mesh) added, and 1,046-1,170 s at 12 (PERF.md). At 4 the random
# model's single stream in phase 12 finds no n-gram proposal in 64 tokens,
# so its verify never runs.
SERVE_LAYERS = 8
# Phases 5 and 9 (the main paths and the cross-host path) run Llama-3-8B
# at full width and 8 of its 32 layers since phase 17 came: at 32 the
# whole script took 1,257 s of its 1,200 s limit on an H100 host (PERF.md
# header); the kernels' shapes do not depend on the depth
MAIN_LAYERS = 8
# the linears' (K, N) of Llama-3-8B: gate/up, down, k/v, q/o; and the head
LINEARS = ((4096, 14336), (14336, 4096), (4096, 1024), (4096, 4096))
HEAD = (4096, 128256)
# (wrapper, group size) of each weight tier: int8, int4, int4 g128
TIERS = (("quant_matmul", None), ("quant4_matmul", None),
         ("quant4_matmul", 128))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------------------
# phase 1
# --------------------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def phase_toolchain(torch, build) -> str:
    card = card_line()
    say(card)
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60)
    release = [ln for ln in nvcc.stdout.splitlines() if "release" in ln]
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"nvcc: {release[0].strip() if release else nvcc.stdout.strip()}")
    t0 = time.perf_counter()
    built = build.build_all()
    say(f"[1] built {built or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in build.SOURCES:
        for ln in build.build_log(name).splitlines():
            if "registers" in ln or "spill" in ln:
                say(f"    {name}: {ln.strip()}")
    return card


# --------------------------------------------------------------------------
# phase 2
# --------------------------------------------------------------------------


def compare(torch, label, out, ref):
    err, rel, ok = verdict(out, ref)
    say(f"[2] {label}: max_abs_err {err:.3e}, worst row rel L2 "
        f"{rel:.3e}")
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=RTOL)
    if not ok:
        fail(f"{label}: worst row relative L2 {rel} >= {ROW_REL_L2}")
    return err


def planted(torch, label, bad, ref):
    """A planted fault: the check must refuse ``bad``."""
    err, rel, ok = verdict(bad, ref)
    say(f"[2] planted fault, {label}: max_abs_err {err:.3e}, worst row rel "
        f"L2 {rel:.3e}")
    if ok:
        fail(f"the kernel check passes {label}")


def window_edge_inside_tile(flash, t, pos, window, d=D) -> bool:
    """Whether some q row's lowest visible key (pos + row - window + 1)
    falls strictly inside a KV tile (of head width ``d``), so that the
    prefill kernels take the window's edge-mask path and not only whole
    tiles."""
    return any((pos + r - window + 1) % flash.prefill_block_k(d)
               for r in range(t) if pos + r - window + 1 > 0)


def tile_short(flash, fn):
    """``fn()`` with every prefill q tile's last live KV tile dropped, as a
    kernel loop ending at max_kb - 1 would: a planted fault."""
    real = flash.kv_block_bounds

    def short(*args):
        lo, hi = real(*args)
        return lo, hi - 1

    flash.kv_block_bounds = short
    try:
        return fn()
    finally:
        flash.kv_block_bounds = real


# (label, B, KVH, G, D, S, pos, window) of the decode checks: the main
# path's shape at frontiers 0 to the buffer's end, windows whose lower edge
# falls inside a 64-key tile (key 1048) and on a tile boundary (key 1024),
# per-row frontiers with and without a window, GQA groups 6 and 7 (Qwen2),
# and the other head width over a buffer that is not a whole number of
# tiles (a --max-seq of 100)
DECODE_CASES = tuple(
    (f"B=1 pos={p}", 1, KVH, H // KVH, D, S, [p], None)
    for p in (0, 1, 127, 2047, 4095)) + (
    ("B=1 pos=2047 window=1000", 1, KVH, H // KVH, D, S, [2047], 1000),
    ("B=1 pos=2047 window=1024", 1, KVH, H // KVH, D, S, [2047], 1024),
    ("B=4 pos=[3, 700, 2048, 4095]", 4, KVH, H // KVH, D, S,
     [3, 700, 2048, 4095], None),
    ("B=4 pos=[3, 700, 2048, 4095] window=1000", 4, KVH, H // KVH, D, S,
     [3, 700, 2048, 4095], 1000),
    ("G=6 B=2 pos=[1000, 4095]", 2, 4, 6, D, S, [1000, 4095], None),
    ("G=7 B=2 pos=[1000, 4095] window=1000", 2, 4, 7, D, S, [1000, 4095],
     1000),
    ("D=64 G=2 S=100 pos=[0, 99]", 2, 2, 2, 64, 100, [0, 99], None),
)


# the same at Gemma's attention (GEMMA: head_dim 256, group 1): frontiers 0
# to the buffer's end, the two window edges, per-row frontiers with and
# without a window
D256_DECODE_CASES = tuple(
    (f"D=256 B=1 pos={p}", 1, GEMMA[1], 1, GEMMA[2], S, [p], None)
    for p in (0, 1, 127, 2047, 4095)) + tuple(
    (f"D=256 B={b} pos={pos}{f' window={w}' if w else ''}", b, GEMMA[1], 1,
     GEMMA[2], S, pos, w)
    for b, pos, w in ((1, [2047], 1000), (1, [2047], 1024),
                      (4, [3, 700, 2048, 4095], None),
                      (4, [3, 700, 2048, 4095], 1000)))


def decode_checks(torch, flash, name, rnd, make_kv, cases=DECODE_CASES,
                  shape=MAIN) -> dict:
    """Decode kernel ``name`` (``flash_decode`` or ``flash_decode_q8``)
    against its plain version on every case of ``cases``, twice on the
    same inputs for the same bits, and with two planted faults at
    ``shape`` (H, KVH, D): a frontier one tile lower (the row's last tile
    dropped, as a loop ending at max_kb - 1 would) and a window one tile
    late (keys 0..63 dropped, as a loop starting at min_kb + 1 would).
    ``make_kv(b, kvh, s, d)`` gives the cache operands."""
    kernel, plain = getattr(flash, name), getattr(flash, f"{name}_ref")
    h0, kvh0, d0 = shape
    tag = () if shape == MAIN else (d0,)
    on_boundary = {(c[6][0] - c[7] + 1) % flash.DECODE_BLOCK_K == 0
                   for c in cases if c[1] == 1 and c[7]}
    if on_boundary != {False, True}:
        fail("the decode cases need a window edge inside a tile and one on "
             "a tile boundary")
    errs, seen = {}, {}
    for label, b, kvh, g, d, s, pos, window in cases:
        key = (b, kvh, d, s)
        if key not in seen:
            seen[key] = make_kv(b, kvh, s, d)
        kv = seen[key]
        q = rnd(b, kvh * g, 1, d)
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        out = kernel(q, *kv, p, window=window)
        err = compare(torch, f"{name} {label}", out,
                      plain(q, *kv, p, window=window))
        if b == 1 and window is None and (kvh * g, kvh, d) == shape:
            errs[(name, *tag, 1, pos[0], None)] = err
        if not torch.equal(out, kernel(q, *kv, p, window=window)):
            fail(f"{name} {label}: a second call on the same inputs gives "
                 "other bits")
    say(f"[2] {name}: two calls give the same bits in every case")
    kv, q1 = seen[(1, kvh0, d0, S)], rnd(1, h0, 1, d0)
    for label, pos, bad_pos, window in (
            ("last tile dropped", 2047, 2047 - 64, None),
            ("first tile dropped", 4095, 4095, 4096 - 64)):
        p, bp = (torch.tensor([x], dtype=torch.int32, device="cuda")
                 for x in (pos, bad_pos))
        planted(torch, f"{name}{''.join(f' D={x}' for x in tag)} "
                f"pos={pos} {label}",
                kernel(q1, *kv, bp, window=window), plain(q1, *kv, p))
    return errs


# the multi-query decode (the speculative verify, T = K + 1 query positions
# a stream): T = 2, 5, 9 (K = 8's verify) and 17 (the rows of a kv head at
# Llama-3-8B's group 4 cross into a fifth 16-row tile); one stream at the
# buffer's last slots and at 2047 with a window whose lower edge falls
# inside a 64-key tile, and 8 streams at ragged frontiers, one at S - T
MQ_T = (2, 5, 9, 17)
MQ_WINDOW = 1000


def mq_rows(t: int) -> tuple:
    return (S - t, 2047, 1100, 517, 260, 64, 33, 5)


def multi_query_checks(torch, flash, name, rnd, make_kv,
                       shape=MAIN) -> dict:
    """Decode kernel ``name`` at T > 1 against its plain version on every
    case above at ``shape`` (H, KVH, D) (worst row relative L2 within
    ROW_REL_L2), twice on the same inputs for the same bits, and with two
    planted faults at T = 9: a stream's last live tile dropped (its
    frontier a tile lower) and the first live tile dropped (a window
    starting a tile late)."""
    kernel, plain = getattr(flash, name), getattr(flash, f"{name}_ref")
    h, kvh, d = shape
    tag = () if shape == MAIN else (d,)
    errs = {}
    kv1, kv8 = make_kv(1, kvh, S, d), make_kv(8, kvh, S, d)
    if not (2047 - MQ_WINDOW + 1) % flash.DECODE_BLOCK_K:
        fail("the multi-query window edge must fall inside a tile")
    for t in MQ_T:
        for b, pos, window in ((1, [S - t], None), (1, [2047], MQ_WINDOW),
                               (8, list(mq_rows(t)), None),
                               (8, list(mq_rows(t)), MQ_WINDOW)):
            kv = kv1 if b == 1 else kv8
            q = rnd(b, h, t, d)
            p = torch.tensor(pos, dtype=torch.int32, device="cuda")
            label = (f"{name} D={d} T={t} B={b} "
                     f"pos={pos if b == 1 else 'ragged'} window={window}")
            out = kernel(q, *kv, p, window=window)
            err = compare(torch, label, out, plain(q, *kv, p, window=window))
            if window is None:
                errs[(name, "mq", *tag, b, t)] = err
            if not torch.equal(out, kernel(q, *kv, p, window=window)):
                fail(f"{label}: a second call on the same inputs gives "
                     "other bits")
    say(f"[2] {name} D={d} at T = {list(MQ_T)}: two calls give the same "
        "bits in every case")
    t = 9
    q = rnd(8, h, t, d)
    p = torch.tensor(mq_rows(t), dtype=torch.int32, device="cuda")
    bad = p.clone()
    bad[1] -= flash.DECODE_BLOCK_K
    planted(torch, f"{name} D={d} T={t} B=8, row 1's last tile dropped",
            kernel(q, *kv8, bad), plain(q, *kv8, p))
    q1 = rnd(1, h, t, d)
    p1 = torch.tensor([S - t], dtype=torch.int32, device="cuda")
    planted(torch, f"{name} D={d} T={t} B=1 pos={S - t}, first tile "
            "dropped",
            kernel(q1, *kv1, p1, window=S - t - flash.DECODE_BLOCK_K + 1),
            plain(q1, *kv1, p1))
    return errs


def phase_kernels(torch, flash) -> dict:
    for t, pos, window in PREFILL_CASES:
        if window is not None and not window_edge_inside_tile(
                flash, t, pos, window):
            fail(f"prefill case T={t} pos={pos} window={window} never "
                 "masks inside a tile")
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    def compare_(label, out, ref):
        return compare(torch, label, out, ref)

    errs = {}
    k1, v1 = rnd(1, KVH, S, D), rnd(1, KVH, S, D)
    for t, pos, window in PREFILL_CASES:
        q = rnd(1, H, t, D)
        errs[("prefill", t, pos, window)] = compare_(
            f"flash_prefill T={t} pos={pos} window={window}",
            flash.flash_attention(q, k1, v1, pos, window=window),
            flash.flash_attention_ref(q, k1, v1, pos, window=window))
    q = rnd(1, H, 256, D)
    planted(torch, "flash_prefill T=256 pos=1000 last tile dropped",
            tile_short(flash, lambda: flash.flash_attention(q, k1, v1, 1000)),
            flash.flash_attention_ref(q, k1, v1, 1000))
    # the other built head width and group size, over a buffer that is not
    # a whole number of tiles (a --max-seq of 100)
    ks, vs = rnd(2, 2, 100, 64), rnd(2, 2, 100, 64)
    qs = rnd(2, 4, 40, 64)
    compare_("flash_prefill D=64 G=2 S=100 T=40 pos=30",
            flash.flash_attention(qs, ks, vs, 30),
            flash.flash_attention_ref(qs, ks, vs, 30))
    errs.update(decode_checks(
        torch, flash, "flash_decode", rnd, lambda b, kvh, s, d: (
            rnd(b, kvh, s, d), rnd(b, kvh, s, d))))
    errs.update(multi_query_checks(
        torch, flash, "flash_decode", rnd, lambda b, kvh, s, d: (
            rnd(b, kvh, s, d), rnd(b, kvh, s, d))))
    torch.cuda.empty_cache()
    return errs


def quantized(quant, w, tier):
    """``w [K, N]`` f32 on the card as ``(wrapper name, weight, scale)`` of
    a weight tier."""
    name, group = tier
    if name == "quant_matmul":
        ql = quant.quantize_linear(w)
        return name, ql.q, ql.scale
    ql = quant.quantize_linear4(w, group_size=group)
    return name, ql.qp, ql.scale


def tier_label(tier) -> str:
    name, group = tier
    return {"quant_matmul": "int8"}.get(name, "int4") + (
        f" g{group}" if group else "")


def phase_quant_kernels(torch, flash, qmatmul, quant, kvcache) -> dict:
    """The four kernels of the quantized path against their plain
    versions, with planted faults; the matmuls and flash_decode_q8 also run
    twice on the same inputs and must give the same bits (no sum depends
    on timing)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    plain = {"quant_matmul": quant.quant_matmul_ref,
             "quant4_matmul": quant.quant4_matmul_ref}
    errs = {}
    # the linears at decode and prefill, the head at decode, and ragged
    # shapes in both regimes (M off the 16-row decode and 128/256-row
    # prefill tiles, N off the 128-column tile, K off the 128-row int4
    # decode slot), the ragged prefill also with 64-row int4 groups
    shapes = [(kn, (1, 2048), TIERS) for kn in LINEARS] + [
        (HEAD, (1,), TIERS), ((256, 1040), (5,), TIERS),
        ((256, 1040), (300,), TIERS + (("quant4_matmul", 64),)),
        ((192, 272), (5, 130), TIERS[:2] + (("quant4_matmul", 64),))]
    for (k, n), ms, tiers in shapes:
        w = torch.randn(k, n, generator=gen, device="cuda") / k ** 0.5
        for tier in tiers:
            name, wq, scale = quantized(quant, w, tier)
            for m in ms:
                x = torch.randn(m, k, generator=gen, device="cuda").to(
                    torch.bfloat16)
                label = f"{name} {tier_label(tier)} M={m} K={k} N={n}"
                out = getattr(qmatmul, name)(x, wq, scale)
                errs[(name, tier[1], m, k, n)] = compare(
                    torch, label, out, plain[name](x, wq, scale))
                if (k, n) in LINEARS and not torch.equal(
                        out, getattr(qmatmul, name)(x, wq, scale)):
                    fail(f"{label}: a second call on the same inputs gives "
                         "other bits")
                if (k, n) == LINEARS[0]:
                    # the kernel run one 64-row K tile short
                    k2 = k - qmatmul.BLOCK_K
                    int4 = name == "quant4_matmul"
                    planted(torch, f"{label} one K tile short",
                            qmatmul._launch(
                                name, x[:, :k2].contiguous(),
                                wq[:k2 // 2 if int4 else k2], scale, n,
                                (tier[1] or 0,) if int4 else ()),
                            plain[name](x, wq, scale))
            del wq, scale
        del w
    say("[2] the matmuls at every linear, M = 1 and 2048: two calls give the "
        "same bits")
    torch.cuda.empty_cache()

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    def cache(b, kvh, s, d):
        kq, vq = (kvcache.quant_kv(rnd(b, kvh, s, d)) for _ in range(2))
        return kq.q, kq.scale, vq.q, vq.scale

    kv8 = cache(1, KVH, S, D)
    for t, pos, window in PREFILL_CASES:
        q = rnd(1, H, t, D)
        errs[("prefill_q8", t, pos, window)] = compare(
            torch, f"flash_prefill_q8 T={t} pos={pos} window={window}",
            flash.flash_attention_q8(q, *kv8, pos, window=window),
            flash.flash_attention_q8_ref(q, *kv8, pos, window=window))
    q = rnd(1, H, 256, D)
    planted(torch, "flash_prefill_q8 T=256 pos=1000 last tile dropped",
            tile_short(flash, lambda: flash.flash_attention_q8(q, *kv8,
                                                               1000)),
            flash.flash_attention_q8_ref(q, *kv8, 1000))
    errs.update(decode_checks(torch, flash, "flash_decode_q8", rnd, cache))
    errs.update(multi_query_checks(torch, flash, "flash_decode_q8", rnd,
                                   cache))
    torch.cuda.empty_cache()
    small = cache(2, 2, 100, 64)
    qs = rnd(2, 4, 40, 64)
    compare(torch, "flash_prefill_q8 D=64 G=2 S=100 T=40 pos=30",
            flash.flash_attention_q8(qs, *small, 30),
            flash.flash_attention_q8_ref(qs, *small, 30))
    return errs


# the families' linears (K, N) beyond Llama-3-8B's, whose shapes Mixtral's
# experts and attention share (LINEARS): Qwen2-7B's gate/up, down, k/v,
# q/o, and Gemma-7B's gate/up, down, q/k/v, o; and the three heads
FAMILY_LINEARS = {
    "qwen2_7b": ((3584, 18944), (18944, 3584), (3584, 512), (3584, 3584)),
    "gemma_7b": ((3072, 24576), (24576, 3072), (3072, 4096), (4096, 3072)),
}
FAMILY_HEADS = {"qwen2_7b": (3584, 152064), "gemma_7b": (3072, 256000),
                "mixtral_8x7b": (4096, 32000)}


def phase_head256_kernels(torch, flash, kvcache) -> dict:
    """Phase 2 at Gemma's attention (GEMMA, S = 4096): both prefills at
    PREFILL_CASES (64-key tiles: the window's edge inside them), both
    decodes at D256_DECODE_CASES and in their multi-query form, each with
    its planted faults (one tile short at either end) and twice on the
    same inputs."""
    h, kvh, d = GEMMA
    for t, pos, window in PREFILL_CASES:
        if window is not None and not window_edge_inside_tile(
                flash, t, pos, window, d):
            fail(f"D=256 prefill case T={t} pos={pos} window={window} "
                 "never masks inside a tile")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    def bf16(b, kvh_, s, d_):
        return rnd(b, kvh_, s, d_), rnd(b, kvh_, s, d_)

    def int8(b, kvh_, s, d_):
        kq, vq = (kvcache.quant_kv(rnd(b, kvh_, s, d_)) for _ in range(2))
        return kq.q, kq.scale, vq.q, vq.scale

    errs = {}
    for name, make_kv in (("flash_attention", bf16),
                          ("flash_attention_q8", int8)):
        kernel = getattr(flash, name)
        plain = getattr(flash, f"{name}_ref")
        kv = make_kv(1, kvh, S, d)
        key = "prefill" if name == "flash_attention" else "prefill_q8"
        for t, pos, window in PREFILL_CASES:
            q = rnd(1, h, t, d)
            out = kernel(q, *kv, pos, window=window)
            errs[(key, d, t, pos, window)] = compare(
                torch, f"{name} D=256 T={t} pos={pos} window={window}",
                out, plain(q, *kv, pos, window=window))
            if not torch.equal(out, kernel(q, *kv, pos, window=window)):
                fail(f"{name} D=256 T={t}: a second call on the same inputs "
                     "gives other bits")
        q = rnd(1, h, 256, d)
        planted(torch, f"{name} D=256 T=256 pos=1000 last tile dropped",
                tile_short(flash, lambda: kernel(q, *kv, 1000)),
                plain(q, *kv, 1000))
        del kv
    for name, make_kv in (("flash_decode", bf16), ("flash_decode_q8", int8)):
        errs.update(decode_checks(torch, flash, name, rnd, make_kv,
                                  D256_DECODE_CASES, GEMMA))
        errs.update(multi_query_checks(torch, flash, name, rnd, make_kv,
                                       GEMMA))
        torch.cuda.empty_cache()
    return errs


def phase_family_matmuls(torch, qmatmul, quant) -> dict:
    """Phase 2's matmul checks at the families' shapes: every linear of
    FAMILY_LINEARS at M = 1, 8 and 2048, each head at M = 1 and 8, int8
    and int4 g128 (Qwen2 and Gemma run both tiers), twice on the same
    inputs; a planted fault (one K tile short) on each family's gate at
    M = 1 and 2048."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    plain = {"quant_matmul": quant.quant_matmul_ref,
             "quant4_matmul": quant.quant4_matmul_ref}
    errs = {}
    shapes = [(kn, (1, 8, 2048)) for lins in FAMILY_LINEARS.values()
              for kn in lins] + [(kn, (1, 8)) for kn in FAMILY_HEADS.values()]
    for (k, n), ms in shapes:
        w = torch.randn(k, n, generator=gen, device="cuda") / k ** 0.5
        for tier in (TIERS[0], TIERS[2]):
            name, wq, scale = quantized(quant, w, tier)
            fn = getattr(qmatmul, name)
            for m in ms:
                x = torch.randn(m, k, generator=gen, device="cuda").to(
                    torch.bfloat16)
                label = f"{name} {tier_label(tier)} M={m} K={k} N={n}"
                out = fn(x, wq, scale)
                errs[(name, tier[1], m, k, n)] = compare(
                    torch, label, out, plain[name](x, wq, scale))
                if not torch.equal(out, fn(x, wq, scale)):
                    fail(f"{label}: a second call on the same inputs gives "
                         "other bits")
                if (k, n) in [lins[0] for lins in FAMILY_LINEARS.values()] \
                        and m != 8:
                    k2 = k - qmatmul.BLOCK_K
                    int4 = name == "quant4_matmul"
                    planted(torch, f"{label} one K tile short",
                            qmatmul._launch(
                                name, x[:, :k2].contiguous(),
                                wq[:k2 // 2 if int4 else k2], scale, n,
                                (tier[1] or 0,) if int4 else ()),
                            plain[name](x, wq, scale))
            del wq, scale
        del w
        torch.cuda.empty_cache()
    say("[2] the matmuls at the families' linears and heads: two calls give "
        "the same bits")
    return errs


# int4 groups the card folds inside its 64-row K tile (a multiple of the
# k16 step but not of 64): (group, its linears (K, N)) -- Llama-3-8B's
# gate/up and down for g16 and g32, Gemma-7B's for g96 (96 does not divide
# 4096) -- and a ragged shape off the 128-row int4 decode slot
FINE_GROUPS = tuple(
    (g, lins + ((192, 272),)) for g, lins in (
        (16, LINEARS[:2]), (32, LINEARS[:2]),
        (96, FAMILY_LINEARS["gemma_7b"][:2])))


def phase_fine_groups(torch, qmatmul, quant) -> dict:
    """quant4_matmul at the FINE_GROUPS (M = 1, 8 and 2048; the ragged shape
    at 5 and 130) against its plain version, twice on the same inputs (the
    same bits); a planted fault, each group scaled by the next group's
    scales, must fail the same check."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    errs = {}
    for group, shapes in FINE_GROUPS:
        for k, n in shapes:
            w = torch.randn(k, n, generator=gen, device="cuda") / k ** 0.5
            _, wq, scale = quantized(quant, w, ("quant4_matmul", group))
            del w
            # the scale row of the next group (the last keeps its own)
            shifted = torch.cat([scale[1:], scale[-1:]]).contiguous()
            for m in (5, 130) if k == 192 else (1, 8, 2048):
                x = torch.randn(m, k, generator=gen, device="cuda").to(
                    torch.bfloat16)
                label = f"quant4_matmul int4 g{group} M={m} K={k} N={n}"
                out = qmatmul.quant4_matmul(x, wq, scale)
                ref = quant.quant4_matmul_ref(x, wq, scale)
                errs[("quant4_matmul", group, m, k, n)] = compare(
                    torch, label, out, ref)
                if not torch.equal(out, qmatmul.quant4_matmul(x, wq, scale)):
                    fail(f"{label}: a second call on the same inputs gives "
                         "other bits")
                planted(torch, f"{label} each group scaled by the next's",
                        qmatmul.quant4_matmul(x, wq, shifted), ref)
            del wq, scale, shifted
            torch.cuda.empty_cache()
    say("[2] quant4_matmul at groups of 16, 32 and 96: two calls give the "
        "same bits")
    return errs


# --------------------------------------------------------------------------
# phase 3
# --------------------------------------------------------------------------


# (B, frontier of each row) of the timed decode calls: the headline (one
# stream at 2,048 keys), the buffer's end, and four streams at per-row
# frontiers
DECODE_TIMED = ((1, (2047,)), (1, (4095,)), (4, (3, 700, 2048, 4095)))


def decode_inputs(torch, kvcache, name, b, rnd, shape=MAIN):
    """``(kernel's cache operands, the bf16 K and V a library call reads)``
    of decode kernel ``name`` at ``shape`` (H, KVH, D), batch ``b``."""
    _, kvh, d = shape
    k, v = rnd(b, kvh, S, d), rnd(b, kvh, S, d)
    if name == "flash_decode":
        return (k, v), (k, v)
    kq, vq = kvcache.quant_kv(k), kvcache.quant_kv(v)
    # the library reads keys dequantized before the timed call
    return (kq.q, kq.scale, vq.q, vq.scale), tuple(
        kvcache.dequant_kv(c, torch.bfloat16) for c in (kq, vq))


def decode_case(torch, flash, kvcache, name, b, pos, rnd, t=1,
                shape=MAIN) -> dict:
    """Card times of one decode call of ``t`` query positions a row: the
    kernel, its plain version and SDPA over the live keys (a boolean mask
    for per-row frontiers and for T > 1: query t sees keys up to pos + t),
    beside the bound: q, the output, and each row's live keys (up to its
    last query) read once (bf16 K and V, or int8 codes and their f32
    scales); 2 products of D multiply-adds a key, head and query row."""
    import torch.nn.functional as F

    h, kvh, d = shape
    kv, lib_kv = decode_inputs(torch, kvcache, name, b, rnd, shape)
    q = rnd(b, h, t, d)
    p = torch.tensor(pos, dtype=torch.int32, device="cuda")
    live = [x + t for x in pos]
    b_ms, b_by = bound(*decode_cost(b, h, kvh, d, t, pos,
                                    q8=name != "flash_decode"))
    n = max(live)
    lk, lv = (c[:, :, :n] for c in lib_kv)
    mask = None
    if b > 1 or t > 1:
        mask = (torch.arange(n, device="cuda")[None, None, :]
                <= p.long()[:, None, None]
                + torch.arange(t, device="cuda")[None, :, None])[:, None]
    kernel, plain = getattr(flash, name), getattr(flash, f"{name}_ref")
    case = {"shape": f"q [{b},{h},{t},{d}] "
                     f"{'bf16' if name == 'flash_decode' else 'int8'} k/v "
                     f"[{b},{kvh},{S},{d}] pos {list(pos)}",
            "ms": time_ms(lambda: kernel(q, *kv, p)),
            "plain_ms": time_ms(lambda: plain(q, *kv, p)),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q, lk, lv, attn_mask=mask, enable_gqa=True)),
            "bound_ms": b_ms, "bound_by": b_by}
    case["pct_of_bound"] = 100 * b_ms / case["ms"]
    return case


def decode_row(torch, flash, kvcache, build, name, replaces, errs,
               rnd) -> dict:
    """The kernel-table row of decode kernel ``name``: the headline shape
    (one stream at pos 2047) and the other timed cases."""
    cases = [decode_case(torch, flash, kvcache, name, b, pos, rnd)
             for b, pos in DECODE_TIMED]
    row = {"name": name, "route": "cuda",
           "source": f"cake_tpu_torch/csrc/{name}.cu", "replaces": replaces,
           "max_abs_err": errs[(name, 1, DECODE_TIMED[0][1][0], None)],
           **cases[0], "cases": cases[1:]}
    row.update(kernel_build_info(build, name))
    for c in cases:
        say(f"    {name} {c['shape']}: {c['ms']:.4f} ms, "
            f"{100 * c['bound_ms'] / c['ms']:.1f}% of bound "
            f"{c['bound_ms']:.4f} by {c['bound_by']} (plain "
            f"{c['plain_ms']:.4f}, library {c['library_ms']:.4f})")
    return row


def phase_timing(torch, flash, kvcache, build, errs) -> list:
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    k, v = rnd(1, KVH, S, D), rnd(1, KVH, S, D)
    rows = []

    t = 2048
    q = rnd(1, H, t, D)
    live = t  # keys 0..T-1 at pos 0
    nbytes, flops = prefill_cost(H, KVH, D, t, live, t * (t + 1) // 2)
    b_ms, b_by = bound(nbytes, flops)
    rows.append({
        "name": "flash_prefill", "route": "cuda",
        "source": "cake_tpu_torch/csrc/flash_prefill.cu",
        "replaces": "cake_tpu/ops/pallas/flash.py:74",
        "shape": f"q [1,{H},{t},{D}] k/v [1,{KVH},{S},{D}] bf16 pos 0",
        "flops": flops,
        "max_abs_err": errs[("prefill", t, 0, None)],
        "ms": time_ms(lambda: flash.flash_attention(q, k, v, 0)),
        "plain_ms": time_ms(
                            lambda: flash.flash_attention_ref(q, k, v, 0)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q, k[:, :, :live], v[:, :, :live], is_causal=True,
            enable_gqa=True)),
        "bound_ms": b_ms, "bound_by": b_by,
    })

    rows.append(decode_row(torch, flash, kvcache, build, "flash_decode",
                           "cake_tpu/ops/pallas/flash.py:417", errs, rnd))
    for r in rows:
        r["kernel_ms"] = r["ms"]
        say(f"[3] {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
            f"library {r['library_ms']:.4f}, bound {r['bound_ms']:.4f} by "
            f"{r['bound_by']})")
    return rows


def matmul_case(torch, quant, qmatmul, build, tier, m, k, n, gen) -> dict:
    """Card times of one quantized linear: the kernel, its plain version,
    and ``torch.matmul`` over the weight dequantized to bf16 beforehand
    (the same function up to the weight's rounding, at 2x or 4x the
    weight bytes), beside the bound; the kernel's rate, plan and build
    figures."""
    w = torch.randn(k, n, generator=gen, device="cuda") / k ** 0.5
    name, wq, scale = quantized(quant, w, tier)
    del w
    if name == "quant_matmul":
        w_bf16 = quant.dequantize_linear(quant.QuantizedLinear(wq, scale))
        plain = quant.quant_matmul_ref
    else:
        w_bf16 = quant.dequantize_linear4(quant.Quantized4Linear(wq, scale))
        plain = quant.quant4_matmul_ref
    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    kernel = getattr(qmatmul, name)
    # each input read once, the output written once
    b_ms, b_by = bound(*matmul_cost(m, k, n, wq.numel(), scale.numel()))
    case = {"tier": tier_label(tier), "shape": f"x [{m},{k}] w [{k},{n}]",
            "ms": time_ms(lambda: kernel(x, wq, scale)),
            "plain_ms": time_ms(lambda: plain(x, wq, scale), n=5),
            "library_ms": time_ms(lambda: x @ w_bf16),
            "bound_ms": b_ms, "bound_by": b_by}
    case["pct_of_bound"] = 100 * b_ms / case["ms"]
    case["tflops"] = 2 * m * k * n / case["ms"] / 1e9
    p = qmatmul.plan(m, n, k, torch.cuda.get_device_properties(
        0).multi_processor_count, 8 if name == "quant_matmul" else 4,
        tier[1])
    case["plan"] = (f"{p.regime} block_m {p.block_m} splits {p.splits} "
                    f"grid {p.grid}")
    case.update(matmul_build_info(build, name, p, tier[1], m))
    del wq, scale, w_bf16
    torch.cuda.empty_cache()
    return case


def phase_quant_timing(torch, flash, qmatmul, quant, kvcache, build,
                       errs) -> list:
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rows = []
    # headline shape first: w_gate at decode, then prefill; each linear at
    # M = 1 and 2048, the head at M = 1
    shapes = [(m,) + kn for kn in LINEARS for m in (1, 2048)] + [
        (1,) + HEAD]
    for name, tiers, replaces in (
            ("quant_matmul", TIERS[:1], "cake_tpu/ops/pallas/quant.py:33"),
            ("quant4_matmul", (TIERS[2], TIERS[1]),
             "cake_tpu/ops/pallas/quant.py:96")):
        cases = [matmul_case(torch, quant, qmatmul, build, tier, *shape,
                             gen)
                 for tier in tiers for shape in shapes]
        head = cases[0]
        m, k, n = shapes[0]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"cake_tpu_torch/csrc/{name}.cu", "replaces": replaces,
            "shape": f"{head['tier']} {head['shape']}",
            "max_abs_err": errs[(name, tiers[0][1], m, k, n)],
            **{key: head[key] for key in ("ms", "plain_ms", "library_ms",
                                          "bound_ms", "bound_by", "tflops",
                                          "registers")},
            "cases": cases,
        })

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    kq, vq = (kvcache.quant_kv(rnd(1, KVH, S, D)) for _ in range(2))
    t = 2048
    q = rnd(1, H, t, D)
    live = t  # keys 0..T-1 at pos 0
    k_live, v_live = (kvcache.dequant_kv(kvcache.QuantizedKV(
        c.q[:, :, :live], c.scale[:, :, :live]), torch.bfloat16)
        for c in (kq, vq))
    nbytes, flops = prefill_cost(H, KVH, D, t, live, t * (t + 1) // 2,
                                 q8=True)
    b_ms, b_by = bound(nbytes, flops)
    args = (q, kq.q, kq.scale, vq.q, vq.scale, 0)
    rows.append({
        "name": "flash_prefill_q8", "route": "cuda",
        "source": "cake_tpu_torch/csrc/flash_prefill_q8.cu",
        "replaces": "cake_tpu/ops/pallas/flash.py:235",
        "shape": f"q [1,{H},{t},{D}] int8 k/v [1,{KVH},{S},{D}] pos 0",
        "flops": flops,
        "max_abs_err": errs[("prefill_q8", t, 0, None)],
        "ms": time_ms(lambda: flash.flash_attention_q8(*args)),
        "plain_ms": time_ms(
                            lambda: flash.flash_attention_q8_ref(*args)),
        # over K/V dequantized beforehand: SDPA reads 2x the cache bytes
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q, k_live, v_live, is_causal=True, enable_gqa=True)),
        "bound_ms": b_ms, "bound_by": b_by,
    })
    # the int8-cache decode: the JAX package leaves it to XLA, which fuses
    # the dequantization into the attention's operand read
    rows.append(decode_row(torch, flash, kvcache, build, "flash_decode_q8",
                           "cake_tpu/ops/attention.py:419", errs, rnd))
    for r in rows:
        r["kernel_ms"] = r["ms"]
        say(f"[3] {r['name']} {r['shape']}: {r['ms']:.4f} ms (plain "
            f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f}, bound "
            f"{r['bound_ms']:.4f} by {r['bound_by']})")
        for c in r["cases"] if r["name"].endswith("matmul") else ():
            say(f"    {c['tier']} {c['shape']}: {c['ms']:.4f} ms, "
                f"{c['pct_of_bound']:.1f}% of bound {c['bound_ms']:.4f} by "
                f"{c['bound_by']}, {c['tflops']:.1f} TFLOP/s (plain "
                f"{c['plain_ms']:.4f}, library {c['library_ms']:.4f}); "
                f"{c['plan']}; {c.get('registers')} registers, "
                f"{c['dynamic_smem_bytes']} + {c.get('static_smem_bytes')} "
                f"bytes of shared memory, {c.get('spill_store_bytes')} bytes "
                "of spill stores")
    return rows


def entry_build_info(build, name: str, match) -> dict:
    """Registers, static shared memory and spill stores of the first kernel
    of library ``name`` whose mangled name satisfies ``match``
    (``ptxas -v`` in its build log)."""
    info, entry = {}, ""
    for ln in build.build_log(name).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            if info:
                break
            entry = m.group(1)
            continue
        if not match(entry):
            continue
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("static_smem_bytes", r"(\d+) bytes smem"),
                         ("spill_store_bytes", r"(\d+) bytes spill stores")):
            m = re.search(pat, ln)
            if m:
                info[key] = int(m.group(1))
    return info


def kernel_build_info(build, name: str, d: int = D) -> dict:
    """The build figures of the head-width ``d`` instance of attention
    kernel ``name``, and the dynamic shared memory it launches with."""
    info = entry_build_info(build, name, lambda e: f"Li{d}E" in e)
    fn = getattr(build.library(name), f"{name}_smem_bytes")
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int]
    info["dynamic_smem_bytes"] = fn(d)
    return info


def matmul_build_info(build, name: str, plan, group, m: int) -> dict:
    """The build figures of the matmul instance a call with ``plan`` runs
    (format, regime, and BM or the x rows it pads to), and its dynamic
    shared memory."""
    lib = build.library(name)
    scales = 0
    if name == "quant4_matmul":
        lib.quant4_matmul_scales.restype = ctypes.c_int
        lib.quant4_matmul_scales.argtypes = [ctypes.c_int]
        scales = lib.quant4_matmul_scales(group or 0)
    fmt = "Int8W" if name == "quant_matmul" else f"Int4WILi{scales}E"
    if plan.regime == "prefill":
        kern, inst = "prefill_kernel", f"Li{plan.block_m}E"
    else:
        kern, inst = "decode_kernel", f"Li{1 if m <= 8 else 2}E"
    info = entry_build_info(build, name,
                            lambda e: kern in e and fmt in e and inst in e)
    fn = getattr(lib, f"{name}_smem_bytes")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    info["dynamic_smem_bytes"] = fn(plan.block_m, scales)
    return info


def fine_group_timing(torch, qmatmul, quant, build, errs, rows) -> None:
    """Phase 3's quant4_matmul cases at groups the kernel folds inside its K
    tile: g32 at Llama-3-8B's gate/up and down (M = 1 and 2048), g16 at the
    gate and g96 at Gemma-7B's gate (M = 1 and 2048)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    row = next(r for r in rows if r["name"] == "quant4_matmul")
    for group, (k, n) in ((32, LINEARS[0]), (32, LINEARS[1]),
                          (16, LINEARS[0]),
                          (96, FAMILY_LINEARS["gemma_7b"][0])):
        for m in (1, 2048):
            c = matmul_case(torch, quant, qmatmul, build,
                            ("quant4_matmul", group), m, k, n, gen)
            c["max_abs_err"] = errs.get(("quant4_matmul", group, m, k, n))
            row["cases"].append(c)
            say(f"[3] quant4_matmul {c['tier']} {c['shape']}: "
                f"{c['ms']:.4f} ms, {c['pct_of_bound']:.1f}% of bound "
                f"{c['bound_ms']:.4f} by {c['bound_by']}, "
                f"{c['tflops']:.1f} TFLOP/s (plain {c['plain_ms']:.4f}, "
                f"library {c['library_ms']:.4f}); {c['plan']}; "
                f"{c.get('registers')} registers, "
                f"{c.get('spill_store_bytes')} bytes of spill stores")


def prefill_rows(build, rows) -> None:
    """Adds the prefill kernels' rate and build figures to their rows."""
    for r in rows:
        if "flops" in r:
            r["tflops"] = r.pop("flops") / r["ms"] / 1e9
            r.update(kernel_build_info(build, r["name"]))
            say(f"[3] {r['name']}: {r['tflops']:.1f} TFLOP/s, "
                f"{r.get('registers')} registers, "
                f"{r['dynamic_smem_bytes']} bytes of dynamic shared memory, "
                f"{r.get('spill_store_bytes')} bytes of spill stores")


# (B, T) of the timed multi-query decodes: one stream and 8 at ragged
# frontiers, at the verify's T of K = 4 and K = 8; and the verify's M = B T
# of the linears at K = 8 (one stream, 8 slots)
MQ_TIMED = ((1, 9), (8, 5), (8, 9))
VERIFY_M = (9, 72)


def multi_query_timing(torch, flash, qmatmul, quant, kvcache, build,
                       rows) -> None:
    """Phase 3's timings at the verify's shapes, added to the kernels' rows
    as cases: both decodes at T = 5 and 9 (one stream, 8 streams), and the
    linears and the head at M = 9 and 72 for the int8 and int4 g128
    tiers."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    by_name = {r["name"]: r for r in rows}
    for name in ("flash_decode", "flash_decode_q8"):
        for b, t in MQ_TIMED:
            c = decode_case(torch, flash, kvcache, name, b,
                            (2047,) if b == 1 else mq_rows(t), rnd, t=t)
            by_name[name]["cases"].append(c)
            say(f"[3] {name} {c['shape']}: {c['ms']:.4f} ms, "
                f"{c['pct_of_bound']:.1f}% of bound {c['bound_ms']:.4f} by "
                f"{c['bound_by']} (plain {c['plain_ms']:.4f}, library "
                f"{c['library_ms']:.4f})")
        torch.cuda.empty_cache()
    for name, tier in (("quant_matmul", TIERS[0]), ("quant4_matmul",
                                                     TIERS[2])):
        for m in VERIFY_M:
            for k_, n in LINEARS + (HEAD,):
                c = matmul_case(torch, quant, qmatmul, build, tier, m, k_, n,
                                gen)
                by_name[name]["cases"].append(c)
                say(f"[3] {name} {c['tier']} {c['shape']}: {c['ms']:.4f} "
                    f"ms, {c['pct_of_bound']:.1f}% of bound "
                    f"{c['bound_ms']:.4f} by {c['bound_by']} (plain "
                    f"{c['plain_ms']:.4f}, library {c['library_ms']:.4f}); "
                    f"{c['plan']}")


def prefill_case(torch, flash, kvcache, build, name, shape, t, rnd) -> dict:
    """Card times of one prefill call at ``shape`` (H, KVH, D), T = ``t``
    from pos 0, beside the bound (q, the output and the live K/V read once;
    the causal (q, k) pairs' two products), the plain version and SDPA
    (over K/V dequantized beforehand for the int8 cache); its rate and
    build figures."""
    import torch.nn.functional as F

    h, kvh, d = shape
    q = rnd(1, h, t, d)
    k, v = rnd(1, kvh, S, d), rnd(1, kvh, S, d)
    if name == "flash_prefill":
        args, fn, ref = (q, k, v, 0), flash.flash_attention, \
            flash.flash_attention_ref
        lk, lv = k[:, :, :t], v[:, :, :t]
    else:
        kq, vq = kvcache.quant_kv(k), kvcache.quant_kv(v)
        args = (q, kq.q, kq.scale, vq.q, vq.scale, 0)
        fn, ref = flash.flash_attention_q8, flash.flash_attention_q8_ref
        lk, lv = (kvcache.dequant_kv(kvcache.QuantizedKV(
            c.q[:, :, :t], c.scale[:, :, :t]), torch.bfloat16)
            for c in (kq, vq))
    nbytes, flops = prefill_cost(h, kvh, d, t, t, t * (t + 1) // 2,
                                 q8=name != "flash_prefill")
    b_ms, b_by = bound(nbytes, flops)
    case = {"shape": f"q [1,{h},{t},{d}] "
                     f"{'bf16' if name == 'flash_prefill' else 'int8'} k/v "
                     f"[1,{kvh},{S},{d}] pos 0",
            "ms": time_ms(lambda: fn(*args)),
            "plain_ms": time_ms(lambda: ref(*args), n=5),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q, lk, lv, is_causal=True, enable_gqa=True)),
            "bound_ms": b_ms, "bound_by": b_by}
    case["pct_of_bound"] = 100 * b_ms / case["ms"]
    case["tflops"] = flops / case["ms"] / 1e9
    case.update(kernel_build_info(build, name, d))
    return case


def family_timing(torch, flash, qmatmul, quant, kvcache, build, errs,
                  rows) -> None:
    """Phase 3's timings at the families' shapes, added to the kernels'
    rows as cases: both prefills and both decodes at Gemma's attention
    (GEMMA: prefill T = 2048; decode one stream at pos 2047, 8 streams at
    ragged frontiers, and T = 5 and 9), with registers and shared memory
    at D = 256; the matmuls at FAMILY_LINEARS (M = 1 and 2048) and the
    heads (M = 1), int8 and int4 g128. (Mixtral's experts run at
    Llama-3-8B's linear shapes: phase 3's rows at M = 1, 8 and 2048.)"""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    by_name = {r["name"]: r for r in rows}

    def add(name, c):
        c["max_abs_err"] = c.get("max_abs_err")
        by_name[name].setdefault("cases", []).append(c)
        say(f"[3] {name} {c.get('tier', '')} {c['shape']}: {c['ms']:.4f} "
            f"ms, {c['pct_of_bound']:.1f}% of bound {c['bound_ms']:.4f} by "
            f"{c['bound_by']} (plain {c['plain_ms']:.4f}, library "
            f"{c['library_ms']:.4f}); {c.get('registers')} registers, "
            f"{c.get('dynamic_smem_bytes')} bytes of dynamic shared memory, "
            f"{c.get('spill_store_bytes')} bytes of spill stores")

    d = GEMMA[2]
    for name, key in (("flash_prefill", "prefill"),
                      ("flash_prefill_q8", "prefill_q8")):
        c = prefill_case(torch, flash, kvcache, build, name, GEMMA, 2048, rnd)
        c["max_abs_err"] = errs[(key, d, 2048, 0, None)]
        add(name, c)
        torch.cuda.empty_cache()
    for name in ("flash_decode", "flash_decode_q8"):
        for b, t, pos in ((1, 1, (2047,)), (BATCH, 1, BATCH_POS_TIMED),
                          (1, 9, (2047,)), (8, 5, mq_rows(5)),
                          (8, 9, mq_rows(9))):
            c = decode_case(torch, flash, kvcache, name, b, pos, rnd, t=t,
                            shape=GEMMA)
            c.update(kernel_build_info(build, name, d))
            if (b, t) == (1, 1):
                c["max_abs_err"] = errs[(name, d, 1, 2047, None)]
            add(name, c)
        torch.cuda.empty_cache()
    for name, tier in (("quant_matmul", TIERS[0]),
                       ("quant4_matmul", TIERS[2])):
        for family, lins in FAMILY_LINEARS.items():
            for (k, n), ms in [(kn, (1, 2048)) for kn in lins] + [
                    (FAMILY_HEADS[family], (1,))]:
                for m in ms:
                    c = matmul_case(torch, quant, qmatmul, build, tier, m, k,
                                    n, gen)
                    c["family"] = family
                    c["max_abs_err"] = errs.get((name, tier[1], m, k, n))
                    add(name, c)
        c = matmul_case(torch, quant, qmatmul, build, tier, 1,
                        *FAMILY_HEADS["mixtral_8x7b"], gen)
        c["family"] = "mixtral_8x7b"
        c["max_abs_err"] = errs.get(
            (name, tier[1], 1, *FAMILY_HEADS["mixtral_8x7b"]))
        add(name, c)


# --------------------------------------------------------------------------
# phase 4
# --------------------------------------------------------------------------


def to_device(tree, device):
    """A params tree (dicts of tensors and quantized linears) on
    ``device``."""
    import dataclasses

    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return type(tree)(*(getattr(tree, f.name).to(device)
                            for f in dataclasses.fields(tree)))
    return tree.to(device)


def phase_model(torch) -> None:
    from cake_tpu_torch.models import llama
    from cake_tpu_torch.models.config import llama3_8b
    from cake_tpu_torch.ops import quant
    from cake_tpu_torch.ops.kvcache import init_cache

    cfg = llama3_8b(num_hidden_layers=2, max_seq_len=128)
    tokens = torch.randint(0, cfg.vocab_size, (1, 64),
                           generator=torch.Generator().manual_seed(SEED))
    for label, init, kv_quant in (
            ("bf16", llama.init_params, None),
            ("int8 weights, int8 cache", llama.init_params_int8, "int8"),
            ("int4 g128 weights", lambda c, **kw: llama.init_params_int4(
                c, group_size=128, **kw), None)):
        params = init(cfg, seed=SEED, device="cuda")
        params_cpu = to_device(params, "cpu")
        with torch.inference_mode():
            got = llama.Llama(cfg, params)(
                tokens.cuda(), init_cache(cfg, 1, 128, device="cuda",
                                          quant=kv_quant), 0)
            want = llama.Llama(cfg, params_cpu)(
                tokens, init_cache(cfg, 1, 128, device="cpu",
                                   quant=kv_quant), 0)
        got = got.cpu()
        if got.shape != (1, cfg.vocab_size) or not torch.isfinite(got).all():
            fail(f"2-layer logits ({label}): shape {tuple(got.shape)} or not "
                 "finite")
        rel = ((got - want).norm() / want.norm()).item()
        say(f"[4] 2-layer llama3_8b width, {label}, T=64 prefill, cuda vs "
            f"cpu: relative L2 {rel:.3e} (limit {MODEL_REL_L2})")
        if not rel < MODEL_REL_L2:
            fail(f"2-layer model ({label}): relative L2 {rel} >= "
                 f"{MODEL_REL_L2}")
        del params, params_cpu
        torch.cuda.empty_cache()
    # codes quantized on the card are the codes the CPU makes
    w = torch.randn(4096, 14336, generator=torch.Generator().manual_seed(
        SEED)) / 64.0
    for fn in (quant.quantize_linear,
               lambda t: quant.quantize_linear4(t, group_size=128)):
        on_card, on_cpu = fn(w.cuda()), fn(w)
        for f in ("q", "qp", "scale"):
            if hasattr(on_cpu, f) and not torch.equal(
                    getattr(on_card, f).cpu(), getattr(on_cpu, f)):
                fail(f"{type(on_cpu).__name__}.{f} quantized on the card "
                     "differs from the CPU's")
    say("[4] int8 and int4 g128 codes and scales of a [4096, 14336] weight: "
        "card == cpu")


# Mixtral's routing in two runs of other shapes (the card against the
# CPU, the batch engine against a single stream) may differ where a
# token's k-th and (k+1)-th router logits (f32, from bf16 activations) lie
# closer than the runs' rounding moves them: such a flip is a tie, not a
# fault. On an H100 the 2-layer model's gaps on the card and the CPU
# differ by up to 2.6e-2 (phase 4): a flip at a gap of twice that fails.
ROUTER_TIE = 5e-2


class RouterLog:
    """Records, while active, each ``moe.router_topk`` call's top-k ids
    (sorted) and the gap between its k-th and (k+1)-th logits, per row."""

    def __init__(self, moe):
        self.moe, self.calls = moe, []

    def __enter__(self):
        real = self.real = self.moe.router_topk

        def recording(x2d, router_w, top_k):
            combine, w, idx = real(x2d, router_w, top_k)
            top = (x2d.float() @ router_w.float()).topk(top_k + 1,
                                                        dim=-1).values
            self.calls.append((idx.sort(dim=-1).values.cpu(),
                               (top[:, top_k - 1] - top[:, top_k]).cpu()))
            return combine, w, idx

        self.moe.router_topk = recording
        return self

    def __exit__(self, *exc):
        self.moe.router_topk = self.real


def routing_flips(card: RouterLog, cpu: RouterLog) -> list:
    """(call, row, gap) of every row whose top-k set differs between the
    two runs, the gap the smaller of the two runs'."""
    out = []
    for i, ((ia, ga), (ib, gb)) in enumerate(zip(card.calls, cpu.calls)):
        for r in (ia != ib).any(dim=-1).nonzero().flatten().tolist():
            out.append((i, r, min(float(ga[r]), float(gb[r]))))
    return out


# phase 4's families: (label, preset, init, KV cache)
FAMILY_MODELS = (
    ("qwen2_7b bf16", "qwen2_7b", "bf16", None),
    ("qwen2_7b int4 g128", "qwen2_7b", "int4g128", None),
    ("gemma_7b bf16", "gemma_7b", "bf16", None),
    ("gemma_7b bf16, int8 cache", "gemma_7b", "bf16", "int8"),
    ("mixtral_8x7b bf16", "mixtral_8x7b", "bf16", None),
    ("mixtral_8x7b int8 experts", "mixtral_8x7b", "int8", None),
)


def family_init(llama, weights: str):
    """The random init of a weight tier: bf16, int8 or int4 g128."""
    return {"bf16": llama.init_params, "int8": llama.init_params_int8,
            "int4g128": lambda c, **kw: llama.init_params_int4(
                c, group_size=128, **kw)}[weights]


def phase_model_families(torch) -> list:
    """Phase 4 for the other families: each at full width and 2 layers, a
    T = 64 prefill and one decode step on the card (kernels) against the
    CPU (plain path) from the same weights, the logits held to
    MODEL_REL_L2; Mixtral's routing compared row by row (ROUTER_TIE)."""
    from cake_tpu_torch.models import config as presets
    from cake_tpu_torch.models import llama
    from cake_tpu_torch.ops import moe
    from cake_tpu_torch.ops.kvcache import init_cache

    out = []
    for label, preset, weights, kv_quant in FAMILY_MODELS:
        cfg = getattr(presets, preset)(num_hidden_layers=2, max_seq_len=128)
        tokens = torch.randint(0, cfg.vocab_size, (1, 65),
                               generator=torch.Generator().manual_seed(SEED))
        params = family_init(llama, weights)(cfg, seed=SEED, device="cuda")
        if cfg.tie_word_embeddings and weights == "bf16":
            # Gemma's tied head as a checkpoint loads it: the embedding's
            # transposed view, read by torch.matmul as it lies
            params["lm_head"] = params["embed"].t()
        params_cpu = to_device(params, "cpu")
        logs, logits = [], []
        for dev, p in (("cuda", params), ("cpu", params_cpu)):
            with RouterLog(moe) as log, torch.inference_mode():
                m = llama.Llama(cfg, p)
                cache = init_cache(cfg, 1, 128, device=dev, quant=kv_quant)
                t = tokens.to(dev)
                first = m(t[:, :64], cache, 0)
                step = m(t[:, 64:], cache, torch.tensor(
                    [64], dtype=torch.int32, device=dev))
            logs.append(log)
            logits.append(torch.stack([first[0], step[0]]).float().cpu())
        got, want = logits
        if got.shape != (2, cfg.vocab_size) or not torch.isfinite(got).all():
            fail(f"2-layer logits ({label}): shape {tuple(got.shape)} or "
                 "not finite")
        rows_rel = ((got - want).norm(dim=-1) / want.norm(dim=-1)).tolist()
        rel = max(rows_rel)
        flips = routing_flips(*logs)
        row = {"model": label, "rel_l2": rel, "router_flips": flips}
        note = ""
        if cfg.num_local_experts:
            gaps, cpu_gaps = (torch.cat([g for _, g in log.calls])
                              for log in logs)
            dl = (gaps - cpu_gaps).abs().max().item()
            row.update(min_router_gap=gaps.min().item(), router_gap_diff=dl)
            note = (f"; routing: {len(flips)} rows differ, least k/k+1 "
                    f"gap {gaps.min().item():.3e}, gaps card vs cpu within "
                    f"{dl:.3e}")
        say(f"[4] 2-layer {label} width, T=64 prefill and a decode step, "
            f"cuda vs cpu: relative L2 {rows_rel[0]:.3e} and "
            f"{rows_rel[1]:.3e} (limit {MODEL_REL_L2}){note}")
        wide = [f for f in flips if f[2] >= ROUTER_TIE]
        if wide:
            fail(f"{label}: routing differs between card and CPU at gaps "
                 f"{wide} >= {ROUTER_TIE}")
        if not rel < MODEL_REL_L2 and not flips:
            fail(f"2-layer model ({label}): relative L2 {rel} >= "
                 f"{MODEL_REL_L2}")
        if not rel < MODEL_REL_L2:
            say(f"[4] {label}: relative L2 {rel:.3e} past the limit after "
                f"routing flips at near-ties {flips} (< {ROUTER_TIE}): a "
                "tie, not a fault")
        out.append(row)
        del params, params_cpu
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# phase 5
# --------------------------------------------------------------------------


def expected_launches(cfg, weights: str, kv_quant, prefill_calls: int,
                      decode_steps: int) -> dict:
    """Launches of each kernel in a generation: every linear of every
    forward (7 a layer and the head) goes to the weights' matmul kernel,
    each layer's prefill and each layer's decode step to the cache's
    attention kernels (int8: flash_prefill_q8 and flash_decode_q8)."""
    from cake_tpu_torch.ops.kernels import build

    L = cfg.num_hidden_layers
    counts = dict.fromkeys(build.SOURCES, 0)
    counts["flash_prefill_q8" if kv_quant else "flash_prefill"] = (
        L * prefill_calls)
    counts["flash_decode_q8" if kv_quant else "flash_decode"] = (
        L * decode_steps)
    if weights != "bf16":
        counts[weights] = (7 * L + 1) * (prefill_calls + decode_steps)
    return counts


def stream_logits(torch, cfg, params, prompt, ids, kv_quant):
    """f32 logits of each step of a stream (the ones its ``ids`` were
    chosen from), from one forward pass over the prompt and the stream."""
    from cake_tpu_torch.models.llama import Llama
    from cake_tpu_torch.ops.kvcache import init_cache

    n = len(prompt)
    tokens = torch.tensor([prompt + ids[:-1]], device="cuda")
    model = Llama(cfg, params)
    with torch.inference_mode():
        x = model.hidden(tokens, init_cache(cfg, 1, cfg.max_seq_len,
                                            device="cuda", quant=kv_quant),
                         0)
        return model.logits(x[0, n - 1:]).float()


def top2_gaps(logits) -> list:
    top = logits.topk(2, dim=-1).values
    return (top[:, 0] - top[:, 1]).tolist()


def greedy_margins(torch, cfg, params, prompt, ids, kv_quant) -> list:
    """Top-1 minus top-2 logit at each step of a greedy stream: how near
    each choice came to a tie. A stream that another summation order in a
    kernel changes turns at a step with a small margin."""
    return top2_gaps(stream_logits(torch, cfg, params, prompt, ids,
                                   kv_quant))


def run_path(torch, build, cfg, params, prompt, label, runs, weights,
             kv_quant=None) -> dict:
    """Warm up, then drive ``LlamaGenerator`` once per sampler of ``runs``
    with the launch counts set to 0 just before and read just after; fail
    unless every kernel launched exactly as the model calls say."""
    from cake_tpu_torch.runtime.generator import LlamaGenerator

    n_new = 64
    # warm-up of each sampler (cuBLAS handles and heuristics, first
    # launches of each op): neither timed nor counted
    for _, settings in runs:
        warm = LlamaGenerator(cfg, params, settings=settings, block_size=8,
                              kv_quant=kv_quant)
        warm.set_prompt(prompt)
        for i in range(9):
            warm.next_token(i)
        del warm
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    result = {"path": label, "runs": []}
    prefill_calls = decode_steps = 0
    for name, settings in runs:
        gen = LlamaGenerator(cfg, params, settings=settings, block_size=8,
                             kv_quant=kv_quant)
        gen.set_prompt(prompt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = [gen.next_token(0).id]
        t1 = time.perf_counter()
        ids += [gen.next_token(i).id for i in range(1, n_new)]
        t2 = time.perf_counter()
        prefill_calls += gen.prefill_calls
        decode_steps += gen.decode_steps
        if len(ids) != n_new or not all(0 <= i < cfg.vocab_size
                                        for i in ids):
            fail(f"{label} {name} stream is not {n_new} ids in the "
                 "vocabulary")
        run = {"label": name, "prefill_ms": (t1 - t0) * 1e3,
               "decode_tokens_per_s": (n_new - 1) / (t2 - t1),
               "first_ids": ids[:8], "ids": ids}
        result["runs"].append(run)
        say(f"[5] {label} {name}: prefill_ms {run['prefill_ms']:.2f} "
            f"(2000 tokens, bucket 2048), decode tokens_per_s "
            f"{run['decode_tokens_per_s']:.2f} ({n_new - 1} tokens, "
            f"block 8), ids {ids[:8]}...")
        del gen
    counts = build.launches()
    result["launches"] = counts
    result["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    say(f"[5] {label} launches {counts}; prefill calls {prefill_calls}, "
        f"decode steps {decode_steps}; peak memory {result['peak_gb']:.2f} "
        "GB")
    want = expected_launches(cfg, weights, kv_quant, prefill_calls,
                             decode_steps)
    if counts != want or prefill_calls == 0 or decode_steps == 0:
        fail(f"{label}: kernels launched {counts}, want {want}")
    for run in result["runs"]:
        ids = run.pop("ids")
        if run["label"] == "greedy":
            m = greedy_margins(torch, cfg, params, prompt, ids, kv_quant)
            run["margins_first8"] = [round(x, 4) for x in m[:8]]
            run["min_margin"] = min(m)
            say(f"[5] {label} greedy: top-1 minus top-2 logit at steps "
                f"0-7 {run['margins_first8']}, least over {len(m)} steps "
                f"{run['min_margin']:.4f} at step {m.index(min(m))}")
    return result


def fine_group_path(torch, build) -> dict:
    """``int4:g32`` end to end: Llama-3-8B at full width and 4 layers, int4
    g32 weights drawn on the card (seed 0), 16 greedy tokens after a
    100-id prompt through ``LlamaGenerator``, with the counts set to 0 just
    before and every kernel's launches exact."""
    from cake_tpu_torch.models import llama
    from cake_tpu_torch.models.config import llama3_8b
    from cake_tpu_torch.ops.sampling import SamplerSettings
    from cake_tpu_torch.runtime.generator import LlamaGenerator

    cfg = llama3_8b(num_hidden_layers=4, max_seq_len=4096)
    params = llama.init_params_int4(cfg, seed=SEED, group_size=32)
    prompt = torch.randint(0, cfg.vocab_size, (100,),
                           generator=torch.Generator().manual_seed(SEED)
                           ).tolist()
    build.reset_launches()
    gen = LlamaGenerator(cfg, params, settings=SamplerSettings(
        temperature=0), block_size=8)
    gen.set_prompt(prompt)
    ids = [gen.next_token(i).id for i in range(16)]
    counts = build.launches()
    want = expected_launches(cfg, "quant4_matmul", None, gen.prefill_calls,
                             gen.decode_steps)
    if counts != want or gen.decode_steps == 0:
        fail(f"int4 g32 generation: kernels launched {counts}, want {want}")
    if not all(0 <= i < cfg.vocab_size for i in ids):
        fail(f"int4 g32 generation: ids {ids} outside the vocabulary")
    say(f"[5] (d) int4 g32 weights, 4 layers: 16 ids {ids}; launches "
        f"{counts} exact")
    del gen, params
    torch.cuda.empty_cache()
    return {"path": "(d) int4 g32 weights, 4 layers", "ids": ids,
            "launches": counts}


def phase_main_path(torch, build, flash, kvcache) -> list:
    from cake_tpu_torch.models import llama
    from cake_tpu_torch.models.config import llama3_8b
    from cake_tpu_torch.ops.sampling import SamplerSettings

    cfg = llama3_8b(num_hidden_layers=MAIN_LAYERS, max_seq_len=4096)
    prompt = torch.randint(0, cfg.vocab_size, (2000,),
                           generator=torch.Generator().manual_seed(SEED)
                           ).tolist()
    greedy = ("greedy", SamplerSettings(temperature=0))
    paths = (
        ("(a) bf16", lambda: llama.init_params(cfg, seed=SEED),
         (greedy, ("sampled", SamplerSettings(temperature=0.8, top_k=40))),
         "bf16", None),
        ("(b) int8 weights, int8 cache",
         lambda: llama.init_params_int8(cfg, seed=SEED), (greedy,),
         "quant_matmul", "int8"),
        ("(c) int4 g128 weights",
         lambda: llama.init_params_int4(cfg, seed=SEED, group_size=128),
         (greedy,), "quant4_matmul", None),
    )
    # the int8-cache decode reads the int8 bytes: nothing on the card path
    # makes a dequantized copy of the cache
    dequant_calls = []
    real_dequant = kvcache.dequant_kv

    def counted_dequant(*args, **kwargs):
        dequant_calls.append(1)
        return real_dequant(*args, **kwargs)

    kvcache.dequant_kv = counted_dequant
    try:
        results = main_path_runs(torch, build, flash, kvcache, cfg, prompt,
                                 paths)
    finally:
        kvcache.dequant_kv = real_dequant
    say(f"[5] dequant_kv calls over the three paths: {len(dequant_calls)}")
    if dequant_calls:
        fail("the card's main path dequantized the int8 cache")
    return results


def main_path_runs(torch, build, flash, kvcache, cfg, prompt, paths) -> list:
    """Each path's timed runs, then the one-call traces, then each path's
    profile."""
    results = []
    for label, init, runs, weights, kv_quant in paths:
        t0 = time.perf_counter()
        params = init()  # the previous path's weights are freed
        torch.cuda.synchronize()
        say(f"[5] {label}: llama3_8b weights drawn on the card in "
            f"{time.perf_counter() - t0:.1f} s")
        results.append(run_path(torch, build, cfg, params, prompt, label,
                                runs, weights, kv_quant))
        del params
        torch.cuda.empty_cache()
    # profiled after every timed run: a profiler session slows the host
    # for the rest of the process (and the one-call traces first: after
    # several profiler runs a trace of one ctypes launch came back empty)
    phase_one_launch(torch, flash, kvcache)
    for result, (label, init, _, _, kv_quant) in zip(results, paths):
        params = init()
        result["profile"] = profile_main_path(torch, cfg, params, prompt,
                                              label, kv_quant)
        del params
        torch.cuda.empty_cache()
    return results


def phase_one_launch(torch, flash, kvcache) -> None:
    """A profiler trace of one call of each decode wrapper, with an int32
    ``pos [B]`` already on the card as the main path passes it, holds
    exactly one kernel: no elementwise kernel on ``pos``, no combine."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    k, v, q = (torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16) for shape in ((1, KVH, S, D), (1, KVH, S, D),
                                      (1, H, 1, D)))
    kq, vq = kvcache.quant_kv(k), kvcache.quant_kv(v)
    p = torch.tensor([2047], dtype=torch.int32, device="cuda")
    # and the verify's multi-query form: T = 17 (five 16-row tiles)
    q17 = torch.randn((1, H, 17, D), generator=gen, device="cuda").to(
        torch.bfloat16)
    for name, call in (
            ("flash_decode", lambda: flash.flash_decode(q, k, v, p)),
            ("flash_decode_q8", lambda: flash.flash_decode_q8(
                q, kq.q, kq.scale, vq.q, vq.scale, p)),
            ("flash_decode T=17", lambda: flash.flash_decode(q17, k, v, p)),
            ("flash_decode_q8 T=17", lambda: flash.flash_decode_q8(
                q17, kq.q, kq.scale, vq.q, vq.scale, p))):
        call()  # built and loaded before the trace
        prof = device_profile(torch, call)
        say(f"[5] one {name} call: {prof['kernel_launches']} kernel "
            f"launch(es) on the card: {[n[:80] for n, _ in prof['kernels']]}")
        if prof["kernel_launches"] != 1:
            fail(f"one {name} call launched {prof['kernel_launches']} "
                 "kernels, want 1")


def device_profile(torch, fn) -> dict:
    """Run ``fn`` under ``torch.profiler`` and sum the card's kernel time
    (the profiler table's own rule: events of device type CUDA)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    return {
        "device_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
        "kernel_launches": sum(e.count for e in kernels),
        "top": [(e.key[:60], round(e.self_device_time_total / 1e3, 3),
                 e.count) for e in kernels[:6]],
        "kernels": [(e.key, e.count) for e in kernels],
    }


def profile_main_path(torch, cfg, params, prompt, label, kv_quant) -> dict:
    """Card time of one prefill and of one decode block (8 steps), from a
    profiler trace; the unprofiled wall times stand beside them to give the
    card's busy share."""
    from cake_tpu_torch.ops.sampling import SamplerSettings
    from cake_tpu_torch.runtime.generator import LlamaGenerator

    gen = LlamaGenerator(cfg, params, settings=SamplerSettings(
        temperature=0), block_size=8, kv_quant=kv_quant)
    gen.set_prompt(prompt)
    out = {"prefill": device_profile(torch, lambda: gen.next_token(0))}
    steps = gen.decode_steps
    out["decode_block_8"] = device_profile(torch, lambda: gen.next_token(1))
    steps = gen.decode_steps - steps
    for name, prof in out.items():
        say(f"[5] {label} profile {name}: card kernel time "
            f"{prof['device_ms']:.3f} ms over {prof['kernel_launches']} "
            f"launches; top {prof['top']}")
    dec = out["decode_block_8"]
    names = dec.pop("kernels")
    out["prefill"].pop("kernels")
    if kv_quant:
        say(f"[5] {label} decode trace, top kernels by card time: "
            f"{[(n[:100], c) for n, c in names[:10]]}")
    dec["steps"] = steps
    dec["device_ms_per_step"] = dec["device_ms"] / steps
    dec["kernel_launches_per_step"] = dec["kernel_launches"] / steps
    say(f"[5] {label} decode: {dec['device_ms_per_step']:.3f} ms of card "
        f"kernel time and {dec['kernel_launches_per_step']:.1f} kernel "
        f"launches a step ({steps} steps profiled)")
    return out


# --------------------------------------------------------------------------
# phase 6
# --------------------------------------------------------------------------


# phase 6's tiny checkpoint: head_dim 64, the kernels' other width
CLI_CFG = dict(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2,
               dtype="bfloat16")
CLI_RUN = ["--prompt-ids", "3,5,7,9", "-n", "8", "--temperature", "0",
           "--max-seq", "128"]
# (label, flags, topology master's flags) of phase 6's three runs: the
# flags go to the local run and to phase 9's workers; a topology master
# refuses --kv-quant (the workers own the caches)
CLI_FLAGS = (
    ("bf16", [], []),
    ("int8", ["--quantize", "int8", "--kv-quant", "int8"],
     ["--quantize", "int8"]),
    ("int4:g64", ["--quantize", "int4:g64"], ["--quantize", "int4:g64"]),
)


def write_cli_checkpoint(torch, build, d) -> object:
    """Phase 6's tiny bf16 checkpoint (seed 0, drawn on the card) in
    ``d``; returns its config."""
    from cake_tpu_torch.models.config import tiny
    from cake_tpu_torch.models.llama import init_params
    from cake_tpu_torch.utils.weights import save_llama_params

    cfg = tiny(**CLI_CFG)
    save_llama_params(init_params(cfg, seed=SEED, device="cuda"), d)
    (Path(d) / "config.json").write_text(json.dumps(cfg.to_hf_dict()))
    return cfg


def cli_ids(r, cfg, what: str) -> list:
    """The 8 ids a finished command-line run printed on its last line."""
    if r.returncode != 0:
        fail(f"{what} exit {r.returncode}: {r.stderr[-2000:]}")
    last = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    try:
        ids = [int(x) for x in last.split(",")]
    except ValueError:
        ids = []
    if len(ids) != 8 or not all(0 <= i < cfg.vocab_size for i in ids):
        fail(f"{what} printed {last!r}, want 8 token ids")
    return ids


def phase_cli(torch, build) -> dict:
    """Phase 6's three runs of the local command line; returns each
    label's ids."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = {}
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as d:
        cfg = write_cli_checkpoint(torch, build, d)
        # int4 groups of 32 rows (folded inside the kernel's K tile) run
        # locally too; phase 9 repeats only CLI_FLAGS
        for label, flags, _ in CLI_FLAGS + (
                ("int4:g32", ["--quantize", "int4:g32"], None),):
            r = subprocess.run(
                [sys.executable, "-m", "cake_tpu_torch.cli", "--model", d,
                 *CLI_RUN, *flags],
                capture_output=True, text=True, timeout=300, env=env,
                cwd=REPO)
            out[label] = cli_ids(r, cfg, f"cli {flags}")
            say(f"[6] cli {' '.join(flags) or 'bf16'}: "
                f"{','.join(map(str, out[label]))}")
    return out


# --------------------------------------------------------------------------
# phases 2 and 3 at the serving engine's shapes
# --------------------------------------------------------------------------

# the batch engine's decode at 8 slots: ragged frontiers, a row at the
# buffer's last slot and a finished row past the window (its KV writes
# clamp inside its own row; it attends every key, as in JAX)
BATCH_POS = (S - 1, 2047, 1100, 517, 260, 64, 33, S + 4)
# the timed batch decode: the same rows, the finished one at S - 1
BATCH_POS_TIMED = (S - 1, 2047, 1100, 517, 260, 64, 33, 5)
BATCH = len(BATCH_POS)


def phase_batch_kernels(torch, flash, qmatmul, quant, kvcache) -> dict:
    """Phase 2's checks at the serving engine's shapes: both decodes at
    B = 8 with ragged ``pos``, ``flash_prefill`` at B = 8 (the batched
    prompt pass, bucket 2048), and both matmuls at M = 8 over every linear
    and the head; each with a planted fault that the check must refuse."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    errs = {}
    k, v, q = rnd(BATCH, KVH, S, D), rnd(BATCH, KVH, S, D), rnd(BATCH, H, 1,
                                                                D)
    kq, vq = kvcache.quant_kv(k), kvcache.quant_kv(v)
    p = torch.tensor(BATCH_POS, dtype=torch.int32, device="cuda")
    # one row's last live tile dropped, as a loop ending at max_kb - 1
    bad = p.clone()
    bad[1] -= flash.DECODE_BLOCK_K
    for name, kv in (("flash_decode", (k, v)),
                     ("flash_decode_q8", (kq.q, kq.scale, vq.q, vq.scale))):
        kernel, plain = getattr(flash, name), getattr(flash, f"{name}_ref")
        label = f"{name} B={BATCH} pos={list(BATCH_POS)}"
        out = kernel(q, *kv, p)
        errs[(name, BATCH)] = compare(torch, label, out, plain(q, *kv, p))
        if not torch.equal(out, kernel(q, *kv, p)):
            fail(f"{label}: a second call on the same inputs gives other "
                 "bits")
        planted(torch, f"{label}, row 1's last tile dropped",
                kernel(q, *kv, bad), plain(q, *kv, p))
    qp = rnd(BATCH, H, 2048, D)
    label = f"flash_prefill B={BATCH} T=2048 pos=0"
    errs[("prefill", BATCH)] = compare(
        torch, label, flash.flash_attention(qp, k, v, 0),
        flash.flash_attention_ref(qp, k, v, 0))
    planted(torch, f"{label}, last tile dropped",
            tile_short(flash, lambda: flash.flash_attention(qp, k, v, 0)),
            flash.flash_attention_ref(qp, k, v, 0))
    del k, v, q, kq, vq, qp
    torch.cuda.empty_cache()
    plain = {"quant_matmul": quant.quant_matmul_ref,
             "quant4_matmul": quant.quant4_matmul_ref}
    for kn in LINEARS + (HEAD,):
        k_, n = kn
        w = torch.randn(k_, n, generator=gen, device="cuda") / k_ ** 0.5
        x = torch.randn(BATCH, k_, generator=gen, device="cuda").to(
            torch.bfloat16)
        for tier in TIERS:
            name, wq, scale = quantized(quant, w, tier)
            label = f"{name} {tier_label(tier)} M={BATCH} K={k_} N={n}"
            out = getattr(qmatmul, name)(x, wq, scale)
            errs[(name, tier[1], BATCH, k_, n)] = compare(
                torch, label, out, plain[name](x, wq, scale))
            if kn == LINEARS[0]:
                k2 = k_ - qmatmul.BLOCK_K
                int4 = name == "quant4_matmul"
                planted(torch, f"{label} one K tile short",
                        qmatmul._launch(name, x[:, :k2].contiguous(),
                                        wq[:k2 // 2 if int4 else k2], scale,
                                        n, (tier[1] or 0,) if int4 else ()),
                        plain[name](x, wq, scale))
            del wq, scale
        del w
        torch.cuda.empty_cache()
    return errs


def batch_timing(torch, flash, qmatmul, quant, kvcache, build,
                 rows) -> None:
    """Phase 3's timings at the serving engine's shapes, added to each
    kernel's row as cases: both decodes at B = 8 (ragged frontiers), both
    matmuls at M = 8 over every linear and the head (the decode step of an
    8-slot batch), each beside its bound, plain version and library
    call."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    by_name = {r["name"]: r for r in rows}
    for name in ("flash_decode", "flash_decode_q8"):
        c = decode_case(torch, flash, kvcache, name, BATCH, BATCH_POS_TIMED,
                        rnd)
        by_name[name]["cases"].append(c)
        say(f"[3] {name} {c['shape']}: {c['ms']:.4f} ms, "
            f"{100 * c['bound_ms'] / c['ms']:.1f}% of bound "
            f"{c['bound_ms']:.4f} by {c['bound_by']} (plain "
            f"{c['plain_ms']:.4f}, library {c['library_ms']:.4f})")
    for name, tiers in (("quant_matmul", TIERS[:1]),
                        ("quant4_matmul", (TIERS[2], TIERS[1]))):
        for tier in tiers:
            for k_, n in LINEARS + (HEAD,):
                c = matmul_case(torch, quant, qmatmul, build, tier, BATCH,
                                k_, n, gen)
                by_name[name]["cases"].append(c)
                say(f"[3] {name} {c['tier']} {c['shape']}: {c['ms']:.4f} "
                    f"ms, {c['pct_of_bound']:.1f}% of bound "
                    f"{c['bound_ms']:.4f} by {c['bound_by']} (plain "
                    f"{c['plain_ms']:.4f}, library {c['library_ms']:.4f}); "
                    f"{c['plan']}")


# --------------------------------------------------------------------------
# phase 7
# --------------------------------------------------------------------------

# a greedy stream of the batch engine and the same prompt's single-stream
# run must agree up to the first step whose top-1 minus top-2 logit
# (after the repeat penalty) is below this: two bf16 steps of a logit in
# [4, 8). The logits are the head's bf16 outputs, so margins come in such
# steps; bf16 rows at M = 8 and M = 1 round differently, which can turn a
# near-tie and nothing wider (on an H100 the 22 streams of this phase part
# from their single-stream runs at margins of 0 to 2 such steps, each after
# an earlier near-tie)
MARGIN_TIE = 0.0625
# The ids say nothing past a stream's first near-tie, so the engine's
# top-k logprobs (block 1, logprobs on) are held too, at every step of
# every stream: against log_softmax of the same stream's teacher-forced
# logits (one batch-1 forward pass over the prompt and the delivered
# ids), at the engine's ids. A step is a row, held to its relative L2
# error. On an H100 the sound runs' worst rows read 4.9e-3 to 5.1e-3 (bf16
# logits round by up to 1/64 in [4, 8), against logprobs near -8 to -12);
# the planted splice faults, after which an arrival's first token is still
# right, read 6.3e-2 (decode one position late) and 1.2e-1 (the previous
# occupant's key scales).
LP_K = 5
LP_ROW_REL_L2 = 0.02
# prompt lengths of the 8 slots, which all open with one 128-id prefix
# (prefilled once and broadcast into every row), and each stream's quota
# of new tokens
BATCH_LENS = (2000, 1100, 517, 260, 200, 161, 140, 131)
BATCH_QUOTAS = (64, 12, 40, 20, 64, 32, 48, 24)
ARRIVAL_QUOTAS = (32, 24, 24)
# prompt passes of a batch run: the shared prefix, the batch's
# remainders, one for each arrival
BATCH_PASSES = 2 + len(ARRIVAL_QUOTAS)


def batch_prompts(torch, cfg):
    """The 8 slots' prompts and the three arrivals: the first arrival
    opens with the slots' shared prefix, which set_prompts stored (a
    prefix hit); the third opens with the first arrival's stored prefix
    (another)."""
    g = torch.Generator().manual_seed(SEED + 7)

    def ids(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()

    shared = ids(128)
    prompts = [shared + ids(n - 128) for n in BATCH_LENS]
    a1 = shared + ids(300)
    arrivals = [a1, ids(700), a1[:384] + ids(50)]
    return prompts, arrivals


def penalized_logits(torch, logits, prompt, ids, settings):
    """A stream's :func:`stream_logits` after the repeat penalty of each
    step (over the last ``repeat_last_n`` ids before it): what the greedy
    choice compares."""
    from cake_tpu_torch.ops import sampling

    n, nh, seq = len(prompt), settings.repeat_last_n, prompt + ids
    hist = torch.full((len(ids), nh), -1, dtype=torch.int32)
    for j in range(len(ids)):
        tail = seq[max(0, n + j - nh):n + j]
        hist[j, :len(tail)] = torch.tensor(tail, dtype=torch.int32)
    return sampling.apply_repeat_penalty(logits, hist.cuda(),
                                         settings.repeat_penalty)


def penalized_margins(torch, logits, prompt, ids, settings) -> list:
    """:func:`greedy_margins` after the repeat penalty of each step."""
    return top2_gaps(penalized_logits(torch, logits, prompt, ids, settings))


def logprob_errors(torch, logits, lps) -> list:
    """Relative L2 error of each step's top-k logprobs (the engine's (id,
    value) pairs) against log_softmax of the teacher-forced ``logits`` at
    the same ids."""
    ref = torch.log_softmax(logits, dim=-1)
    out = []
    for j, row in enumerate(lps):
        ids = torch.tensor([i for i, _ in row], device=ref.device)
        got = torch.tensor([v for _, v in row], device=ref.device)
        want = ref[j, ids]
        out.append(float((got - want).norm() / want.norm()))
    return out


def plant_splice_fault(g, kind: str) -> None:
    """A fault in the splice of every arrival into its slot, after which
    its first token (sampled from the staged row) is still right: "pos"
    starts the slot's decode one position late; "scales" leaves the
    slot's int8 key scales at the previous occupant's."""
    real = g._finish_admission

    def faulty(logits):
        slot = g._staging["slot"]
        old = g.cache.k.scale[:, slot].clone() if kind == "scales" else None
        real(logits)
        if kind == "pos":
            g._pos[slot] += 1
        else:
            g.cache.k.scale[:, slot].copy_(old)

    g._finish_admission = faulty


def drive_batch(torch, g, prompts, quotas, arrivals=(), after=2,
                probe=None):
    """Run the serving engine ``g`` the way the serve scheduler does: the
    prompts in slots 0..7, each emitted row delivered to the stream in its
    slot, each stream retired at its quota; ``arrivals`` (prompt, quota)
    enqueued once ``after`` streams have ended; ``probe(step)``, when
    given, runs after each step. Returns each stream's delivered ids by
    stream id, the arrivals' host-clock TTFT (enqueue to first delivered
    token) in ms, the host seconds and tokens of the run after the first
    step, and each stream's delivered top-k logprobs (when the engine
    reports them)."""
    g.set_prompts(prompts, stream_ids=list(range(len(prompts))))
    quota = dict(enumerate(quotas))
    got = {sid: [] for sid in quota}
    lps = {sid: [] for sid in quota}
    ended, ttft, t_enq = set(), {}, None
    pending = list(arrivals)
    t0 = n0 = None
    for step in range(4000):
        row = g.step()
        if step == 0:
            torch.cuda.synchronize()
            t0, n0 = time.perf_counter(), 0
        for slot, tok in enumerate(row):
            sid = g.streams[slot].stream_id
            if tok is None or sid in ended:
                continue
            got[sid].append(tok.id)
            if tok.logprobs is not None:
                lps[sid].append(tok.logprobs)
            if step:
                n0 += 1
            if sid in ttft and ttft[sid] is None:
                ttft[sid] = (time.perf_counter() - t_enq) * 1e3
            if tok.is_end_of_stream or len(got[sid]) >= quota[sid]:
                g.finish(sid)
                ended.add(sid)
        if probe is not None:
            probe(step)
        if pending and len(ended) >= after:
            t_enq = time.perf_counter()
            for i, (prompt, q) in enumerate(pending):
                sid = len(prompts) + i
                quota[sid], got[sid], ttft[sid] = q, [], None
                lps[sid] = []
                g.enqueue(prompt, sid)
            pending = []
        if not pending and len(ended) == len(quota):
            break
    else:
        fail("the batch run did not finish")
    return got, ttft, time.perf_counter() - t0, n0, lps


def single_stream(torch, cfg, params, prompt, n, settings, kv_quant):
    from cake_tpu_torch.runtime.generator import LlamaGenerator

    gen = LlamaGenerator(cfg, params, settings=settings, block_size=8,
                         kv_quant=kv_quant)
    gen.set_prompt(prompt)
    out = []
    for i in range(n):
        tok = gen.next_token(i)
        out.append(tok.id)
        if tok.is_end_of_stream:
            break
    return out


def check_planted(torch, cfg, params, label, prompts, streams, lps,
                  kv_quant) -> float:
    """The worst row relative L2 error of the top-k logprobs of the
    arrivals of a run with a planted splice fault, at the steps after
    their first token (which the staged row gives right); fails unless it
    exceeds LP_ROW_REL_L2."""
    worst = 0.0
    for sid in range(len(BATCH_LENS), len(prompts)):
        logits = stream_logits(torch, cfg, params, prompts[sid],
                               streams[sid], kv_quant)
        worst = max([worst] + logprob_errors(torch, logits, lps[sid])[1:])
    say(f"[7] {label} planted splice fault: the arrivals' worst logprob "
        f"row reads {worst:.3e} (bound {LP_ROW_REL_L2})")
    if worst <= LP_ROW_REL_L2:
        fail(f"{label}: the logprob check does not see a planted splice "
             f"fault ({worst:.3e} <= {LP_ROW_REL_L2})")
    return worst


def check_against_single(torch, cfg, params, label, prompts, streams,
                         lps, settings, kv_quant) -> list:
    """Each stream's ids against its prompt's single-stream run, up to the
    first step whose penalized margin falls below MARGIN_TIE; fails on a
    difference before it. ``lps`` are the streams' top-k logprobs of a run
    with the same ids, held to LP_ROW_REL_L2 at every step."""
    out = []
    for sid, ids in streams.items():
        ref = single_stream(torch, cfg, params, prompts[sid], len(ids),
                            settings, kv_quant)
        logits = stream_logits(torch, cfg, params, prompts[sid], ids,
                               kv_quant)
        m = penalized_margins(torch, logits, prompts[sid], ids, settings)
        lp_err = logprob_errors(torch, logits, lps[sid])
        tie = next((j for j, x in enumerate(m) if x < MARGIN_TIE), len(ids))
        diff = next((j for j, (a, b) in enumerate(zip(ids, ref)) if a != b),
                    None)
        say(f"[7] {label} stream {sid} ({len(prompts[sid])} ids, "
            f"{len(ids)} new): first difference from the single-stream "
            f"run at step {diff} (margin there "
            f"{'-' if diff is None else round(m[diff], 4)}), first margin "
            f"< {MARGIN_TIE} at step {tie}; margins 0-7 "
            f"{[round(x, 4) for x in m[:8]]}, least {min(m):.4f}; top-"
            f"{LP_K} logprobs: worst row relative L2 {max(lp_err):.3e}")
        if diff is not None and diff < tie:
            fail(f"{label} stream {sid} differs from its single-stream run "
                 f"at step {diff}, before any near-tie (margin "
                 f"{m[diff]:.4f} there)")
        if max(lp_err) > LP_ROW_REL_L2:
            fail(f"{label} stream {sid}: top-{LP_K} logprobs off by a row "
                 f"relative L2 of {max(lp_err):.3e} > {LP_ROW_REL_L2}")
        out.append({"stream": sid, "first_difference": diff,
                    "first_near_tie": tie, "min_margin": min(m),
                    "lp_row_rel_l2": max(lp_err)})
    return out


def phase_batch(torch, build, after=None) -> list:
    """The serving engine over Llama-3-8B (SERVE_LAYERS) at 8 slots:
    (a) bf16, (b) int8 weights with the int8 KV cache; then a small
    window (1,024) whose longest stream runs to the edge. ``after(label,
    cfg, params, weights, kv_quant, prompts, arrivals, streams)`` runs at
    the end of each path, over its weights, once its engines are freed
    (phase 11)."""
    from cake_tpu_torch.models import llama
    from cake_tpu_torch.models.config import llama3_8b
    from cake_tpu_torch.ops.sampling import SamplerSettings
    from cake_tpu_torch.runtime.batch_generator import BatchGenerator

    cfg = llama3_8b(num_hidden_layers=SERVE_LAYERS,
                    max_seq_len=4096)
    prompts, arrivals = batch_prompts(torch, cfg)
    every = prompts + arrivals
    settings = SamplerSettings(temperature=0)
    results = []
    for label, init, weights, kv_quant in (
            ("(a) bf16", lambda: llama.init_params(cfg, seed=SEED), "bf16",
             None),
            ("(b) int8 weights, int8 cache",
             lambda: llama.init_params_int8(cfg, seed=SEED), "quant_matmul",
             "int8")):
        params = init()
        runs = {}
        # block 1 reports logprobs (held to the teacher-forced logits);
        # block 8 is the timed and profiled run
        for block in (8, 1):
            g = BatchGenerator(cfg, params, settings=settings,
                               block_size=block, kv_quant=kv_quant,
                               logprobs=LP_K if block == 1 else 0)
            g.warm_admission(64)  # kernels built, cuBLAS warm
            torch.cuda.synchronize()
            build.reset_launches()
            p0, d0 = g.prefill_calls, g.decode_steps
            streams, ttft, wall, tokens, lps = drive_batch(
                torch, g, prompts, BATCH_QUOTAS,
                list(zip(arrivals, ARRIVAL_QUOTAS)))
            torch.cuda.synchronize()
            counts = build.launches()
            want = expected_launches(cfg, weights, kv_quant,
                                     g.prefill_calls - p0,
                                     g.decode_steps - d0)
            st = g.stats()
            say(f"[7] {label} block {block}: {tokens} tokens in "
                f"{wall:.3f} s after the first step, {tokens / wall:.2f} "
                f"tokens/s aggregate (host clock, 8 slots); arrivals' TTFT "
                f"ms {[round(t, 2) for t in ttft.values()]}; "
                f"{g.prefill_calls - p0} prompt passes, "
                f"{g.decode_steps - d0} decode steps; prefix hits "
                f"{st['prefix_hits']}; launches {counts}")
            if counts != want:
                fail(f"{label} block {block}: kernels launched {counts}, "
                     f"want {want}")
            if g.prefill_calls - p0 != BATCH_PASSES:
                fail(f"{label} block {block}: {g.prefill_calls - p0} prompt "
                     f"passes, want {BATCH_PASSES} (the shared prefix once, "
                     "the remainders, one an arrival)")
            if st["prefix_hits"] != 2:
                fail(f"{label}: the first and third arrivals did not both "
                     f"hit a stored prefix ({st['prefix_hits']} hits)")
            want_n = list(BATCH_QUOTAS) + list(ARRIVAL_QUOTAS)
            for sid, ids in streams.items():
                if len(ids) != want_n[sid] and not (
                        ids and ids[-1] in cfg.eos_ids()):
                    fail(f"{label} stream {sid}: {len(ids)} ids, quota "
                         f"{want_n[sid]}")
                if not all(0 <= i < cfg.vocab_size for i in ids):
                    fail(f"{label} stream {sid}: ids out of the vocabulary")
            runs[block] = {"streams": streams, "ttft_ms": ttft,
                           "tokens_per_s": tokens / wall, "wall_s": wall,
                           "tokens": tokens, "launches": counts,
                           "lps": lps, "generator": g}
        if runs[8]["streams"] != runs[1]["streams"]:
            diff = [sid for sid in runs[8]["streams"]
                    if runs[8]["streams"][sid] != runs[1]["streams"][sid]]
            fail(f"{label}: streams {diff} differ between blocks 8 and 1")
        say(f"[7] {label}: all 11 streams identical at blocks 8 and 1")
        result = {"path": f"batch {label}", "launches": runs[8]["launches"],
                  "tokens_per_s": runs[8]["tokens_per_s"],
                  "tokens_per_s_block_1": runs[1]["tokens_per_s"],
                  "arrival_ttft_ms": list(runs[8]["ttft_ms"].values())}
        result["vs_single_stream"] = check_against_single(
            torch, cfg, params, label, every, runs[1]["streams"],
            runs[1]["lps"], settings, kv_quant)
        # the same run with a planted fault in every arrival's splice
        g = BatchGenerator(cfg, params, settings=settings, block_size=1,
                           kv_quant=kv_quant, logprobs=LP_K)
        plant_splice_fault(g, "scales" if kv_quant else "pos")
        streams, _, _, _, lps = drive_batch(
            torch, g, prompts, BATCH_QUOTAS,
            list(zip(arrivals, ARRIVAL_QUOTAS)))
        del g
        result["planted_lp_row_rel_l2"] = check_planted(
            torch, cfg, params, label, every, streams, lps, kv_quant)
        result["profile"] = profile_batch(torch, runs[8]["generator"],
                                          prompts, label)
        for r in runs.values():
            r.pop("generator")
        if weights == "bf16":
            result["window_edge"] = window_edge_run(torch, cfg, params,
                                                    settings)
        results.append(result)
        streams8 = runs[8]["streams"]
        del runs
        torch.cuda.empty_cache()
        if after is not None:
            after(label, cfg, params, weights, kv_quant, prompts, arrivals,
                  streams8)
        del params
        torch.cuda.empty_cache()
    return results


def profile_batch(torch, g, prompts, label, tag="[7]") -> dict:
    """Card time of one decode block (8 steps) of the 8-slot batch from a
    profiler trace, beside the host clock's time for an unprofiled block:
    the card's busy share of a step."""
    g.set_prompts(prompts)
    g.step()
    for _ in range(8):  # one unprofiled block, timed
        g.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        g.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 8
    d0 = g.decode_steps
    prof = device_profile(torch, lambda: [g.step() for _ in range(8)])
    steps = g.decode_steps - d0
    prof.pop("kernels")
    prof["steps"] = steps
    prof["device_ms_per_step"] = prof["device_ms"] / steps
    prof["wall_ms_per_step"] = wall_ms
    prof["busy_share"] = prof["device_ms_per_step"] / wall_ms
    say(f"{tag} {label} 8-slot decode: {prof['device_ms_per_step']:.3f} ms of "
        f"card kernel time a step over {prof['kernel_launches'] / steps:.1f}"
        f" launches, {wall_ms:.3f} ms a step on the host clock: card busy "
        f"{100 * prof['busy_share']:.1f}%; top {prof['top']}")
    return prof


def window_edge_run(torch, cfg, params, settings) -> dict:
    """A 1,024-slot window: the 1,000-id stream fills it after 24 tokens
    while a fused block of 8 runs its row past the edge (clamped writes
    inside its own row); every stream equals its block-1 run."""
    from cake_tpu_torch.runtime.batch_generator import BatchGenerator

    g = torch.Generator().manual_seed(SEED + 8)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()
               for n in (1000, 300, 77, 9)]
    out = {}
    for block in (8, 1):
        gen = BatchGenerator(cfg, params, settings=settings,
                             block_size=block, max_seq=1024)
        out[block] = drive_batch(torch, gen, prompts, (64, 64, 40, 48))[0]
        edge = gen.streams[0]
        if len(out[block][0]) != 24 or edge.end_reason != "length":
            fail(f"window edge, block {block}: the 1,000-id stream emitted "
                 f"{len(out[block][0])} ids ({edge.end_reason}), want 24 "
                 "to the window's end")
    if out[8] != out[1]:
        fail("window edge: streams differ between blocks 8 and 1")
    say("[7] window 1024: the 1,000-id stream filled the window (24 ids, "
        "'length'); all 4 streams identical at blocks 8 and 1")
    return {"streams": {k: len(v) for k, v in out[8].items()}}


# --------------------------------------------------------------------------
# phase 8
# --------------------------------------------------------------------------


def sse(port: int, body: dict, on_token=None) -> dict:
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps(dict(body, stream=True)).encode(),
        headers={"Content-Type": "application/json"})
    ids, done = [], None
    with urllib.request.urlopen(req, timeout=300) as r:
        for raw in r:
            raw = raw.strip()
            if not raw.startswith(b"data: ") or raw == b"data: [DONE]":
                continue
            ev = json.loads(raw[6:])
            if "token" in ev:
                ids.append(ev["token"])
                if on_token:
                    on_token()
            elif ev.get("done"):
                done = ev
            elif "error" in ev:
                fail(f"serve: SSE error {ev}")
    return {"ids": ids, "done": done}


def phase_serve(torch) -> dict:
    """The port's HTTP server in this process on 127.0.0.1 (an ephemeral
    port) over path (a)'s engine, 8 slots: four concurrent SSE requests
    and one arrival while they run; their ids must equal the engine's own
    for the same prompts, admitted the same way. Then a drain: the
    in-flight stream finishes, a new request is refused with 503."""
    import threading
    import urllib.error
    import urllib.request

    from cake_tpu_torch.models import llama
    from cake_tpu_torch.models.config import llama3_8b
    from cake_tpu_torch.ops.sampling import SamplerSettings
    from cake_tpu_torch.runtime.batch_generator import BatchGenerator
    from cake_tpu_torch.serve.api import start_api_server
    from cake_tpu_torch.serve.scheduler import Scheduler

    cfg = llama3_8b(num_hidden_layers=SERVE_LAYERS,
                    max_seq_len=4096)
    prompts, quotas = serve_prompts(torch, cfg)
    params = llama.init_params(cfg, seed=SEED)
    settings = SamplerSettings(temperature=0)
    # the engine's own ids: 8 slots, each request admitted with enqueue
    # as the server admits it
    ref = BatchGenerator(cfg, params, settings=settings, block_size=8)
    streams = drive_batch(torch, ref, [[cfg.bos_token_id]] * 8, [1] * 8,
                          list(zip(prompts, quotas)), after=8)[0]
    want = [streams[8 + i] for i in range(len(prompts))]
    del ref
    torch.cuda.empty_cache()

    engine = BatchGenerator(cfg, params, settings=settings, block_size=8)
    sched = Scheduler(engine, queue_depth=8, request_timeout_s=300)
    sched.start(max_concurrent=8, warm_prompt_len=64)
    server = start_api_server(sched, bind="127.0.0.1", port=0)
    port = server.port
    got, started = {}, threading.Event()
    counts = [0] * 4

    def client(i):
        def on_token():
            counts[i] += 1
            if all(c >= 2 for c in counts):
                started.set()
        got[i] = sse(port, {"prompt_ids": prompts[i],
                            "max_tokens": quotas[i]}, on_token)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    if not started.wait(timeout=300):
        fail("serve: the four streams never started")
    got[4] = sse(port, {"prompt_ids": prompts[4], "max_tokens": quotas[4]})
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    for i in range(5):
        if got.get(i) is None or got[i]["ids"] != want[i]:
            fail(f"serve: request {i}'s SSE ids differ from the engine's: "
                 f"{(got.get(i) or {}).get('ids')} vs {want[i]}")
    ttft = [got[i]["done"]["usage"]["ttft_ms"] for i in range(5)]
    n_tok = sum(len(got[i]["ids"]) for i in range(5))
    say(f"[8] serve: 5 SSE streams equal the engine's ids; {n_tok} tokens "
        f"in {wall:.3f} s; TTFT ms (server usage) {ttft}, the mid-run "
        f"arrival's {ttft[4]}")
    # drain while a stream is in flight: it finishes; a new request is
    # refused with 503 until the listener closes
    live = threading.Event()
    tail = {}

    def long_client():
        tail["r"] = sse(port, {"prompt_ids": prompts[1], "max_tokens": 48},
                        on_token=live.set)

    t = threading.Thread(target=long_client)
    t.start()
    if not live.wait(timeout=300):
        fail("serve: the drain's in-flight stream never started")
    drainer = threading.Thread(target=server.drain,
                               kwargs={"timeout_s": 300})
    drainer.start()
    deadline = time.time() + 30
    refused = None
    while refused is None and time.time() < deadline:
        try:
            with urllib.request.urlopen(urllib.request.Request(
                    f"http://127.0.0.1:{port}/v1/completions",
                    data=json.dumps({"prompt_ids": [1, 2],
                                     "max_tokens": 2}).encode()),
                    timeout=30):
                pass
        except urllib.error.HTTPError as e:
            refused = e.code
        except urllib.error.URLError as e:  # the listener already closed
            refused = str(e)
        time.sleep(0.01)
    t.join(timeout=300)
    drainer.join(timeout=300)
    sched.close()
    if refused != 503:
        fail(f"serve: a request during the drain got {refused}, want 503")
    if len(tail.get("r", {}).get("ids", [])) != 48:
        fail("serve: the in-flight stream did not finish during the drain")
    say("[8] serve drain: the in-flight stream finished (48 ids), a new "
        "request got 503, the listener closed")
    del engine, params
    torch.cuda.empty_cache()
    return {"ttft_ms": ttft, "tokens": n_tok, "wall_s": wall}


# --------------------------------------------------------------------------
# phase 9
# --------------------------------------------------------------------------

# the reference's deployment of record (examples/topology.yaml), two
# workers serving layers 0-19 and 20-31 of 32, at MAIN_LAYERS: 0-4 and
# 5-7; then the master running 0-1 itself over one int8-cache worker
# serving 2-7
CROSS_HOST_PATHS = (
    ("(a) bf16, w1 0-4 + w2 5-7", "bf16", None, {"w1": (0, 5),
                                                "w2": (5, 8)}),
    ("(b) int8 weights, master 0-1 (bf16 cache) + w1 2-7 (int8 cache)",
     "quant_matmul", "int8", {"w1": (2, 8)}),
)


def served_layers(nodes: dict) -> set:
    return {i for lo, hi in nodes.values() for i in range(lo, hi)}


def deployment_cache(cfg, nodes: dict, kv_quant):
    """The single-device generator's cache laid out as the deployment's:
    the workers' layers in ``kv_quant``'s cache, the master's in the
    model's dtype (a master's local segments keep no int8 cache)."""
    from types import SimpleNamespace

    from cake_tpu_torch.ops.kvcache import init_cache

    plain = init_cache(cfg, device="cuda")
    if kv_quant is None:
        return plain
    quant = init_cache(cfg, device="cuda", quant=kv_quant)
    remote = served_layers(nodes)
    pick = [quant if i in remote else plain
            for i in range(cfg.num_hidden_layers)]
    return SimpleNamespace(k=[c.k[i] for i, c in enumerate(pick)],
                           v=[c.v[i] for i, c in enumerate(pick)],
                           max_seq=plain.max_seq)


def deployment_launches(cfg, weights, kv_quant, nodes, prefill_calls,
                        decode_steps) -> dict:
    """``expected_launches`` with the attention of the workers' layers on
    ``kv_quant``'s kernels and the master's on the model dtype's."""
    counts = expected_launches(cfg, weights, None, prefill_calls,
                               decode_steps)
    q8 = len(served_layers(nodes)) if kv_quant else 0
    for kind, n in (("prefill", prefill_calls), ("decode", decode_steps)):
        counts[f"flash_{kind}"] -= q8 * n
        counts[f"flash_{kind}_q8"] += q8 * n
    return counts


def start_workers(cfg, params, nodes: dict, kv_quant):
    """One ``Worker`` a node, each in a background thread on an ephemeral
    loopback port, serving views of ``params``' stacked layers (nothing is
    copied); returns the workers and the master's topology over them."""
    from cake_tpu_torch.parallel.topology import Topology
    from cake_tpu_torch.runtime.worker import Worker

    def names(lo, hi):
        return [f"model.layers.{i}" for i in range(lo, hi)]

    topo = Topology.from_dict({n: {"layers": names(*r)}
                               for n, r in nodes.items()})

    def loader(lo, hi):
        return {k: v[lo:hi] for k, v in params["layers"].items()}

    workers = {}
    for name in nodes:
        workers[name] = Worker(name, cfg, topo, loader,
                               address="127.0.0.1:0", kv_quant=kv_quant)
        workers[name].serve_in_background()
    master_topo = Topology.from_dict({
        n: {"host": f"127.0.0.1:{w.port}", "layers": names(*nodes[n])}
        for n, w in workers.items()})
    return workers, master_topo, loader


def keep_logits(gen) -> list:
    """Every step's f32 logits of ``gen`` (both generators sample through
    ``_sample``), copied to the host."""
    out, real = [], gen._sample

    def keep(logits, index):
        out.append(logits.float().cpu())
        return real(logits, index)

    gen._sample = keep
    return out


def logits_diff(torch, got: list, want: list) -> dict:
    """Steps whose logits differ in any bit, the largest absolute
    difference, and the worst step's relative L2 (a row is one step's
    logits)."""
    n = min(len(got), len(want))
    rel = [((got[i] - want[i]).norm() / want[i].norm()).item()
           for i in range(n)]
    return {"steps": n,
            "unequal_steps": sum(not torch.equal(got[i], want[i])
                                 for i in range(n)),
            "max_abs": max((got[i] - want[i]).abs().max().item()
                           for i in range(n)),
            "worst_row_rel_l2": max(rel)}


def drive_stream(torch, gen, prompt, n_new) -> dict:
    """Set ``prompt`` and draw ``n_new`` tokens: ids, host-clock TTFT
    (``next_token(0)`` with its prefill) and decode tokens/s."""
    gen.set_prompt(prompt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = [gen.next_token(0).id]
    t1 = time.perf_counter()
    ids += [gen.next_token(i).id for i in range(1, n_new)]
    t2 = time.perf_counter()
    return {"ids": ids, "ttft_ms": (t1 - t0) * 1e3,
            "decode_tokens_per_s": (n_new - 1) / (t2 - t1)}


def cross_host_path(torch, build, cfg, params, prompt, label, weights,
                    kv_quant, nodes) -> dict:
    """One deployment on this card: the single-device ``LlamaGenerator``
    (block 1, its cache laid out as the deployment's) for the reference
    stream and logits, then the master over its workers through the
    library the command line uses. Fails unless
    every step's logits are the reference's bit for bit, the ids equal,
    and each kernel launched as the model calls say; then a planted fault
    (a worker decoding one position late) must fail the same check."""
    from cake_tpu_torch import obs
    from cake_tpu_torch.ops.sampling import SamplerSettings
    from cake_tpu_torch.runtime.generator import LlamaGenerator
    from cake_tpu_torch.runtime.master import (
        DistributedGenerator,
        build_runners,
    )

    n_new = 64
    greedy = SamplerSettings(temperature=0)
    ref_gen = LlamaGenerator(cfg, params, settings=greedy, block_size=1)
    ref_gen.cache = deployment_cache(cfg, nodes, kv_quant)
    drive_stream(torch, ref_gen, prompt, 4)  # warm: neither timed nor kept
    ref_logits = keep_logits(ref_gen)
    ref = drive_stream(torch, ref_gen, prompt, n_new)
    del ref_gen
    workers, topo, loader = start_workers(cfg, params, nodes, kv_quant)
    head = {k: params[k] for k in ("embed", "norm_f", "lm_head")}

    def master():
        return DistributedGenerator(
            cfg, head, build_runners(cfg, topo, loader,
                                     max_seq=cfg.max_seq_len),
            settings=greedy)

    gen = None
    try:
        gen = master()  # a warm-up master: neither timed nor counted
        drive_stream(torch, gen, prompt, 4)
        gen.close()
        gen = master()
        transport = {r.ident(): "native" if r.conn.is_native else "python"
                     for r in gen.runners if r.ident() != "local"}
        logits = keep_logits(gen)
        rec = obs.flight.recorder()
        rec.enable()
        rec.clear()
        p0, d0 = gen.prefill_calls, gen.decode_steps
        torch.cuda.synchronize()
        build.reset_launches()
        run = drive_stream(torch, gen, prompt, n_new)
        torch.cuda.synchronize()
        counts = build.launches()
        records = rec.records()
        rec.disable()
        want = deployment_launches(cfg, weights, kv_quant, nodes,
                                   gen.prefill_calls - p0,
                                   gen.decode_steps - d0)
        diff = logits_diff(torch, logits, ref_logits)
        say(f"[9] {label}: transport {transport}; launches {counts} "
            f"(master and workers); logits against the single-device "
            f"generator over {diff['steps']} steps: {diff['unequal_steps']} "
            f"steps differ, max abs {diff['max_abs']:.3e}, worst row "
            f"relative L2 {diff['worst_row_rel_l2']:.3e}")
        if counts != want or gen.prefill_calls - p0 != 1:
            fail(f"{label}: kernels launched {counts}, want {want}")
        if diff["steps"] != n_new or diff["unequal_steps"]:
            fail(f"{label}: logits differ from the single-device "
                 f"generator's at {diff['unequal_steps']} of "
                 f"{diff['steps']} steps (worst row relative L2 "
                 f"{diff['worst_row_rel_l2']:.3e})")
        if run["ids"] != ref["ids"]:
            fail(f"{label}: greedy ids differ from the single-device "
                 f"stream: {run['ids']} vs {ref['ids']}")
        segs = gen.runner_stats()
        dec = [r for r in records if r["kind"] == "decode"]
        pre = [r for r in records if r["kind"] == "prefill"]

        def mean(key, recs):
            return sum(r[key] for r in recs) / len(recs)

        result = {
            "path": f"cross-host {label}", "launches": counts,
            "transport": transport, "logits": diff,
            "ttft_ms": run["ttft_ms"],
            "decode_tokens_per_s": run["decode_tokens_per_s"],
            "single_device_block_1": {
                "ttft_ms": ref["ttft_ms"],
                "decode_tokens_per_s": ref["decode_tokens_per_s"]},
            "segments": [{k: seg[k] for k in ("ident", "layers", "calls",
                                              "avg_ms", "p50_ms", "p99_ms",
                                              "warmup_ms")}
                         for seg in segs],
            "decode_wire_bytes_per_token": mean("wire_bytes_out", dec)
            + mean("wire_bytes_in", dec),
            "prefill_wire_bytes": pre[0]["wire_bytes_out"]
            + pre[0]["wire_bytes_in"],
            "decode_serialize_ms": mean("serialize_ms", dec),
            "decode_deserialize_ms": mean("deserialize_ms", dec),
            "prefill_serialize_ms": pre[0]["serialize_ms"],
            "prefill_deserialize_ms": pre[0]["deserialize_ms"],
        }
        say(f"[9] {label}: TTFT {run['ttft_ms']:.2f} ms, decode "
            f"{run['decode_tokens_per_s']:.2f} tokens/s (host clock; the "
            f"single-device generator at block 1 in this phase: "
            f"{ref['ttft_ms']:.2f} ms, {ref['decode_tokens_per_s']:.2f} "
            f"tokens/s); wire bytes a decode token "
            f"{result['decode_wire_bytes_per_token']:.0f} (prefill "
            f"{result['prefill_wire_bytes']}); serialize / deserialize ms "
            f"a decode token {result['decode_serialize_ms']:.3f} / "
            f"{result['decode_deserialize_ms']:.3f} (prefill "
            f"{result['prefill_serialize_ms']:.3f} / "
            f"{result['prefill_deserialize_ms']:.3f})")
        for seg in result["segments"]:
            say(f"[9] {label} segment {seg['layers']} @ {seg['ident']}: "
                f"{seg['calls']} steady calls, {seg['avg_ms']:.3f} ms avg "
                f"(p50 {seg['p50_ms']:.3f}, p99 {seg['p99_ms']:.3f}), "
                f"prefill {seg['warmup_ms']:.2f} ms")
        result["prefill_breakdown"] = prefill_breakdown(torch, gen, prompt,
                                                        label)
        result["profile"] = profile_cross_host(torch, gen, n_new, label)
        result["planted"] = planted_late_position(
            torch, gen, workers, prompt, ref_logits, label)
        return result
    finally:
        if gen is not None:
            gen.close()
        for w in workers.values():
            w.shutdown()


def prefill_breakdown(torch, gen, prompt, label) -> list:
    """One traced prefill (the master's spans and the workers' span
    digests): for each segment its wall ms on the master and, for a
    remote one, the master's send of the request, the worker's handling
    (decode, forward with its host copies, encode) and the rest of the
    round trip (the worker's receive, the reply's transfer, the master's
    receive)."""
    from cake_tpu_torch.obs import trace as obs_trace

    tr = obs_trace.tracer()
    tr.start()
    try:
        gen.set_prompt(prompt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen.next_token(0)
        ttft = (time.perf_counter() - t0) * 1e3
    finally:
        tr.stop()
    pid = os.getpid()
    xs = [e for e in tr.to_chrome_trace()["traceEvents"] if e["ph"] == "X"]

    def spans(name, remote=False):
        return [e["dur"] / 1e3 for e in xs if e["name"] == name
                and (e["pid"] != pid) == remote]

    segs = spans("decode.segment")
    rtt, send = spans("segment.remote_rtt"), spans("wire.send")
    handle = {n: spans(f"ops.{n}", remote=True)
              for n in ("handle", "decode", "forward", "encode")}
    hops = [{"rtt_ms": rtt[i], "send_ms": send[i],
             "worker_decode_ms": handle["decode"][i],
             "worker_forward_ms": handle["forward"][i],
             "worker_encode_ms": handle["encode"][i],
             "rest_ms": rtt[i] - send[i] - handle["handle"][i]}
            for i in range(len(rtt))]
    say(f"[9] {label} traced prefill: TTFT {ttft:.2f} ms; segments ms "
        f"{[round(x, 2) for x in segs]}; remote hops "
        f"{[{k: round(v, 2) for k, v in h.items()} for h in hops]}")
    return {"ttft_ms": ttft, "segments_ms": segs, "hops": hops}


def profile_cross_host(torch, gen, index0, label, phase: int = 9) -> dict:
    """Card time of 8 decode steps from a profiler trace, beside the host
    clock's time for 8 unprofiled steps: the card's busy share a step."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(index0, index0 + 8):
        gen.next_token(i)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 8
    prof = device_profile(torch, lambda: [
        gen.next_token(i) for i in range(index0 + 8, index0 + 16)])
    prof.pop("kernels")
    prof["device_ms_per_step"] = prof["device_ms"] / 8
    prof["wall_ms_per_step"] = wall_ms
    prof["busy_share"] = prof["device_ms_per_step"] / wall_ms
    say(f"[{phase}] {label} decode step: "
        f"{prof['device_ms_per_step']:.3f} ms of "
        f"card kernel time over {prof['kernel_launches'] / 8:.1f} launches,"
        f" {wall_ms:.3f} ms on the host clock: card busy "
        f"{100 * prof['busy_share']:.1f}%; top {prof['top']}")
    return prof


def planted_late_position(torch, gen, workers, prompt, ref_logits,
                          label) -> dict:
    """The last worker decodes every token one position late; the logits
    check must fail on it."""
    w = list(workers.values())[-1]
    real = w._run_ops

    def late(x, ops, caches):
        if x.shape[1] == 1:
            ops = [(name, pos + 1) for name, pos in ops]
        return real(x, ops, caches)

    w._run_ops = late
    try:
        logits = keep_logits(gen)
        drive_stream(torch, gen, prompt, 8)
    finally:
        w._run_ops = real
    diff = logits_diff(torch, logits, ref_logits[:8])
    say(f"[9] {label} planted fault ({w.name} decodes one position late): "
        f"{diff['unequal_steps']} of {diff['steps']} steps differ, worst "
        f"row relative L2 {diff['worst_row_rel_l2']:.3e}")
    if not diff["unequal_steps"]:
        fail(f"{label}: a worker decoding one position late passed the "
             "logits check")
    return diff


def phase_cross_host(torch, build, main_path) -> list:
    """The master over loopback workers at full Llama-3-8B width and
    MAIN_LAYERS (phase 5's seed-0 weights and 2,000-id prompt), 64 greedy
    tokens a path, beside phase 5's numbers of the same weights."""
    from cake_tpu_torch.models import llama
    from cake_tpu_torch.models.config import llama3_8b

    cfg = llama3_8b(num_hidden_layers=MAIN_LAYERS, max_seq_len=4096)
    prompt = torch.randint(0, cfg.vocab_size, (2000,),
                           generator=torch.Generator().manual_seed(SEED)
                           ).tolist()
    inits = {"bf16": lambda: llama.init_params(cfg, seed=SEED),
             "quant_matmul": lambda: llama.init_params_int8(cfg, seed=SEED)}
    results = []
    for (label, weights, kv_quant, nodes), p5 in zip(CROSS_HOST_PATHS,
                                                      main_path):
        params = inits[weights]()
        r = cross_host_path(torch, build, cfg, params, prompt, label,
                            weights, kv_quant, nodes)
        greedy5 = p5["runs"][0]
        r["phase5"] = {"path": p5["path"],
                       "prefill_ms": greedy5["prefill_ms"],
                       "decode_tokens_per_s": greedy5["decode_tokens_per_s"],
                       "decode_device_ms_per_step":
                           p5["profile"]["decode_block_8"][
                               "device_ms_per_step"]}
        say(f"[9] {label} beside phase 5 {p5['path']} (block 8, one "
            f"process, no wire): TTFT {r['ttft_ms']:.2f} vs "
            f"{greedy5['prefill_ms']:.2f} ms; decode "
            f"{r['decode_tokens_per_s']:.2f} vs "
            f"{greedy5['decode_tokens_per_s']:.2f} tokens/s; card ms a "
            f"decode step {r['profile']['device_ms_per_step']:.3f} vs "
            f"{r['phase5']['decode_device_ms_per_step']:.3f}")
        results.append(r)
        del params
        torch.cuda.empty_cache()
    return results


def worker_port(proc, log: Path) -> int:
    """The port a ``--mode worker`` process bound itself (``--address
    127.0.0.1:0``), from its "listening on port N" log line."""
    deadline = time.time() + 300
    while time.time() < deadline:
        m = re.search(r"listening on port (\d+)", log.read_text())
        if m:
            return int(m.group(1))
        if proc.poll() is not None:
            fail(f"a --mode worker exited with {proc.returncode}: "
                 f"{log.read_text()[-2000:]}")
        time.sleep(0.2)
    fail(f"a --mode worker named no port in 300 s: "
         f"{log.read_text()[-2000:]}")


def phase_cli_topology(torch, build, local_ids: dict) -> dict:
    """Phase 6's runs again over the cross-host path: two ``--mode
    worker`` processes on the card (layers 0 and 1 of the tiny checkpoint,
    each on the port it bound itself) and the master command line with a
    JSON ``--topology`` naming those ports; its ids must equal phase 6's."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = {}
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as d:
        cfg = write_cli_checkpoint(torch, build, d)
        layers = {f"w{i}": [f"model.layers.{i}"] for i in range(2)}
        own = Path(d) / "workers.json"
        own.write_text(json.dumps({n: {"layers": ls}
                                   for n, ls in layers.items()}))
        for label, flags, master_flags in CLI_FLAGS:
            logs = {n: Path(d) / f"{n}.log" for n in layers}
            procs = {}
            try:
                for n in layers:
                    with open(logs[n], "w") as log:
                        procs[n] = subprocess.Popen(
                            [sys.executable, "-m", "cake_tpu_torch.cli",
                             "--mode", "worker", "--name", n, "--model", d,
                             "--topology", str(own), "--address",
                             "127.0.0.1:0", "--max-seq", "128", *flags],
                            stdout=subprocess.DEVNULL, stderr=log, env=env,
                            cwd=REPO)
                topo = Path(d) / "topology.json"
                topo.write_text(json.dumps({
                    n: {"host": f"127.0.0.1:{worker_port(procs[n], logs[n])}",
                        "layers": ls} for n, ls in layers.items()}))
                r = subprocess.run(
                    [sys.executable, "-m", "cake_tpu_torch.cli", "--model",
                     d, *CLI_RUN, "--topology", str(topo),
                     "--connect-retries", "100", *master_flags],
                    capture_output=True, text=True, timeout=300, env=env,
                    cwd=REPO)
            finally:
                for proc in procs.values():
                    proc.terminate()
                for proc in procs.values():
                    try:
                        proc.wait(timeout=60)
                    except subprocess.TimeoutExpired:
                        proc.kill()
                        proc.wait()
            what = (f"topology master {master_flags} over workers "
                    f"{flags}")
            out[label] = cli_ids(r, cfg, what)
            segs = [ln.split("cake_tpu_torch.cli: ")[-1]
                    for ln in r.stderr.splitlines() if "segment " in ln]
            say(f"[9] cli {what}: {','.join(map(str, out[label]))}; "
                f"{segs}")
            if out[label] != local_ids[label]:
                fail(f"{what} printed {out[label]}, phase 6's local run "
                     f"{local_ids[label]}")
    return out


# --------------------------------------------------------------------------
# phase 10
# --------------------------------------------------------------------------


class AsciiTok:
    """Phase 10's tokenizer: id ``i`` decodes to one printable ASCII
    character, ``chr(32 + i % 95)``, over all 128,256 ids of Llama-3-8B
    (many ids a character, like merged BPE entries)."""

    def decode(self, ids):
        return "".join(chr(32 + (i % 95)) for i in ids)

    def encode(self, text):
        return [ord(c) - 32 for c in text]


GUIDE_REGEX = "[0-9]{1,6};"
GUIDE_SCHEMA = {"type": "object",
                "properties": {"a": {"type": "integer"},
                               "ok": {"type": "boolean"}},
                "required": ["a", "ok"]}
# a guided stream's token cap: the schema's longest stream is 30 tokens and
# EOS, the regex's 7 and EOS
GUIDED_MAX = 48
# the plain streams' tokens beside the guided ones at 8 slots
GUIDED_BATCH_NEW = 40
# the lookahead runs: tokens a run, runs a mode
LOOKAHEAD_NEW = 64
LOOKAHEAD_RUNS = 3


def compile_guides(cfg) -> dict:
    """The regex and the schema as token DFAs over the 128,256 ids, each
    compiled (not loaded: the cache directory is new): ``name ->
    (pattern, dfa, compile ms)``."""
    from cake_tpu_torch.constrain import fsm

    t0 = time.perf_counter()
    vocab = fsm.token_strings(AsciiTok(), cfg.vocab_size)
    say(f"[10] vocab strings of {cfg.vocab_size} ids in "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    out = {}
    for name, pattern in (("regex", GUIDE_REGEX),
                          ("schema", fsm.json_schema_to_regex(GUIDE_SCHEMA))):
        t0 = time.perf_counter()
        dfa = fsm.compile_constraint(pattern, vocab, eos_ids=cfg.eos_ids())
        ms = (time.perf_counter() - t0) * 1e3
        out[name] = (pattern, dfa, ms)
        say(f"[10] grammar {name} {pattern!r}: compiled over "
            f"{cfg.vocab_size} ids in {ms:.1f} ms; {dfa.mask_bits.shape[0]} "
            f"states, mask table {dfa.mask_bits.nbytes} bytes")
    return out


def check_guided(torch, what, pattern, dfa, ids, eos, logits=None) -> str:
    """Replay a guided stream through its DFA: every token allowed at its
    state (and, given each step's logits, the argmax of the masked
    logits); the text fullmatches the pattern when EOS ends the stream,
    else the last state is a dead end. Returns the end reason."""
    state = dfa.start
    for j, t in enumerate(ids):
        if not (int(dfa.mask_bits[state, t >> 3]) >> (t & 7)) & 1:
            fail(f"{what}: token {j} ({t}) is not allowed at DFA state "
                 f"{state}")
        if logits is not None:
            mask = torch.from_numpy(dfa.mask_bool(state))
            best = int(torch.where(mask, logits[j], -torch.inf).argmax())
            if best != t:
                fail(f"{what}: token {j} is {t}, the argmax of the masked "
                     f"logits is {best}")
        if t in eos:
            if j != len(ids) - 1:
                fail(f"{what}: tokens after EOS")
            break
        state = int(dfa.trans[state, t])
    text = AsciiTok().decode([t for t in ids if t not in eos])
    if ids[-1] in eos:
        if not re.fullmatch(pattern, text):
            fail(f"{what}: {text!r} does not fullmatch {pattern!r}")
        return "eos"
    if dfa.mask_bits[state].any():
        fail(f"{what}: {len(ids)} tokens and no end ({text!r})")
    return "constraint"


def guided_stream(torch, gen, prompt, dfa, n_max=GUIDED_MAX) -> dict:
    """One guided stream to its end (or ``n_max`` tokens): ids, prefill ms
    and decode ms a token on the host clock."""
    from cake_tpu_torch.constrain import Guide

    gen.set_prompt(prompt)
    gen.set_guide(None if dfa is None else Guide(dfa))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tok = gen.next_token(0)
    ids = [tok.id]
    t1 = time.perf_counter()
    while not tok.is_end_of_stream and len(ids) < n_max:
        tok = gen.next_token(len(ids))
        ids.append(tok.id)
    t2 = time.perf_counter()
    return {"ids": ids, "prefill_ms": (t1 - t0) * 1e3,
            "decode_ms_per_token": (t2 - t1) * 1e3 / max(1, len(ids) - 1)}


def guided_single(torch, build, cfg, params, prompt, guides) -> dict:
    """(i) ``LlamaGenerator`` greedy under each guide: allowed tokens, the
    argmax of the masked logits at every step (a second, logit-keeping run
    of the same stream), the end; launches exact; host ms a token beside an
    unguided stream of as many tokens stepping one token at a time, run
    just after it."""
    from cake_tpu_torch.ops.sampling import SamplerSettings
    from cake_tpu_torch.runtime.generator import LlamaGenerator

    # penalty 1: the greedy choice is the argmax of the masked logits
    settings = SamplerSettings(temperature=0, repeat_penalty=1.0)
    eos = set(cfg.eos_ids())

    def new(block):
        return LlamaGenerator(cfg, params, tokenizer=AsciiTok(),
                              settings=settings, block_size=block)

    for dfa in (guides["regex"][1], None):  # warm-up, not counted
        guided_stream(torch, new(1), prompt, dfa)
    build.reset_launches()
    calls = [0, 0]
    out = {"path": "(i) guided single stream", "streams": {}}
    for name, (pattern, dfa, compile_ms) in guides.items():
        gen = new(8)
        run = guided_stream(torch, gen, prompt, dfa)
        free = new(1)
        plain = guided_stream(torch, free, prompt, None, len(run["ids"]))
        run["unguided_block1_ms_per_token"] = plain["decode_ms_per_token"]
        kept = new(8)
        logits = keep_logits(kept)
        again = guided_stream(torch, kept, prompt, dfa)["ids"]
        for g in (gen, free, kept):
            calls[0] += g.prefill_calls
            calls[1] += g.decode_steps
        if again != run["ids"]:
            fail(f"[10] guided {name}: two runs differ")
        end = check_guided(torch, f"[10] guided {name}", pattern, dfa,
                           run["ids"], eos, logits)
        if gen.decode_steps != len(run["ids"]) - 1:
            fail(f"[10] guided {name}: {gen.decode_steps} decode steps for "
                 f"{len(run['ids'])} tokens: a block ran under a guide")
        run.update(end=end, compile_ms=compile_ms,
                   text=AsciiTok().decode([t for t in run["ids"]
                                           if t not in eos]))
        out["streams"][name] = run
        say(f"[10] (i) guided {name}: {len(run['ids'])} tokens, end {end}, "
            f"text {run['text']!r}; every token allowed and the argmax of "
            f"the masked logits; prefill {run['prefill_ms']:.2f} ms, decode "
            f"{run['decode_ms_per_token']:.3f} ms a token (unguided, one "
            f"token a step, as many tokens just after: "
            f"{plain['decode_ms_per_token']:.3f})")
    counts = build.launches()
    want = expected_launches(cfg, "bf16", None, *calls)
    say(f"[10] (i) launches {counts}; prefill calls {calls[0]}, decode "
        f"steps {calls[1]}")
    if counts != want:
        fail(f"[10] (i): kernels launched {counts}, want {want}")
    out["launches"] = counts
    # one masked step and one unguided single step under the profiler,
    # after the counted runs: card ms and launches a step
    for key, dfa in (("guided_step", guides["schema"][1]),
                     ("unguided_step", None)):
        gen = new(1)
        guided_stream(torch, gen, prompt, dfa, 2)
        prof = device_profile(torch, lambda: gen.next_token(2))
        prof.pop("kernels")
        out[key] = prof
        say(f"[10] (i) profile of one {key.replace('_', ' ')}: "
            f"{prof['device_ms']:.3f} ms of card kernel time over "
            f"{prof['kernel_launches']} launches")
    return out


def guided_batch(torch, build, cfg, params, guides) -> dict:
    """(ii) The batch engine at 8 slots (phase 7's prompts), greedy, the
    regex guiding slot 2 and the schema slot 5: the six plain streams'
    ids equal an unguided run of the same engine (a difference is allowed
    only after a top-1/top-2 tie, and printed); the guided streams'
    tokens are allowed and end their grammars; while a guide is live the
    batch takes masked single steps, and fused blocks resume once the
    last one retires; launches exact."""
    from cake_tpu_torch.constrain import Guide
    from cake_tpu_torch.ops.sampling import SamplerSettings
    from cake_tpu_torch.runtime.batch_generator import BatchGenerator

    prompts, _ = batch_prompts(torch, cfg)
    settings = SamplerSettings(temperature=0)
    eos = set(cfg.eos_ids())
    guided = {2: "regex", 5: "schema"}

    def new():
        return BatchGenerator(cfg, params, tokenizer=AsciiTok(),
                              settings=settings, block_size=8)

    ref = new()
    ref.set_prompts(prompts)
    want = ref.generate(GUIDED_BATCH_NEW)
    ref.warm_constrain()  # the masked step, built and run once
    del ref
    torch.cuda.empty_cache()

    g = new()
    sizes, real = [], g._dispatch

    def dispatch(size, masked=False):
        sizes.append((size, masked, g._guides_live()))
        return real(size, masked)

    g._dispatch = dispatch
    build.reset_launches()
    g.set_prompts(prompts, guides=[Guide(guides[guided[i]][1])
                                   if i in guided else None
                                   for i in range(len(prompts))])
    g.step()  # the prefill's tokens
    masked_ms, prof = [], None
    while g._guides_live():
        if len(masked_ms) == 2 and prof is None:  # the third masked step
            prof = device_profile(torch, g.step)
            continue
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g.step()
        masked_ms.append((time.perf_counter() - t0) * 1e3)
    while any(not s.done and len(s.generated) < GUIDED_BATCH_NEW
              for s in g.streams):
        g.step()
    counts = build.launches()
    calls = (g.prefill_calls, g.decode_steps)
    if counts != expected_launches(cfg, "bf16", None, *calls):
        fail(f"[10] (ii): kernels launched {counts} for {calls}")
    if any(size != 1 or not masked for size, masked, live in sizes if live):
        fail(f"[10] (ii): a live guide's batch took a block: {sizes}")
    after = [size for size, _, live in sizes if not live]
    if not after or after[0] != 8:
        fail(f"[10] (ii): no fused block after the guides retired: {sizes}")
    prof.pop("kernels")
    out = {"path": "(ii) guided batch", "launches": counts,
           "masked_steps": sum(1 for _, m, _ in sizes if m),
           "blocks_after": len(after),
           "masked_step_ms": sorted(masked_ms)[len(masked_ms) // 2],
           "masked_step_profile": prof, "streams": {}}
    for slot, name in guided.items():
        pattern, dfa, _ = guides[name]
        ids = g.streams[slot].generated
        end = check_guided(torch, f"[10] (ii) slot {slot} {name}", pattern,
                           dfa, ids, eos)
        if g.streams[slot].end_reason != end:
            fail(f"[10] (ii) slot {slot}: end reason "
                 f"{g.streams[slot].end_reason}, want {end}")
        out["streams"][name] = {"ids": len(ids), "end": end,
                                "text": AsciiTok().decode(
                                    [t for t in ids if t not in eos])}
    equal, turned = 0, []
    for slot in range(len(prompts)):
        if slot in guided:
            continue
        got = g.streams[slot].generated[:GUIDED_BATCH_NEW]
        if got == want[slot]:
            equal += 1
            continue
        j = next(i for i, (a, b) in enumerate(zip(got, want[slot]))
                 if a != b)
        margin = penalized_margins(torch, stream_logits(
            torch, cfg, params, prompts[slot], want[slot], None),
            prompts[slot], want[slot], settings)[j]
        turned.append((slot, j, round(margin, 4)))
        if margin >= MARGIN_TIE:
            fail(f"[10] (ii) plain slot {slot} differs from the unguided "
                 f"run at step {j}, margin {margin:.4f} there")
    out["plain_equal"], out["plain_turned_at_tie"] = equal, turned
    say(f"[10] (ii) 8 slots: guided {out['streams']}; {out['masked_steps']} "
        f"masked single steps ({out['masked_step_ms']:.3f} ms a step, "
        f"median host clock; one profiled: {prof['device_ms']:.3f} ms of "
        f"card over {prof['kernel_launches']} launches), then "
        f"{len(after)} fused blocks; plain streams "
        f"equal to the unguided run: {equal} of 6, turned at a tie "
        f"(slot, step, margin): {turned}; launches {counts}")
    del g
    torch.cuda.empty_cache()
    return out


def guided_serve(torch, build, cfg, params, prompt, guides) -> dict:
    """(iv) The HTTP server in this process over a bf16 engine at 8 slots
    with the ASCII tokenizer: a ``json_schema`` and a ``regex``
    ``response_format`` request; the body parses as the schema's JSON (or
    ends at a dead end with finish reason ``constraint``), the regex
    text fullmatches; launches exact."""
    import urllib.request

    from cake_tpu_torch.ops.sampling import SamplerSettings
    from cake_tpu_torch.runtime.batch_generator import BatchGenerator
    from cake_tpu_torch.serve.api import start_api_server
    from cake_tpu_torch.serve.scheduler import Scheduler

    build.reset_launches()
    engine = BatchGenerator(cfg, params, tokenizer=AsciiTok(),
                            settings=SamplerSettings(temperature=0),
                            block_size=8)
    sched = Scheduler(engine, queue_depth=8, request_timeout_s=300)
    sched.start(max_concurrent=8, warm_prompt_len=64, warm_constrain=True)
    server = start_api_server(sched, bind="127.0.0.1", port=0)
    out = {"path": "(iv) guided serve"}
    try:
        for name, rf in (("json_schema", {"type": "json_schema",
                                          "schema": GUIDE_SCHEMA}),
                         ("regex", {"type": "regex",
                                    "pattern": GUIDE_REGEX})):
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.port}/v1/completions",
                data=json.dumps({"prompt_ids": prompt[:300],
                                 "max_tokens": GUIDED_MAX,
                                 "response_format": rf}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                body = json.loads(r.read())
            reason, text = body["finish_reason"], body["text"]
            if reason == "eos" and name == "json_schema":
                obj = json.loads(text)
                if not (isinstance(obj.get("a"), int)
                        and isinstance(obj.get("ok"), bool)):
                    fail(f"[10] (iv) {name}: {text!r} is not the schema's")
            elif reason == "eos":
                if not re.fullmatch(GUIDE_REGEX, text):
                    fail(f"[10] (iv) {name}: {text!r} does not match")
            elif reason != "constraint":
                fail(f"[10] (iv) {name}: finish reason {reason}")
            out[name] = {"text": text, "finish_reason": reason,
                         "tokens": len(body["token_ids"]),
                         "ttft_ms": body["usage"].get("ttft_ms")}
            say(f"[10] (iv) serve {name}: {text!r}, finish reason {reason}, "
                f"{len(body['token_ids'])} tokens, server TTFT "
                f"{out[name]['ttft_ms']} ms")
    finally:
        server.drain(timeout_s=60)
        sched.close()
    counts = build.launches()
    calls = (engine.prefill_calls, engine.decode_steps)
    if counts != expected_launches(cfg, "bf16", None, *calls):
        fail(f"[10] (iv): kernels launched {counts} for {calls}")
    out["launches"] = counts
    del engine
    torch.cuda.empty_cache()
    return out


def lookahead_path(torch, build, cfg, params, prompt, label, weights,
                   kv_quant) -> dict:
    """(iii) ``LlamaGenerator`` at block 8, greedy, with and without
    lookahead, LOOKAHEAD_RUNS runs each in turns: every stream
    bit-identical, launches exact; decode tokens/s of each run, and the
    card's busy share a step (profiler card time over the host clock's
    time a token)."""
    from cake_tpu_torch.ops.sampling import SamplerSettings
    from cake_tpu_torch.runtime.generator import LlamaGenerator

    settings = SamplerSettings(temperature=0)

    def new(look):
        return LlamaGenerator(cfg, params, settings=settings, block_size=8,
                              kv_quant=kv_quant, lookahead=look)

    for look in (False, True):  # warm-up, not counted
        drive_stream(torch, new(look), prompt, 17)
    build.reset_launches()
    calls, rates, ref = [0, 0], {False: [], True: []}, None
    for r in range(LOOKAHEAD_RUNS):
        for look in ((False, True) if r % 2 == 0 else (True, False)):
            gen = new(look)
            run = drive_stream(torch, gen, prompt, LOOKAHEAD_NEW)
            torch.cuda.synchronize()  # a block may still be in flight
            calls[0] += gen.prefill_calls
            calls[1] += gen.decode_steps
            ref = ref or run["ids"]
            if run["ids"] != ref:
                fail(f"[10] (iii) {label} lookahead={look}: the stream "
                     "differs")
            rates[look].append(run["decode_tokens_per_s"])
            del gen
    counts = build.launches()
    if counts != expected_launches(cfg, weights, kv_quant, *calls):
        fail(f"[10] (iii) {label}: kernels launched {counts} for {calls}")
    out = {"path": f"(iii) lookahead {label}", "launches": counts,
           "tokens_per_s": {"plain": rates[False], "lookahead": rates[True]}}
    for look in (False, True):
        gen = new(look)
        gen.set_prompt(prompt)
        gen.next_token(0)
        d0 = gen.decode_steps
        prof = device_profile(torch, lambda: [gen.next_token(i)
                                              for i in range(1, 17)])
        steps = gen.decode_steps - d0
        card = prof["device_ms"] / steps
        host = 1e3 / (sum(rates[look]) / len(rates[look]))
        out["lookahead" if look else "plain"] = {
            "card_ms_per_step": card, "host_ms_per_token": host,
            "busy_share": card / host, "steps_profiled": steps}
        del gen
    for key, look in (("plain", False), ("lookahead", True)):
        r, o = rates[look], out[key]
        say(f"[10] (iii) {label} {key}: decode tokens/s "
            f"{[round(x, 2) for x in r]} (spread {max(r) - min(r):.2f}); "
            f"card {o['card_ms_per_step']:.3f} ms a step, host "
            f"{o['host_ms_per_token']:.3f} ms a token: busy "
            f"{100 * o['busy_share']:.1f}%")
    say(f"[10] (iii) {label}: {2 * LOOKAHEAD_RUNS} streams bit-identical "
        f"({LOOKAHEAD_NEW} tokens); launches {counts}")
    return out


def guided_cli(torch, build, local_ids: dict) -> dict:
    """(v) The command line over phase 6's tiny checkpoint: ``--lookahead``
    prints phase 6's bf16 ids; ``--window 8`` over a 12-id prompt prints
    the ids of an in-process ``LlamaGenerator`` with the window set to 8
    (and not those of the full context); ``--logit-bias 7:100`` prints only
    7; ``--trace``, ``--metrics-out``, ``--flight-log`` and ``--profile``
    write files that parse and hold the JAX command line's span and metric
    names, and the card's kernels in the profile."""
    from cake_tpu_torch.models.config import tiny
    from cake_tpu_torch.ops.sampling import SamplerSettings
    from cake_tpu_torch.runtime.generator import LlamaGenerator
    from cake_tpu_torch.utils.weights import load_llama_params

    env = dict(os.environ, PYTHONPATH=str(REPO))
    long_prompt = list(range(3, 27, 2))
    out = {}
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as d:
        cfg = write_cli_checkpoint(torch, build, d)

        def run(extra, prompt=None):
            args = list(CLI_RUN)
            if prompt is not None:
                args[1] = ",".join(map(str, prompt))
            r = subprocess.run(
                [sys.executable, "-m", "cake_tpu_torch.cli", "--model", d,
                 *args, *extra], capture_output=True, text=True,
                timeout=300, env=env, cwd=REPO)
            return cli_ids(r, cfg, f"cli {' '.join(extra)}")

        out["lookahead"] = run(["--lookahead"])
        if out["lookahead"] != local_ids["bf16"]:
            fail(f"[10] (v) --lookahead printed {out['lookahead']}, phase "
                 f"6's bf16 run {local_ids['bf16']}")
        out["window"] = run(["--window", "8"], long_prompt)
        full = run([], long_prompt)
        wcfg = tiny(**CLI_CFG, sliding_window=8)
        gen = LlamaGenerator(wcfg, load_llama_params(
            d, wcfg.num_hidden_layers, dtype=wcfg.dtype, device="cuda"),
            settings=SamplerSettings(temperature=0), max_seq=128,
            block_size=8)
        gen.set_prompt(long_prompt)
        want = [gen.next_token(i).id for i in range(8)]
        if out["window"] != want or want == full:
            fail(f"[10] (v) --window 8 printed {out['window']}; the "
                 f"generator with window 8 {want}, the full context {full}")
        out["logit_bias"] = run(["--logit-bias", "7:100"])
        if set(out["logit_bias"]) != {7}:
            fail(f"[10] (v) --logit-bias 7:100 printed {out['logit_bias']}")
        obs = Path(d) / "obs"
        files = {"trace": obs / "t.json", "metrics": obs / "m.json",
                 "flight": obs / "f.jsonl", "profile": obs / "prof"}
        obs.mkdir()
        out["obs"] = run(["--trace", str(files["trace"]), "--metrics-out",
                          str(files["metrics"]), "--flight-log",
                          str(files["flight"]), "--profile",
                          str(files["profile"])])
        spans = {e["name"] for e in json.loads(files["trace"].read_text())[
            "traceEvents"] if e.get("ph") == "X"}
        metrics = json.loads(files["metrics"].read_text())
        kinds = [json.loads(ln)["kind"]
                 for ln in files["flight"].read_text().splitlines()]
        profiles = list(files["profile"].glob("*.pt.trace.json"))
        prof_events = (json.loads(profiles[0].read_text())["traceEvents"]
                       if len(profiles) == 1 else [])
        kernels = sum(1 for e in prof_events if e.get("cat") == "kernel")
        ranges = {e.get("name") for e in prof_events} & {"prefill",
                                                         "decode.block"}
        if (out["obs"] != local_ids["bf16"]
                or spans != {"prefill", "decode.block"}
                or not {"generator.decode_ms", "generator.prefill_ms"}
                <= set(metrics)
                or metrics["generator.prefill_ms"]["count"] != 1
                or kinds != ["prefill"] + ["decode"] * (len(kinds) - 1)
                or len(kinds) < 2 or not kernels
                or ranges != {"prefill", "decode.block"}):
            fail(f"[10] (v) obs flags: ids {out['obs']}, spans {spans}, "
                 f"metrics {sorted(metrics)}, flight kinds {kinds}, "
                 f"profiles {profiles} with {kernels} kernel events and "
                 f"ranges {ranges}")
    say(f"[10] (v) cli --lookahead {out['lookahead']} (phase 6's bf16 ids); "
        f"--window 8 {out['window']} (the generator's; full context "
        f"{full}); --logit-bias 7:100 {out['logit_bias']}; obs flags: spans "
        f"{sorted(spans)}, metrics {sorted(metrics)}, flight {kinds}, "
        f"profile {kernels} kernel events with ranges {sorted(ranges)}")
    return out


def phase_guided(torch, build, local_ids: dict) -> tuple[list, dict]:
    """Phase 10 over Llama-3-8B params (seed 0, SERVE_LAYERS) and phase
    5's 2,000-id prompt: (i) guided single streams, (ii) the guided batch,
    (iv) the HTTP plane's ``response_format`` on bf16; (iii) lookahead on
    bf16 and on int8 weights with the int8 cache; (v) the command line."""
    from cake_tpu_torch.models import llama
    from cake_tpu_torch.models.config import llama3_8b

    cfg = llama3_8b(num_hidden_layers=SERVE_LAYERS, max_seq_len=4096)
    prompt = torch.randint(0, cfg.vocab_size, (2000,),
                           generator=torch.Generator().manual_seed(SEED)
                           ).tolist()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as cache:
        # a new DFA cache: the compiles are timed, not loaded
        os.environ["CAKE_FSM_CACHE_DIR"] = cache
        guides = compile_guides(cfg)
        params = llama.init_params(cfg, seed=SEED)
        paths = [guided_single(torch, build, cfg, params, prompt, guides),
                 guided_batch(torch, build, cfg, params, guides),
                 guided_serve(torch, build, cfg, params, prompt, guides)]
        del os.environ["CAKE_FSM_CACHE_DIR"]
    paths.append(lookahead_path(torch, build, cfg, params, prompt,
                                "(a) bf16", "bf16", None))
    del params
    torch.cuda.empty_cache()
    params = llama.init_params_int8(cfg, seed=SEED)
    paths.append(lookahead_path(torch, build, cfg, params, prompt,
                                "(b) int8 weights, int8 cache",
                                "quant_matmul", "int8"))
    del params
    torch.cuda.empty_cache()
    paths[0]["compile_ms"] = {k: v[2] for k, v in guides.items()}
    cli = guided_cli(torch, build, local_ids)
    return paths, cli


def kernel_times(torch, flash, qmatmul, quant) -> dict:
    """Card ms of the two matmul wrappers and of ``flash_decode`` of
    whichever package was imported, at phase 3's shapes and tiers
    (``--kernels DIR``: a same-call comparison with another tree, such as
    the parent commit unpacked)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    shapes = [(m,) + kn for kn in LINEARS for m in (1, 2048)] + [
        (1,) + HEAD]
    times = {}
    for tier in TIERS:
        for m, k, n in shapes:
            w = torch.randn(k, n, generator=gen, device="cuda") / k ** 0.5
            name, wq, scale = quantized(quant, w, tier)
            x = torch.randn(m, k, generator=gen, device="cuda").to(
                torch.bfloat16)
            fn = getattr(qmatmul, name)
            times[f"{tier_label(tier)} x [{m},{k}] w [{k},{n}]"] = time_ms(
                lambda: fn(x, wq, scale))
            del w, wq, scale
        torch.cuda.empty_cache()

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    decode = {}
    for b, pos in DECODE_TIMED:
        k, v, q = rnd(b, KVH, S, D), rnd(b, KVH, S, D), rnd(b, H, 1, D)
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        decode[f"q [{b},{H},1,{D}] pos {list(pos)}"] = time_ms(
            lambda: flash.flash_decode(q, k, v, p))
    return {"matmul_ms": times, "flash_decode_ms": decode}


# --------------------------------------------------------------------------
# phase 11
# --------------------------------------------------------------------------

PAGE = 16  # tokens a KV page
# the pool-pressure scenario's window (a minimum pool of 1,024 pages: 8
# streams x 64 pages + the sink, rounded up to a power of two), its 8
# prompts and quotas, and 12 distinct 880-id arrivals (55 full pages each
# into the prefix tree), 8 tokens each
PRESSURE_WINDOW = 1024
PRESSURE_LENS = (900, 700, 500, 300, 200, 100, 40, 9)
PRESSURE_QUOTAS = (40, 40, 40, 40, 40, 40, 40, 1)
PRESSURE_ARRIVALS = 12
# the export/import scenario: stream 0 (2,000 ids) exported after 20
# tokens, finished, imported under stream id 100 and run on to 40
EXPORT_AT, EXPORT_QUOTA = 20, 40
SPILL_MB = 256


def paged_engine(torch, cfg, params, kv_quant, block, **kw):
    from cake_tpu_torch.runtime.batch_generator import BatchGenerator

    return BatchGenerator(cfg, params, block_size=block, kv_quant=kv_quant,
                          kv_layout="paged", kv_page_size=PAGE, **kw)


def timed_runs(torch, build, make, prompts, arrivals, n, label, layout,
               cfg, weights, kv_quant, want=None):
    """``n`` timed runs of phase 7's scenario at block 8, each on a new
    engine (``make()``: the slot layout's prefix store outlives
    set_prompts, and a row stored by an earlier run would change an
    arrival's prefix hit), the first with its launches checked against
    the model calls; every run's streams must equal ``want`` (the first
    run's when None). Returns the first run's streams, launches and
    counters, the tokens/s of every run, the arrivals' TTFT, the peak of
    allocated card memory and the last engine."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {"tokens_per_s": [], "ttft_ms": []}
    g = None
    for i in range(n):
        g = None  # the previous run's engine goes before the next one
        g = make()
        g.warm_admission(64)
        torch.cuda.synchronize()
        build.reset_launches()
        p0, d0 = g.prefill_calls, g.decode_steps
        shared = []
        probe = (lambda step: shared.append(
            g.stats()["kvpool"]["pages_shared"])) if layout == "paged" \
            else None
        streams, ttft, wall, tokens, _ = drive_batch(
            torch, g, prompts, BATCH_QUOTAS,
            list(zip(arrivals, ARRIVAL_QUOTAS)), probe=probe)
        torch.cuda.synchronize()
        counts = build.launches()
        if i == 0:
            exp = expected_launches(cfg, weights, kv_quant,
                                    g.prefill_calls - p0,
                                    g.decode_steps - d0)
            if counts != exp:
                fail(f"[11] {label} {layout}: kernels launched {counts}, "
                     f"want {exp}")
            out.update(streams=streams, launches=counts,
                       prefill_calls=g.prefill_calls - p0,
                       decode_steps=g.decode_steps - d0,
                       pages_shared_max=max(shared) if shared else None,
                       stats=g.stats())
            if want is None:
                want = streams
        if streams != want:
            diff = [sid for sid in want if streams.get(sid) != want[sid]]
            fail(f"[11] {label} {layout} run {i}: streams {diff} differ "
                 "from the slot layout's")
        out["tokens_per_s"].append(tokens / wall)
        out["ttft_ms"].append(list(ttft.values()))
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["engine"] = g
    tps = out["tokens_per_s"]
    say(f"[11] {label} {layout} block 8: tokens/s (host clock) "
        f"{[round(t, 2) for t in tps]} (spread {max(tps) - min(tps):.2f}); "
        f"arrivals' TTFT ms {[round(t, 2) for t in out['ttft_ms'][0]]}; "
        f"peak {out['peak_gb']:.2f} GB; launches {out['launches']}")
    return out


def page_moves_ms(torch, g) -> dict:
    """Card ms of one decode dispatch's gather of the live batch's pages
    into the contiguous view and of its write-back of 2 pages a row (block
    8), at the engine's live state (CUDA events, L2 flushed)."""
    from cake_tpu_torch.kvpool import pool as kvpool

    with torch.inference_mode():  # the engine's tensors
        page_map = g._ids(g._page_map_np())
        w = kvpool.writeback_width(8, PAGE, g._ppp)
        ids = g._ids(g._scatter_ids_np(8))
        first = torch.clamp(g._ids(g._pos).long() // PAGE, max=g._ppp - w)
        view = kvpool.gather_view(g.cache, page_map)
        gather = time_ms(lambda: kvpool.gather_view(g.cache,
                                                           page_map), n=10)
        scatter = time_ms(lambda: kvpool.scatter_back(
            g.cache, view, first, ids), n=10)
    nbytes = sum(t.numel() * t.element_size() for t in kvpool.halves(view))
    del view
    return {"gather_ms": gather, "scatter_ms": scatter,
            "view_gb": nbytes / 1e9,
            "gather_bound_ms": bound(2 * nbytes, 0)[0]}


def plant_page_shift(g) -> None:
    """The planted fault: stream 0's page map shifted by one page (its
    logical page j read from physical page j + 1)."""
    real = g._page_map_np

    def shifted():
        m = real()
        m[0, :-1] = m[0, 1:].copy()
        return m

    g._page_map_np = shifted


def pressure_drive(torch, g, prompts, quotas, arrivals, hold=None):
    """The pressure scenario's loop, for both layouts: the prompts in
    slots 0..7, each stream retired at its quota, the arrivals enqueued one
    at a time, each once no admission is pending; ``hold(step)``, when
    given, runs after each step and holds the next arrival back while it
    returns True. Returns each stream's ids by stream id."""
    g.set_prompts(prompts, stream_ids=list(range(len(prompts))))
    quota = dict(enumerate(quotas))
    got = {sid: [] for sid in quota}
    ended, queue = set(), list(arrivals)
    for step in range(6000):
        row = g.step()
        for slot, tok in enumerate(row):
            sid = g.streams[slot].stream_id
            if tok is None or sid in ended:
                continue
            got[sid].append(tok.id)
            if tok.is_end_of_stream or len(got[sid]) >= quota[sid]:
                g.finish(sid)
                ended.add(sid)
        held = hold(step) if hold is not None else False
        if queue and not held and not g.pending_admissions():
            sid = len(quota)
            prompt, quota[sid] = queue.pop(0)
            got[sid] = []
            g.enqueue(prompt, sid)
        if not queue and len(ended) == len(quota):
            return got
    fail("[11] the pool-pressure run did not finish")


def pressure_run(torch, cfg, params, kv_quant, label) -> dict:
    """The minimum pool under pressure, window 1,024. Snapshots of two
    live streams are begun as imports (pages pinned outside every table and
    the tree) until fewer pages are free than the first 880-id arrival
    needs: it defers, exactly once. Then all but eight of the 900-id
    stream's imports abort, and the twelve arrivals' prefix pages outgrow
    what is left, so the tree evicts. Every stream equals the slot
    engine's on the same scenario."""
    from cake_tpu_torch.runtime.batch_generator import BatchGenerator

    gen = torch.Generator().manual_seed(SEED + 11)

    def ids(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()

    prompts = [ids(n) for n in PRESSURE_LENS]
    arrivals = [(ids(880), 8) for _ in range(PRESSURE_ARRIVALS)]
    slot = BatchGenerator(cfg, params, block_size=8, kv_quant=kv_quant,
                          max_seq=PRESSURE_WINDOW)
    want = pressure_drive(torch, slot, prompts, PRESSURE_QUOTAS, arrivals)
    del slot
    torch.cuda.empty_cache()
    need = len(prompts) * (PRESSURE_WINDOW // PAGE) + 1
    pages = 1 << (need - 1).bit_length()
    g = paged_engine(torch, cfg, params, kv_quant, 8,
                     max_seq=PRESSURE_WINDOW, kv_pool_pages=pages)
    st = {"stage": "pin", "big": [], "small": [], "pinned": 0}

    def landed():
        return not any(a[3] for a in g._arrivals)

    def hold(step):
        pool = g._pagepool
        if st["stage"] == "pin":
            # one import at a time, each landing before the next is
            # priced: 57 pages of stream 0 while that leaves room for a
            # stream's growth, then 7 of stream 5
            if step >= 1 and landed():
                free = pool.free_count
                n0, n5 = ((int(g._pos[i]) - 1) // PAGE + 1 for i in (0, 5))
                # room for one page of growth of each live stream
                src = 0 if free >= n0 + 8 else 5 if free >= n5 + 8 else None
                if src is None:
                    st["stage"] = "defer"
                    st["pinned"] = pool.pinned_count
                    st["defers0"] = pool._defer_ctr.value
                else:
                    meta = g.import_begin(g.export_stream(src))
                    st["big" if src == 0 else "small"].append(
                        meta["xfer_id"])
            return st["stage"] == "pin"
        if st["stage"] == "defer":
            if pool._defer_ctr.value > st["defers0"]:
                st["stage"], st["at"] = "deferred", step
            return False
        if st["stage"] == "deferred" and step >= st["at"] + 2:
            for x in st["small"] + st["big"][8:]:
                g.import_abort(x)
            st["stage"] = "flow"
            st["kept"] = pool.pinned_count
        return False

    got = pressure_drive(torch, g, prompts, PRESSURE_QUOTAS, arrivals, hold)
    for x in st["big"][:8]:
        g.import_abort(x)
    s = g.stats()
    out = {"pool_pages": pages, "evictions": g._pagepool._evict_ctr.value,
           "admit_defers": g._pagepool._defer_ctr.value,
           "pinned_at_defer": st["pinned"], "pinned_kept": st.get("kept"),
           "kvpool": s["kvpool"]}
    say(f"[11] {label} pool pressure (window {PRESSURE_WINDOW}, {pages} "
        f"pages): {out['admit_defers']} deferred admission(s) behind "
        f"{st['pinned']} pinned pages, then {out['evictions']} prefix-tree "
        f"evictions with {st.get('kept')} pages still pinned; pool "
        f"{s['kvpool']}")
    if got != want:
        diff = [sid for sid in want if got.get(sid) != want[sid]]
        fail(f"[11] {label} pool pressure: streams {diff} differ from the "
             "slot engine's")
    if out["admit_defers"] != 1 or not out["evictions"]:
        fail(f"[11] {label} pool pressure: {out['admit_defers']} deferrals "
             f"(want 1), {out['evictions']} evictions (want > 0)")
    if s["imports_pending"] or s["kvpool"]["pages_pinned"]:
        fail(f"[11] {label} pool pressure: pins left behind {s}")
    del g
    torch.cuda.empty_cache()
    return out


def export_import_run(torch, g, prompts, codec, label, want=None) -> dict:
    """Stream 0 of phase 7's batch on engine ``g`` exported after EXPORT_AT
    tokens (codecs "none" and ``codec``, whose pages must be the same
    bits), finished, imported under stream id 100 and run on to
    EXPORT_QUOTA tokens: its ids must equal ``want`` (an uninterrupted
    run's; run here when None)."""
    from cake_tpu_torch.disagg import snapshot

    def tokens(sid):
        return next((list(s.generated) for s in g.streams
                     if s.stream_id == sid and not s.done), None)

    def run_to(sid, n):
        for _ in range(4 * n + 64):
            got = tokens(sid)
            if got is not None and len(got) >= n \
                    and not g.pending_admissions():
                return got[:n]
            g.step()
        fail(f"[11] {label}: stream {sid} stalled")

    if want is None:
        g.set_prompts(prompts, stream_ids=list(range(len(prompts))))
        want = run_to(0, EXPORT_QUOTA)
    g.set_prompts(prompts, stream_ids=list(range(len(prompts))))
    run_to(0, EXPORT_AT)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    data = g.export_stream(0, codec="none")
    export_ms = (time.perf_counter() - t0) * 1e3
    data_c = g.export_stream(0, codec=codec)
    a, b = snapshot.decode_snapshot(data), snapshot.decode_snapshot(data_c)
    if any(not torch.equal(pa[k], pb[k]) for pa, pb in zip(a.pages, b.pages)
           for k in pa):
        fail(f"[11] {label}: the {codec} snapshot's pages differ from the "
             "lossless one's")
    g.finish(0)
    t0 = time.perf_counter()
    g.import_stream(data_c, stream_id=100)
    torch.cuda.synchronize()
    import_ms = (time.perf_counter() - t0) * 1e3
    got = run_to(100, EXPORT_QUOTA)
    if got != want:
        fail(f"[11] {label}: the imported stream's ids differ from the "
             f"uninterrupted run's: {got} vs {want}")
    return {"bytes": len(data), "bytes_codec": len(data_c), "codec": codec,
            "pages": a.n_pages, "export_ms": export_ms,
            "import_ms": import_ms}


def spill_over_http(torch, cfg, params) -> dict:
    """(a)'s paged engine behind the in-process server with --spill-mb 256:
    eight batch-class requests hold every slot, then an interactive one
    arrives; a victim is spilled and resumed, and every stream equals the
    engine's own ids for its prompt."""
    import threading
    import urllib.request

    from cake_tpu_torch.obs import metrics as obs_metrics
    from cake_tpu_torch.ops.sampling import SamplerSettings
    from cake_tpu_torch.serve.api import start_api_server
    from cake_tpu_torch.serve.scheduler import Scheduler

    gen = torch.Generator().manual_seed(SEED + 12)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in (400, 350, 300, 250, 200, 150, 100, 60, 220)]
    quotas = [48] * 8 + [16]
    settings = SamplerSettings(temperature=0)
    ref = paged_engine(torch, cfg, params, None, 8, settings=settings)
    streams = drive_batch(torch, ref, [[cfg.bos_token_id]] * 8, [1] * 8,
                          list(zip(prompts, quotas)), after=8)[0]
    want = [streams[8 + i] for i in range(len(prompts))]
    del ref
    torch.cuda.empty_cache()
    engine = paged_engine(torch, cfg, params, None, 8, settings=settings)
    sched = Scheduler(engine, queue_depth=16, request_timeout_s=300,
                      spill_mb=SPILL_MB)
    spilled = []
    commit = sched._spill.spill_commit

    def record(claim, payload):
        spilled.append(len(payload))
        commit(claim, payload)

    sched._spill.spill_commit = record
    # the engine thread waits for all eight batch requests before its
    # first step, and once all eight run with two tokens each, waits for
    # the interactive request to be queued: otherwise on a slow host a
    # batch stream can finish first, and the arrival takes the freed slot
    # with no preemption to test
    step, gate_open = engine.step, threading.Event()

    def wait_for(pred):
        t_end = time.monotonic() + 300
        while time.monotonic() < t_end:
            with sched._cond:
                if pred():
                    return
            time.sleep(0.002)

    def gated_step():
        if not gate_open.is_set():
            wait_for(lambda: len(sched._by_sid) + len(sched._queue) >= 8)
            with sched._cond:
                live = list(sched._by_sid.values())
            if len(live) == 8 and all(len(s.generated) >= 2 for s in live):
                wait_for(lambda: sched._queue)
                gate_open.set()
        return step()

    engine.step = gated_step
    sched.start(max_concurrent=8, warm_prompt_len=64)
    server = start_api_server(sched, bind="127.0.0.1", port=0)
    port = server.port
    got, counts, started = {}, [0] * 8, threading.Event()

    def client(i):
        def on_token():
            counts[i] += 1
            if all(c >= 2 for c in counts):
                started.set()
        got[i] = sse(port, {"prompt_ids": prompts[i], "max_tokens": quotas[i],
                            "class": "batch"}, on_token)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    if not started.wait(timeout=300):
        fail("[11] spill: the eight batch streams never started")
    got[8] = sse(port, {"prompt_ids": prompts[8], "max_tokens": quotas[8],
                        "class": "interactive"})
    for t in threads:
        t.join(timeout=300)
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                timeout=30) as r:
        health = json.loads(r.read())
    st = sched.stats()
    resume = obs_metrics.registry().snapshot().get("serve.resume_ms", {})
    server.close()
    sched.close()
    for i in range(len(prompts)):
        if got.get(i) is None or got[i]["ids"] != want[i]:
            fail(f"[11] spill: request {i}'s ids differ from the engine's "
                 f"own: {(got.get(i) or {}).get('ids')} vs {want[i]}")
    if health["preemptions"] < 1 or not spilled or st["spilled"]:
        fail(f"[11] spill: no victim spilled and resumed (healthz "
             f"{health}, spilled payloads {spilled})")
    out = {"preemptions": health["preemptions"], "spill_bytes": spilled,
           "resume_ms": resume, "healthz": health}
    say(f"[11] spill over HTTP (--spill-mb {SPILL_MB}): {len(prompts)} "
        f"streams equal the engine's ids; /healthz preemptions "
        f"{health['preemptions']}, spilled {health['spilled']}, "
        f"kv_pages_free {health.get('kv_pages_free')}; serve.spill_bytes "
        f"of each spill {spilled}; serve.resume_ms {resume}")
    del engine, sched, server
    gc.collect()  # the server's threads leave reference cycles behind
    torch.cuda.empty_cache()
    return out


def phase_paged(torch, build, label, cfg, params, weights, kv_quant,
                prompts, arrivals, slot_streams=None) -> dict:
    """Phase 11 over one path's weights: the paged engine (page size 16)
    against the slot engine on phase 7's scenario, a planted page-map
    fault, the pool under pressure, export/import, and (bf16) preemption
    with spill over HTTP."""
    from cake_tpu_torch.ops.sampling import SamplerSettings
    from cake_tpu_torch.runtime.batch_generator import BatchGenerator

    settings = SamplerSettings(temperature=0)
    n_runs = 3 if weights == "bf16" else 1
    t_phase = time.perf_counter()
    slot = timed_runs(
        torch, build, lambda: BatchGenerator(
            cfg, params, settings=settings, block_size=8,
            kv_quant=kv_quant), prompts, arrivals, n_runs, label, "slot",
        cfg, weights, kv_quant, want=slot_streams)
    g = slot.pop("engine")
    slot["profile"] = profile_batch(torch, g, prompts, f"{label} slot",
                                    tag="[11]")
    del g
    torch.cuda.empty_cache()
    want = slot["streams"]
    paged = timed_runs(
        torch, build, lambda: paged_engine(torch, cfg, params, kv_quant, 8,
                                           settings=settings),
        prompts, arrivals, n_runs, label, "paged", cfg, weights, kv_quant,
        want=want)
    g = paged.pop("engine")
    st = paged["stats"]
    if not paged["pages_shared_max"]:
        fail(f"[11] {label}: no page shared while the prefix sharers lived")
    kp = st["kvpool"]
    if kp["pages_used"] != st["prefix_entries"] or kp["pages_pinned"]:
        fail(f"[11] {label}: after every stream retired, {kp['pages_used']} "
             f"pages are held, the prefix tree holds {st['prefix_entries']}")
    if st["prefix_hits"] != 2:
        fail(f"[11] {label}: {st['prefix_hits']} prefix hits, want 2")
    say(f"[11] {label} paged block 8: every stream equals the slot "
        f"layout's; up to {paged['pages_shared_max']} pages shared; after "
        f"retirement {kp['pages_used']} pages held, all by the prefix tree "
        f"({st['prefix_entries']} nodes); pool {kp}")
    paged["profile"] = profile_batch(torch, g, prompts, f"{label} paged",
                                     tag="[11]")
    paged["page_moves"] = page_moves_ms(torch, g)
    pm = paged["page_moves"]
    share = (pm["gather_ms"] + pm["scatter_ms"]) / (
        8 * paged["profile"]["device_ms_per_step"])
    say(f"[11] {label} page moves a dispatch: gather "
        f"{pm['gather_ms']:.3f} ms of a {pm['view_gb']:.2f} GB view (bound "
        f"{pm['gather_bound_ms']:.3f} ms), write-back "
        f"{pm['scatter_ms']:.3f} ms: {100 * share:.1f}% of a block-8 "
        "dispatch's card time")
    # block 1, and the planted fault at block 8
    g1 = paged_engine(torch, cfg, params, kv_quant, 1, settings=settings)
    streams1 = drive_batch(torch, g1, prompts, BATCH_QUOTAS,
                           list(zip(arrivals, ARRIVAL_QUOTAS)))[0]
    del g1
    if streams1 != want:
        fail(f"[11] {label} paged block 1: streams differ from the slot "
             "layout's")
    say(f"[11] {label} paged block 1: every stream equals the slot layout's")
    plant_page_shift(g)
    bad = drive_batch(torch, g, prompts, BATCH_QUOTAS,
                      list(zip(arrivals, ARRIVAL_QUOTAS)))[0]
    if bad == want:
        fail(f"[11] {label}: the check does not see stream 0's page map "
             "shifted by one page")
    say(f"[11] {label} planted fault (stream 0's page map shifted by one "
        f"page): streams {[s for s in want if bad[s] != want[s]]} differ "
        "from the slot layout's, as they must")
    del g.__dict__["_page_map_np"]
    codec = "int8" if kv_quant else "bf16"
    xfer = {"greedy": export_import_run(torch, g, prompts, codec, label,
                                        want=want[0][:EXPORT_QUOTA])}
    del g
    torch.cuda.empty_cache()
    g = paged_engine(torch, cfg, params, kv_quant, 8, settings=SamplerSettings(
        temperature=0.8, top_k=40))
    xfer["sampled"] = export_import_run(torch, g, prompts, codec, label)
    for kind, r in xfer.items():
        say(f"[11] {label} export/import {kind}: stream 0 after "
            f"{EXPORT_AT} tokens, {r['pages']} pages, snapshot "
            f"{r['bytes']} bytes (none) / {r['bytes_codec']} ({codec}); "
            f"export {r['export_ms']:.1f} ms, import {r['import_ms']:.1f} "
            f"ms; the continuation equals the uninterrupted run's "
            f"{EXPORT_QUOTA} ids")
    del g
    torch.cuda.empty_cache()
    out = {"path": f"paged {label}", "launches": paged["launches"],
           "slot": {k: v for k, v in slot.items()
                    if k not in ("streams", "stats")},
           "paged": {k: v for k, v in paged.items()
                     if k not in ("streams", "stats")},
           "export_import": xfer,
           "pressure": pressure_run(torch, cfg, params, kv_quant, label)}
    if weights == "bf16":
        out["spill"] = spill_over_http(torch, cfg, params)
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"[11] {label}: {out['phase_s']:.1f} s")
    return out


def phase_paged_only(torch, build) -> list:
    """``--phase 11``: phase 11 alone, over freshly drawn weights (seed 0)
    and phase 7's prompts; the slot engine gives the reference ids."""
    from cake_tpu_torch.models import llama
    from cake_tpu_torch.models.config import llama3_8b

    cfg = llama3_8b(num_hidden_layers=SERVE_LAYERS,
                    max_seq_len=4096)
    prompts, arrivals = batch_prompts(torch, cfg)
    out = []
    for label, init, weights, kv_quant in (
            ("(a) bf16", lambda: llama.init_params(cfg, seed=SEED), "bf16",
             None),
            ("(b) int8 weights, int8 cache",
             lambda: llama.init_params_int8(cfg, seed=SEED), "quant_matmul",
             "int8")):
        params = init()
        out.append(phase_paged(torch, build, label, cfg, params, weights,
                               kv_quant, prompts, arrivals))
        del params
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# phase 12
# --------------------------------------------------------------------------

# proposals a round: the default of the JAX package's command line
SPEC_K = 8
# A verify writes the K/V of its K + 1 positions from M = K + 1 (or 8 (K +
# 1)) projections, whose bf16 outputs round otherwise than a plain step's
# M = 1 or 8: over the bf16 cache the streams part at near-ties as phase
# 7's do (MARGIN_TIE). Over the int8 cache a K or V element one bf16 ulp
# off can flip its int8 code, which moves it by a whole scale step (1/127
# of the row's largest element, ~2^-7 relative against bf16's 2^-8), so a
# stream there is held up to its first margin below twice MARGIN_TIE (on
# an H100 the int8 single stream at rounds 1 parted at a margin of 0.0682)
SPEC_MARGIN_TIE_Q8 = 2 * MARGIN_TIE
# single-stream rounds chained on the card a host copy (1 is the host loop)
SPEC_ROUNDS = (1, 8)
# (K, rounds of the replay): one corpus pass, capped so the phase stays
# short; tokens a round read over every round replayed
REPLAY_K = (4, 8)
REPLAY_ROUNDS = 128


def main_path_prompt(torch, cfg) -> list:
    """Phase 5's 2,000-id prompt."""
    return torch.randint(0, cfg.vocab_size, (2000,),
                         generator=torch.Generator().manual_seed(SEED)
                         ).tolist()


def check_until_tie(torch, cfg, params, label, prompt, ids, ref, settings,
                    kv_quant, tag="[12]") -> dict:
    """``ids`` against the reference ``ref`` up to the first step whose
    penalized margin (over ``ids``' own teacher-forced logits) falls below
    MARGIN_TIE (SPEC_MARGIN_TIE_Q8 over the int8 cache); fails on a
    difference before it."""
    m = penalized_margins(torch, stream_logits(torch, cfg, params, prompt,
                                               ids, kv_quant),
                          prompt, ids, settings)
    limit = SPEC_MARGIN_TIE_Q8 if kv_quant else MARGIN_TIE
    tie = next((j for j, x in enumerate(m) if x < limit), len(ids))
    diff = next((j for j, (a, b) in enumerate(zip(ids, ref)) if a != b),
                None)
    if diff is None and len(ids) != len(ref):
        diff = min(len(ids), len(ref))  # one of them ended at an EOS
    at = round(m[diff], 4) if diff is not None and diff < len(m) else "-"
    say(f"{tag} {label}: first difference from the plain run at step "
        f"{diff} (margin there {at}), first margin < {limit} at step {tie} "
        f"(least margin {min(m):.4f})")
    if diff is not None and diff < tie:
        fail(f"{label} differs from the plain run at step {diff}, before "
             f"any near-tie (margin {at} there)")
    return {"first_difference": diff, "first_near_tie": tie,
            "min_margin": min(m)}


def spec_single(torch, build, cfg, params, label, weights, kv_quant,
                prompt, ref_ids, settings) -> list:
    """(i) ``SpeculativeGenerator`` (K = 8) on phase 5's prompt, 64 tokens
    at each of SPEC_ROUNDS, launches exact (the prefill, each plain
    fallback step and each verify is one model call)."""
    from cake_tpu_torch.runtime.speculative import SpeculativeGenerator

    n_new = 64
    warm = SpeculativeGenerator(cfg, params, settings=settings,
                                kv_quant=kv_quant, spec_k=SPEC_K,
                                spec_rounds=2)
    warm.set_prompt(prompt)
    for i in range(4):  # cuBLAS at M = 9, the accept's first launches
        warm.next_token(i)
    del warm
    out = []
    for rounds in SPEC_ROUNDS:
        gen = SpeculativeGenerator(cfg, params, settings=settings,
                                   kv_quant=kv_quant, spec_k=SPEC_K,
                                   spec_rounds=rounds)
        gen.set_prompt(prompt)
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        ids = [gen.next_token(0).id]
        t1 = time.perf_counter()
        for i in range(1, n_new):
            tok = gen.next_token(i)
            ids.append(tok.id)
            if tok.is_end_of_stream:
                break
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = build.launches()
        want = expected_launches(cfg, weights, kv_quant, gen.prefill_calls,
                                 gen.decode_steps + gen.verify_calls)
        run = {"spec_rounds": rounds, "launches": counts,
               "prefill_calls": gen.prefill_calls,
               "decode_steps": gen.decode_steps,
               "verify_calls": gen.verify_calls,
               "dispatches": gen.dispatches, "emitted": gen.emitted,
               "decode_tokens_per_s": (len(ids) - 1) / (t2 - t1),
               "prefill_ms": (t1 - t0) * 1e3}
        say(f"[12] {label} single stream K={SPEC_K} rounds={rounds}: "
            f"{len(ids)} ids, {gen.verify_calls} verifies, "
            f"{gen.decode_steps} plain steps, {gen.dispatches} dispatches, "
            f"{gen.emitted / gen.dispatches:.2f} tokens a dispatch, decode "
            f"{run['decode_tokens_per_s']:.2f} tokens/s (host clock); "
            f"launches {counts}")
        if counts != want or not gen.verify_calls:
            fail(f"[12] {label} rounds={rounds}: kernels launched {counts}, "
                 f"want {want} ({gen.verify_calls} verifies)")
        run.update(check_until_tie(
            torch, cfg, params, f"{label} single stream rounds={rounds}",
            prompt, ids, ref_ids, settings, kv_quant))
        out.append(run)
        del gen
    return out


def spec_batch(torch, build, cfg, params, label, weights, kv_quant, prompts,
               arrivals, ref_streams, settings) -> dict:
    """(ii) The batch engine at 8 slots with K = 8 (rounds chained, the
    default 8) on phase 7's scenario: launches exact, every stream equal to
    ``ref_streams`` (phase 7's block-8 slot ids) up to its first near-tie;
    then the card time of one chained dispatch a round beside a plain
    8-slot step's."""
    from cake_tpu_torch.runtime.batch_generator import BatchGenerator

    g = BatchGenerator(cfg, params, settings=settings, block_size=8,
                       kv_quant=kv_quant, spec_k=SPEC_K)
    g.warm_admission(64)
    torch.cuda.synchronize()
    build.reset_launches()
    p0, d0, v0 = g.prefill_calls, g.decode_steps, g.verify_calls
    streams, ttft, wall, tokens, _ = drive_batch(
        torch, g, prompts, BATCH_QUOTAS, list(zip(arrivals, ARRIVAL_QUOTAS)))
    torch.cuda.synchronize()
    counts = build.launches()
    st = g.stats()
    calls = (g.prefill_calls - p0, g.decode_steps - d0, g.verify_calls - v0)
    want = expected_launches(cfg, weights, kv_quant, calls[0],
                             calls[1] + calls[2])
    say(f"[12] {label} batch K={SPEC_K}: {tokens} tokens in {wall:.3f} s "
        f"after the first step, {tokens / wall:.2f} tokens/s aggregate "
        f"(host clock, 8 slots); {calls[0]} prompt passes, {calls[1]} plain "
        f"steps, {calls[2]} verifies in {st['spec_chains']} chains; "
        f"{st['tokens_per_dispatch']} tokens a dispatch; launches {counts}")
    if counts != want or not calls[2]:
        fail(f"[12] {label} batch: kernels launched {counts}, want {want}")
    every = prompts + arrivals
    vs = {}
    for sid, ids in streams.items():
        vs[sid] = check_until_tie(torch, cfg, params,
                                  f"{label} batch stream {sid}", every[sid],
                                  ids, ref_streams[sid], settings, kv_quant)
    # one chained dispatch (8 rounds) under the profiler, then a plain
    # 8-slot step of the same prompts
    g.set_prompts(prompts)
    g.step()  # the first tokens
    c0 = g.stats()["spec_chains"]
    prof = device_profile(torch, g.step)
    if g.stats()["spec_chains"] != c0 + 1:
        fail(f"[12] {label}: the profiled step ran no chained dispatch")
    prof.pop("kernels")
    rounds = g._spec_rounds
    del g
    torch.cuda.empty_cache()
    plain = BatchGenerator(cfg, params, settings=settings, block_size=1,
                           kv_quant=kv_quant)
    plain.set_prompts(prompts)
    plain.step()
    plain.step()
    step = device_profile(torch, plain.step)
    step.pop("kernels")
    del plain
    torch.cuda.empty_cache()
    say(f"[12] {label} batch: a verify round {prof['device_ms'] / rounds:.3f}"
        f" ms of card kernel time over {prof['kernel_launches'] / rounds:.1f}"
        f" launches (8 slots x {SPEC_K + 1} positions); a plain 8-slot step "
        f"{step['device_ms']:.3f} ms over {step['kernel_launches']} "
        f"launches; top of the round {prof['top']}")
    return {"launches": counts, "tokens_per_s": tokens / wall,
            "arrival_ttft_ms": list(ttft.values()), "stats": st,
            "prompt_passes": calls[0], "plain_steps": calls[1],
            "verifies": calls[2], "vs_plain": vs,
            "verify_round_device_ms": prof["device_ms"] / rounds,
            "verify_round_launches": prof["kernel_launches"] / rounds,
            "plain_step_device_ms": step["device_ms"],
            "plain_step_launches": step["kernel_launches"]}


def spec_replay(torch, build, cfg, params, label, weights, kv_quant,
                settings) -> list:
    """(iii) ``spec_replay_fn`` over ``corpus_tokens`` (one pass, 64 ids
    prefilled) at each K of REPLAY_K: tokens a round over REPLAY_ROUNDS
    rounds; the card time and launches of a verify round (a profiled chain
    of 8, kernel launches exact) beside a plain single-stream step's."""
    from cake_tpu_torch.models.llama import Llama
    from cake_tpu_torch.ops.kvcache import init_cache
    from cake_tpu_torch.parallel.pipeline import build_sharded_verify
    from cake_tpu_torch.runtime.generator import LlamaGenerator
    from cake_tpu_torch.runtime.speculative import spec_replay_fn
    from cake_tpu_torch.utils.corpus import corpus_tokens

    model = Llama(cfg, params)
    verify = build_sharded_verify(model)
    toks = corpus_tokens(cfg.vocab_size)
    window = min(cfg.max_seq_len, len(toks))
    corpus = torch.tensor(toks[:window], dtype=torch.int64, device="cuda")
    prompt_len, chain = 64, 8
    out = []
    for k in REPLAY_K:
        cache = init_cache(cfg, 1, cfg.max_seq_len, device="cuda",
                           quant=kv_quant)
        with torch.inference_mode():
            model.hidden(corpus[None, :prompt_len], cache, 0)
            pos = torch.tensor([prompt_len], dtype=torch.int32,
                               device="cuda")
            acc = torch.zeros((), device="cuda")
            counts = []
            pos_h = prompt_len
            while (pos_h + 2 * chain * (k + 1) + 1 < window
                   and len(counts) < REPLAY_ROUNDS):
                c, pos, acc = spec_replay_fn(verify, corpus, pos, cache, acc,
                                             k, 3, chain)
                counts += c.tolist()
                pos_h = int(pos)
            build.reset_launches()
            prof = device_profile(torch, lambda: spec_replay_fn(
                verify, corpus, pos, cache, acc, k, 3, chain))
            launches = build.launches()
        want = expected_launches(cfg, weights, kv_quant, 0, chain)
        if launches != want:
            fail(f"[12] {label} replay K={k}: kernels launched {launches} "
                 f"for {chain} verifies, want {want}")
        if not torch.isfinite(acc).item():
            fail(f"[12] {label} replay K={k}: the logits checksum is not "
                 "finite")
        prof.pop("kernels")
        out.append({"k": k, "rounds": len(counts),
                    "tokens_per_round": sum(counts) / len(counts),
                    "acceptance": (sum(counts) - len(counts))
                    / (k * len(counts)),
                    "verify_device_ms": prof["device_ms"] / chain,
                    "verify_launches": prof["kernel_launches"] / chain,
                    "kernel_launches_per_verify": {
                        n: c // chain for n, c in launches.items() if c}})
        del cache
        torch.cuda.empty_cache()
    gen = LlamaGenerator(cfg, params, settings=settings, block_size=1,
                         kv_quant=kv_quant)
    gen.set_prompt(toks[:prompt_len].tolist())
    gen.next_token(0)
    gen.next_token(1)
    step = device_profile(torch, lambda: gen.next_token(2))
    del gen
    for r in out:
        r["plain_step_device_ms"] = step["device_ms"]
        r["plain_step_launches"] = step["kernel_launches"]
        say(f"[12] {label} corpus replay K={r['k']}: "
            f"{r['tokens_per_round']:.3f} tokens a round over {r['rounds']} "
            f"rounds (acceptance {r['acceptance']:.3f}); a verify "
            f"{r['verify_device_ms']:.3f} ms of card kernel time over "
            f"{r['verify_launches']:.1f} launches (kernels "
            f"{r['kernel_launches_per_verify']}), a plain step "
            f"{step['device_ms']:.3f} ms over {step['kernel_launches']}")
    return out


def spec_serve(torch, cfg, params, settings) -> dict:
    """(iv) One ``--mode serve`` request on a K = 8 engine (8 slots, in this
    process): its SSE ids equal the engine's own for the prompt admitted
    the same way, cut at ``max_tokens`` exactly."""
    from cake_tpu_torch.runtime.batch_generator import BatchGenerator
    from cake_tpu_torch.serve.api import start_api_server
    from cake_tpu_torch.serve.scheduler import Scheduler

    prompt = torch.randint(0, cfg.vocab_size, (300,),
                           generator=torch.Generator().manual_seed(SEED + 12)
                           ).tolist()
    n = 29  # not a whole number of rounds: tokens stay banked at the cut
    ref = BatchGenerator(cfg, params, settings=settings, block_size=8,
                         spec_k=SPEC_K)
    want = drive_batch(torch, ref, [[cfg.bos_token_id]] * 8, [1] * 8,
                       [(prompt, n)], after=8)[0][8]
    del ref
    torch.cuda.empty_cache()
    engine = BatchGenerator(cfg, params, settings=settings, block_size=8,
                            spec_k=SPEC_K)
    sched = Scheduler(engine, queue_depth=8, request_timeout_s=300)
    sched.start(max_concurrent=8, warm_prompt_len=64)
    server = start_api_server(sched, bind="127.0.0.1", port=0)
    try:
        got = sse(server.port, {"prompt_ids": prompt, "max_tokens": n})
    finally:
        server.close()
        sched.close()
    spec_dispatches = engine.stats()["spec_dispatches"]
    del engine
    torch.cuda.empty_cache()
    say(f"[12] serve on a K={SPEC_K} engine: {len(got['ids'])} SSE ids "
        f"(max_tokens {n}), {spec_dispatches} verifies; equal to the "
        f"engine's: {got['ids'] == want}")
    if got["ids"] != want or len(want) != n or not spec_dispatches:
        fail(f"[12] serve: SSE ids {got['ids']} vs the engine's {want} "
             f"(max_tokens {n}, {spec_dispatches} verifies)")
    return {"ids": len(got["ids"]), "spec_dispatches": spec_dispatches}


def phase_spec(torch, build, label, cfg, params, weights, kv_quant, prompts,
               arrivals, slot_streams=None) -> dict:
    """Phase 12 over one path's weights (phase 5's and 7's): speculation
    on the single stream and in the batch engine, the corpus replay, and
    (bf16) one request over HTTP. ``slot_streams``: phase 7's block-8 ids
    (computed here when None)."""
    from cake_tpu_torch.ops.sampling import SamplerSettings
    from cake_tpu_torch.runtime.batch_generator import BatchGenerator

    t_phase = time.perf_counter()
    settings = SamplerSettings(temperature=0)
    if slot_streams is None:
        g = BatchGenerator(cfg, params, settings=settings, block_size=8,
                           kv_quant=kv_quant)
        slot_streams = drive_batch(torch, g, prompts, BATCH_QUOTAS,
                                   list(zip(arrivals, ARRIVAL_QUOTAS)))[0]
        del g
        torch.cuda.empty_cache()
    prompt = main_path_prompt(torch, cfg)
    ref = single_stream(torch, cfg, params, prompt, 64, settings, kv_quant)
    out = {"path": f"spec {label}"}
    out["single"] = spec_single(torch, build, cfg, params, label, weights,
                                kv_quant, prompt, ref, settings)
    torch.cuda.empty_cache()
    out["batch"] = spec_batch(torch, build, cfg, params, label, weights,
                              kv_quant, prompts, arrivals, slot_streams,
                              settings)
    out["replay"] = spec_replay(torch, build, cfg, params, label, weights,
                                kv_quant, settings)
    if weights == "bf16":
        out["serve"] = spec_serve(torch, cfg, params, settings)
    out["launches"] = {name: sum(r["launches"][name] for r in
                                 out["single"] + [out["batch"]])
                       for name in out["batch"]["launches"]}
    out["seconds"] = time.perf_counter() - t_phase
    say(f"[12] {label}: {out['seconds']:.1f} s")
    return out


def phase_spec_only(torch, build) -> list:
    """``--phase 12``: phase 12 alone, over freshly drawn weights (seed 0)
    and phase 7's prompts; the plain slot engine gives the reference ids."""
    from cake_tpu_torch.models import llama
    from cake_tpu_torch.models.config import llama3_8b

    cfg = llama3_8b(num_hidden_layers=SERVE_LAYERS,
                    max_seq_len=4096)
    prompts, arrivals = batch_prompts(torch, cfg)
    out = []
    for label, init, weights, kv_quant in (
            ("(a) bf16", lambda: llama.init_params(cfg, seed=SEED), "bf16",
             None),
            ("(b) int8 weights, int8 cache",
             lambda: llama.init_params_int8(cfg, seed=SEED), "quant_matmul",
             "int8")):
        params = init()
        out.append(phase_spec(torch, build, label, cfg, params, weights,
                              kv_quant, prompts, arrivals))
        del params
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# phase 13
# --------------------------------------------------------------------------

# (label, preset, layers, weight tier, KV caches of the single stream,
# batch engine?, speculation?) of phase 13's paths; Mixtral's bf16 experts
# (93 GB at 32 layers) do not fit the card: 8 layers (12 before phase 18
# came). Qwen2-7B and Gemma-7B run 8 of their 28 layers and the int8
# experts 4 of 32 (8 before phase 18), so the script stays inside its
# 1,200 s as the mesh phases grow (on an H100 the whole script took
# 1,062.6 s with them at 28, 28 and 16 layers, and 1,087.2 s at 16, 16
# and 12 on a slower host)
FAMILY_PATHS = (
    ("(q) qwen2_7b bf16", "qwen2_7b", 8, "bf16", (None,), False, False),
    ("(g) gemma_7b bf16", "gemma_7b", 8, "bf16", (None, "int8"), True,
     True),
    ("(m) mixtral_8x7b int8 experts", "mixtral_8x7b", 4, "int8", (None,),
     True, False),
    ("(m16) mixtral_8x7b bf16 experts, 8 layers", "mixtral_8x7b", 8,
     "bf16", (None,), False, False),
)
# speculation on (g): the command line's --speculate 4, rounds chained
FAMILY_SPEC_K = 4
# Two runs at other shapes round each logit to bf16 on their own (up to
# half a step each, so a margin can move by two steps on rounding alone)
# from hidden states the kernels' shapes already moved: a margin under
# three bf16 steps of the top logit is a near-tie. (On an H100 Gemma-7B's
# batch streams parted from their single streams at margins of 0 to 2
# steps.)
FAMILY_TIE_STEPS = 3


class MoeRows:
    """Records, while active, the rows N (B x T) of every routed MLP call
    of the model: the experts' products are 3 E a layer when N k >
    GATHER_MAX_ROWS (dense), else 3 N k (gather)."""

    def __init__(self, llama):
        self.llama, self.rows = llama, []

    def __enter__(self):
        real = self.real = self.llama.moe_swiglu

        def recording(x, *args, **kw):
            self.rows.append(x.shape[0] * x.shape[1])
            return real(x, *args, **kw)

        self.llama.moe_swiglu = recording
        return self

    def __exit__(self, *exc):
        self.llama.moe_swiglu = self.real

    def expert_products(self, cfg) -> int:
        from cake_tpu_torch.ops.moe import GATHER_MAX_ROWS

        k, e = cfg.num_experts_per_tok, cfg.num_local_experts
        return sum(3 * e if n * k > GATHER_MAX_ROWS else 3 * n * k
                   for n in self.rows)


def family_launches(cfg, weights, kv_quant, calls: int, prefill_calls: int,
                    moe_rows: MoeRows) -> dict:
    """Each kernel's launches over ``calls`` model calls (``prefill_calls``
    of them prompt passes, the rest decode steps or verifies): one
    attention kernel a layer a call; with quantized weights 7 linears a
    layer and the head a call, or with routed experts 4 linears a layer,
    the head, and the expert products ``moe_rows`` counted."""
    L = cfg.num_hidden_layers
    counts = expected_launches(cfg, "bf16", kv_quant, prefill_calls,
                               calls - prefill_calls)
    if weights == "int8":
        counts["quant_matmul"] = (
            (4 * L + 1) * calls + moe_rows.expert_products(cfg)
            if cfg.num_local_experts else (7 * L + 1) * calls)
    elif weights == "int4g128":
        counts["quant4_matmul"] = (7 * L + 1) * calls
    return counts


def bf16_steps(torch, x):
    """The bf16 step (ulp) at the magnitude of each element of ``x``."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp(min=1e-30)))
                      - 7)


def family_until_tie(torch, cfg, params, label, prompt, ids, ref,
                     settings, tag="[13]", check: bool = True) -> dict:
    """``ids`` (a stream of one engine) against ``ref`` (the same prompt's
    single stream, or a function that runs it: not called when the first
    near-tie is at step 0) up to the first near-tie, and each step of ``ids``
    against the greedy choice of its own teacher-forced logits (one
    forward pass over the prompt and ``ids``). A step is a near-tie where
    its penalized top-1 minus top-2 logit is under FAMILY_TIE_STEPS bf16
    steps of the top logit; near-ties are exempt from the per-step check,
    and the streams may part at the first. For a routed model the first
    step whose position's k-th and (k+1)-th router logits lie closer than
    ROUTER_TIE in some layer is a near-tie too, and ends the per-step
    check (a flip there changes the context every later step reads).
    Fails on a difference before the first near-tie, or on a step off its
    logits' choice outside a near-tie; with ``check`` False it reports
    that under ``fault`` instead (a planted fault's run)."""
    from cake_tpu_torch.ops import moe

    with RouterLog(moe) as log:
        logits = stream_logits(torch, cfg, params, prompt, ids, None)
    pen = penalized_logits(torch, logits, prompt, ids, settings)
    top = pen.topk(2, dim=-1)
    margin = top.values[:, 0] - top.values[:, 1]
    near = margin < FAMILY_TIE_STEPS * bf16_steps(torch, top.values[:, 0])
    n = len(prompt)
    near = near.tolist()
    gaps, routed = None, len(ids)
    if log.calls:
        gaps = torch.stack([g for _, g in log.calls])[
            :, n - 1:n - 1 + len(ids)].min(dim=0).values
        routed = next((j for j, g in enumerate(gaps.tolist())
                       if g < ROUTER_TIE), len(ids))
    choice = top.indices[:, 0].tolist()
    tie = min(next((j for j, x in enumerate(near) if x), len(ids)), routed)
    diff = None
    if tie:  # else nothing comes before the first near-tie
        ref = ref() if callable(ref) else ref
        diff = next((j for j, (a, b) in enumerate(zip(ids, ref))
                     if a != b), None)
        if diff is None and len(ids) != len(ref):
            diff = min(len(ids), len(ref))  # one of them ended at an EOS
    off = [j for j, (i, c) in enumerate(zip(ids[:routed], choice))
           if i != c and not near[j]]
    out = {"first_difference": diff, "first_near_tie": tie,
           "near_ties": sum(near), "min_margin": margin.min().item(),
           "off_choice": off, "steps_held": routed}
    note = ""
    if gaps is not None:
        note = f"; first router gap < {ROUTER_TIE} at step {routed}"
        out["min_router_gap"] = gaps.min().item()
        at = "-" if diff is None or diff >= len(ids) else (
            f"{gaps[diff].item():.3e}")
        note += (f"; least router gap {gaps.min().item():.3e}, at the "
                 f"first difference {at}")
    if diff is not None and diff < len(ids):
        steps = (margin[diff] / bf16_steps(torch, top.values[diff, 0]))
        note = (f"; margin at the first difference {margin[diff]:.4f} "
                f"({steps.item():.1f} bf16 steps)") + note
    against = (f"at step {diff}" if tie else
               "not compared (a near-tie at step 0)")
    say(f"{tag} {label}: first difference from the single stream {against}, "
        f"first near-tie at step {tie}, {sum(near)} of "
        f"{len(ids)} steps logit near-ties; steps off their logits' choice "
        f"outside a near-tie: {off}{note}")
    out["fault"] = None
    if diff is not None and diff < tie:
        out["fault"] = (f"{label} differs from the single stream at step "
                        f"{diff}, before any near-tie")
    elif off:
        out["fault"] = (f"{label}: steps {off} are not their teacher-forced "
                        "logits' greedy choice, and no near-tie")
    if check and out["fault"]:
        fail(out["fault"])
    return out


def family_generator(torch, build, cfg, params, label, weights, kv_quant,
                     prompt, settings) -> dict:
    """``LlamaGenerator`` on phase 5's prompt, 64 tokens at blocks 8 and 1
    (the same ids), launches exact; the greedy margins; one profiled
    decode block."""
    from cake_tpu_torch.models import llama
    from cake_tpu_torch.runtime.generator import LlamaGenerator

    n_new = 64
    warm = LlamaGenerator(cfg, params, settings=settings, block_size=8,
                          kv_quant=kv_quant)
    warm.set_prompt(prompt)
    for i in range(9):
        warm.next_token(i)
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {"path": label, "kv_quant": kv_quant, "runs": []}
    ids_by_block = {}
    for block in (8, 1):
        gen = LlamaGenerator(cfg, params, settings=settings,
                             block_size=block, kv_quant=kv_quant)
        gen.set_prompt(prompt)
        torch.cuda.synchronize()
        build.reset_launches()
        with MoeRows(llama) as rows:
            t0 = time.perf_counter()
            ids = [gen.next_token(0).id]
            t1 = time.perf_counter()
            ids += [gen.next_token(i).id for i in range(1, n_new)]
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        counts = build.launches()
        calls = gen.prefill_calls + gen.decode_steps
        want = family_launches(cfg, weights, kv_quant, calls,
                               gen.prefill_calls, rows)
        if counts != want or not gen.decode_steps:
            fail(f"[13] {label} block {block}: kernels launched {counts}, "
                 f"want {want}")
        run = {"block": block, "prefill_ms": (t1 - t0) * 1e3,
               "decode_tokens_per_s": (n_new - 1) / (t2 - t1),
               "launches": counts, "first_ids": ids[:8]}
        out["runs"].append(run)
        ids_by_block[block] = ids
        say(f"[13] {label}{' int8 cache' if kv_quant else ''} block "
            f"{block}: prefill_ms {run['prefill_ms']:.2f}, decode "
            f"tokens_per_s {run['decode_tokens_per_s']:.2f}, ids "
            f"{ids[:8]}...; launches {counts}")
        del gen
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["launches"] = {k: sum(r["launches"][k] for r in out["runs"])
                       for k in out["runs"][0]["launches"]}
    if ids_by_block[8] != ids_by_block[1]:
        fail(f"[13] {label}: blocks 8 and 1 give other ids")
    m = greedy_margins(torch, cfg, params, prompt, ids_by_block[8],
                       kv_quant)
    out["min_margin"] = min(m)
    out["ids"] = ids_by_block[8]
    prof = profile_main_path(torch, cfg, params, prompt, label, kv_quant)
    out["decode_card_ms_per_step"] = prof["decode_block_8"][
        "device_ms_per_step"]
    out["decode_launches_per_step"] = prof["decode_block_8"][
        "kernel_launches_per_step"]
    out["prefill_card_ms"] = prof["prefill"]["device_ms"]
    say(f"[13] {label}: blocks 8 and 1 equal; least greedy margin "
        f"{min(m):.4f}; peak {out['peak_gb']:.2f} GB; decode "
        f"{out['decode_card_ms_per_step']:.3f} card ms and "
        f"{out['decode_launches_per_step']:.1f} launches a step")
    return out


def family_batch(torch, build, cfg, params, label, weights,
                 settings) -> list:
    """The batch engine at 8 slots on phase 7's scenario, slot and paged
    layouts at block 8: launches exact, the layouts' streams equal, every
    stream equal to its single-stream run up to its first near-tie."""
    from cake_tpu_torch.models import llama
    from cake_tpu_torch.runtime.batch_generator import BatchGenerator

    prompts, arrivals = batch_prompts(torch, cfg)
    every = prompts + arrivals
    out, want = [], None
    for layout in ("slot", "paged"):
        if layout == "slot":
            g = BatchGenerator(cfg, params, settings=settings, block_size=8)
        else:
            g = paged_engine(torch, cfg, params, None, 8, settings=settings)
        g.warm_admission(64)
        torch.cuda.synchronize()
        build.reset_launches()
        p0, d0 = g.prefill_calls, g.decode_steps
        with MoeRows(llama) as rows:
            streams, ttft, wall, tokens, _ = drive_batch(
                torch, g, prompts, BATCH_QUOTAS,
                list(zip(arrivals, ARRIVAL_QUOTAS)))
            torch.cuda.synchronize()
        counts = build.launches()
        pc, dc = g.prefill_calls - p0, g.decode_steps - d0
        expect = family_launches(cfg, weights, None, pc + dc, pc, rows)
        say(f"[13] {label} batch {layout} block 8: {tokens} tokens in "
            f"{wall:.3f} s, {tokens / wall:.2f} tokens/s aggregate (host "
            f"clock, 8 slots); arrivals' TTFT ms "
            f"{[round(t, 2) for t in ttft.values()]}; {pc} prompt passes, "
            f"{dc} decode steps; launches {counts}")
        if counts != expect:
            fail(f"[13] {label} batch {layout}: kernels launched {counts}, "
                 f"want {expect}")
        if want is not None and streams != want:
            fail(f"[13] {label}: the paged layout's streams differ from the "
                 "slot layout's")
        prof = profile_batch(torch, g, prompts, f"{label} {layout}",
                             tag="[13]")
        out.append({"path": f"batch {label} {layout}", "launches": counts,
                    "tokens_per_s": tokens / wall,
                    "arrival_ttft_ms": list(ttft.values()),
                    "card_ms_per_step": prof["device_ms_per_step"],
                    "launches_per_step": prof["kernel_launches"]
                    / prof["steps"], "busy_share": prof["busy_share"]})
        want = streams
        del g
        torch.cuda.empty_cache()
    out[0]["vs_single_stream"] = [
        family_until_tie(
            torch, cfg, params, f"{label} batch stream {sid}", every[sid],
            ids, lambda sid=sid, n=len(ids): single_stream(
                torch, cfg, params, every[sid], n, settings, None), settings)
        for sid, ids in want.items()]
    return out


def family_spec(torch, build, cfg, params, label, prompt, ref_ids,
                settings) -> dict:
    """``SpeculativeGenerator`` (K = FAMILY_SPEC_K, rounds chained) on
    phase 5's prompt, 64 tokens: launches exact (a verify is one model
    call: a multi-query decode a layer at D = 256), ids equal to the plain
    stream up to its first near-tie."""
    from cake_tpu_torch.runtime.speculative import SpeculativeGenerator

    gen = SpeculativeGenerator(cfg, params, settings=settings,
                               spec_k=FAMILY_SPEC_K, spec_rounds=8)
    gen.set_prompt(prompt)
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    ids = [gen.next_token(0).id]
    t1 = time.perf_counter()
    ids += [gen.next_token(i).id for i in range(1, len(ref_ids))]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = build.launches()
    want = expected_launches(cfg, "bf16", None, gen.prefill_calls,
                             gen.decode_steps + gen.verify_calls)
    say(f"[13] {label} --speculate {FAMILY_SPEC_K}: {gen.verify_calls} "
        f"verifies, {gen.decode_steps} plain steps, "
        f"{gen.emitted / gen.dispatches:.2f} tokens a dispatch, decode "
        f"{(len(ids) - 1) / (t2 - t1):.2f} tokens/s; launches {counts}")
    if counts != want or not gen.verify_calls:
        fail(f"[13] {label} speculation: kernels launched {counts}, want "
             f"{want}")
    out = {"path": f"spec {label}", "launches": counts,
           "verify_calls": gen.verify_calls,
           "decode_tokens_per_s": (len(ids) - 1) / (t2 - t1)}
    out.update(family_until_tie(torch, cfg, params,
                                f"{label} speculation", prompt, ids,
                                ref_ids, settings))
    return out


def phase_families(torch, build) -> list:
    """Phase 13: each of FAMILY_PATHS at full width with random weights
    (seed 0) drawn on the card, each path's weights freed before the
    next."""
    from cake_tpu_torch.models import config as presets
    from cake_tpu_torch.models import llama
    from cake_tpu_torch.ops.sampling import SamplerSettings

    settings = SamplerSettings(temperature=0)
    results = []
    for label, preset, layers, weights, caches, batch, spec in FAMILY_PATHS:
        t_path = time.perf_counter()
        cfg = getattr(presets, preset)(num_hidden_layers=layers,
                                       max_seq_len=S)
        prompt = main_path_prompt(torch, cfg)
        t0 = time.perf_counter()
        params = family_init(llama, weights)(cfg, seed=SEED)
        torch.cuda.synchronize()
        say(f"[13] {label}: {layers} layers drawn on the card in "
            f"{time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
        plain_ids = None
        for kv_quant in caches:
            r = family_generator(torch, build, cfg, params, label, weights,
                                 kv_quant, prompt, settings)
            ids = r.pop("ids")
            plain_ids = plain_ids or ids
            results.append(r)
        if batch:
            results += family_batch(torch, build, cfg, params, label,
                                    weights, settings)
        if spec:
            results.append(family_spec(torch, build, cfg, params, label,
                                       prompt, plain_ids, settings))
        del params
        torch.cuda.empty_cache()
        say(f"[13] {label}: {time.perf_counter() - t_path:.1f} s")
    return results


# --------------------------------------------------------------------------
# phase 14
# --------------------------------------------------------------------------

# the disaggregated fleet's replicas: the paged engine at 8 slots, page 16
DISAGG_SLOTS = 8
# phase 5's prompt length: the handoff the prediction in PERF.md is about
HANDOFF_PROMPT = 2000


def serve_prompts(torch, cfg) -> tuple[list, tuple]:
    """Phase 8's five prompts (900, 300, 120, 40 and 600 ids) and quotas."""
    g = torch.Generator().manual_seed(SEED + 9)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()
               for n in (900, 300, 120, 40, 600)]
    return prompts, (32, 24, 40, 16, 24)


class Replica:
    """One serve replica in this process: the paged engine (8 slots, page
    16, greedy) over ``params``, its scheduler in ``role``, the HTTP API
    on an ephemeral port and, with ``transfer``, a KV transfer listener
    whose port ``/healthz`` advertises."""

    def __init__(self, cfg, params, role="mixed", transfer=False,
                 kv_quant=None, codec="none"):
        from cake_tpu_torch.disagg import TransferServer
        from cake_tpu_torch.ops.sampling import SamplerSettings
        from cake_tpu_torch.runtime.batch_generator import BatchGenerator
        from cake_tpu_torch.serve.api import start_api_server
        from cake_tpu_torch.serve.scheduler import Scheduler

        self.role = role
        self.engine = BatchGenerator(
            cfg, params, settings=SamplerSettings(temperature=0),
            block_size=8, kv_quant=kv_quant, kv_layout="paged",
            kv_page_size=16)
        self.sched = Scheduler(self.engine, queue_depth=8,
                               request_timeout_s=300, role=role,
                               transfer_codec=codec)
        self.sched.start(max_concurrent=DISAGG_SLOTS, warm_prompt_len=64)
        self.server = start_api_server(self.sched, bind="127.0.0.1", port=0)
        self.port = self.server.port
        self.addr = f"127.0.0.1:{self.port}"
        self.xfer = None
        if transfer:
            self.xfer = TransferServer(self.sched).start()
            self.sched.transfer_port = self.xfer.port

    def calls(self) -> tuple[int, int]:
        return self.engine.prefill_calls, self.engine.decode_steps

    def healthz(self) -> tuple[int, dict]:
        import urllib.error
        import urllib.request

        try:
            with urllib.request.urlopen(
                    f"http://{self.addr}/healthz", timeout=30) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read() or b"{}")

    def close(self) -> None:
        self.server.close()
        if self.xfer is not None:
            self.xfer.stop()
        self.sched.close()


def timed_sse(port: int, body: dict, on_token=None) -> dict:
    """``sse`` with the client's times: to the first and to the second
    token (ms from the request)."""
    t0 = time.perf_counter()
    marks = []

    def mark():
        marks.append((time.perf_counter() - t0) * 1e3)
        if on_token is not None:
            on_token(len(marks))

    r = sse(port, body, mark)
    r["ttft_ms"] = marks[0] if marks else None
    r["second_token_ms"] = marks[1] if len(marks) > 1 else None
    return r


def wait_until(cond, what: str, timeout: float = 60.0) -> None:
    deadline = time.time() + timeout
    while not cond():
        if time.time() > deadline:
            fail(f"[14] {what}")
        time.sleep(0.05)


class HandoffClock:
    """The handoff's parts, timed where they run: the prefill engine's
    export (pages gathered and copied to the host), the send over the
    transfer channel (with its ACK), and the decode engine's import
    (parse, then the pages written into its pool). Each is a list of ms,
    one a handoff; ``bytes`` the snapshot sizes."""

    def __init__(self, torch, pre, dec):
        import cake_tpu_torch.disagg as disagg

        self.parts = {"export_ms": [], "send_ms": [], "import_parse_ms": [],
                      "import_write_ms": [], "bytes": []}
        self._undo = []

        def timed(obj, name, key, sync=False, nbytes=None):
            real = getattr(obj, name)

            def wrapper(*a, **kw):
                if sync:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = real(*a, **kw)
                if sync:
                    torch.cuda.synchronize()
                self.parts[key].append((time.perf_counter() - t0) * 1e3)
                if nbytes is not None:
                    self.parts["bytes"].append(nbytes(a, kw))
                return out

            setattr(obj, name, wrapper)
            self._undo.append((obj, name, real))

        timed(pre.engine, "export_stream", "export_ms", sync=True)
        timed(disagg, "send_snapshot", "send_ms",
              nbytes=lambda a, kw: len(a[2]))
        timed(dec.engine, "import_begin", "import_parse_ms")
        timed(dec.engine, "_import_begin_tick", "import_write_ms",
              sync=True)

    def close(self) -> None:
        for obj, name, real in self._undo:
            if isinstance(obj, type(json)):  # a module's function
                setattr(obj, name, real)
            else:
                delattr(obj, name)  # the engine's own method again


def two_stage(pre, dec, prompt, quota) -> dict:
    """The gateway's two-stage route by hand, timed: prefill on ``pre``
    with ``dec``'s transfer channel as the handoff target (the reply
    carries the transfer id and the snapshot's bytes), then the resume on
    ``dec``, whose first token is the snapshot's own (replayed) and whose
    second is the first it decodes."""
    import urllib.request

    t0 = time.perf_counter()
    req = urllib.request.Request(
        f"http://{pre.addr}/v1/completions",
        data=json.dumps({"prompt_ids": prompt, "max_tokens": quota,
                         "_disagg": {"target": f"127.0.0.1:"
                                               f"{dec.xfer.port}"}}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        out = json.loads(r.read())
    leg_ms = (time.perf_counter() - t0) * 1e3
    if not out.get("handoff"):
        fail(f"[14] the prefill replica did not hand off: {out}")
    r = timed_sse(dec.port, {"prompt_ids": prompt, "max_tokens": quota,
                             "_resume": {"xfer_id": out["xfer_id"]}})
    return {"prefill_leg_ms": leg_ms,
            "resume_to_first_token_ms": r["second_token_ms"],
            "snapshot_bytes": out["snapshot_bytes"], "ids": r["ids"]}


def disagg_path(torch, build, cfg, params, label, weights, kv_quant,
                codecs) -> dict:
    """One path of phase 14 over ``params``: the reference (a mixed
    replica, requests one at a time), then a decode replica and, for each
    codec of ``codecs``, a fresh prefill replica (a second pass over the
    same prompts would hit its prefix store, and a prefix hit prefills at
    other shapes) that join a p2c gateway started with no backends by
    registering; the five prompts through the gateway as SSE, and phase
    5's 2,000-id handoff by hand."""
    from cake_tpu_torch.gateway.api import HANDOFFS, start_gateway
    from cake_tpu_torch.gateway.health import HealthMonitor
    from cake_tpu_torch.gateway.policy import make_policy
    from cake_tpu_torch.ops.sampling import SamplerSettings
    from cake_tpu_torch.serve.register import Registrar

    settings = SamplerSettings(temperature=0)
    prompts, quotas = serve_prompts(torch, cfg)
    mixed = Replica(cfg, params, kv_quant=kv_quant)
    ref = [timed_sse(mixed.port, {"prompt_ids": p, "max_tokens": q})
           for p, q in zip(prompts, quotas)]
    mixed.close()
    del mixed
    torch.cuda.empty_cache()

    mon = HealthMonitor([], probe_interval=0.2, up_after=1, lease_ttl_s=5.0,
                        allow_empty=True).start()
    gw = start_gateway(mon, make_policy("p2c"), connect_timeout=5.0,
                       read_timeout=300.0)
    gw_url = f"http://127.0.0.1:{gw.port}"
    dec = Replica(cfg, params, "decode", transfer=True, kv_quant=kv_quant)
    dec_reg = Registrar(gw_url, dec.addr, role="decode",
                        transfer_port=dec.xfer.port).start()
    out = {"path": label, "runs": {}}
    # launches and model calls of both replicas while requests run (each
    # prefill replica is made and warmed outside these windows)
    counts = dict.fromkeys(build.launches(), 0)
    calls, pre_calls = [0, 0], [0, 0]
    n_req = handoffs = 0
    parts = {}
    try:
        for codec in codecs + ("handoff",):
            pre = Replica(cfg, params, "prefill", kv_quant=kv_quant,
                          codec="none" if codec == "handoff" else codec)
            reg = Registrar(gw_url, pre.addr, role="prefill").start()
            wait_until(lambda: {b.addr for b in mon.routable()}
                       >= {pre.addr, dec.addr},
                       f"{label}: the gateway never found the tiers from "
                       "the replicas' registrations and /healthz")
            clock = HandoffClock(torch, pre, dec)
            torch.cuda.synchronize()
            l0, p0, d0 = build.launches(), pre.calls(), dec.calls()
            h0 = HANDOFFS.value

            def close_window():
                """The window's launches and both replicas' model calls,
                once no transfer is left in flight."""
                wait_until(lambda: dec.sched.kv_transfers_inflight() == 0
                           and pre.sched.kv_transfers_inflight() == 0,
                           f"{label}: kv_transfers_inflight never returned "
                           "to 0")
                torch.cuda.synchronize()
                l1, p1, d1 = build.launches(), pre.calls(), dec.calls()
                for k in counts:
                    counts[k] += l1[k] - l0[k]
                for j in range(2):
                    pre_calls[j] += p1[j] - p0[j]
                    calls[j] += p1[j] - p0[j] + d1[j] - d0[j]

            try:
                if codec == "handoff":
                    g = torch.Generator().manual_seed(SEED)
                    long_prompt = torch.randint(
                        0, cfg.vocab_size, (HANDOFF_PROMPT,),
                        generator=g).tolist()
                    hand = two_stage(pre, dec, long_prompt, 16)
                    close_window()
                    parts = clock.parts
                    continue
                got = [timed_sse(gw.port, {"prompt_ids": p,
                                           "max_tokens": q})
                       for p, q in zip(prompts, quotas)]
                # the comparisons' teacher-forced passes run after it
                close_window()
                n_req += len(got)
                handoffs += HANDOFFS.value - h0
                run = {"ttft_ms": [r["ttft_ms"] for r in got],
                       "ttft_direct_ms": [r["ttft_ms"] for r in ref],
                       "snapshot_bytes": clock.parts["bytes"],
                       "export_ms": clock.parts["export_ms"],
                       "send_ms": clock.parts["send_ms"],
                       "import_parse_ms": clock.parts["import_parse_ms"],
                       "import_write_ms": clock.parts["import_write_ms"]}
                for i, (r, want) in enumerate(zip(got, ref)):
                    what = f"{label} codec {codec} prompt {i}"
                    if codec == "int8":
                        # lossy: each step the greedy choice of its own
                        # teacher-forced logits outside near-ties
                        run.setdefault("held", []).append(family_until_tie(
                            torch, cfg, params, what, prompts[i], r["ids"],
                            want["ids"], settings, tag="[14]"))
                    elif codec == "bf16":
                        if r["ids"] != out["runs"]["none"]["ids"][i]:
                            fail(f"[14] {what}: the bf16 codec's ids differ "
                                 "from codec none's (it is lossless on "
                                 "this cache)")
                    else:
                        run.setdefault("held", []).append(check_until_tie(
                            torch, cfg, params, what, prompts[i], r["ids"],
                            want["ids"], settings, kv_quant, tag="[14]"))
                run["ids"] = [r["ids"] for r in got]
                out["runs"][codec] = run
                say(f"[14] {label} codec {codec}: 5 SSE streams through the "
                    f"gateway (prefill -> handoff -> decode) held to the "
                    f"mixed replica's ids; snapshot bytes "
                    f"{run['snapshot_bytes']}; export ms "
                    f"{[round(x, 2) for x in run['export_ms']]}, send ms "
                    f"{[round(x, 2) for x in run['send_ms']]}, import ms "
                    f"{[round(x, 2) for x in run['import_parse_ms']]} parse "
                    f"+ {[round(x, 2) for x in run['import_write_ms']]} "
                    f"write; client TTFT ms "
                    f"{[round(t, 2) for t in run['ttft_ms']]} against the "
                    f"mixed replica's direct "
                    f"{[round(t, 2) for t in run['ttft_direct_ms']]}")
            finally:
                clock.close()
                reg.deregister()
                pre.close()
                del pre
                torch.cuda.empty_cache()
        want = expected_launches(cfg, weights, kv_quant, *calls)
        say(f"[14] {label} launches {counts} over {calls[0]} prompt passes "
            f"and {calls[1]} decode steps (prefill replicas {pre_calls}, "
            f"decode replica {[calls[j] - pre_calls[j] for j in range(2)]});"
            f" gateway handoffs {handoffs} for {n_req} requests; no "
            "transfer left in flight")
        if counts != want:
            fail(f"[14] {label}: kernels launched {counts}, want {want}")
        if handoffs != n_req:
            fail(f"[14] {label}: {handoffs} handoffs for {n_req} "
                 "requests through the gateway")
        out.update(launches=counts, handoffs=handoffs, handoff_2000=dict(
            hand, ids=None, export_ms=parts["export_ms"][-1],
            send_ms=parts["send_ms"][-1],
            import_parse_ms=parts["import_parse_ms"][-1],
            import_write_ms=parts["import_write_ms"][-1]))
        h = out["handoff_2000"]
        say(f"[14] {label} handoff of the {HANDOFF_PROMPT}-id prompt (codec "
            f"none): snapshot {h['snapshot_bytes']} bytes; export "
            f"{h['export_ms']:.2f} ms, send {h['send_ms']:.2f} ms, import "
            f"{h['import_parse_ms']:.2f} ms parse + "
            f"{h['import_write_ms']:.2f} ms pool write; prefill leg "
            f"{h['prefill_leg_ms']:.2f} ms; resume to first decoded token "
            f"{h['resume_to_first_token_ms']:.2f} ms")
    finally:
        dec_reg.deregister()
        gw.close()
        mon.stop()
        dec.server.close()
        dec.xfer.stop()
        dec.sched.close()
    # the decode replica's 8-slot step on the card, its engine driven here
    # once its scheduler has stopped
    out["decode_profile"] = profile_batch(
        torch, dec.engine, batch_prompts(torch, cfg)[0], label, tag="[14]")
    del dec
    torch.cuda.empty_cache()
    return out


def migrate_and_register(torch, cfg, params) -> dict:
    """Two mixed replicas with transfer listeners join a round-robin
    gateway started with no backends (``Registrar``). A stream runs on the
    first; once it has 8 tokens the gateway drains that replica
    (``/v1/fleet/drain/<addr>``: the replica migrates to its sibling), and
    the stream must finish with the ids of an undisturbed run on the
    sibling. Then the sibling leaves as SIGTERM has it leave: it
    deregisters first, and the gateway stops routing to it while its own
    ``/healthz`` still answers 200; only then does its drain turn that
    503."""
    import threading
    import urllib.request

    from cake_tpu_torch.gateway.api import start_gateway
    from cake_tpu_torch.gateway.health import HealthMonitor
    from cake_tpu_torch.gateway.policy import make_policy
    from cake_tpu_torch.ops.sampling import SamplerSettings
    from cake_tpu_torch.serve import scheduler as scheduler_mod
    from cake_tpu_torch.serve.register import Registrar

    prompts, _ = serve_prompts(torch, cfg)
    a = Replica(cfg, params, transfer=True)
    b = Replica(cfg, params, transfer=True)
    mon = HealthMonitor([], probe_interval=0.2, up_after=1, lease_ttl_s=5.0,
                        allow_empty=True).start()
    gw = start_gateway(mon, make_policy("round_robin"), connect_timeout=5.0,
                       read_timeout=300.0)
    gw_url = f"http://127.0.0.1:{gw.port}"
    regs = {r.addr: Registrar(gw_url, r.addr, role="mixed",
                              transfer_port=r.xfer.port).start()
            for r in (a, b)}
    out = {}
    try:
        wait_until(lambda: {x.addr for x in mon.routable()}
                   == {a.addr, b.addr},
                   "the registered replicas never became routable")
        body = {"prompt_ids": prompts[1], "max_tokens": 160}
        want = sse(b.port, body)["ids"]
        m0 = scheduler_mod.MIGRATED.value
        ack, fired = {}, threading.Event()

        def drain():
            fired.wait(timeout=300)
            req = urllib.request.Request(
                f"{gw_url}/v1/fleet/drain/{a.addr}", data=b"{}",
                headers={"Content-Type": "application/json"},
                method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                ack.update(json.loads(r.read()))

        t = threading.Thread(target=drain)
        t.start()
        got = timed_sse(a.port, body,
                        on_token=lambda n: n == 8 and fired.set())["ids"]
        t.join(timeout=120)
        migrated = scheduler_mod.MIGRATED.value - m0
        say(f"[14] migrate-on-drain: drain ack {ack}; {migrated} session "
            f"migrated; the stream's {len(got)} ids against the undisturbed "
            f"run on the sibling")
        if not ack.get("ok") or migrated != 1 or len(got) != 160:
            fail(f"[14] the drain did not migrate the stream mid-decode "
                 f"(ack {ack}, {migrated} migrated, {len(got)} ids)")
        out["migrate"] = check_until_tie(
            torch, cfg, params, "migrated stream", prompts[1], got, want,
            SamplerSettings(temperature=0), None, tag="[14]")
        if mon.lookup(a.addr).state != "draining":
            fail(f"[14] the drained replica is {mon.lookup(a.addr).state} "
                 "at the gateway, want draining")
        # the sibling leaves: deregistered first, out of rotation while
        # its /healthz still says 200
        regs[b.addr].deregister()
        state = mon.lookup(b.addr).state
        code, _ = b.healthz()
        routable = [x.addr for x in mon.routable()]
        say(f"[14] registration: after the deregister the gateway holds the "
            f"sibling {state} (routable {routable}) while its /healthz "
            f"answers {code}")
        if b.addr in routable or code != 200:
            fail("[14] the gateway still routes to a deregistered replica, "
                 "or its /healthz turned 503 before the deregister")
        b.sched.migrate_out(None)  # the drain SIGTERM starts next
        wait_until(lambda: b.healthz()[0] == 503,
                   "the drained sibling's /healthz never turned 503")
        out["deregistered_state"] = state
    finally:
        for reg in regs.values():
            reg.stop()
        gw.close()
        mon.stop()
        a.close()
        b.close()
    del a, b
    torch.cuda.empty_cache()
    return out


def disagg_cli(torch, build) -> dict:
    """The command line's entry points as processes over phase 6's tiny
    checkpoint: ``--mode gateway`` (no backends), a prefill and a decode
    replica that ``--register-with`` it, and a mixed replica beside them.
    A request through the gateway gives the mixed replica's ids; SIGTERM
    drains all four and each exits 0 with "drained; bye"."""
    import signal
    import urllib.request

    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = {}

    def port_of(proc, log, pattern):
        deadline = time.time() + 300
        while time.time() < deadline:
            m = re.search(pattern, log.read_text())
            if m:
                return int(m.group(1))
            if proc.poll() is not None:
                fail(f"[14] cli: a process exited with {proc.returncode}: "
                     f"{log.read_text()[-2000:]}")
            time.sleep(0.2)
        fail(f"[14] cli: no port in 300 s: {log.read_text()[-2000:]}")

    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as d:
        write_cli_checkpoint(torch, build, d)
        logs, procs = {}, {}

        def start(name, args):
            logs[name] = Path(d) / f"{name}.log"
            with open(logs[name], "w") as log:
                procs[name] = subprocess.Popen(
                    [sys.executable, "-m", "cake_tpu_torch.cli", *args],
                    stdout=subprocess.DEVNULL, stderr=log, env=env,
                    cwd=REPO)

        try:
            start("gateway", ["--mode", "gateway", "--serve-port", "0",
                              "--probe-interval", "0.2", "--lease-ttl",
                              "5"])
            gw_port = port_of(procs["gateway"], logs["gateway"],
                              r"gateway on http://127\.0\.0\.1:(\d+)/")
            serve = ["--model", d, "--mode", "serve", "--serve-port", "0",
                     "--kv-layout", "paged", "--max-seq", "128",
                     "--temperature", "0", "--max-concurrent", "4"]
            reg = ["--register-with", f"http://127.0.0.1:{gw_port}"]
            start("prefill", serve + ["--role", "prefill"] + reg)
            start("decode", serve + ["--role", "decode"] + reg)
            start("mixed", serve)
            ports = {n: port_of(procs[n], logs[n],
                                r"serving on http://127\.0\.0\.1:(\d+)/")
                     for n in ("prefill", "decode", "mixed")}

            def tiers():
                try:
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{gw_port}/healthz",
                            timeout=10) as r:
                        return json.loads(r.read()).get("tiers") or {}
                except OSError:
                    return {}

            wait_until(lambda: tiers().get("prefill") and
                       tiers().get("decode"),
                       f"cli: the gateway never listed both tiers "
                       f"({tiers()})")
            body = {"prompt_ids": [3, 5, 7, 9], "max_tokens": 8}
            want = sse(ports["mixed"], body)["ids"]
            got = sse(gw_port, body)["ids"]
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{gw_port}/metrics", timeout=10) as r:
                metrics = r.read().decode()
            m = re.search(r"^cake_disagg_handoffs(?:_total)? (\S+)$",
                          metrics, re.M)
            handoffs = float(m.group(1)) if m else 0.0
            say(f"[14] cli: gateway {got} against the mixed replica "
                f"{want}; gateway handoffs {handoffs}")
            if got != want or len(got) != 8 or handoffs < 1:
                fail(f"[14] cli: the tiered route gave {got} ({handoffs} "
                     f"handoffs), the mixed replica {want}")
            out = {"ids": got, "handoffs": handoffs}
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.send_signal(signal.SIGTERM)
            codes = {}
            for n, proc in procs.items():
                try:
                    codes[n] = proc.wait(timeout=120)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    codes[n] = proc.wait()
        tails = {n: logs[n].read_text().strip().splitlines()[-1:]
                 for n in procs}
        say(f"[14] cli: SIGTERM exit codes {codes}")
        for n in procs:
            if codes[n] != 0 or not tails[n] or \
                    not tails[n][0].endswith("drained; bye"):
                fail(f"[14] cli: {n} exited {codes[n]}, last log line "
                     f"{tails[n]}: {logs[n].read_text()[-2000:]}")
        out["exit_codes"] = codes
    return out


def phase_disagg(torch, build) -> list:
    """Phase 14: disaggregated prefill/decode behind the routing gateway on
    Llama-3-8B at full width and SERVE_LAYERS, random weights (seed 0): (a)
    bf16 under the transfer codecs none, bf16 (bit-identical to none) and
    int8 (lossy: held to the teacher-forced choice), then migrate-on-drain
    and registration over the same weights; (b) int8 weights with the int8
    cache, codec none. Returns each path's results (the command line's
    entry points are ``disagg_cli``)."""
    from cake_tpu_torch.models import llama
    from cake_tpu_torch.models.config import llama3_8b

    cfg = llama3_8b(num_hidden_layers=SERVE_LAYERS, max_seq_len=4096)
    out = []
    for label, init, weights, kv_quant, codecs in (
            ("(a) bf16", lambda: llama.init_params(cfg, seed=SEED), "bf16",
             None, ("none", "bf16", "int8")),
            ("(b) int8 weights, int8 cache",
             lambda: llama.init_params_int8(cfg, seed=SEED), "quant_matmul",
             "int8", ("none",))):
        params = init()
        r = disagg_path(torch, build, cfg, params, label, weights, kv_quant,
                        codecs)
        if kv_quant is None:
            r.update(migrate_and_register(torch, cfg, params))
        out.append(r)
        del params
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# phase 15
# --------------------------------------------------------------------------


# the full-width run: Llama-3-8B at 8 of its 32 layers, split unevenly over
# two workers; the master keeps the embedding, the final norm and the head.
# On the H100 80GB HBM3 (700 W) a worker's decode op took about 1 ms plus
# 1.3 ms a layer, mostly host time, so 2 layers against 6 ran only 2.2-2.8x
# apart, and the report's p99s, interpolated in buckets 2x apart (2.5, 5,
# 10, 25 ms), flagged B at factor 2 in some runs and not in others; 1 layer
# against 7 should run about 4.5x apart
TOOLS_LAYERS = 8
TOOLS_NODES = {"A": (0, 1), "B": (1, 8)}
TOOLS_NEW = 32
# decode steps each worker serves before the cluster report is read: from
# 100 samples on, a p99 is no longer the largest sample, so one stalled op
# on the shared host does not decide which worker is the straggler
REPORT_STEPS = 256
# the card's codes are compared with the CPU quantizer's for these
TOOLS_CHECKED = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                 "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj",
                 "mlp.down_proj")
# a process that loads the embedding shim with ctypes and serves a worker
# through cake_start_worker_opts until SIGTERM
SHIM_HOST = ("import ctypes, logging, sys\n"
             "logging.basicConfig(level=logging.INFO)\n"
             "lib = ctypes.CDLL(sys.argv[1])\n"
             "f = lib.cake_start_worker_opts\n"
             "f.argtypes = [ctypes.c_char_p] * 5\n"
             "f.restype = ctypes.c_int\n"
             "sys.exit(f(*(a.encode() for a in sys.argv[2:])))\n")


def gbytes(path: Path) -> float:
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file()) / 1e9


def quantized_codes(quant, w, bits: int):
    """(codes in the HF [out, in] orientation, scale) of an HF weight, as
    ``tools/quantize_model.py`` stores them."""
    if bits == 8:
        q = quant.quantize_linear(w.t())
        return q.q.t().contiguous(), q.scale
    q = quant.quantize_linear4(w.t(), group_size=128)
    return q.qp.t().contiguous(), q.scale


def check_card_codes(torch, quant, src: Path, outs: dict) -> dict:
    """Layer 0's seven linears and the head, quantized on the CPU, against
    the files the card wrote (``outs``: bits -> directory), bit for bit;
    then a planted fault (one scale's last bit flipped) must fail the same
    check. Returns the CPU's seconds and GB/s for layer 0's linears."""
    from cake_tpu_torch.utils.safetensors import SafetensorsFile
    from cake_tpu_torch.utils.weights import load_safetensors_index

    src_files = load_safetensors_index(src)
    names = [f"model.layers.0.{n}.weight" for n in TOOLS_CHECKED]
    names.append("lm_head.weight")
    card = {bits: load_safetensors_index(d) for bits, d in outs.items()}

    def stored(bits, name):
        f = card[bits][name]
        return SafetensorsFile(f).get_tensor(name)

    cpu_s, cpu_bytes = 0.0, 0
    planted = None
    for name in names:
        w = SafetensorsFile(src_files[name]).get_tensor(name)
        for bits in outs:
            t0 = time.perf_counter()
            q, scale = quantized_codes(quant, w, bits)
            if bits == 8 and name.startswith("model.layers.0."):
                cpu_s += time.perf_counter() - t0
                cpu_bytes += w.numel() * w.element_size()
            suffix = ".q8" if bits == 8 else ".q4"
            got_q = stored(bits, name + suffix)
            got_s = stored(bits, name + ".scale")
            if not (torch.equal(got_q, q) and torch.equal(got_s, scale)):
                fail(f"{name} int{bits}: the card's codes or scales differ "
                     "from the CPU quantizer's")
            if planted is None:
                bad = got_s.clone()
                bad.view(torch.int32)[0] ^= 1
                planted = torch.equal(bad, scale)
    if planted:
        fail("a scale with its last bit flipped passed the codes check")
    say(f"[15] the card's int8 and int4 g128 codes and scales of layer 0's "
        f"seven linears and the head equal the CPU quantizer's bit for bit; "
        f"a scale with its last bit flipped fails the check; the CPU "
        f"quantizes layer 0's linears (int8) in {cpu_s:.3f} s, "
        f"{cpu_bytes / cpu_s / 1e9:.3f} GB/s")
    return {"cpu_layer0_s": cpu_s, "cpu_layer0_gb_per_s":
            cpu_bytes / cpu_s / 1e9}


def tools_master(cfg, head, topo, **kw):
    from cake_tpu_torch.ops.sampling import SamplerSettings
    from cake_tpu_torch.runtime.master import (
        DistributedGenerator,
        build_runners,
    )

    return DistributedGenerator(
        cfg, head, build_runners(cfg, topo, None, max_seq=cfg.max_seq_len,
                                 **kw),
        settings=SamplerSettings(temperature=0))


# a recovery replays the context in one prefill-shaped pass, so the
# replayed step's logits are the decode step's up to bf16 rounding in other
# kernel shapes: held to this relative L2 error (a replay at the wrong
# positions or over the wrong context reads ~1)
REPLAY_REL_L2 = 5e-2


def chaos_run(torch, cfg, head, workers, prompt, clean, label, faults,
              want_recoveries, **kw) -> dict:
    """The clean run again with a port ``ChaosProxy`` in front of each
    worker (``faults``: name -> schedule). The recoveries must count each
    fatal fault and the proxies' events list each fault. The ids must
    equal the clean run's (``clean``: its ids, logits and penalized
    margins) up to a replayed step that is a near-tie there (MARGIN_TIE),
    and each replayed step before that must take the clean step's greedy
    choice with logits within REPLAY_REL_L2 of the clean step's."""
    from cake_tpu_torch.parallel.topology import Topology
    from cake_tpu_torch.testing.chaos import ChaosProxy, parse_spec

    proxies = {n: ChaosProxy("127.0.0.1", w.port, parse_spec(faults[n]))
               .start() for n, w in workers.items()}
    gen = None
    replayed = []
    try:
        topo = Topology.from_dict({
            n: {"host": p.addr, "layers": [
                f"model.layers.{i}" for i in range(*TOOLS_NODES[n])]}
            for n, p in proxies.items()})
        gen = tools_master(cfg, head, topo, **kw)
        logits = keep_logits(gen)
        real = gen._replay_context

        def replay():
            replayed.append(len(gen._generated))
            return real()

        gen._replay_context = replay
        run = drive_stream(torch, gen, prompt, TOOLS_NEW)
        segs = gen.runner_stats()
        recoveries = gen.recoveries
    finally:
        if gen is not None:
            gen.close()
        for p in proxies.values():
            p.stop()
    events = {n: p.events for n, p in proxies.items()}
    fired = {n: [f for f in faults[n].split(",") if f != "none"]
             for n in faults}
    ids = run["ids"]
    parted = next((i for i, (a, b) in enumerate(zip(ids, clean["ids"]))
                   if a != b), None)
    held = [j for j in replayed if parted is None or j <= parted]
    rel = {j: float((logits[j] - clean["logits"][j]).norm()
                    / clean["logits"][j].norm()) for j in held}
    margins = {j: clean["margins"][j] for j in held}
    say(f"[15] {label}: {recoveries} recoveries, replayed steps {replayed} "
        f"(clean margins {margins}, logits relative L2 against the clean "
        f"steps {rel}); ids "
        f"{'equal' if parted is None else f'part at step {parted}'}; "
        f"events {events}; TTFT {run['ttft_ms']:.2f} ms, decode "
        f"{run['decode_tokens_per_s']:.2f} tokens/s; segment p50 ms "
        f"{[round(s['p50_ms'], 3) for s in segs]}")
    if recoveries != want_recoveries:
        fail(f"{label}: {recoveries} recoveries, want {want_recoveries}")
    for n in faults:
        if [e for _, e in events[n]] != fired[n]:
            fail(f"{label}: proxy {n} recorded {events[n]}, want "
                 f"{fired[n]}")
    bad = {j: r for j, r in rel.items() if r > REPLAY_REL_L2}
    if bad:
        fail(f"{label}: replayed steps' logits off the clean steps' by "
             f"{bad} (relative L2)")
    if parted is not None and not (parted in replayed
                                   and clean["margins"][parted] < MARGIN_TIE):
        fail(f"{label}: ids {ids} part from the clean run's "
             f"{clean['ids']} at step {parted}, not a replayed near-tie")
    return {"ttft_ms": run["ttft_ms"],
            "decode_tokens_per_s": run["decode_tokens_per_s"],
            "recoveries": recoveries, "events": events,
            "replayed_steps": replayed, "parted_at": parted,
            "replay_rel_l2": rel, "replay_clean_margins": margins,
            "segments_p50_ms": [s["p50_ms"] for s in segs]}


def tools_full_width(torch, build, root: Path) -> dict:
    """Phase 15 (a): Llama-3-8B at full width and 8 layers written by the
    port's writer, quantized on the card, split, served by two embedded
    workers from their bundles, clean and under chaos, and the cluster
    report of the clean run."""
    import shutil

    from cake_tpu_torch import embed
    from cake_tpu_torch.models import llama
    from cake_tpu_torch.models.config import llama3_8b
    from cake_tpu_torch.ops import quant
    from cake_tpu_torch.ops.sampling import SamplerSettings
    from cake_tpu_torch.parallel.runner import RemoteRunner
    from cake_tpu_torch.parallel.topology import Topology
    from cake_tpu_torch.runtime.generator import LlamaGenerator
    from cake_tpu_torch.tools import quantize_model, split_model
    from cake_tpu_torch.utils.weights import (
        load_llama_params,
        save_llama_params,
    )

    out: dict = {}
    cfg = llama3_8b(num_hidden_layers=TOOLS_LAYERS, max_seq_len=4096)
    src, q8, q4 = root / "bf16", root / "int8", root / "int4g128"
    params = llama.init_params(cfg, seed=SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_llama_params(params, src)
    (src / "config.json").write_text(json.dumps(cfg.to_hf_dict()))
    dt = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    out["checkpoint_gb"] = gbytes(src)
    out["checkpoint_write_gb_per_s"] = out["checkpoint_gb"] / dt
    say(f"[15] bf16 checkpoint of Llama-3-8B at {TOOLS_LAYERS} layers: "
        f"{out['checkpoint_gb']:.3f} GB written in {dt:.2f} s, "
        f"{out['checkpoint_write_gb_per_s']:.3f} GB/s")
    for label, d, kw in (("int8", q8, {}),
                         ("int4 g128", q4, dict(bits=4, group_size=128))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        quantize_model.quantize_checkpoint(src, d, **kw)
        dt = time.perf_counter() - t0
        out[f"quantize_{label}_s"] = dt
        say(f"[15] quantize_model {label} on the card: {dt:.2f} s, "
            f"{out['checkpoint_gb'] / dt:.3f} GB/s of the bf16 checkpoint "
            f"read; {gbytes(d):.3f} GB written")
    out.update(check_card_codes(torch, quant, src, {8: q8, 4: q4}))
    shutil.rmtree(q4)
    shutil.rmtree(src)

    topo_file = root / "topology.json"
    full_topo = {n: {"host": "127.0.0.1:0", "layers": [
        f"model.layers.{lo}" if hi - lo == 1 else
        f"model.layers.{lo}-{hi - 1}"]} for n, (lo, hi) in TOOLS_NODES.items()}
    topo_file.write_text(json.dumps(full_topo))
    t0 = time.perf_counter()
    split_model.main(["--model-path", str(q8), "--topology", str(topo_file),
                      "--output", str(root / "bundles")])
    out["split_s"] = time.perf_counter() - t0
    bundles = {n: root / "bundles" / f"{n}-node" for n in TOOLS_NODES}
    out["bundle_gb"] = {n: gbytes(b) for n, b in bundles.items()}
    say(f"[15] split_model: bundles {out['bundle_gb']} GB in "
        f"{out['split_s']:.2f} s")
    for n, b in bundles.items():
        if list(Topology.from_path(b / "topology.yml").nodes) != [n]:
            fail(f"bundle {n}: its topology.yml does not load back as {n}")

    workers = {}
    try:
        for n, b in bundles.items():
            t0 = time.perf_counter()
            workers[n] = embed.spawn_worker(
                n, str(b / "model"), str(b / "topology.yml"),
                address="127.0.0.1:0", max_seq=cfg.max_seq_len)
            out[f"load_{n}_bundle_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        from_full = embed.spawn_worker("B", str(q8), str(topo_file),
                                       address="127.0.0.1:0",
                                       max_seq=cfg.max_seq_len)
        out["load_B_full_dir_s"] = time.perf_counter() - t0
        from_full.shutdown()
        del from_full
        say(f"[15] embed.spawn_worker load: A {out['load_A_bundle_s']:.2f} "
            f"s, B {out['load_B_bundle_s']:.2f} s from their bundles; B "
            f"{out['load_B_full_dir_s']:.2f} s from the full directory")

        prompt = torch.randint(
            0, cfg.vocab_size, (2000,),
            generator=torch.Generator().manual_seed(SEED)).tolist()
        ref_gen = LlamaGenerator(
            cfg, load_llama_params(q8, TOOLS_LAYERS, quantize="int8"),
            settings=SamplerSettings(temperature=0), block_size=1)
        drive_stream(torch, ref_gen, prompt, 4)  # warm
        ref_logits = keep_logits(ref_gen)
        ref = drive_stream(torch, ref_gen, prompt, TOOLS_NEW)
        del ref_gen
        head = load_llama_params(q8, TOOLS_LAYERS, quantize="int8",
                                 layer_range=(0, 0))
        topo = Topology.from_dict({
            n: {"host": f"127.0.0.1:{w.port}",
                "layers": full_topo[n]["layers"]}
            for n, w in workers.items()})
        gen = tools_master(cfg, head, topo)  # warm: not timed or counted
        drive_stream(torch, gen, prompt, 4)
        gen.close()
        gen = tools_master(cfg, head, topo)
        try:
            logits = keep_logits(gen)
            p0, d0 = gen.prefill_calls, gen.decode_steps
            torch.cuda.synchronize()
            build.reset_launches()
            run = drive_stream(torch, gen, prompt, TOOLS_NEW)
            torch.cuda.synchronize()
            counts = build.launches()
            want = expected_launches(cfg, "quant_matmul", None,
                                     gen.prefill_calls - p0,
                                     gen.decode_steps - d0)
            diff = logits_diff(torch, logits, ref_logits)
            say(f"[15] clean run over the bundles: launches {counts} "
                f"(master and workers); logits against the single-device "
                f"generator over {diff['steps']} steps: "
                f"{diff['unequal_steps']} steps differ, max abs "
                f"{diff['max_abs']:.3e}")
            if counts != want or gen.prefill_calls - p0 != 1:
                fail(f"phase 15: kernels launched {counts}, want {want}")
            if diff["steps"] != TOOLS_NEW or diff["unequal_steps"]:
                fail(f"phase 15: logits differ from the single-device "
                     f"generator's at {diff['unequal_steps']} of "
                     f"{diff['steps']} steps")
            if run["ids"] != ref["ids"]:
                fail(f"phase 15: ids {run['ids']} differ from the "
                     f"single-device stream's {ref['ids']}")
            segs = gen.runner_stats()
            clean = {"ids": run["ids"], "logits": logits,
                     "margins": penalized_margins(
                         torch, torch.stack(logits).cuda(), prompt,
                         run["ids"], gen.settings)}
            out["clean"] = {"ttft_ms": run["ttft_ms"],
                            "decode_tokens_per_s":
                                run["decode_tokens_per_s"],
                            "segments": [{k: s[k] for k in (
                                "layers", "p50_ms", "p99_ms")}
                                for s in segs]}
            out["launches"] = counts
            say(f"[15] clean: TTFT {run['ttft_ms']:.2f} ms, decode "
                f"{run['decode_tokens_per_s']:.2f} tokens/s; segments "
                f"{out['clean']['segments']}")
            out["profile"] = profile_cross_host(torch, gen, TOOLS_NEW,
                                                "clean", phase=15)
            for i in range(TOOLS_NEW + 16, TOOLS_NEW + 16 + REPORT_STEPS):
                gen.next_token(i)
            report = gen.cluster_report(2.0)
        finally:
            gen.close()
        check_report(report)
        out["report"] = {n: {k: w[k] for k in (
            "forward_p50_ms", "forward_p99_ms", "rtt_ms", "clock_offset_ms",
            "straggler")} for n, w in report["workers"].items()}

        op_f = 2 + RemoteRunner.CLOCK_PINGS  # the first op of a connection
        out["chaos"] = chaos_run(
            torch, cfg, head, workers, prompt, clean,
            "chaos (kill, truncate, corrupt, a stall under --op-timeout)",
            {"A": f"none,kill@{op_f + 4},none,corrupt@{op_f + 1},none",
             "B": f"none,none,truncate@{op_f + 2},none,"
                  f"stall@{op_f + 1}=500"}, 3)
        out["chaos_stall"] = chaos_run(
            torch, cfg, head, workers, prompt, clean,
            "chaos (a stall over --op-timeout 3)",
            {"A": "none,none", "B": f"none,stall@{op_f + 2}=4500"}, 1,
            op_timeout_s=3.0)
    finally:
        for w in workers.values():
            w.shutdown()
    return out


def check_report(report: dict) -> None:
    """The clean run's cluster report: both workers up with forward
    p50/p99, RTT and clock offset; at a straggler factor of 2 the worker
    with 7 layers is flagged and the one with 1 is not; the panel carries
    both rows."""
    from cake_tpu_torch.obs.top import render

    ws = report["workers"]
    say("[15] cluster report: " + json.dumps(
        {n: {k: w.get(k) for k in ("up", "forward_p50_ms", "forward_p99_ms",
                                   "rtt_ms", "clock_offset_ms",
                                   "straggler")} for n, w in ws.items()}))
    for n in TOOLS_NODES:
        w = ws.get(n, {})
        if not (w.get("up") and w.get("forward_p50_ms")
                and w.get("forward_p99_ms") and w.get("rtt_ms")
                and w.get("clock_offset_ms") is not None):
            fail(f"cluster report: worker {n} is not up with its forward "
                 f"p50/p99, RTT and clock offset: {w}")
    if report["stragglers"] != ["B"]:
        fail(f"cluster report: stragglers {report['stragglers']} at factor "
             "2, want B (7 layers) and not A (1)")
    panel = render(report)
    if not all(f"\n{n} " in panel for n in TOOLS_NODES):
        fail(f"the --top panel lacks a worker's row:\n{panel}")
    say(panel)


def tools_cli(torch, build, root: Path, local_ids: dict) -> dict:
    """Phase 15 (b): the tools and the cluster flags as processes over
    phase 6's checkpoint: quantize_model (int8; int4 g64) and split_model
    over two workers, one a ``--mode worker`` process and one served
    through the C shim from a process that loads it with ctypes; a
    ``--topology`` master with ``--chaos``, ``--cluster-report`` and
    ``--top`` prints phase 6's ids; SIGTERM ends each worker with exit 0.
    The two tiers run side by side."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    shim = build.build_shim()
    write_cli_checkpoint(torch, build, root)
    # phase 6's label -> (quantize_model's flags, the --mode worker's
    # flags, the shim worker's options, the master's flags)
    tiers = {"int8": (["--bits", "8"], ["--quantize", "int8",
                                        "--kv-quant", "int8"],
                      {"kv_quant": "int8"}, ["--quantize", "int8"]),
             "int4:g64": (["--bits", "4", "--group-size", "64"],
                          ["--quantize", "int4:g64"], {},
                          ["--quantize", "int4:g64"])}
    dirs = {t: t.replace(":", "") for t in tiers}
    layers = {"w0": ["model.layers.0"], "w1": ["model.layers.1"]}
    topo = root / "split.json"
    topo.write_text(json.dumps({n: {"host": "127.0.0.1:10128",
                                    "layers": ls}
                                for n, ls in layers.items()}))

    def run_all(cmds: dict, what: str) -> dict:
        procs = {k: subprocess.Popen(c, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True,
                                     env=env, cwd=REPO)
                 for k, c in cmds.items()}
        outs = {}
        for k, p in procs.items():
            o, e = p.communicate(timeout=300)
            if p.returncode != 0:
                fail(f"{what} {k} exit {p.returncode}: {e[-2000:]}")
            outs[k] = (o, e)
        return outs

    t0 = time.perf_counter()
    py = [sys.executable, "-m"]
    run_all({t: py + ["cake_tpu_torch.tools.quantize_model", "--model-path",
                      str(root), "--output", str(root / dirs[t]), *qf]
             for t, (qf, _, _, _) in tiers.items()}, "quantize_model")
    run_all({t: py + ["cake_tpu_torch.tools.split_model", "--model-path",
                      str(root / dirs[t]), "--topology", str(topo),
                      "--output", str(root / f"b-{dirs[t]}")]
             for t in tiers}, "split_model")
    say(f"[15] cli: quantize_model and split_model, int8 and int4 g64, in "
        f"{time.perf_counter() - t0:.1f} s")
    procs, logs = {}, {}
    out = {}
    try:
        for t, (_, wflags, opts, _) in tiers.items():
            b = root / f"b-{dirs[t]}"
            logs[t, "w0"] = root / f"{dirs[t]}-w0.log"
            logs[t, "w1"] = root / f"{dirs[t]}-w1.log"
            with open(logs[t, "w0"], "w") as log:
                procs[t, "w0"] = subprocess.Popen(
                    py + ["cake_tpu_torch.cli", "--mode", "worker", "--name",
                          "w0", "--model", str(b / "w0-node" / "model"),
                          "--topology", str(b / "w0-node" / "topology.yml"),
                          "--address", "127.0.0.1:0", "--max-seq", "128",
                          *wflags],
                    stdout=subprocess.DEVNULL, stderr=log, env=env, cwd=REPO)
            with open(logs[t, "w1"], "w") as log:
                procs[t, "w1"] = subprocess.Popen(
                    [sys.executable, "-c", SHIM_HOST, str(shim), "w1",
                     str(b / "w1-node" / "model"),
                     str(b / "w1-node" / "topology.yml"), "127.0.0.1:0",
                     json.dumps({"max_seq": 128, **opts})],
                    stdout=subprocess.DEVNULL, stderr=log, env=env, cwd=REPO)
        masters = {}
        for t, (_, _, _, mflags) in tiers.items():
            mt = root / f"master-{dirs[t]}.json"
            mt.write_text(json.dumps({
                n: {"host": f"127.0.0.1:"
                            f"{worker_port(procs[t, n], logs[t, n])}",
                    "layers": ls} for n, ls in layers.items()}))
            masters[t] = py + [
                "cake_tpu_torch.cli", "--model", str(root / dirs[t]),
                *CLI_RUN, "--topology", str(mt), "--connect-retries", "100",
                "--chaos", "kill@7", "--cluster-report",
                str(root / f"report-{dirs[t]}.json"), "--top", *mflags]
        results = run_all(masters, "topology master")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.terminate()
        codes = {}
        for k, p in procs.items():
            try:
                codes[k] = p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                codes[k] = p.wait()
    for t, (stdout, stderr) in results.items():
        ids = stdout.strip()
        want = ",".join(map(str, local_ids[t]))
        report = json.loads((root / f"report-{dirs[t]}.json").read_text())
        say(f"[15] cli {t}: master over a --mode worker and a shim worker "
            f"printed {ids!r} (phase 6: {want}); report workers "
            f"{sorted(report['workers'])}, recoveries "
            f"{report['recoveries']}; worker exit codes "
            f"{[codes[t, n] for n in layers]}")
        if ids != want:
            fail(f"cli {t}: stdout {ids!r}, want only phase 6's ids {want}")
        if sorted(report["workers"]) != sorted(layers) or not all(
                w["up"] for w in report["workers"].values()):
            fail(f"cli {t}: the cluster report names {report['workers']}")
        if "WORKER" not in stderr or "cake-tpu cluster" not in stderr:
            fail(f"cli {t}: no --top panel on stderr")
        if "chaos enabled" not in stderr:
            fail(f"cli {t}: --chaos did not arm its proxies")
        out[t] = {"ids": ids, "recoveries": report["recoveries"]}
    bad = {f"{t}/{n}": c for (t, n), c in codes.items() if c != 0}
    if bad:
        fail(f"workers did not exit 0 on SIGTERM: {bad}; "
             f"{[logs[k].read_text()[-1000:] for k in logs]}")
    return out


def phase_tools(torch, build, local_ids: dict) -> dict:
    """Phase 15: the operator's tools, the embeddable worker and the
    cross-host fault and cluster views on the card. The files live in a
    temporary directory removed at the end, whatever happens."""
    import shutil

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(build.BUILD_DIR).free
    say(f"[15] free disk under {build.BUILD_DIR.name}: {free / 1e9:.1f} GB "
        "(the run writes ~12 GB)")
    t0 = time.perf_counter()
    root = Path(tempfile.mkdtemp(dir=build.BUILD_DIR))
    try:
        full = tools_full_width(torch, build, root / "full")
        t_full = time.perf_counter() - t0
        (root / "cli").mkdir()
        cli_run = tools_cli(torch, build, root / "cli", local_ids)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    seconds = time.perf_counter() - t0
    say(f"[15] phase 15 took {seconds:.1f} s ({t_full:.1f} s the "
        "full-width run)")
    return {"path": "tools: quantize, split, embedded workers, chaos, "
                    "cluster report", "launches": full.pop("launches"),
            "full_width": full, "cli": cli_run, "seconds": seconds}


# --------------------------------------------------------------------------
# phase 16
# --------------------------------------------------------------------------


# the (tp, H, KVH) of the tp-local attention: Llama-3-8B's heads over tp 2
# and 4
TP_HEADS = tuple((tp, H // tp, KVH // tp) for tp in (2, 4))
# the tp-local linears (K, N) of Llama-3-8B at tp 2 and 4: gate/up and q
# (column-parallel: N split), down and o (row-parallel: K split), and the
# vocab-sharded head (N 64,128 and 32,064: the latter off the 128-column
# tile)
TP_LINEARS = tuple(
    (tp, ((4096, 14336 // tp), (14336 // tp, 4096), (4096, 1024 // tp),
          (4096, 4096 // tp), (4096 // tp, 4096), (4096, 128256 // tp)))
    for tp in (2, 4))
# the mesh's speculative verify at tp-local heads: T = K + 1 query rows a
# stream at the command line's --speculate 4 and at K = 8; M = 5 rows of
# each tp-local linear
TP_MQ_T = (5, 9)
TP_VERIFY_M = 5


def phase_tp_kernels(torch, flash, qmatmul, quant, kvcache) -> dict:
    """Phase 2 at the mesh's tp-local shapes: both prefills (the 2,000-id
    prompt) and both decodes (one stream at 2047, four rows at ragged
    frontiers) at H/tp and KVH/tp, both decodes' multi-query form (the
    mesh's verify) at T = TP_MQ_T (one stream at 2047, four rows at
    ragged frontiers with one at S - T), each matmul tier at every
    tp-local linear at M = 1, TP_VERIFY_M and 2000; planted faults at tp 4
    (a dropped KV tile in each attention kernel, also at each T, a K tile
    short in each matmul tier) must fail."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    errs = {}
    for tp, h, kvh in TP_HEADS:
        k, v = rnd(1, kvh, S, D), rnd(1, kvh, S, D)
        kq, vq = kvcache.quant_kv(k), kvcache.quant_kv(v)
        kv8 = (kq.q, kq.scale, vq.q, vq.scale)
        q = rnd(1, h, 2000, D)
        for name, ops, fn, ref in (
                ("flash_prefill", (k, v), flash.flash_attention,
                 flash.flash_attention_ref),
                ("flash_prefill_q8", kv8, flash.flash_attention_q8,
                 flash.flash_attention_q8_ref)):
            errs[(name, "tp", tp)] = compare(
                torch, f"{name} tp={tp} H={h} KVH={kvh} T=2000",
                fn(q, *ops, 0), ref(q, *ops, 0))
            if tp == 4:
                planted(torch, f"{name} tp=4 T=2000 last tile dropped",
                        tile_short(flash, lambda: fn(q, *ops, 0)),
                        ref(q, *ops, 0))
        kb, vb = rnd(4, kvh, S, D), rnd(4, kvh, S, D)
        kbq, vbq = kvcache.quant_kv(kb), kvcache.quant_kv(vb)
        for name, one, four in (
                ("flash_decode", (k, v), (kb, vb)),
                ("flash_decode_q8", kv8,
                 (kbq.q, kbq.scale, vbq.q, vbq.scale))):
            kernel = getattr(flash, name)
            plain = getattr(flash, f"{name}_ref")
            for b, ops, pos in ((1, one, [2047]),
                                (4, four, [3, 700, 2048, 4095])):
                qd = rnd(b, h, 1, D)
                p = torch.tensor(pos, dtype=torch.int32, device="cuda")
                err = compare(torch, f"{name} tp={tp} H={h} KVH={kvh} "
                              f"B={b} pos={pos}", kernel(qd, *ops, p),
                              plain(qd, *ops, p))
                if b == 1:
                    errs[(name, "tp", tp)] = err
            if tp == 4:
                qd = rnd(1, h, 1, D)
                good = torch.tensor([2047], dtype=torch.int32,
                                    device="cuda")
                planted(torch, f"{name} tp=4 pos=2047 last tile dropped",
                        kernel(qd, *one, good - 64), plain(qd, *one, good))
            for t in TP_MQ_T:
                for b, ops, pos in ((1, one, [2047]),
                                    (4, four, [S - t, 2047, 700, 3])):
                    qd = rnd(b, h, t, D)
                    p = torch.tensor(pos, dtype=torch.int32, device="cuda")
                    err = compare(torch, f"{name} tp={tp} H={h} KVH={kvh} "
                                  f"T={t} B={b} pos={pos}",
                                  kernel(qd, *ops, p), plain(qd, *ops, p))
                    if b == 1:
                        errs[(name, "tp", tp, "mq", t)] = err
                if tp == 4:
                    qd = rnd(1, h, t, D)
                    good = torch.tensor([2047], dtype=torch.int32,
                                        device="cuda")
                    planted(torch, f"{name} tp=4 T={t} pos=2047 last tile "
                            "dropped", kernel(qd, *one, good - 64),
                            plain(qd, *one, good))
        del k, v, kv8, kb, vb, kbq, vbq
    plain = {"quant_matmul": quant.quant_matmul_ref,
             "quant4_matmul": quant.quant4_matmul_ref}
    for tp, linears in TP_LINEARS:
        for k, n in linears:
            w = torch.randn(k, n, generator=gen, device="cuda") / k ** 0.5
            for tier in TIERS:
                name, wq, scale = quantized(quant, w, tier)
                for m in (1, TP_VERIFY_M, 2000):
                    x = torch.randn(m, k, generator=gen, device="cuda").to(
                        torch.bfloat16)
                    label = f"{name} {tier_label(tier)} tp={tp} M={m} " \
                            f"K={k} N={n}"
                    errs[(name, tier[1], "tp", tp, m, k, n)] = compare(
                        torch, label, getattr(qmatmul, name)(x, wq, scale),
                        plain[name](x, wq, scale))
                    if tp == 4 and (k, n) == linears[1] and m == 1:
                        k2 = k - qmatmul.BLOCK_K
                        int4 = name == "quant4_matmul"
                        planted(torch, f"{label} one K tile short",
                                qmatmul._launch(
                                    name, x[:, :k2].contiguous(),
                                    wq[:k2 // 2 if int4 else k2], scale, n,
                                    (tier[1] or 0,) if int4 else ()),
                                plain[name](x, wq, scale))
                del wq, scale
            del w
    torch.cuda.empty_cache()
    say("[2] every kernel at the tp 2 and tp 4 local shapes (the decodes "
        f"also at T = {list(TP_MQ_T)}, the matmuls also at M = "
        f"{TP_VERIFY_M}): within tolerance; the planted faults fail")
    return errs


def tp_local_timing(torch, flash, qmatmul, quant, kvcache, build,
                    rows) -> None:
    """Phase 3 at the tp-local shapes: each kernel row gains ``tp_cases``,
    the kernel's, plain and library ms beside the bound at tp 2 and 4
    (attention: the 2,000-id prompt's prefill, one stream's decode at
    2047, also at T = TP_MQ_T; matmuls at M = 1 and TP_VERIFY_M: the
    tp-local gate/up, down and head)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    by_name = {r["name"]: r for r in rows}
    for tp, h, kvh in TP_HEADS:
        for name in ("flash_decode", "flash_decode_q8"):
            for t in (1,) + TP_MQ_T:
                c = decode_case(torch, flash, kvcache, name, 1, (2047,),
                                rnd, t=t, shape=(h, kvh, D))
                by_name[name].setdefault("tp_cases", []).append(
                    {"tp": tp, **c})
        k, v = rnd(1, kvh, S, D), rnd(1, kvh, S, D)
        kq, vq = kvcache.quant_kv(k), kvcache.quant_kv(v)
        t = 2000
        q = rnd(1, h, t, D)
        for name, ops, fn, ref in (
                ("flash_prefill", (k, v), flash.flash_attention,
                 flash.flash_attention_ref),
                ("flash_prefill_q8", (kq.q, kq.scale, vq.q, vq.scale),
                 flash.flash_attention_q8, flash.flash_attention_q8_ref)):
            b_ms, b_by = bound(*prefill_cost(
                h, kvh, D, t, t, t * (t + 1) // 2,
                q8=name == "flash_prefill_q8"))
            lk, lv = ((k, v) if name == "flash_prefill" else tuple(
                kvcache.dequant_kv(c, torch.bfloat16) for c in (kq, vq)))
            c = {"tp": tp, "shape": f"q [1,{h},{t},{D}] k/v "
                                     f"[1,{kvh},{S},{D}] pos 0",
                 "ms": time_ms(lambda: fn(q, *ops, 0)),
                 "plain_ms": time_ms(lambda: ref(q, *ops, 0)),
                 "library_ms": time_ms(
                     lambda: F.scaled_dot_product_attention(
                         q, lk[:, :, :t], lv[:, :, :t], is_causal=True,
                         enable_gqa=True)),
                 "bound_ms": b_ms, "bound_by": b_by}
            by_name[name].setdefault("tp_cases", []).append(c)
        del k, v, kq, vq, q
    for tp, linears in TP_LINEARS:
        for (k, n), m in itertools.product(
                (linears[0], linears[1], linears[5]), (1, TP_VERIFY_M)):
            for tier in (TIERS[0], TIERS[2]):
                c = matmul_case(torch, quant, qmatmul, build, tier, m, k, n,
                                gen)
                by_name[tier[0]].setdefault("tp_cases", []).append(
                    {"tp": tp, "tier": tier_label(tier), "shape":
                     f"M={m} K={k} N={n}",
                     **{key: c[key] for key in (
                         "ms", "plain_ms", "library_ms", "bound_ms",
                         "bound_by")}})
    for r in rows:
        for c in r.get("tp_cases", []):
            say(f"[3] {r['name']} tp={c['tp']} {c.get('tier', '')} "
                f"{c['shape']}: {c['ms']:.4f} ms (plain "
                f"{c['plain_ms']:.4f}, library {c['library_ms']:.4f}, "
                f"bound {c['bound_ms']:.4f} by {c['bound_by']})")
    torch.cuda.empty_cache()


# Llama-3-8B at full width and 4 of its 32 layers over 4 ranks on this
# card (gloo): stages 2 x tp 2 for one stream, dp 2 x tp 2 for the batch
# (8 layers before phase 17 came: with it the script ran 1,257 s of its
# 1,200 on a slow H100 host, PERF.md); phase 17 reads the same checkpoint
# (8 layers of its own before phase 18 came)
MESH_LAYERS = 4
MESH_NEW = 32
MESH_SLOTS = 8
MESH_BATCH_NEW = 16
MESH_BATCH_LENS = (600, 410, 333, 257, 200, 129, 64, 17)
# step 0's f32 logits over the mesh against one card: the tp all-reduce
# and the tp-split matmuls sum bf16 partials in another order than one
# card, through 8 bf16 layers
MESH_LOGITS_REL_L2 = 5e-2
MESH_LABEL = "one card, 4 ranks, gloo"
# (s): the command line's --speculate 4 over the mesh, one round a
# dispatch (the JAX MeshSpeculativeGenerator's); each rank then times this
# many verify calls and as many plain steps
MESH_SPEC_K = 4
MESH_SPEC_TIMED = 8
# (s)'s stream is phase 5's random prompt, on which random weights accept
# almost nothing live (one card's stream too): tokens a dispatch above 1
# are read, as phase 12 reads them, off the mesh's verify replaying the
# corpus (the proposer on real text) for this many rounds
MESH_REPLAY_ROUNDS = 32
# (x): the 2,000-id stream exported after this many tokens, and the tokens
# its continuations run to
MESH_EXPORT_AT = 8
MESH_EXPORT_QUOTA = 24
# the bf16 stream's prompt pass: the pipelined prefill in this many chunks
# (the command line's --prefill-chunks)
MESH_CHUNKS = 2


def mesh_expected(cfg, coords, weights: str, kv_quant, prefill_calls: int,
                  decode_steps: int, plan) -> dict:
    """A rank's launches: its own layers' attention and linears, and the
    head on the last stage only."""
    import dataclasses

    local = dataclasses.replace(
        cfg, num_hidden_layers=cfg.num_hidden_layers // plan.num_stages)
    want = expected_launches(local, weights, kv_quant, prefill_calls,
                             decode_steps)
    if weights != "bf16" and coords["stage"] != plan.num_stages - 1:
        want[weights] -= prefill_calls + decode_steps
    return want


def check_rank_launches(label: str, out: list, cfg, weights, kv_quant,
                        plan) -> None:
    """Each rank's launches: a verify is one model call, as a decode step
    is (the multi-query decode a layer, the linears at M = K + 1)."""
    for r in out:
        want = mesh_expected(cfg, r["coords"], weights, kv_quant,
                             r["prefill_calls"], r["decode_steps"]
                             + r.get("verify_calls", 0), plan)
        if r["launches"] != want:
            fail(f"{label}: rank {r['rank']} launched {r['launches']}, "
                 f"expected {want}")
    say(f"[16] {label}: every rank's launches exact (its layers' kernels "
        f"at its prefill and decode counts; the head on the last stage)")


def mesh_rank_lines(label: str, out: list, steps: int,
                    tag: str = "[16]") -> list:
    """The per-rank numbers: card ms a decode step (or a verify call of
    K + 1 tokens and a plain step), collective calls, ms and bytes a step
    per axis, TTFT and tokens/s."""
    rows = []
    for r in out:
        coll = {axis: {"ms_per_step": v["ms"] / steps,
                       "bytes_per_step": v["bytes"] / steps,
                       "calls_per_step": v["calls"] / steps}
                for axis, v in r["coll"].items()}
        row = {"rank": r["rank"], "coords": {
            a: r["coords"][a] for a in ("dp", "stage", "sp", "ep", "tp")},
            "collectives": coll}
        for key in ("decode_ms_per_step", "ttft_s", "tok_s", "ms",
                    "verify_ms", "step_ms"):
            if r.get(key) is not None:
                row[key] = r[key]
        if "ms" in row:  # the batch: card ms a dispatch (prefill included)
            row["ms_per_step"] = row["ms"] / steps
        rows.append(row)
        say(f"{tag} {label} ({MESH_LABEL}) rank {r['rank']} "
            f"{row['coords']}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in row.items()
                if isinstance(v, float)) + "; collectives a step: " +
            ", ".join(f"{a} {c['calls_per_step']:.1f} calls "
                      f"{c['ms_per_step']:.3f} ms "
                      f"{c['bytes_per_step'] / 1e6:.4f} MB"
                      for a, c in coll.items()))
    return rows


def rel_l2(torch, a, b) -> float:
    a = torch.as_tensor(a).float()
    b = torch.as_tensor(b).float().to(a.device)
    return ((a - b).norm() / b.norm()).item()


def prefill_logits(torch, cfg, params, prompt, kv_quant):
    """One card's f32 logits at the prompt's last position (the prompt
    padded to the generator's bucket)."""
    from cake_tpu_torch.models.llama import Llama
    from cake_tpu_torch.ops.kvcache import init_cache
    from cake_tpu_torch.runtime.generator import _bucket

    t_pad = _bucket(len(prompt), cfg.max_seq_len)
    tokens = torch.tensor([prompt + [0] * (t_pad - len(prompt))],
                          device="cuda")
    model = Llama(cfg, params)
    with torch.inference_mode():
        x = model.hidden(tokens, init_cache(cfg, 1, cfg.max_seq_len,
                                            device="cuda", quant=kv_quant),
                         0)
        return model.logits(x[:, len(prompt) - 1])[0].float().cpu()


def mesh_stream(torch, pool, cfg, params, d, prompt, settings, label,
                weights, kv_quant, prefill_chunks: int = 1) -> dict:
    """One stream over stages 2 x tp 2, read shard by shard from ``d``
    (with ``prefill_chunks`` the pipelined prefill): every rank's ids
    equal, equal to one card's up to the first near-tie, step 0's logits
    within MESH_LOGITS_REL_L2, launches exact (a pipelined prefill one
    prefill launch a layer a chunk)."""
    from cake_tpu_torch.parallel.mesh import MeshPlan

    plan = MeshPlan(num_stages=2, tp=2)
    ref = single_stream(torch, cfg, params, prompt, MESH_NEW, settings,
                        kv_quant)
    ref_logits = prefill_logits(torch, cfg, params, prompt, kv_quant)
    t0 = time.perf_counter()
    out = pool.run("cake_tpu_torch.parallel.jobs:mesh_generate", cfg, plan,
                   prompt, MESH_NEW, model_dir=str(d),
                   quantize=None if weights == "bf16" else "int8",
                   settings=settings, block_size=8, kv_quant=kv_quant,
                   prefill_chunks=prefill_chunks, want_logits=True)
    seconds = time.perf_counter() - t0
    ids = out[0]["ids"]
    if any(r["ids"] != ids for r in out):
        fail(f"{label}: the ranks' ids differ: {[r['ids'] for r in out]}")
    say(f"[16] {label}: the 4 ranks sampled the same {len(ids)} tokens")
    steps = out[0]["decode_steps"] + out[0]["prefill_calls"]
    if prefill_chunks > 1:
        if weights != "bf16":
            fail(f"{label}: the launch check counts a pipelined prefill's "
                 "chunks in bf16 only")
        for r in out:  # one prompt pass a chunk, one head
            r["prefill_calls"] *= prefill_chunks
    tie = check_until_tie(torch, cfg, params, label, prompt, ids, ref,
                          settings, kv_quant, tag="[16]")
    err = rel_l2(torch, out[0]["logits"], ref_logits)
    say(f"[16] {label}: step 0's f32 logits against one card: relative L2 "
        f"{err:.3e} (limit {MESH_LOGITS_REL_L2})")
    if not err < MESH_LOGITS_REL_L2:
        fail(f"{label}: step 0's logits relative L2 {err} >= "
             f"{MESH_LOGITS_REL_L2}")
    check_rank_launches(label, out, cfg, weights, kv_quant, plan)
    return {"label": label, "plan": "stages 2 x tp 2", "ids": ids,
            "tie": tie, "logits_rel_l2": err, "seconds": seconds,
            "prefill_chunks": prefill_chunks,
            "ranks": mesh_rank_lines(label, out, steps),
            "launches": {k: sum(r["launches"][k] for r in out)
                         for k in out[0]["launches"]}}


def mesh_batch_prompts(torch, cfg, params, settings) -> tuple:
    """The mesh batch's 8 prompts (MESH_BATCH_LENS) and one card's
    engine's streams of them."""
    from cake_tpu_torch.runtime.batch_generator import BatchGenerator

    g = torch.Generator().manual_seed(SEED + 16)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()
               for n in MESH_BATCH_LENS]
    eng = BatchGenerator(cfg, params, settings=settings, block_size=8)
    eng.set_prompts(prompts)
    ref = eng.generate(MESH_BATCH_NEW)
    del eng
    torch.cuda.empty_cache()
    return prompts, ref


def mesh_batch_run(torch, pool, cfg, params, d, settings, prompts,
                   ref) -> dict:
    """The batch engine at dp 2 x tp 2, 8 slots: every stream equals one
    card's engine's (``ref``) up to its first near-tie, and each of its
    steps outside a near-tie is the greedy choice of its own
    teacher-forced logits on one card (``family_until_tie``); launches
    exact."""
    from cake_tpu_torch.parallel.mesh import MeshPlan

    plan = MeshPlan(dp=2, tp=2)
    t0 = time.perf_counter()
    out = pool.run("cake_tpu_torch.parallel.jobs:mesh_batch", cfg, plan,
                   prompts, MESH_BATCH_NEW, model_dir=str(d),
                   settings=settings, block_size=8)
    seconds = time.perf_counter() - t0
    streams = out[0]["streams"]
    if any(r["streams"] != streams for r in out):
        fail("batch dp 2 x tp 2: the ranks' streams differ")
    ties = [family_until_tie(torch, cfg, params, f"batch dp 2 x tp 2 slot "
                             f"{i}", p, s, r, settings, tag="[16]")
            for i, (p, s, r) in enumerate(zip(prompts, streams, ref))]
    equal = sum(s == r for s, r in zip(streams, ref))
    say(f"[16] batch dp 2 x tp 2: {equal} of {len(ref)} streams equal one "
        "card's engine's whole; the rest up to a near-tie, and every step "
        "of every stream outside a near-tie is its teacher-forced logits' "
        "greedy choice")
    check_rank_launches("batch dp 2 x tp 2", out, cfg, "bf16", None,
                        plan)
    steps = out[0]["decode_steps"] + out[0]["prefill_calls"]
    return {"label": "batch dp 2 x tp 2, 8 slots", "streams_equal": equal,
            "ties": ties, "seconds": seconds,
            "tokens": sum(len(s) for s in streams),
            "ranks": mesh_rank_lines("batch", out, steps),
            "launches": {k: sum(r["launches"][k] for r in out)
                         for k in out[0]["launches"]}}


def schedule_expected(cfg, plan, r) -> dict:
    """A rank's launches in bf16 over a batch run that took either
    schedule: a serialized call one attention launch a layer, an
    interleaved one a launch a layer for each of its S microbatches (or
    prompt chunks), every decode and verify through the decode kernel."""
    from cake_tpu_torch.ops.kernels import build

    L = cfg.num_hidden_layers // plan.num_stages
    n_st = plan.num_stages
    want = dict.fromkeys(build.SOURCES, 0)
    passes = {k: r[k] - r[f"il_{k}"] + n_st * r[f"il_{k}"]
              for k in ("prefill_calls", "decode_steps", "verify_calls")}
    want["flash_prefill"] = L * passes["prefill_calls"]
    want["flash_decode"] = L * (passes["decode_steps"]
                                + passes["verify_calls"])
    return want


def mesh_schedule_run(torch, pool, cfg, params, d, settings, prompts, ref,
                      label, **engine_kw) -> dict:
    """The batch engine at stages 2 x tp 2, 8 slots, in the schedule
    ``engine_kw`` asks for (interleaved by default; ``interleave=False``;
    ``spec_k``): every stream equal to one card's engine's (``ref``) up to
    its first near-tie, each step outside one its teacher-forced greedy
    choice; launches exact for the schedule each dispatch took; each
    rank's card ms a decode dispatch (a block, or a verify round; the
    batched prefill apart) and its stage collectives' ms a decode
    dispatch (the time it waits on the other stage: its idle time)."""
    from cake_tpu_torch.parallel.mesh import MeshPlan

    plan = MeshPlan(num_stages=2, tp=2)
    t0 = time.perf_counter()
    out = pool.run("cake_tpu_torch.parallel.jobs:mesh_batch", cfg, plan,
                   prompts, MESH_BATCH_NEW, model_dir=str(d),
                   settings=settings, block_size=8, **engine_kw)
    seconds = time.perf_counter() - t0
    streams = out[0]["streams"]
    if any(r["streams"] != streams for r in out):
        fail(f"{label}: the ranks' streams differ")
    ties = [family_until_tie(torch, cfg, params, f"{label} slot {i}", p, s,
                             r, settings, tag="[16]")
            for i, (p, s, r) in enumerate(zip(prompts, streams, ref))]
    equal = sum(s == r for s, r in zip(streams, ref))
    for r in out:
        want = schedule_expected(cfg, plan, r)
        if r["launches"] != want:
            fail(f"{label}: rank {r['rank']} launched {r['launches']}, "
                 f"expected {want} (schedule {r['schedule']})")
    r0 = out[0]
    dispatches = sum(r0["schedule"].values()) - r0["prefill_calls"]
    idle = [(r["coll"]["stage"]["ms"] - r["prefill_coll"]["stage"]["ms"])
            / dispatches for r in out]
    busy = [(r["ms"] - r["prefill_ms"]) / dispatches for r in out]
    prefill_ms = [r["prefill_ms"] for r in out]
    say(f"[16] {label}: {equal} of {len(ref)} streams equal one card's "
        f"engine's whole, the rest up to a near-tie; schedule "
        f"{r0['schedule']} ({r0['il_decode_steps']} of "
        f"{r0['decode_steps']} steps, {r0['il_verify_calls']} of "
        f"{r0['verify_calls']} verifies, {r0['il_prefill_calls']} of "
        f"{r0['prefill_calls']} prefills interleaved); every rank's "
        f"launches exact; card ms a decode dispatch "
        f"{[round(x, 3) for x in busy]}, of it the stage hand-offs (idle) "
        f"{[round(x, 3) for x in idle]}; the prefill "
        f"{[round(x, 3) for x in prefill_ms]} ms ({MESH_LABEL})")
    return {"label": label, "streams": streams, "streams_equal": equal,
            "ties": ties, "seconds": seconds, "schedule": r0["schedule"],
            "il_decode_steps": r0["il_decode_steps"],
            "il_verify_calls": r0["il_verify_calls"],
            "il_prefill_calls": r0["il_prefill_calls"],
            "ms_per_dispatch": busy, "stage_idle_ms_per_dispatch": idle,
            "prefill_ms": prefill_ms,
            "ranks": mesh_rank_lines(label, out, dispatches),
            "launches": {k: sum(r["launches"][k] for r in out)
                         for k in r0["launches"]}}


def mesh_schedules(torch, pool, cfg, params, d, settings, prompts,
                   ref) -> dict:
    """Phase 16's schedules at stages 2 x tp 2: the batch engine
    interleaved (its choice at 8 slots) and serialized on the same
    prompts, in turns (interleaved, serialized, interleaved, serialized:
    the first pair also warms the ranks' shapes, the second is compared),
    and speculation (K = 4, rounds chained) through the interleaved
    verify. Each must take the schedule asked for."""
    def run(which, turn):
        kw = {} if which == "interleaved" else {"interleave": False}
        return mesh_schedule_run(
            torch, pool, cfg, params, d, settings, prompts, ref,
            f"batch stages 2 x tp 2 {which} ({turn})", **kw)

    first = {k: run(k, "first") for k in ("interleaved", "serialized")}
    out = {k: run(k, "second") for k in ("interleaved", "serialized")}
    out.update({
        "first_turn": {k: {f: v[f] for f in (
            "ms_per_dispatch", "stage_idle_ms_per_dispatch", "prefill_ms",
            "seconds")} for k, v in first.items()},
        "spec": mesh_schedule_run(
            torch, pool, cfg, params, d, settings, prompts, ref,
            f"batch stages 2 x tp 2 --speculate {MESH_SPEC_K} interleaved",
            spec_k=MESH_SPEC_K),
    })
    for k in ("interleaved", "serialized"):
        out[k]["launches"] = {n: c + first[k]["launches"][n]
                              for n, c in out[k]["launches"].items()}
        out[k]["seconds"] += first[k]["seconds"]
    il, se, sp = out["interleaved"], out["serialized"], out["spec"]
    if not (il["schedule"]["serialized"] == 0 and il["il_decode_steps"] > 0
            and il["il_prefill_calls"] == 1):
        fail(f"the interleaved batch took {il['schedule']}")
    if se["schedule"]["interleaved"] != 0:
        fail(f"the serialized batch took {se['schedule']}")
    if not sp["il_verify_calls"] > 0:
        fail("speculation at stages 2 x tp 2 ran no interleaved verify")
    same = sum(a == b for a, b in zip(il["streams"], se["streams"]))
    say(f"[16] the two schedules: {same} of {len(prompts)} streams equal "
        "each other whole; second turn: card ms a decode dispatch "
        f"interleaved {[round(x, 3) for x in il['ms_per_dispatch']]} "
        f"against serialized {[round(x, 3) for x in se['ms_per_dispatch']]}"
        "; stage idle ms a decode dispatch interleaved "
        f"{[round(x, 3) for x in il['stage_idle_ms_per_dispatch']]} "
        f"against serialized "
        f"{[round(x, 3) for x in se['stage_idle_ms_per_dispatch']]}")
    out["streams_equal_across_schedules"] = same
    return out


def mesh_cli(d, prompt, want: list, extra=(), what="the first mesh run",
             axes=("--tp", "2", "--stages", "2"), tag="[16]") -> dict:
    """``axes`` (``--tp 2 --stages 2``) with ``--dist-backend gloo`` (and
    ``extra``) as a process: its ids equal ``want``, ``what``'s."""
    cmd = [sys.executable, "-m", "cake_tpu_torch.cli", "--model", str(d),
           *axes, "--dist-backend", "gloo",
           "--prompt-ids", ",".join(map(str, prompt)), "-n", str(len(want)),
           "--temperature", "0", "--max-seq", "4096", *extra]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                       cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)))
    seconds = time.perf_counter() - t0
    if r.returncode != 0:
        fail(f"the mesh command line exited {r.returncode}: "
             f"{r.stderr[-3000:]}")
    ids = [int(t) for t in r.stdout.strip().splitlines()[-1].split(",")]
    flags = " ".join([*axes, "--dist-backend gloo", *extra])
    if ids != want:
        fail(f"{flags} printed {ids}, {what} {want}")
    say(f"{tag} {flags} as a process: {what}'s {len(ids)} ids in "
        f"{seconds:.1f} s")
    return {"ids_equal": True, "seconds": seconds}


def mesh_spec_run(torch, pool, cfg, params, d, prompt, settings, label,
                  weights, kv_quant, prefill_chunks: int = 1) -> dict:
    """(s) ``MeshSpeculativeGenerator`` at stages 2 x tp 2, K =
    MESH_SPEC_K, read shard by shard from ``d``: every rank's ids equal,
    equal to one card's ``SpeculativeGenerator`` at the same rounds up to
    the first near-tie (over the int8 cache SPEC_MARGIN_TIE_Q8), launches
    exact with the verifies counted; each rank's card ms a verify call and
    a plain step; then more than one token a dispatch of the mesh's
    verify over the corpus replay (MESH_REPLAY_ROUNDS), its logits
    finite."""
    from cake_tpu_torch.parallel.mesh import MeshPlan
    from cake_tpu_torch.runtime.speculative import SpeculativeGenerator

    plan = MeshPlan(num_stages=2, tp=2)
    gen = SpeculativeGenerator(cfg, params, settings=settings,
                               kv_quant=kv_quant, spec_k=MESH_SPEC_K,
                               spec_rounds=1)
    gen.set_prompt(prompt)
    ref = [gen.next_token(i).id for i in range(MESH_NEW)]
    card = {"verify_calls": gen.verify_calls,
            "tokens_per_dispatch": gen.emitted / gen.dispatches}
    del gen
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = pool.run("cake_tpu_torch.parallel.jobs:mesh_speculate", cfg,
                   plan, prompt, MESH_NEW, model_dir=str(d),
                   quantize=None if weights == "bf16" else "int8",
                   settings=settings, kv_quant=kv_quant,
                   spec_k=MESH_SPEC_K, prefill_chunks=prefill_chunks,
                   time_calls=MESH_SPEC_TIMED,
                   replay_rounds=MESH_REPLAY_ROUNDS)
    seconds = time.perf_counter() - t0
    ids = out[0]["ids"]
    if any(r["ids"] != ids for r in out):
        fail(f"{label}: the ranks' ids differ: {[r['ids'] for r in out]}")
    if prefill_chunks > 1:
        if weights != "bf16":
            fail(f"{label}: the launch check counts a pipelined prefill's "
                 "chunks in bf16 only")
        for r in out:  # one prompt pass a chunk, one head
            r["prefill_calls"] *= prefill_chunks
    r0 = out[0]
    per = r0["emitted"] / r0["dispatches"]
    replay = r0["replay"]
    say(f"[16] {label}: the 4 ranks sampled the same {len(ids)} tokens; "
        f"{r0['verify_calls']} verifies, {r0['decode_steps']} plain steps, "
        f"{per:.2f} tokens a dispatch live (one card: "
        f"{card['verify_calls']} verifies, "
        f"{card['tokens_per_dispatch']:.2f}); the corpus replay through "
        f"the mesh's verify: {replay['tokens_per_round']:.3f} tokens a "
        f"dispatch over {replay['rounds']} rounds")
    if not (replay["tokens_per_round"] > 1 and all(
            r["replay"] == replay for r in out) and replay["finite"]):
        fail(f"{label}: the replay gave {[r['replay'] for r in out]}, not "
             "above 1 token a dispatch with finite logits on every rank")
    if kv_quant:
        tie = check_until_tie(torch, cfg, params, label, prompt, ids, ref,
                              settings, kv_quant, tag="[16]")
    else:
        tie = family_until_tie(torch, cfg, params, label, prompt, ids, ref,
                               settings, tag="[16]")
    check_rank_launches(label, out, cfg, weights, kv_quant, plan)
    calls = r0["prefill_calls"] + r0["decode_steps"] + r0["verify_calls"]
    return {"label": label, "plan": "stages 2 x tp 2", "spec_k": MESH_SPEC_K,
            "ids": ids, "tie": tie, "seconds": seconds,
            "tokens_per_dispatch": per,
            "replay_tokens_per_dispatch": replay["tokens_per_round"],
            "one_card": card,
            "verify_calls": r0["verify_calls"],
            "verify_ms": [r["verify_ms"] for r in out],
            "step_ms": [r["step_ms"] for r in out],
            "ranks": mesh_rank_lines(label, out, calls),
            "launches": {k: sum(r["launches"][k] for r in out)
                         for k in r0["launches"]}}


def swap_tp_halves(data: bytes) -> bytes:
    """A planted fault: the snapshot with the two tp 2 halves of every
    page's kv heads swapped (what assembling the ranks' parts in the wrong
    order would give)."""
    import torch

    from cake_tpu_torch.disagg import snapshot as snap_mod

    s = snap_mod.decode_snapshot(data)
    for page in s.pages:
        for k, t in page.items():
            h = t.shape[1] // 2
            page[k] = torch.cat([t[:, h:], t[:, :h]], dim=1)
    return snap_mod.encode_snapshot(
        xfer_id=s.xfer_id, fingerprint=s.fingerprint, codec=s.codec,
        stream_id=s.stream_id, prompt=s.prompt, generated=s.generated,
        pos=s.pos, index=s.index, last_token=s.last_token, key=s.key,
        history=s.history, hist_slot=s.hist_slot, guide_spec=s.guide_spec,
        guide_state=s.guide_state, pages=s.pages, trace=s.trace)


def card_import(torch, cfg, params, data, settings, n) -> list:
    """Snapshot ``data`` imported into one card's paged engine (slots
    free), run to ``n`` tokens of its stream: the snapshot's generated
    ids and the continuation."""
    g = paged_engine(torch, cfg, params, None, 1, settings=settings)
    g.set_prompts([[1]])
    g.retire_all()
    g.import_stream(data, stream_id=7)
    for _ in range(4 * n + 64):
        s = next(s for s in g.streams if s.stream_id == 7)
        if len(s.generated) >= n:
            break
        g.step()
    out = list(s.generated)[:n]
    del g
    torch.cuda.empty_cache()
    return out


def mesh_snapshot_run(torch, pool, cfg, params, d, prompt, settings) -> dict:
    """(x) The paged batch engine at stages 2 x tp 2 (dp 1), 4 slots, rank
    0 driving it as the serve scheduler does: the 2,000-id stream 0
    exported after MESH_EXPORT_AT tokens (each rank's pages gathered to
    rank 0), run on uninterrupted to MESH_EXPORT_QUOTA, finished, and its
    snapshot imported into the freed slot (scattered back to the ranks)
    must continue with the uninterrupted ids bit for bit. The same bytes
    on one card continue with one card's greedy ids up to a near-tie
    (``family_until_tie``); with the tp halves of the kv heads swapped
    they must fail that check."""
    from cake_tpu_torch.parallel.mesh import MeshPlan

    plan = MeshPlan(num_stages=2, tp=2)
    g = torch.Generator().manual_seed(SEED + 18)
    prompts = [prompt] + [
        torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()
        for n in MESH_BATCH_LENS[1:4]]
    script = [("run", 0, MESH_EXPORT_AT), ("export", 0, "live"),
              ("run", 0, MESH_EXPORT_QUOTA), ("finish", 0),
              ("import", "live", 100),
              ("run", 100, MESH_EXPORT_QUOTA - MESH_EXPORT_AT)]
    t0 = time.perf_counter()
    out = pool.run("cake_tpu_torch.parallel.jobs:mesh_snapshot", cfg, plan,
                   prompts, script, model_dir=str(d), settings=settings,
                   kv_page_size=PAGE)
    seconds = time.perf_counter() - t0
    r0 = out[0]
    data = r0["snapshots"]["live"]
    want = r0["streams"][0][:MESH_EXPORT_QUOTA]
    got = r0["streams"][100][:MESH_EXPORT_QUOTA - MESH_EXPORT_AT]
    if got != want[MESH_EXPORT_AT:]:
        fail(f"(x): the stream imported on the mesh continued with {got}, "
             f"the uninterrupted stream with {want[MESH_EXPORT_AT:]}")
    say(f"[16] (x) stages 2 x tp 2 paged: stream 0 exported after "
        f"{MESH_EXPORT_AT} tokens ({len(data):,} B) and imported into the "
        f"freed slot continues with the uninterrupted ids bit for bit "
        f"({len(got)} tokens)")
    check_rank_launches("(x) paged stages 2 x tp 2", out, cfg, "bf16", None,
                        plan)
    card = card_import(torch, cfg, params, data, settings,
                       MESH_EXPORT_QUOTA)
    tie = family_until_tie(torch, cfg, params,
                           "(x) the mesh's snapshot on one card", prompt,
                           card, want, settings, tag="[16]")
    bad = card_import(torch, cfg, params, swap_tp_halves(data), settings,
                      MESH_EXPORT_QUOTA)
    planted_tie = family_until_tie(
        torch, cfg, params, "(x) planted fault: the tp halves swapped",
        prompt, bad, want, settings, tag="[16]", check=False)
    if planted_tie["fault"] is None:
        fail("(x): the snapshot with its tp halves swapped passes the "
             "one-card check")
    say(f"[16] (x) planted fault, the kv heads' tp halves swapped: "
        f"{planted_tie['fault']}")
    snap = {k: [r["coll"]["snapshot"][k] for r in out]
            for k in ("calls", "bytes", "ms")}
    ms = r0["snapshot_ms"]
    say(f"[16] (x) ({MESH_LABEL}): export {ms['export live']:.2f} ms, "
        f"import {ms['import live']:.2f} ms (rank 0, card clock); the "
        f"snapshot collectives a rank (gather, scatter): calls "
        f"{snap['calls']}, bytes {snap['bytes']}, ms "
        f"{[round(x, 3) for x in snap['ms']]}")
    steps = r0["decode_steps"] + r0["prefill_calls"]
    return {"label": "(x) paged stages 2 x tp 2, 4 slots",
            "snapshot_bytes": len(data), "export_ms": ms["export live"],
            "import_ms": ms["import live"], "snapshot_coll": snap,
            "same_mesh_bit_exact": True, "one_card": tie,
            "planted": planted_tie["fault"], "seconds": seconds,
            "ranks": mesh_rank_lines("(x) paged", out, steps),
            "launches": {k: sum(r["launches"][k] for r in out)
                         for k in r0["launches"]}}


def phase_mesh(torch, build, run16: bool = True, run17: bool = True,
               run18: bool = True) -> dict:
    """Phase 16: the (dp, stage, tp) mesh on this card, 4 ranks over
    gloo: Llama-3-8B at full width and MESH_LAYERS layers written by the
    port's writer, read shard by shard, and its int8 form quantized on
    the card; stages 2 x tp 2 in bf16 (the pipelined prefill in
    MESH_CHUNKS chunks) and with int8 weights plus the int8 KV cache, the
    batch engine at dp 2 x tp 2 and at stages 2 x tp 2 in both schedules
    and speculating through the interleaved verify, (s) speculation and
    (x) snapshots at stages 2 x tp 2, the command line as a process with
    --speculate and --prefill-chunks. Then phase 17 (``run17``, under
    ``sp``) over the same ranks and checkpoints, and ``--sp 2 --tp 2``
    beside the other command lines; then phase 18 (``run18``, under
    ``moe``): Mixtral-8x7B over the ep axis, and ``--ep 2 --tp 2``. The
    checkpoints live in a temporary directory removed at the end,
    whatever happens."""
    import shutil

    from cake_tpu_torch.models import llama
    from cake_tpu_torch.models.config import llama3_8b
    from cake_tpu_torch.ops.sampling import SamplerSettings
    from cake_tpu_torch.parallel.launch import RankPool
    from cake_tpu_torch.utils.weights import save_llama_params

    gc.collect()
    torch.cuda.empty_cache()  # the ranks share the card with this process
    # the ranks' gloo collectives run on the host's cores: what else is
    # using them shows here
    say(f"[16] host: {os.cpu_count()} cores, load average "
        f"{os.getloadavg()[0]:.2f}, {threading.active_count()} threads in "
        "this process")
    t0 = time.perf_counter()
    root = Path(tempfile.mkdtemp(dir=build.BUILD_DIR))
    out: dict = {"label": MESH_LABEL}
    try:
        settings = SamplerSettings(temperature=0)
        # phases 16's and 17's checkpoint (MESH_LAYERS) and its int8 form
        # quantized on the card by tools.quantize_model
        ckpts = {}
        d8 = root / "ckpt16_q8"
        if run16 or run17:
            from cake_tpu_torch.tools import quantize_model

            cfg = llama3_8b(num_hidden_layers=MESH_LAYERS, max_seq_len=4096)
            d = root / "ckpt16"
            both = (cfg, llama.init_params(cfg, seed=SEED), d)
            save_llama_params(both[1], d)
            (d / "config.json").write_text(json.dumps(cfg.to_hf_dict()))
            ckpts = {"16": both, "17": both}
            quantize_model.quantize_checkpoint(d, d8)
        prompt = main_path_prompt(torch, llama3_8b())
        t_pool = time.perf_counter()
        out["checkpoint_s"] = t_pool - t0
        with RankPool(4, backend="gloo", device_type="cuda",
                      timeout_s=300.0, job_timeout_s=600.0) as pool:
            out["pool_start_s"] = time.perf_counter() - t_pool
            if run16:
                mesh_runs(torch, pool, *ckpts["16"], d8, prompt, settings,
                          out)
            if run17:
                out["sp"] = phase_sp(torch, pool, *ckpts["17"], d8,
                                     settings)
            ckpts = {k: (c, None, d) for k, (c, _, d) in ckpts.items()}
            both = None
            if run18:
                out["moe"] = phase_moe(torch, pool, root, settings)
        torch.cuda.empty_cache()
        with ThreadPoolExecutor(3) as ex:
            jobs = {}
            if run16:
                jobs["cli"] = ex.submit(
                    mesh_cli, ckpts["16"][2], prompt, out["spec"]["ids"],
                    ("--speculate", str(MESH_SPEC_K), "--prefill-chunks",
                     str(MESH_CHUNKS)), "(s)")
            if run17:
                jobs["sp_cli"] = ex.submit(
                    mesh_cli, ckpts["17"][2], out["sp"]["prompt"],
                    out["sp"]["sp2_tp2"]["ids"], (), "the sp 2 x tp 2 run",
                    ("--sp", "2", "--tp", "2"), "[17]")
            if run18:
                moe = out["moe"]
                jobs["moe_cli"] = ex.submit(
                    mesh_cli, moe["ckpt_q8"], moe["prompt"],
                    moe["ep2_tp2_int8"]["ids"], ("--quantize", "int8"),
                    "the ep 2 x tp 2 int8 run", ("--ep", "2", "--tp", "2"),
                    "[18]")
            for key, job in jobs.items():
                out[key] = job.result()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    if run17:
        out["sp"]["cli"] = out.pop("sp_cli")
        out["sp"].pop("prompt")
    if run18:
        out["moe"]["cli"] = out.pop("moe_cli")
        for key in ("prompt", "ckpt_q8"):
            out["moe"].pop(key)
    if not run16:
        return out
    runs = ("bf16", "spec", "snapshot", "int8", "spec_int8", "batch")
    schedules = ("interleaved", "serialized", "spec")
    out["launches"] = {
        k: sum(out[p]["launches"][k] for p in runs)
        + sum(out["schedules"][p]["launches"][k] for p in schedules)
        for k in out["bf16"]["launches"]}
    say(f"[16] phase 16 took {out['seconds']:.1f} s ({MESH_LABEL}), phases "
        f"17 and 18 included: checkpoint {out['checkpoint_s']:.1f} s, 4 "
        f"ranks up in {out['pool_start_s']:.1f} s, " + ", ".join(
            f"{k} {out[k]['seconds']:.1f} s"
            for k in (*runs, "cli")) + ", " + ", ".join(
            f"schedule {k} {out['schedules'][k]['seconds']:.1f} s"
            for k in schedules) + " (the command lines side by side)")
    return out


def mesh_runs(torch, pool, cfg, params, d, d8, prompt, settings,
              out) -> None:
    """Phase 16's runs over the pool, into ``out``: bf16 from ``d``, int8
    from ``d8`` (``d`` quantized on the card)."""
    from cake_tpu_torch.ops import quant

    # the runs over one shard follow each other: a rank keeps the
    # shard it read for the next job (parallel/jobs.py _shard)
    out["bf16"] = mesh_stream(torch, pool, cfg, params, d, prompt,
                              settings, "stages 2 x tp 2 bf16 "
                              f"--prefill-chunks {MESH_CHUNKS}", "bf16",
                              None, prefill_chunks=MESH_CHUNKS)
    out["spec"] = mesh_spec_run(
        torch, pool, cfg, params, d, prompt, settings,
        f"(s) stages 2 x tp 2 bf16 --speculate 4 --prefill-chunks "
        f"{MESH_CHUNKS}", "bf16", None, prefill_chunks=MESH_CHUNKS)
    out["snapshot"] = mesh_snapshot_run(torch, pool, cfg, params, d,
                                        prompt, settings)
    # quantized on the card: the codes tools.quantize_model wrote
    params8 = quant.quantize_params(params, 8)
    out["int8"] = mesh_stream(
        torch, pool, cfg, params8, d8, prompt, settings,
        "stages 2 x tp 2 int8 pre-quantized + int8 KV", "quant_matmul",
        "int8")
    out["spec_int8"] = mesh_spec_run(
        torch, pool, cfg, params8, d8, prompt, settings,
        "(s) stages 2 x tp 2 int8 pre-quantized + int8 KV --speculate 4",
        "quant_matmul", "int8")
    del params8
    torch.cuda.empty_cache()
    prompts, ref = mesh_batch_prompts(torch, cfg, params, settings)
    out["batch"] = mesh_batch_run(torch, pool, cfg, params, d, settings,
                                  prompts, ref)
    out["schedules"] = mesh_schedules(torch, pool, cfg, params, d,
                                      settings, prompts, ref)


# --------------------------------------------------------------------------
# phase 17: sequence parallelism over the rank mesh
# --------------------------------------------------------------------------

# a 2,030-id prompt: a 2,048-token bucket, so the ring runs 1,024-token
# chunks at sp 2 and 512 at sp 4; its 32 decoded tokens cross position
# 2,048, the first of sp 2's second shard (4,096 / 2)
SP_PROMPT = 2030
SP_NEW = 32
SP_BATCH_NEW = 16
# the engine's 8 slots: the longest crosses 2,048 as it decodes
SP_BATCH_LENS = (2040, 1100, 517, 260, 200, 129, 64, 17)


def sp_expected(cfg, coords, plan, weights: str, kv_quant, ring_passes: int,
                decode_steps: int) -> dict:
    """A rank's launches at sp > 1: each ring pass one prefill statistics
    launch a layer for each visit a row of the rank sees (the blocks at or
    before its own: its sp index + 1), each decode step one decode
    statistics launch a layer (over the int8 cache its q8 form), and the
    linears as at sp 1 (the head on the last stage only)."""
    from cake_tpu_torch.ops.kernels import build

    L = cfg.num_hidden_layers // plan.num_stages
    want = dict.fromkeys(build.SOURCES, 0)
    want["flash_prefill_stats"] = L * (coords["sp"] + 1) * ring_passes
    want["flash_decode_q8_stats" if kv_quant else "flash_decode_stats"] = (
        L * decode_steps)
    if weights != "bf16":
        calls = ring_passes + decode_steps
        want[weights] = (7 * L + 1) * calls
        if coords["stage"] != plan.num_stages - 1:
            want[weights] -= calls
    return want


def sp_check_launches(label: str, out: list, cfg, plan, weights,
                      kv_quant) -> None:
    for r in out:
        want = sp_expected(cfg, r["coords"], plan, weights, kv_quant,
                           r["prefill_calls"], r["decode_steps"])
        if r["launches"] != want:
            fail(f"{label}: rank {r['rank']} launched {r['launches']}, "
                 f"expected {want}")
    say(f"[17] {label}: every rank's launches exact (its visible ring "
        "visits a layer a prompt pass, one decode statistics launch a "
        "layer a step)")


def sp_stream(torch, pool, cfg, d, prompt, settings, label, plan, weights,
              kv_quant, ref, ref_logits, ref_params) -> dict:
    """One stream over ``plan``, read shard by shard from ``d`` (int8
    weights: a pre-quantized checkpoint): every
    rank's ids equal, equal to one card's ``ref`` up to the first
    near-tie, step 0's logits within MESH_LOGITS_REL_L2 of ``ref_logits``,
    launches exact; TTFT, card ms a decode step and the collectives per
    axis, a rank."""
    t0 = time.perf_counter()
    out = pool.run("cake_tpu_torch.parallel.jobs:mesh_generate", cfg, plan,
                   prompt, SP_NEW, model_dir=str(d),
                   quantize=None if weights == "bf16" else "int8",
                   settings=settings, block_size=8, kv_quant=kv_quant,
                   want_logits=True)
    seconds = time.perf_counter() - t0
    ids = out[0]["ids"]
    if any(r["ids"] != ids for r in out):
        fail(f"{label}: the ranks' ids differ: {[r['ids'] for r in out]}")
    say(f"[17] {label}: the {plan.size} ranks sampled the same {len(ids)} "
        f"tokens, positions {len(prompt)}..{len(prompt) + len(ids) - 1} "
        f"(the shard boundary at {S // plan.sp})")
    tie = check_until_tie(torch, cfg, ref_params, label, prompt, ids, ref,
                          settings, kv_quant, tag="[17]")
    err = rel_l2(torch, out[0]["logits"], ref_logits)
    say(f"[17] {label}: step 0's f32 logits against one card: relative L2 "
        f"{err:.3e} (limit {MESH_LOGITS_REL_L2})")
    if not err < MESH_LOGITS_REL_L2:
        fail(f"{label}: step 0's logits relative L2 {err} >= "
             f"{MESH_LOGITS_REL_L2}")
    sp_check_launches(label, out, cfg, plan, weights, kv_quant)
    return {"label": label, "ids": ids, "tie": tie, "logits_rel_l2": err,
            "seconds": seconds,
            "ranks": mesh_rank_lines(label, out, out[0]["decode_steps"]
                                     + out[0]["prefill_calls"], "[17]"),
            "launches": {k: sum(r["launches"][k] for r in out)
                         for k in out[0]["launches"]}}


def sp_batch_run(torch, pool, cfg, params, d, settings) -> dict:
    """The batch engine at sp 2 x tp 2, 8 slots, one ring pass over the 8
    prompts (SP_BATCH_LENS): every stream equals one card's engine's up to
    its first near-tie, and each step outside a near-tie is its own
    teacher-forced logits' greedy choice (``family_until_tie``); launches
    exact."""
    from cake_tpu_torch.parallel.mesh import MeshPlan
    from cake_tpu_torch.runtime.batch_generator import BatchGenerator

    g = torch.Generator().manual_seed(SEED + 17)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()
               for n in SP_BATCH_LENS]
    eng = BatchGenerator(cfg, params, settings=settings, block_size=8)
    eng.set_prompts(prompts)
    ref = eng.generate(SP_BATCH_NEW)
    del eng
    torch.cuda.empty_cache()
    plan = MeshPlan(sp=2, tp=2)
    label = "batch sp 2 x tp 2"
    t0 = time.perf_counter()
    out = pool.run("cake_tpu_torch.parallel.jobs:mesh_batch", cfg, plan,
                   prompts, SP_BATCH_NEW, model_dir=str(d),
                   settings=settings, block_size=8)
    seconds = time.perf_counter() - t0
    streams = out[0]["streams"]
    if any(r["streams"] != streams for r in out):
        fail(f"{label}: the ranks' streams differ")
    ties = [family_until_tie(torch, cfg, params, f"{label} slot {i}", p, s,
                             r, settings, tag="[17]")
            for i, (p, s, r) in enumerate(zip(prompts, streams, ref))]
    equal = sum(s == r for s, r in zip(streams, ref))
    say(f"[17] {label}: {equal} of {len(ref)} streams equal one card's "
        "engine's whole; the rest up to a near-tie")
    if out[0]["prefill_calls"] != 1:
        fail(f"{label}: {out[0]['prefill_calls']} prompt passes, one ring "
             "pass expected")
    sp_check_launches(label, out, cfg, plan, "bf16", None)
    steps = out[0]["decode_steps"] + out[0]["prefill_calls"]
    return {"label": f"{label}, 8 slots", "streams_equal": equal,
            "ties": ties, "seconds": seconds,
            "tokens": sum(len(s) for s in streams),
            "ranks": mesh_rank_lines(label, out, steps, "[17]"),
            "launches": {k: sum(r["launches"][k] for r in out)
                         for k in out[0]["launches"]}}


def periodic_prompts(torch, cfg, lens, seed: int) -> list:
    """Prompts of ``lens`` ids repeating a random 7-id pattern each: the
    n-gram proposer finds their tails earlier in them, so speculation
    verifies from its first round on random weights."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for n in lens:
        pattern = torch.randint(0, cfg.vocab_size, (7,), generator=g)
        out.append(pattern.repeat(-(-n // 7))[:n].tolist())
    return out


def sp_spec_runs(torch, pool, cfg, params, d, settings) -> dict:
    """Phase 17's speculation at sp 2 x tp 2 (the verify's K + 1 rows at
    per-row frontiers, replicated over sp, through the decode statistics
    form): the batch engine at K = 4 with rounds 1 (host rounds) and 4
    (the fused chain) on SP_BATCH_LENS periodic prompts, and
    MeshSpeculativeGenerator on a periodic SP_PROMPT-id prompt whose
    tokens cross the shard boundary; each against one card's plain
    engine or stream up to its first near-tie, launches exact on every
    rank (one decode statistics launch a layer a verify), each rank's
    card ms a verify and a plain step."""
    from cake_tpu_torch.parallel.mesh import MeshPlan
    from cake_tpu_torch.runtime.batch_generator import BatchGenerator

    plan = MeshPlan(sp=2, tp=2)
    prompts = periodic_prompts(torch, cfg, SP_BATCH_LENS, SEED + 170)
    eng = BatchGenerator(cfg, params, settings=settings, block_size=8)
    eng.set_prompts(prompts)
    ref = eng.generate(SP_BATCH_NEW)
    del eng
    torch.cuda.empty_cache()
    out: dict = {}
    for rounds in (1, 4):
        label = (f"batch sp 2 x tp 2 --speculate {MESH_SPEC_K}, rounds "
                 f"{rounds}")
        t0 = time.perf_counter()
        got = pool.run("cake_tpu_torch.parallel.jobs:mesh_batch", cfg, plan,
                       prompts, SP_BATCH_NEW, model_dir=str(d),
                       settings=settings, spec_k=MESH_SPEC_K,
                       spec_rounds=rounds)
        seconds = time.perf_counter() - t0
        streams = got[0]["streams"]
        if any(r["streams"] != streams for r in got):
            fail(f"{label}: the ranks' streams differ")
        if not got[0]["verify_calls"]:
            fail(f"{label}: no verify ran")
        ties = [family_until_tie(torch, cfg, params, f"{label} slot {i}", p,
                                 st, r, settings, tag="[17]")
                for i, (p, st, r) in enumerate(zip(prompts, streams, ref))]
        for r in got:
            r["decode_steps"] += r["verify_calls"]
        sp_check_launches(label, got, cfg, plan, "bf16", None)
        equal = sum(a == b for a, b in zip(streams, ref))
        say(f"[17] {label}: {got[0]['verify_calls']} verifies, "
            f"{got[0]['decode_steps'] - got[0]['verify_calls']} plain "
            f"steps; {equal} of {len(ref)} streams equal one card's plain "
            "engine's whole, the rest up to a near-tie")
        out[f"batch_rounds{rounds}"] = {
            "label": label, "streams_equal": equal, "ties": ties,
            "verify_calls": got[0]["verify_calls"], "seconds": seconds,
            "ranks": mesh_rank_lines(label, got, got[0]["decode_steps"]
                                     + got[0]["prefill_calls"], "[17]"),
            "launches": {k: sum(r["launches"][k] for r in got)
                         for k in got[0]["launches"]}}
    prompt = periodic_prompts(torch, cfg, (SP_PROMPT,), SEED + 171)[0]
    ref = single_stream(torch, cfg, params, prompt, SP_NEW, settings, None)
    label = f"MeshSpeculativeGenerator sp 2 x tp 2 K = {MESH_SPEC_K}"
    t0 = time.perf_counter()
    got = pool.run("cake_tpu_torch.parallel.jobs:mesh_speculate", cfg,
                   plan, prompt, SP_NEW, model_dir=str(d),
                   settings=settings, spec_k=MESH_SPEC_K,
                   time_calls=MESH_SPEC_TIMED)
    seconds = time.perf_counter() - t0
    ids = got[0]["ids"]
    if any(r["ids"] != ids for r in got):
        fail(f"{label}: the ranks' ids differ")
    if not got[0]["verify_calls"]:
        fail(f"{label}: no verify ran")
    tie = family_until_tie(torch, cfg, params, label, prompt, ids, ref,
                           settings, tag="[17]")
    for r in got:
        r["decode_steps"] += r["verify_calls"]
    sp_check_launches(label, got, cfg, plan, "bf16", None)
    r0 = got[0]
    say(f"[17] {label}: {r0['verify_calls']} verifies, "
        f"{r0['decode_steps'] - r0['verify_calls']} plain steps over "
        f"positions {len(prompt)}..{len(prompt) + len(ids) - 1}; card ms a "
        f"verify of {MESH_SPEC_K + 1} tokens "
        f"{[round(r['verify_ms'], 3) for r in got]} against a plain step's "
        f"{[round(r['step_ms'], 3) for r in got]} ({MESH_LABEL})")
    out["mesh_spec"] = {
        "label": label, "ids": ids, "tie": tie, "seconds": seconds,
        "verify_calls": r0["verify_calls"],
        "verify_ms": [r["verify_ms"] for r in got],
        "step_ms": [r["step_ms"] for r in got],
        "ranks": mesh_rank_lines(label, got, r0["decode_steps"]
                                 + r0["prefill_calls"], "[17]"),
        "launches": {k: sum(r["launches"][k] for r in got)
                     for k in r0["launches"]}}
    return out


def phase_sp(torch, pool, cfg, params, d, d8, settings) -> dict:
    """Phase 17: sequence parallelism on this card over phase 16's 4 gloo
    ranks (Llama-3-8B at full width, MESH_LAYERS layers, seed 0, max_seq
    4096, read from ``d``, and its int8 form from ``d8``): MeshGenerator at
    sp 2 x tp 2 and sp 4 in bf16 and at sp 2 x tp 2 with int8 weights and
    the int8 cache, on a 2,030-id prompt decoding across the shard
    boundary; the batch engine at sp 2 x tp 2. (The command line, ``--sp 2
    --tp 2``, runs after the pool, in :func:`phase_mesh`.)"""
    from cake_tpu_torch.ops import quant
    from cake_tpu_torch.parallel.mesh import MeshPlan

    t0 = time.perf_counter()
    prompt = torch.randint(0, cfg.vocab_size, (SP_PROMPT,),
                           generator=torch.Generator().manual_seed(SEED + 17)
                           ).tolist()
    out: dict = {"prompt": prompt}
    ref = single_stream(torch, cfg, params, prompt, SP_NEW, settings, None)
    ref_logits = prefill_logits(torch, cfg, params, prompt, None)
    # the batch follows the sp 2 x tp 2 stream: a rank keeps the shard it
    # read for the next job of the same plan (parallel/jobs.py _shard)
    out["sp2_tp2"] = sp_stream(torch, pool, cfg, d, prompt, settings,
                               "sp 2 x tp 2 bf16", MeshPlan(sp=2, tp=2),
                               "bf16", None, ref, ref_logits, params)
    out["batch"] = sp_batch_run(torch, pool, cfg, params, d, settings)
    out.update(sp_spec_runs(torch, pool, cfg, params, d, settings))
    out["sp4"] = sp_stream(torch, pool, cfg, d, prompt, settings,
                           "sp 4 bf16", MeshPlan(sp=4), "bf16", None, ref,
                           ref_logits, params)
    params8 = quant.quantize_params(params, 8)
    ref8 = single_stream(torch, cfg, params8, prompt, SP_NEW, settings,
                         "int8")
    ref8_logits = prefill_logits(torch, cfg, params8, prompt, "int8")
    out["sp2_tp2_int8"] = sp_stream(
        torch, pool, cfg, d8, prompt, settings,
        "sp 2 x tp 2 int8 pre-quantized + int8 KV", MeshPlan(sp=2, tp=2),
        "quant_matmul", "int8", ref8, ref8_logits, params8)
    del params8
    torch.cuda.empty_cache()
    runs = ("sp2_tp2", "batch", "batch_rounds1", "batch_rounds4",
            "mesh_spec", "sp4", "sp2_tp2_int8")
    out["launches"] = {k: sum(out[r]["launches"][k] for r in runs)
                       for k in out["sp2_tp2"]["launches"]}
    out["seconds"] = time.perf_counter() - t0
    say(f"[17] phase 17's runs over the pool took {out['seconds']:.1f} s: "
        + ", ".join(f"{k} {out[k]['seconds']:.1f} s" for k in runs))
    return out


# --------------------------------------------------------------------------
# phase 18: expert parallelism over the rank mesh
# --------------------------------------------------------------------------

# Mixtral-8x7B at full width and its smallest depth over two stages: one
# layer a stage; 16 tokens of phase 5's 2,000-id prompt
MOE_LAYERS = 2
MOE_NEW = 16


def moe_expected(cfg, coords, plan, weights: str, calls: int,
                 prefill_calls: int) -> dict:
    """A rank's launches at ep > 1 over ``calls`` model calls (the first
    ``prefill_calls`` of them prompt passes): an attention kernel a layer
    a call; with int8 weights 4 linears a layer and the head on the last
    stage a call, and every local expert's three products a layer a call
    (the dense path: at ep > 1 a decode step runs every local expert)."""
    import dataclasses

    L = cfg.num_hidden_layers // plan.num_stages
    want = expected_launches(
        dataclasses.replace(cfg, num_hidden_layers=L), "bf16", None,
        prefill_calls, calls - prefill_calls)
    if weights == "int8":
        last = coords["stage"] == plan.num_stages - 1
        e_local = cfg.num_local_experts // plan.ep
        want["quant_matmul"] = (4 * L + int(last) + 3 * e_local * L) * calls
    return want


def moe_stream(torch, pool, cfg, params, d, prompt, settings, label, plan,
               weights: str) -> dict:
    """Mixtral over ``plan``, read shard by shard from ``d`` (int8: a
    checkpoint quantized on the card): every rank's ids equal, equal to
    one card's (``params``) up to the first near-tie (a router near-tie
    included), step 0's logits within MESH_LOGITS_REL_L2 of one card's,
    launches exact; TTFT and each rank's card ms a decode step."""
    ref = single_stream(torch, cfg, params, prompt, MOE_NEW, settings, None)
    ref_logits = prefill_logits(torch, cfg, params, prompt, None)
    t0 = time.perf_counter()
    out = pool.run("cake_tpu_torch.parallel.jobs:mesh_generate", cfg, plan,
                   prompt, MOE_NEW, model_dir=str(d),
                   quantize=None if weights == "bf16" else "int8",
                   settings=settings, block_size=8, want_logits=True)
    seconds = time.perf_counter() - t0
    ids = out[0]["ids"]
    if any(r["ids"] != ids for r in out):
        fail(f"{label}: the ranks' ids differ: {[r['ids'] for r in out]}")
    tie = family_until_tie(torch, cfg, params, label, prompt, ids, ref,
                           settings, tag="[18]")
    err = rel_l2(torch, out[0]["logits"], ref_logits)
    say(f"[18] {label}: the {plan.size} ranks sampled the same {len(ids)} "
        f"tokens; step 0's f32 logits against one card: relative L2 "
        f"{err:.3e} (limit {MESH_LOGITS_REL_L2})")
    if not err < MESH_LOGITS_REL_L2:
        fail(f"{label}: step 0's logits relative L2 {err} >= "
             f"{MESH_LOGITS_REL_L2}")
    for r in out:
        calls = r["prefill_calls"] + r["decode_steps"]
        want = moe_expected(cfg, r["coords"], plan, weights, calls,
                            r["prefill_calls"])
        if r["launches"] != want:
            fail(f"{label}: rank {r['rank']} launched {r['launches']}, "
                 f"expected {want}")
    say(f"[18] {label}: every rank's launches exact (its layers' attention, "
        "its experts' products and linears, the head on the last stage)")
    steps = out[0]["decode_steps"] + out[0]["prefill_calls"]
    return {"label": label, "ids": ids, "tie": tie, "logits_rel_l2": err,
            "seconds": seconds,
            "ranks": mesh_rank_lines(label, out, steps, "[18]"),
            "launches": {k: sum(r["launches"][k] for r in out)
                         for k in out[0]["launches"]}}


def phase_moe(torch, pool, root: Path, settings) -> dict:
    """Phase 18: expert parallelism on this card over the 4 gloo ranks:
    Mixtral-8x7B at full width, MOE_LAYERS layers, seed 0, written by the
    port's writer and quantized on the card by tools.quantize_model; at
    ep 2 x tp 2 with int8 experts (one (ep, tp) all-reduce a routed MLP)
    and at stages 2 x ep 2 in bf16. (The command line, ``--ep 2 --tp
    2``, runs after the pool, in :func:`phase_mesh`.)"""
    from cake_tpu_torch.models import llama
    from cake_tpu_torch.models.config import mixtral_8x7b
    from cake_tpu_torch.ops import quant
    from cake_tpu_torch.parallel.mesh import MeshPlan
    from cake_tpu_torch.tools import quantize_model
    from cake_tpu_torch.utils.weights import save_llama_params

    gc.collect()
    torch.cuda.empty_cache()  # phases 16's and 17's weights are gone
    t0 = time.perf_counter()
    cfg = mixtral_8x7b(num_hidden_layers=MOE_LAYERS, max_seq_len=4096)
    params = llama.init_params(cfg, seed=SEED)
    d, d8 = root / "ckpt18", root / "ckpt18_q8"
    save_llama_params(params, d)
    (d / "config.json").write_text(json.dumps(cfg.to_hf_dict()))
    quantize_model.quantize_checkpoint(d, d8)
    out: dict = {"checkpoint_s": time.perf_counter() - t0}
    prompt = main_path_prompt(torch, cfg)
    params8 = quant.quantize_params(params, 8)
    out["ep2_tp2_int8"] = moe_stream(
        torch, pool, cfg, params8, d8, prompt, settings,
        "Mixtral-8x7B ep 2 x tp 2 int8 experts", MeshPlan(ep=2, tp=2),
        "int8")
    del params8
    torch.cuda.empty_cache()
    out["stages2_ep2"] = moe_stream(
        torch, pool, cfg, params, d, prompt, settings,
        "Mixtral-8x7B stages 2 x ep 2 bf16", MeshPlan(num_stages=2, ep=2),
        "bf16")
    del params
    torch.cuda.empty_cache()
    runs = ("ep2_tp2_int8", "stages2_ep2")
    out["launches"] = {k: sum(out[r]["launches"][k] for r in runs)
                       for k in out["ep2_tp2_int8"]["launches"]}
    out["prompt"], out["ckpt_q8"] = prompt, d8
    out["seconds"] = time.perf_counter() - t0
    say(f"[18] phase 18 took {out['seconds']:.1f} s before its command "
        f"line: checkpoint {out['checkpoint_s']:.1f} s, " + ", ".join(
            f"{k} {out[k]['seconds']:.1f} s" for k in runs))
    return out


# --------------------------------------------------------------------------
# phases 2 and 3: the statistics forms (sequence parallelism)
# --------------------------------------------------------------------------

# Llama-3-8B's sp-local shapes: a ring chunk of the 2,048-token bucket at
# sp 2 and a shard of the 4,096 window at sp 2, at the full heads and at
# tp 2's local heads
SP_BLOCK = 1024
SP_SHARD = 2048
SP_HEADS = ((1, H, KVH), (2, H // 2, KVH // 2))
# decode frontiers relative to the shard (T = 5 rows at each): inside it,
# a shard wholly past the row (-3000), a frontier in (-64, 0) (-10), rows
# of one launch on both sides of the shard's first key (-3), and past the
# shard's end (3000)
SP_DECODE_POS = (2047, 1500, 700, 3, -3, -10, -3000, 3000)
SP_STATS = ("flash_prefill_stats", "flash_decode_stats",
            "flash_decode_q8_stats")
_LOG2E = 1.4426950408889634
# a row with no live key: m exactly this, l and o exactly 0
NEG_INF_F32 = -1e30


def compare_stats(torch, label, got, ref) -> float:
    """A statistics form's ``(o, m, l)`` against its plain version: the
    rows with no live key exactly ``m = -1e30, l = 0, o = 0`` in both; of
    the others, m and l held as every kernel output is (``compare``, each
    as one row), and o, which grows with l, divided by l as its user
    divides it (the attention output, held elementwise and row by row),
    and undivided to the worst row's relative L2 (ROW_REL_L2). Returns the
    max abs error of o / l."""
    o, m, l = got
    ro, rm, rl = ref
    torch.cuda.synchronize()
    empty = rm == NEG_INF_F32
    if not torch.equal(m == NEG_INF_F32, empty):
        fail(f"{label}: the rows with no live key differ ("
             f"{int((m == NEG_INF_F32).sum())} against "
             f"{int(empty.sum())})")
    if not ((l[empty] == 0).all() and (o[empty] == 0).all()):
        fail(f"{label}: a row with no live key has l or o other than 0")
    live = ~empty
    err = 0.0
    if live.any():
        err = compare(torch, f"{label} o / l", o[live] / l[live][:, None],
                      ro[live] / rl[live][:, None])
        _, rel, _ = verdict(o[live], ro[live])
        say(f"[2] {label} o: worst row rel L2 {rel:.3e}")
        if not rel < ROW_REL_L2:
            fail(f"{label}: o's worst row relative L2 {rel} >= "
                 f"{ROW_REL_L2}")
        compare(torch, f"{label} m", m[live][None], rm[live][None])
        compare(torch, f"{label} l", l[live][None], rl[live][None])
    say(f"[2] {label}: {int(empty.sum())} of {empty.numel()} rows with no "
        "live key, exact")
    return err


def sp_decode_ops(kvcache, name, k, v):
    """The cache operands of decode statistics form ``name``."""
    if "q8" not in name:
        return k, v
    kq, vq = kvcache.quant_kv(k), kvcache.quant_kv(v)
    return kq.q, kq.scale, vq.q, vq.scale


def phase_sp_kernels(torch, flash, kvcache) -> dict:
    """Phase 2 of the statistics forms at Llama-3-8B's sp-local shapes
    (full heads and tp 2's): the prefill form, q [1, H, 1024, 128] against
    a [1, KVH, 1024, 128] block at relative offsets 0 (the diagonal) and
    1024 (an earlier block, every key live); then a later block (no row
    sees a key: every q tile empty), a window that empties rows and whole
    q tiles, and a block not a whole number of tiles with the queries past
    its end. The decode forms over a [B, KVH, 2048, 128] shard: one stream
    at 2047 and 8 streams of T = 5 rows at SP_DECODE_POS, with and without
    a window. Planted faults must fail: the prefill one tile short, a
    decode frontier one tile lower, m left in log2 units."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 18)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    errs = {}
    for tp, h, kvh in SP_HEADS:
        q = rnd(1, h, SP_BLOCK, D)
        k, v = rnd(1, kvh, SP_BLOCK, D), rnd(1, kvh, SP_BLOCK, D)
        cases = [(0, None, k, v), (SP_BLOCK, None, k, v)]
        if tp == 1:
            cases += [(-SP_BLOCK, None, k, v), (512, 300, k, v),
                      (SP_BLOCK, None, k[:, :, :1000].contiguous(),
                       v[:, :, :1000].contiguous())]
        for pos, window, kb, vb in cases:
            label = (f"flash_prefill_stats tp={tp} q [1,{h},{SP_BLOCK},{D}] "
                     f"block [1,{kvh},{kb.shape[2]},{D}] offset {pos}"
                     f"{f' window={window}' if window else ''}")
            err = compare_stats(
                torch, label,
                flash.flash_attention_stats(q, kb, vb, pos, window=window),
                flash.flash_attention_stats_ref(q, kb, vb, pos,
                                                window=window))
            errs[("flash_prefill_stats", tp, pos, window, kb.shape[2])] = err
        if tp == 1:
            ref = flash.flash_attention_stats_ref(q, k, v, 0)
            planted(torch, "flash_prefill_stats offset 0 last tile "
                    "dropped", tile_short(
                        flash, lambda: flash.flash_attention_stats(
                            q, k, v, 0))[2][None], ref[2][None])
            # past the diagonal the loop's end is the block's: its last
            # tile left out
            ref = flash.flash_attention_stats_ref(q, k, v, SP_BLOCK)
            cut = SP_BLOCK - flash.PREFILL_BLOCK_K
            planted(torch, f"flash_prefill_stats offset {SP_BLOCK} the "
                    "block's last tile dropped",
                    flash.flash_attention_stats(
                        q, k[:, :, :cut].contiguous(),
                        v[:, :, :cut].contiguous(), SP_BLOCK)[2][None],
                    ref[2][None])
            got = flash.flash_attention_stats(q, k, v, SP_BLOCK)
            planted(torch, "flash_prefill_stats m in log2 units",
                    got[1] * _LOG2E, ref[1])
        for name in SP_STATS[1:]:
            kernel = getattr(flash, name)
            plain = getattr(flash, f"{name}_ref")
            for b, t, pos, window in (
                    (1, 1, [SP_SHARD - 1], None),
                    (8, 5, list(SP_DECODE_POS), None),
                    (8, 5, list(SP_DECODE_POS), 700)):
                kb, vb = rnd(b, kvh, SP_SHARD, D), rnd(b, kvh, SP_SHARD, D)
                ops = sp_decode_ops(kvcache, name, kb, vb)
                qd = rnd(b, h, t, D)
                p = torch.tensor(pos, dtype=torch.int32, device="cuda")
                label = (f"{name} tp={tp} q [{b},{h},{t},{D}] shard "
                         f"[{b},{kvh},{SP_SHARD},{D}] pos {pos}"
                         f"{f' window={window}' if window else ''}")
                errs[(name, tp, b, t, window)] = compare_stats(
                    torch, label, kernel(qd, *ops, p, window=window),
                    plain(qd, *ops, p, window=window))
                if tp == 1 and b == 1:
                    planted(torch, f"{name} pos {pos} one tile lower",
                            kernel(qd, *ops, p - 64)[0],
                            plain(qd, *ops, p)[0])
    torch.cuda.empty_cache()
    say("[2] the statistics forms at the sp-local shapes (full heads and "
        "tp 2's), empty rows exact, edge frontiers and windows: within "
        "tolerance; the planted faults fail")
    return errs


def sp_prefill_case(torch, flash, h, kvh, pos, rnd) -> dict:
    """Card times of one prefill statistics call, q [1, h, 1024, 128]
    against a [1, kvh, 1024, 128] block at relative offset ``pos`` (0: the
    diagonal, causal; 1024: every key live): the kernel, its plain
    version and ``aten._scaled_dot_product_flash_attention`` (which
    returns the log-sum-exp beside its output; K and V repeated to the
    query heads beforehand), beside the bound: q, K and V read once, o, m
    and l (f32) written once; 2 products of D multiply-adds a live (q,
    key) pair."""
    t = s = SP_BLOCK
    q = rnd(1, h, t, D)
    k, v = rnd(1, kvh, s, D), rnd(1, kvh, s, D)
    kx, vx = (x.repeat_interleave(h // kvh, dim=1) for x in (k, v))
    pairs = t * (t + 1) // 2 if pos == 0 else t * s
    nbytes = q.numel() * 2 + 2 * k.numel() * 2 + q.numel() * 4 + 2 * h * t * 4
    b_ms, b_by = bound(nbytes, 4 * h * D * pairs)
    lib = torch.ops.aten._scaled_dot_product_flash_attention
    case = {"shape": f"q [1,{h},{t},{D}] block [1,{kvh},{s},{D}] offset "
                     f"{pos}",
            "ms": time_ms(lambda: flash.flash_attention_stats(
                q, k, v, pos)),
            "plain_ms": time_ms(lambda: flash.flash_attention_stats_ref(
                q, k, v, pos)),
            "library_ms": time_ms(lambda: lib(q, kx, vx, 0.0,
                                                     pos == 0)),
            "bound_ms": b_ms, "bound_by": b_by}
    case["pct_of_bound"] = 100 * b_ms / case["ms"]
    return case


def sp_decode_case(torch, flash, kvcache, name, b, t, pos, h, kvh,
                   rnd) -> dict:
    """Card times of one decode statistics call over a [b, kvh, 2048, 128]
    shard from the shard-relative frontiers ``pos``: the kernel, its plain
    version and SDPA over the same live keys (a boolean mask per row and
    query), beside the bound: q read, o, m and l written, and each row's
    live keys read once (bf16 K and V, or int8 codes and f32 scales); 2
    products of D multiply-adds a live (query, key) pair."""
    import torch.nn.functional as F

    k, v = rnd(b, kvh, SP_SHARD, D), rnd(b, kvh, SP_SHARD, D)
    ops = sp_decode_ops(kvcache, name, k, v)
    q = rnd(b, h, t, D)
    p = torch.tensor(pos, dtype=torch.int32, device="cuda")
    live = [max(0, min(x + t, SP_SHARD)) for x in pos]
    pairs = sum(max(0, min(x + i + 1, SP_SHARD)) for x in pos
                for i in range(t))
    per_key = 2 * D * 2 if "q8" not in name else 2 * (D + 4)
    nbytes = q.numel() * 2 + q.numel() * 4 + 2 * b * h * t * 4 + \
        kvh * sum(live) * per_key
    b_ms, b_by = bound(nbytes, 4 * h * D * pairs)
    n = max(1, max(live))
    mask = (torch.arange(n, device="cuda")[None, None, :]
            <= p.long()[:, None, None]
            + torch.arange(t, device="cuda")[None, :, None])[:, None]
    lk, lv = ((k, v) if "q8" not in name else tuple(
        kvcache.dequant_kv(kvcache.quant_kv(x), torch.bfloat16)
        for x in (k, v)))
    lk, lv = lk[:, :, :n], lv[:, :, :n]
    kernel, plain = getattr(flash, name), getattr(flash, f"{name}_ref")
    case = {"shape": f"q [{b},{h},{t},{D}] "
                     f"{'int8' if 'q8' in name else 'bf16'} shard "
                     f"[{b},{kvh},{SP_SHARD},{D}] pos {list(pos)}",
            "ms": time_ms(lambda: kernel(q, *ops, p)),
            "plain_ms": time_ms(lambda: plain(q, *ops, p)),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q, lk, lv, attn_mask=mask, enable_gqa=True)),
            "bound_ms": b_ms, "bound_by": b_by}
    case["pct_of_bound"] = 100 * b_ms / case["ms"]
    return case


def sp_kernel_timing(torch, flash, kvcache, build, errs, rows) -> None:
    """Phase 3 of the statistics forms: a kernel-table row each, headed by
    the ring's visit of an earlier block (prefill, offset 1024) and one
    stream's decode at 2047 over its shard, with the diagonal visit, tp
    2's local heads and 8 streams of T = 5 at SP_DECODE_POS as cases."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    replaces = {"flash_prefill_stats": "cake_tpu/ops/ring.py:38",
                "flash_decode_stats": "cake_tpu/ops/ring.py:214",
                "flash_decode_q8_stats": "cake_tpu/ops/attention.py:385"}
    for name in SP_STATS:
        if name == "flash_prefill_stats":
            cases = [sp_prefill_case(torch, flash, h, kvh, pos, rnd)
                     for (tp, h, kvh), pos in ((SP_HEADS[0], SP_BLOCK),
                                               (SP_HEADS[0], 0),
                                               (SP_HEADS[1], SP_BLOCK))]
            err = errs[(name, 1, SP_BLOCK, None, SP_BLOCK)]
        else:
            cases = [sp_decode_case(torch, flash, kvcache, name, b, t, pos,
                                    h, kvh, rnd)
                     for (tp, h, kvh), b, t, pos in (
                         (SP_HEADS[0], 1, 1, (SP_SHARD - 1,)),
                         (SP_HEADS[0], 8, 5, SP_DECODE_POS),
                         (SP_HEADS[1], 1, 1, (SP_SHARD - 1,)))]
            err = errs[(name, 1, 1, 1, None)]
        row = {"name": name, "route": "cuda",
               "source": f"cake_tpu_torch/csrc/{name}.cu",
               "replaces": replaces[name], "max_abs_err": err, **cases[0],
               "cases": cases[1:], **kernel_build_info(build, name)}
        row["kernel_ms"] = row["ms"]
        rows.append(row)
        for c in cases:
            say(f"[3] {name} {c['shape']}: {c['ms']:.4f} ms, "
                f"{c['pct_of_bound']:.1f}% of bound {c['bound_ms']:.4f} by "
                f"{c['bound_by']} (plain {c['plain_ms']:.4f}, library "
                f"{c['library_ms']:.4f})")
    torch.cuda.empty_cache()

# --------------------------------------------------------------------------
# phase 19: the tools on the card
# --------------------------------------------------------------------------

# stage_slice here: 5 of Llama-3-70B's layers (a 16-stage pipeline's
# stage), 8 timed decode steps
TOOL_STAGE_LAYERS = 5
TOOL_STAGE_STEPS = 8
# memory after the stage's weights and cache against hbm_budget's
TOOL_BUDGET_REL = 0.03
# the sweeps' short grids (the command lines run the full ones)
TOOL_PREFILL_GRID = ((512, 2048),)
TOOL_DECODE_GRID = ((1, 1, (2047,)), (8, 9, (4095, 2047, 1100, 517, 260,
                                             64, 33, 5)))
TOOL_INT4_SHAPES = (("down", 14336, 4096),)
TOOL_INT4_MS = (1, 72)


def phase_card_tools(torch, build) -> dict:
    """(i) ``tools.ici_probe`` over 2 gloo ranks on this card: the payload
    back intact after its hops, the per-hop us host-staged; (ii)
    ``tools.stage_slice`` at TOOL_STAGE_LAYERS of Llama-3-70B, int8 and
    bf16, with (i)'s hop: both rows measured, memory after init within
    TOOL_BUDGET_REL of ``hbm_budget``'s ``layers + kv_cache``, layer 0's
    decode output at mid-window within MODEL_REL_L2 of the CPU plain path
    on the same weights (an end-to-end witness: the residual dominates
    it), and the stage's kernels at its own shapes each within phase 2's
    tolerance of its plain version, a planted fault refused beside each
    (``stage_slice.check_stage_kernels``); (iii)
    ``tools.kernel_check`` as a process: exit 0 with the nine kernels'
    lines; (iv) ``tools.flash_sweep`` and ``tools.int4_sweep`` on short
    grids: every row's kernel output within phase 2's tolerance of its
    plain version. The stage runs are this phase's path: their launches
    count; the comparison runs' do not."""
    from cake_tpu_torch.tools import (
        flash_sweep,
        ici_probe,
        int4_sweep,
        kernel_check,
        stage_slice,
    )

    t0 = time.perf_counter()
    recs = ici_probe.probe(2, reps=64, device_type="cuda", backend="gloo",
                           payloads=(stage_slice.HOP_BYTES, 1 << 20))
    if len(recs) != 2 or not all(r["host_staged"] for r in recs):
        fail(f"[19] (i) ici_probe records {recs}")
    for r in recs:
        say(f"[19] (i) ici_probe {r['payload_bytes']} B over 2 gloo ranks on "
            f"one card (host-staged): {r['per_hop_us']:.2f} us a hop, "
            f"{r['gbps']:.3f} GB/s, {r['hops']} hops")
    hop = {"per_hop_us": recs[0]["per_hop_us"], "backend": "gloo",
           "host_staged": True, "source": "measured"}
    t_ici = time.perf_counter() - t0

    rows, launches = [], {}
    for quant in ("int8", None):
        row = stage_slice.measure_slice(quant, TOOL_STAGE_LAYERS, 8192,
                                        TOOL_STAGE_STEPS, device="cuda",
                                        hop=hop, check=True)
        rows.append(row)
        for k, n in row["launches"].items():
            launches[k] = launches.get(k, 0) + n
        want = row["budget_layers_bytes"] + row["budget_kv_cache_bytes"]
        off = abs(row["allocated_after_init_bytes"] - want) / want
        say(f"[19] (ii) stage_slice {row['quant']} {TOOL_STAGE_LAYERS} "
            f"layers of Llama-3-70B, window 8192: decode step "
            f"{row['decode_step_ms_wall']:.3f} ms wall, "
            f"{row['decode_step_ms_card']:.3f} card (roofline "
            f"{row['decode_step_ms_roofline']:.3f}); prefill "
            f"{row['prefill_t']} {row['prefill_ms_wall']:.3f} wall, "
            f"{row['prefill_ms_card']:.3f} card; allocated "
            f"{row['allocated_after_init_bytes']} B against the budget's "
            f"{want} ({100 * off:.2f}%), peak {row['peak_bytes']} B; layer "
            f"0 against the CPU: rel L2 {row['layer0_rel_l2']:.3e}, max "
            f"{row['layer0_max_abs_err']:.3e}; launches {row['launches']}")
        if off > TOOL_BUDGET_REL:
            fail(f"[19] (ii) {row['quant']} memory after init "
                 f"{row['allocated_after_init_bytes']} B is {100 * off:.2f}% "
                 f"off hbm_budget's {want}")
        if not row["layer0_rel_l2"] < MODEL_REL_L2:
            fail(f"[19] (ii) {row['quant']} layer 0 relative L2 "
                 f"{row['layer0_rel_l2']} >= {MODEL_REL_L2}")
    for k in ("flash_prefill", "flash_decode", "quant_matmul"):
        if not launches.get(k):
            fail(f"[19] (ii) the stage launched no {k}: {launches}")
    stage_kernels = stage_slice.check_stage_kernels(
        stage_slice.slice_config(TOOL_STAGE_LAYERS, 8192, False), 8192,
        stage_slice.prefill_len(8192), device="cuda")
    for rec in stage_kernels:
        say(f"[19] (ii) {rec['kernel']} {rec['shape']}: max_abs_err "
            f"{rec['max_abs_err']:.3e}, worst row rel L2 "
            f"{rec['rel_l2']:.3e}; planted fault {rec['planted_rel_l2']:.3e}")
        if not rec["ok"]:
            fail(f"[19] (ii) {rec['kernel']} {rec['shape']} outside phase "
                 f"2's tolerance: {rec}")
        if not rec["planted_refused"]:
            fail(f"[19] (ii) the check passes a planted fault of "
                 f"{rec['kernel']} {rec['shape']}: {rec}")
    t_stage = time.perf_counter() - t0 - t_ici

    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-m",
                        "cake_tpu_torch.tools.kernel_check", "--e2e",
                        "bf16"], capture_output=True, text=True, cwd=REPO,
                       env=env, timeout=300)
    lines = [json.loads(ln) for ln in r.stdout.splitlines()
             if ln.startswith("{")]
    checked = [ln for ln in lines if ln["kernel"] in kernel_check.KERNELS]
    if r.returncode != 0 or [ln["kernel"] for ln in checked] != list(
            kernel_check.KERNELS):
        fail(f"[19] (iii) kernel_check exited {r.returncode} with "
             f"{[ln['kernel'] for ln in checked]}: {r.stderr[-2000:]}")
    for ln in lines:
        say(f"[19] (iii) kernel_check {json.dumps(ln)}")
    t_check = time.perf_counter() - t0 - t_ici - t_stage

    flash_rows = flash_sweep.sweep(prefill_grid=TOOL_PREFILL_GRID,
                                   decode_grid=TOOL_DECODE_GRID)
    int4_rows = int4_sweep.sweep(shapes=TOOL_INT4_SHAPES, ms=TOOL_INT4_MS)
    bad = [x for x in flash_rows + int4_rows if x.get("ok") is False]
    if bad:
        fail(f"[19] (iv) sweep rows outside the tolerance: {bad}")
    seconds = time.perf_counter() - t0
    say(f"[19] (iv) flash_sweep {len(flash_rows)} rows, int4_sweep "
        f"{len(int4_rows)} rows, each kernel within tolerance of its plain "
        f"version; phase 19 {seconds:.1f} s (ici {t_ici:.1f}, stage "
        f"{t_stage:.1f}, kernel_check {t_check:.1f})")
    return {"ici_probe": recs, "stage_slice": rows,
            "stage_kernels": stage_kernels, "kernel_check": lines,
            "flash_sweep": flash_rows, "int4_sweep": int4_rows,
            "launches": {k: launches.get(k, 0) for k in build.SOURCES},
            "seconds": seconds}


# --------------------------------------------------------------------------
# phase 20
# --------------------------------------------------------------------------

# Phase 20 drives the serving plane with the load generator
# (tools/loadgen.py) over Llama-3-8B at SERVE_LAYERS, 8 slots, block 8 (the
# serve default). (a) closed loop: 16 requests from 4 clients, 32 tokens
# each, the prompt lengths cycled from a chat turn to phase 5's 2,000-id
# document; (b) churn and (c) mixed-class: Poisson arrivals at 8 req/s over
# a short and a long prompt, every 4th churn client walking away after 2
# tokens.
LOAD_SLOTS = 8
LOAD_N, LOAD_C, LOAD_NEW = 16, 4, 32
LOAD_LENS = [8, 128, 512, 2000]
# (a)'s served ids against their own history's teacher-forced logits: a
# decode step and the teacher-forced pass each round a logit by up to two
# bf16 steps of its size (MARGIN_TIE is two steps in [4, 8)), so a served
# id may sit up to four steps of its step's best logit below it (on an
# H100 one sat two steps below); an id from a wrong history sits near the
# rest of the vocabulary, logits below the best
CHOSEN_STEPS = 4
CHURN_N, CLASS_N, OPEN_RATE = 24, 16, 8.0
OPEN_LENS = [8, 512]
# (c)'s per-request targets: a TTFT a chat user waits for, and a mean gap
# between tokens (block 8 sends a block's tokens together, so the mean
# is the step time)
SLO_TTFT_MS, SLO_TPOT_MS = 1000.0, 100.0
# (d) the command line's spawned loopback fleets as processes: a tiered
# prefill/decode pair, and the elastic fleet grown to 3 and drained back
LOAD_PROCS = {
    "tiered": ["--spawn-backends", "2", "--spawn-roles", "prefill,decode",
               "-n", "6", "-c", "2", "--max-tokens", "4", "--prompt-len",
               "4", "--retry-429"],
    "elastic": ["--spawn-backends", "2", "--resize-to", "3", "-n", "24",
                "--rate", "12", "--max-tokens", "8", "--retry-429"],
}
# (e) the gate's rows of (a): (metric, report key, percentile or None, unit)
LOAD_ROWS = (("tok_s", None, "tok/s"), ("ttft_ms", "p50", "ms"),
             ("ttft_ms", "p95", "ms"), ("tpot_ms", "p50", "ms"),
             ("tpot_ms", "p95", "ms"))


def load_server(torch, cfg, params, paged: bool, **sched_kw):
    """The in-process server of phase 8 over a new engine (the slot
    layout, or the paged one at page 16), 8 slots."""
    from cake_tpu_torch.ops.sampling import SamplerSettings
    from cake_tpu_torch.runtime.batch_generator import BatchGenerator
    from cake_tpu_torch.serve.api import start_api_server
    from cake_tpu_torch.serve.scheduler import Scheduler

    kw = {"kv_layout": "paged", "kv_page_size": PAGE} if paged else {}
    engine = BatchGenerator(cfg, params,
                            settings=SamplerSettings(temperature=0),
                            block_size=8, **kw)
    sched = Scheduler(engine, queue_depth=32, request_timeout_s=300,
                      **sched_kw)
    sched.start(max_concurrent=LOAD_SLOTS, warm_prompt_len=64)
    server = start_api_server(sched, bind="127.0.0.1", port=0)
    return engine, sched, server


def load_drained(sched, what: str) -> None:
    """Wait until the scheduler holds no session: every stream finished
    or, for a client that walked away, reaped."""
    deadline = time.time() + 120
    while True:
        st = sched.stats()
        if st["running"] == 0 and st["queued"] == 0:
            return
        if time.time() > deadline:
            fail(f"[20] {what}: sessions left after 120 s: {st}")
        time.sleep(0.05)


def pool_state(engine) -> dict:
    """The paged pool's pages by holder, counted as distinct page ids: the
    free list, the prefix tree's nodes and the tables of idle slots (a
    primed slot keeps its page until its next admission). ``held`` is
    their union, so a page both in the tree and in an idle table counts
    once and a leaked page is missing from it."""
    from cake_tpu_torch.kvpool.table import SINK

    free = set(engine._pagepool._free)
    tree, nodes = set(), [engine._prefix_tree._root]
    while nodes:
        node = nodes.pop()
        nodes.extend(node.children.values())
        tree.add(node.page)
    idle = {pid for i, s in enumerate(engine.streams) if s.done
            for pid in engine._tables[i]}
    st = engine.stats()
    return {"pages": engine._pagepool.num_pages - 1,
            "held": len((free | tree | idle) - {SINK, -1}),
            "free": len(free), "tree": len(tree - {-1}),
            "idle": len(idle - {SINK}), "live": st["streams_live"],
            "pinned": st["kvpool"]["pages_pinned"]}


def served_load(torch, build, loadgen, cfg, params, what: str, paged: bool,
                run_kw: dict, sched_kw: dict | None = None):
    """One ``run_load`` against a new engine behind phase 8's server: the
    report, the kernel launches over the run, and the engine's state
    (model calls made, the paged pool before and after, ``/healthz``
    once the run drained). The server and the engine thread are stopped
    before the counts are read, so they are final."""
    import urllib.request

    engine, sched, server = load_server(torch, cfg, params, paged,
                                        **(sched_kw or {}))
    url = f"http://127.0.0.1:{server.port}"
    state = {"pool_before": pool_state(engine) if paged else None}
    p0, d0 = engine.prefill_calls, engine.decode_steps
    torch.cuda.synchronize()
    build.reset_launches()
    rep = loadgen.run_load(url, seed=SEED, vocab=cfg.vocab_size, **run_kw)
    load_drained(sched, what)
    state["pool_after"] = pool_state(engine) if paged else None
    with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
        state["health"] = json.loads(r.read())
    server.close()
    sched.close()
    torch.cuda.synchronize()
    counts = build.launches()
    state["calls"] = (engine.prefill_calls - p0, engine.decode_steps - d0)
    del engine, sched, server
    gc.collect()  # the server's threads leave reference cycles behind
    torch.cuda.empty_cache()
    return rep, counts, state


def bf16_step(torch, x):
    """One bf16 step (unit in the last place) at each value of ``x``:
    bf16 keeps 8 significant bits, so a value m * 2**e with m in
    [0.5, 1) has steps of 2**(e - 8)."""
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def load_line(rep: dict) -> str:
    return (f"{rep['completed']}/{rep['requests']} requests, "
            f"{rep['tokens']} tokens in {rep['wall_s']} s, {rep['tok_s']} "
            f"tokens/s aggregate (host clock); TTFT ms p50 "
            f"{rep['ttft_ms']['p50']} p95 {rep['ttft_ms']['p95']}; TPOT ms "
            f"p50 {rep['tpot_ms']['p50']} p95 {rep['tpot_ms']['p95']}; "
            f"{rep['errors']} errors, {rep['disconnected']} disconnected")


def load_closed(torch, build, loadgen, cfg, params, settings) -> dict:
    """(a): the closed loop over the slot engine; every stream against its
    prompt's single-stream greedy run up to its first near-tie; the
    launches against the engine's model calls."""
    rep, counts, state = served_load(
        torch, build, loadgen, cfg, params, "(a)", False,
        {"n": LOAD_N, "concurrency": LOAD_C, "max_tokens": LOAD_NEW,
         "prompt_lens": LOAD_LENS})
    calls = state["calls"]
    want = expected_launches(cfg, "bf16", None, *calls)
    say(f"[20] (a) closed loop, slot, {LOAD_C} clients: "
        f"{load_line(rep)}; {calls[0]} prompt passes, {calls[1]} "
        f"decode steps; launches {counts}")
    if rep["completed"] != LOAD_N or rep["errors"] or rep["rejected_429"]:
        fail(f"[20] (a): {rep['completed']} of {LOAD_N} requests completed, "
             f"{rep['errors']} errors, {rep['rejected_429']} refused")
    if counts != want:
        fail(f"[20] (a): kernels launched {counts}, want {want} (the "
             f"engine's {calls[0]} prompt passes and {calls[1]} decode "
             "steps)")
    frags = loadgen._make_prompts(LOAD_N, LOAD_LENS, cfg.vocab_size, SEED,
                                  [])
    vs = []
    for i, r in enumerate(rep["results"]):
        prompt, ids = frags[i]["prompt_ids"], r["ids"]
        if len(ids) != LOAD_NEW and not (ids and ids[-1] in cfg.eos_ids()):
            fail(f"[20] (a) request {i}: {len(ids)} ids, quota {LOAD_NEW}")
        ref = single_stream(torch, cfg, params, prompt, len(ids), settings,
                            None)
        pen = penalized_logits(torch, stream_logits(
            torch, cfg, params, prompt, ids, None), prompt, ids, settings)
        m = top2_gaps(pen)
        tie = next((j for j, x in enumerate(m) if x < MARGIN_TIE), len(ids))
        diff = next((j for j, (a, b) in enumerate(zip(ids, ref)) if a != b),
                    None)
        if diff is not None and diff < tie:
            fail(f"[20] (a) request {i} ({len(prompt)} ids) differs from its "
                 f"single-stream run at step {diff}, before any near-tie "
                 f"(margin {m[diff]:.4f} there)")
        # past a near-tie the ids of the two runs say nothing, so each
        # served id is also held to its own history's teacher-forced
        # logits: it is the best of them, or within rounding of it
        best = pen.max(dim=1).values
        chosen = pen.gather(1, torch.tensor(ids, device=pen.device)[:, None])
        steps = (best - chosen[:, 0]) / bf16_step(torch, best)
        worst = steps.max().item()
        if worst > CHOSEN_STEPS:
            j = int(steps.argmax())
            fail(f"[20] (a) request {i}: the id served at step {j} is "
                 f"{worst:.2f} bf16 steps ({(best - chosen[:, 0])[j]:.4f}) "
                 f"below its step's best teacher-forced logit "
                 f"{best[j]:.4f} (bound {CHOSEN_STEPS} steps)")
        vs.append({"request": i, "prompt_len": len(prompt),
                   "first_difference": diff, "first_near_tie": tie,
                   "min_margin": min(m), "chosen_steps": worst,
                   "best_logit": [best.min().item(), best.max().item()]})
    lo = min(v["best_logit"][0] for v in vs)
    hi = max(v["best_logit"][1] for v in vs)
    say(f"[20] (a) every stream equals its single-stream greedy run up to "
        f"its first near-tie (margin < {MARGIN_TIE}): first differences "
        f"{[v['first_difference'] for v in vs]}, first near-ties "
        f"{[v['first_near_tie'] for v in vs]}; every served id within "
        f"{max(v['chosen_steps'] for v in vs):.2f} bf16 steps of its "
        f"step's best teacher-forced logit (bound {CHOSEN_STEPS}); best "
        f"logits from {lo:.4f} to {hi:.4f}")
    rep.pop("results")
    return {"report": rep, "launches": counts, "prompt_passes": calls[0],
            "decode_steps": calls[1], "vs_single_stream": vs}


def load_churn(torch, build, loadgen, cfg, params) -> dict:
    """(b): the churn workload over the paged engine; once it drains, every
    page is back: free, the prefix tree's, or an idle slot's."""
    rep, counts, state = served_load(
        torch, build, loadgen, cfg, params, "(b)", True,
        {"n": CHURN_N, "max_tokens": LOAD_NEW, "prompt_lens": OPEN_LENS,
         "rate": OPEN_RATE, "workload": "churn"})
    before, after = state["pool_before"], state["pool_after"]
    say(f"[20] (b) churn, paged (page {PAGE}), {OPEN_RATE} req/s: "
        f"{load_line(rep)}; pool before {before}, after {after}; "
        f"launches {counts}")
    if (rep["errors"] or rep["rejected_429"] or rep["completed"] != CHURN_N
            or rep["disconnected"] != CHURN_N // 4):
        fail(f"[20] (b): {rep['completed']} completed, {rep['errors']} "
             f"errors, {rep['rejected_429']} refused, {rep['disconnected']} "
             f"disconnected (want {CHURN_N}, 0, 0, {CHURN_N // 4})")
    if (after["live"] or after["pinned"]
            or not before["held"] == after["held"] == after["pages"]):
        fail(f"[20] (b): pages not back after the run drained: before "
             f"{before}, after {after}")
    rep.pop("results")
    return {"report": rep, "pool_before": before, "pool_after": after,
            "launches": counts}


def load_classes(torch, build, loadgen, cfg, params) -> dict:
    """(c): the mixed-class workload over the paged engine with spill
    (phase 11's --spill-mb) and SLO targets."""
    rep, counts, state = served_load(
        torch, build, loadgen, cfg, params, "(c)", True,
        {"n": CLASS_N, "max_tokens": LOAD_NEW, "prompt_lens": OPEN_LENS,
         "rate": OPEN_RATE, "workload": "mixed-class",
         "slo_ttft_ms": SLO_TTFT_MS, "slo_tpot_ms": SLO_TPOT_MS},
        {"spill_mb": SPILL_MB})
    health = state["health"]
    by_class = rep.get("ttft_ms_by_class", {})
    say(f"[20] (c) mixed-class, paged, --spill-mb {SPILL_MB}, {OPEN_RATE} "
        f"req/s: {load_line(rep)}; TTFT ms by class {by_class}; "
        f"goodput {rep['slo']['goodput']} (TTFT <= {SLO_TTFT_MS} ms, TPOT "
        f"<= {SLO_TPOT_MS} ms); serve.preemptions {health['preemptions']}; "
        f"launches {counts}")
    if rep["errors"] or rep["rejected_429"] or rep["completed"] != CLASS_N:
        fail(f"[20] (c): {rep['completed']} of {CLASS_N} completed, "
             f"{rep['errors']} errors, {rep['rejected_429']} refused")
    if set(by_class) != {"batch", "interactive"}:
        fail(f"[20] (c): classes reported {sorted(by_class)}, want batch "
             "and interactive")
    rep.pop("results")
    return {"report": rep, "preemptions": health["preemptions"],
            "launches": counts}


def load_processes(build) -> dict:
    """(d): ``python -m cake_tpu_torch.tools.loadgen --spawn-backends 2``
    as two processes side by side on this card, each exiting 0 with no
    error in its report; the elastic one's events hold a grow and a
    drain."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out, procs = {}, {}
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as d:
        try:
            for name, args in LOAD_PROCS.items():
                with open(Path(d) / f"{name}.out", "w") as o, \
                        open(Path(d) / f"{name}.err", "w") as e:
                    procs[name] = subprocess.Popen(
                        [sys.executable, "-m", "cake_tpu_torch.tools.loadgen",
                         *args], stdout=o, stderr=e, env=env, cwd=REPO)
            t0 = time.perf_counter()
            codes, secs = {}, {}
            for n, p in procs.items():
                codes[n] = p.wait(timeout=600)
                secs[n] = time.perf_counter() - t0
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for name in LOAD_PROCS:
            text = (Path(d) / f"{name}.out").read_text()
            err = (Path(d) / f"{name}.err").read_text()
            try:
                rep = json.loads(text)
            except ValueError:
                fail(f"[20] (d) {name}: exit {codes[name]}, no JSON report: "
                     f"{text[-1000:]} {err[-2000:]}")
            say(f"[20] (d) {name} ({' '.join(LOAD_PROCS[name])}): exit "
                f"{codes[name]} after {secs[name]:.1f} s; "
                f"{load_line(rep)}; fleet events "
                f"{rep.get('fleet_events')}")
            if codes[name] != 0 or rep["errors"] or rep["json_invalid"]:
                fail(f"[20] (d) {name} exited {codes[name]} with "
                     f"{rep['errors']} errors: {err[-2000:]}")
            out[name] = rep
    events = out["elastic"].get("fleet_events") or []
    if not (any(e.startswith("grow") for e in events)
            and any(e.startswith("drain") for e in events)):
        fail(f"[20] (d) elastic: no grow and drain among {events}")
    return out


def load_gate(card: str, closed: dict) -> dict:
    """(e): ``python -m cake_tpu_torch.tools.benchdiff`` over a temporary
    ledger: the repo's ``bench_results.jsonl`` (TPU and CPU rows), then
    (a)'s rows twice under this card's name: exit 0; then a planted (a)
    tokens/s row at 10% of the measured one: exit 1, REGRESSED."""
    device = card.split(",")[0].strip()
    repo_ledger = REPO / "bench_results.jsonl"
    text = repo_ledger.read_text()
    rep = closed["report"]
    rows = [{"metric": f"loadgen_closed_{key}"
                       f"{'_' + q if q else ''}_llama3_8b_"
                       f"{SERVE_LAYERS}l_bf16_c{LOAD_C}",
             "value": rep[key][q] if q else rep[key], "unit": unit,
             "device": device} for key, q, unit in LOAD_ROWS]
    runs = []
    with tempfile.TemporaryDirectory() as d:
        ledger = Path(d) / "ledger.jsonl"
        ledger.write_text(text + "".join(json.dumps(r) + "\n"
                                         for r in rows + rows))
        for planted in (False, True):
            if planted:
                with open(ledger, "a") as f:
                    f.write(json.dumps(dict(
                        rows[0], value=round(rows[0]["value"] * 0.1, 2)))
                        + "\n")
            r = subprocess.run(
                [sys.executable, "-m", "cake_tpu_torch.tools.benchdiff",
                 "--ledger", str(ledger), "--baseline",
                 str(Path(d) / "missing.json")],
                capture_output=True, text=True, timeout=120, cwd=REPO,
                env=dict(os.environ, PYTHONPATH=str(REPO)))
            regressed = [ln for ln in r.stdout.splitlines()
                         if "REGRESSED" in ln]
            say(f"[20] (e) benchdiff over {len(text.splitlines())} ledger "
                f"rows + (a)'s {len(rows)} rows twice as {device!r}"
                f"{' + a planted tokens/s row at 10%' if planted else ''}: "
                f"exit {r.returncode}; {r.stdout.strip().splitlines()[-1]}"
                f"{'; ' + regressed[0].strip() if regressed else ''}")
            want = 1 if planted else 0
            if r.returncode != want or bool(regressed) != planted or (
                    planted and not regressed[0].startswith(rows[0]["metric"])):
                fail(f"[20] (e) benchdiff exited {r.returncode} (want {want})"
                     f": {r.stdout[-3000:]} {r.stderr[-1000:]}")
            runs.append({"exit": r.returncode, "regressed": regressed})
    if repo_ledger.read_text() != text:
        fail("[20] (e) the repo's bench_results.jsonl changed")
    return {"rows": rows, "runs": runs}


def phase_load(torch, build, card: str) -> dict:
    """Phase 20: the serving plane under the load generator, (a)-(e)."""
    from cake_tpu_torch.models import llama
    from cake_tpu_torch.models.config import llama3_8b
    from cake_tpu_torch.ops.sampling import SamplerSettings
    from cake_tpu_torch.tools import loadgen

    t0 = time.perf_counter()
    cfg = llama3_8b(num_hidden_layers=SERVE_LAYERS, max_seq_len=4096)
    params = llama.init_params(cfg, seed=SEED)
    settings = SamplerSettings(temperature=0)
    closed = load_closed(torch, build, loadgen, cfg, params, settings)
    churn = load_churn(torch, build, loadgen, cfg, params)
    classes = load_classes(torch, build, loadgen, cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    procs = load_processes(build)
    gate = load_gate(card, closed)
    launches = {k: closed["launches"][k] + churn["launches"][k]
                + classes["launches"][k] for k in build.SOURCES}
    seconds = time.perf_counter() - t0
    say(f"[20] phase 20 {seconds:.1f} s; launches {launches}")
    return {"closed": closed, "churn": churn, "classes": classes,
            "processes": procs, "gate": gate, "launches": launches,
            "seconds": seconds}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    other = None
    only_guided = sys.argv[1:] == ["--phase", "10"]
    only_paged = sys.argv[1:] == ["--phase", "11"]
    only_spec = sys.argv[1:] == ["--phase", "12"]
    only_families = sys.argv[1:] == ["--phase", "13"]
    only_disagg = sys.argv[1:] == ["--phase", "14"]
    only_tools = sys.argv[1:] == ["--phase", "15"]
    only_mesh = sys.argv[1:] == ["--phase", "16"]
    only_sp = sys.argv[1:] == ["--phase", "17"]
    only_moe = sys.argv[1:] == ["--phase", "18"]
    only_card_tools = sys.argv[1:] == ["--phase", "19"]
    only_load = sys.argv[1:] == ["--phase", "20"]
    if len(sys.argv) == 3 and sys.argv[1] == "--kernels":
        other = Path(sys.argv[2]).resolve()
    elif len(sys.argv) > 1 and not (only_guided or only_paged or only_spec
                                    or only_families or only_disagg
                                    or only_tools or only_mesh or only_sp
                                    or only_moe or only_card_tools
                                    or only_load):
        fail(f"usage: {sys.argv[0]} [--kernels DIR | --phase 10 | "
             "--phase 11 | --phase 12 | --phase 13 | --phase 14 | "
             "--phase 15 | --phase 16 | --phase 17 | --phase 18 | "
             "--phase 19 | --phase 20]")
    sys.path.insert(0, str(other or REPO))
    global time_ms, bound, verdict, decode_cost, prefill_cost, matmul_cost
    try:
        from cake_tpu_torch.ops import flash, kvcache, qmatmul, quant
        from cake_tpu_torch.ops.kernels import build
        from cake_tpu_torch.tools.kernel_check import (
            bound,
            decode_cost,
            matmul_cost,
            prefill_cost,
            time_ms,
            verdict,
        )
    except ImportError as e:
        fail(f"the cake_tpu_torch package is not beside this script ({e})")
    torch.backends.cuda.matmul.allow_tf32 = False

    if other is not None:
        say(card_line())
        build.build_all(["quant_matmul", "quant4_matmul", "flash_decode"])
        say(json.dumps({"package": str(other),
                        **kernel_times(torch, flash, qmatmul, quant)}))
        return 0

    card = phase_toolchain(torch, build)
    if only_guided:
        guided, guided_cli_ids = phase_guided(torch, build,
                                              phase_cli(torch, build))
        say(json.dumps({"card": card, "guided": guided,
                        "guided_cli": guided_cli_ids}))
        say(card)
        return 0
    if only_paged:
        say(json.dumps({"card": card,
                        "paged": phase_paged_only(torch, build)}))
        say(card)
        return 0
    if only_spec:
        say(json.dumps({"card": card, "spec": phase_spec_only(torch,
                                                              build)}))
        say(card)
        return 0
    if only_families:
        say(json.dumps({"card": card, "families": phase_families(torch,
                                                                 build)}))
        say(card)
        return 0
    if only_disagg:
        say(json.dumps({"card": card, "disagg": phase_disagg(torch, build),
                        "disagg_cli": disagg_cli(torch, build)}))
        say(card)
        return 0
    if only_tools:
        say(json.dumps({"card": card, "tools": phase_tools(
            torch, build, phase_cli(torch, build))}))
        say(card)
        return 0
    if only_mesh:
        phase_tp_kernels(torch, flash, qmatmul, quant, kvcache)
        say(json.dumps({"card": card, "mesh": phase_mesh(
            torch, build, run17=False, run18=False)}))
        say(card)
        return 0
    if only_sp:
        errs = phase_sp_kernels(torch, flash, kvcache)
        rows: list = []
        sp_kernel_timing(torch, flash, kvcache, build, errs, rows)
        mesh = phase_mesh(torch, build, run16=False, run18=False)
        for r in rows:
            r["launches"] = mesh["sp"]["launches"][r["name"]]
        say(json.dumps({"card": card, "sp": mesh["sp"]}))
        say(json.dumps({"kernels": rows}))
        say(card)
        return 0
    if only_moe:
        mesh = phase_mesh(torch, build, run16=False, run17=False)
        say(json.dumps({"card": card, "moe": mesh["moe"]}))
        say(card)
        return 0
    if only_card_tools:
        say(json.dumps({"card": card, "card_tools": phase_card_tools(
            torch, build)}))
        say(card)
        return 0
    if only_load:
        say(json.dumps({"card": card, "load": phase_load(torch, build,
                                                         card)}))
        say(card)
        return 0
    t_run = time.perf_counter()

    def lap(phases: str) -> None:
        say(f"[t] phases {phases} done, {time.perf_counter() - t_run:.1f} s "
            "after phase 1")

    errs = phase_kernels(torch, flash)
    errs.update(phase_quant_kernels(torch, flash, qmatmul, quant, kvcache))
    errs.update(phase_batch_kernels(torch, flash, qmatmul, quant, kvcache))
    errs.update(phase_head256_kernels(torch, flash, kvcache))
    errs.update(phase_family_matmuls(torch, qmatmul, quant))
    errs.update(phase_fine_groups(torch, qmatmul, quant))
    errs.update(phase_tp_kernels(torch, flash, qmatmul, quant, kvcache))
    errs.update(phase_sp_kernels(torch, flash, kvcache))
    lap("2")
    # timed before the profiled main path: a profiler session slows the
    # host for the rest of the process
    rows = phase_timing(torch, flash, kvcache, build, errs)
    rows += phase_quant_timing(torch, flash, qmatmul, quant, kvcache, build,
                               errs)
    batch_timing(torch, flash, qmatmul, quant, kvcache, build, rows)
    multi_query_timing(torch, flash, qmatmul, quant, kvcache, build, rows)
    prefill_rows(build, rows)
    family_timing(torch, flash, qmatmul, quant, kvcache, build, errs, rows)
    fine_group_timing(torch, qmatmul, quant, build, errs, rows)
    tp_local_timing(torch, flash, qmatmul, quant, kvcache, build, rows)
    sp_kernel_timing(torch, flash, kvcache, build, errs, rows)
    lap("3")
    phase_model(torch)
    families_model = phase_model_families(torch)
    lap("4")
    main_path = phase_main_path(torch, build, flash, kvcache)
    main_path.append(fine_group_path(torch, build))
    lap("5")
    cli = phase_cli(torch, build)
    lap("6")
    # phases 11 and 12 run at the end of each of phase 7's paths, over its
    # weights
    paged, spec = [], []

    def after(*a):
        paged.append(phase_paged(torch, build, *a))
        spec.append(phase_spec(torch, build, *a))

    batch = phase_batch(torch, build, after=after)
    lap("7, 11, 12")
    serve = phase_serve(torch)
    lap("8")
    cross_host = phase_cross_host(torch, build, main_path)
    cross_host_cli = phase_cli_topology(torch, build, cli)
    lap("9")
    guided, guided_cli_ids = phase_guided(torch, build, cli)
    lap("10")
    families = phase_families(torch, build)
    lap("13")
    disagg = phase_disagg(torch, build)
    disagg_cli_run = disagg_cli(torch, build)
    lap("14")
    tools = phase_tools(torch, build, cli)
    lap("15")
    mesh = phase_mesh(torch, build)
    lap("16, 17, 18")
    load = phase_load(torch, build, card)
    lap("20")
    # last: its stage runs profile the card, and a profiler session slows
    # the host for the rest of the process
    card_tools = phase_card_tools(torch, build)
    lap("19")
    # over the paths (a), (b), (c), the batch runs, the cross-host runs,
    # phase 10's guided and lookahead runs, phase 11's paged runs, phase
    # 12's speculative runs, phase 13's family runs, phase 14's
    # disaggregated runs (both replicas), phase 15's clean run over the
    # bundles (master and workers), phase 16's, 17's and 18's mesh runs
    # (every rank), phase 20's served loads and phase 19's stage runs
    for r in rows:
        r["launches"] = sum(p["launches"][r["name"]]
                            for p in main_path + batch + cross_host + guided
                            + paged + spec + families + disagg
                            + [tools, mesh, mesh["sp"], mesh["moe"], load,
                               card_tools])
    say(json.dumps({"card": card, "main_path": main_path, "batch": batch,
                    "serve": serve, "cross_host": cross_host,
                    "cross_host_cli": cross_host_cli, "guided": guided,
                    "guided_cli": guided_cli_ids, "paged": paged,
                    "spec": spec, "families_model": families_model,
                    "families": families, "disagg": disagg,
                    "disagg_cli": disagg_cli_run, "tools": tools,
                    "mesh": mesh, "load": load, "card_tools": card_tools}))
    say(json.dumps({"kernels": rows}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
