#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py [--save-steps PATH]

``--save-steps`` also writes the decode steps that phase 10 recorded, the
Mamba-2 prefill stages that phase 9 recorded and the paged prefill stages
that phase 12 recorded to PATH (``torch.save``), for
``scripts/compare_attention.py --steps PATH``.

Phases, each of which ends the script with a non-zero exit code when it
fails (nothing is caught).  Every engine on the card serves as a user's
would: each bucket's prefill and decode loop (a ``StaticEngine``: one
graph whose WHILE node runs the slice's steps; a ``ContinuousEngine``:
its join prefill and its decode step) captured once into CUDA graphs and
replayed (``repro_torch.engine.graphs``); the kernels' launch counts
include the replays' launches, and the loop's condition kernel
(``graph_loop``) launches once a decode step and once a slice.  Only
phase 26 also runs the engines' eager paths (``graphs.disabled()``),
beside the graphs:

1. device: the card's name and power limit from ``nvidia-smi``; float32
   matrix products are kept out of TF32;
2. build: ``nvcc`` compiles every CUDA kernel of the port from
   ``src/repro_torch/kernels/csrc`` (one process per source, all at once);
3. kernels: each kernel runs at the main path's full-width shapes
   (llama3.2-1b: 32 query heads, 8 KV heads, head_dim 64, 16-token pages,
   bf16, 8 rows of about 512 tokens over a page pool of the slice's size;
   flash_prefill also at one row of 1280 and with a window,
   decode_attention over 768-slot rows, one of them empty, and at the
   dense slices' 2 x 1344 and 16 x 1280; ssd_scan at
   mamba2-130m's prefill: 8 left-padded rows of 512 tokens, 24 heads of
   P 64, N 128, chunks of 128, float32, one group and two; phase 11 adds
   the Mamba-2 slice's own stages, phase 12 the paged slices' own prefill
   stages to the writes') and is held against its plain
   PyTorch version on the same inputs, then timed beside that plain
   version, PyTorch yardsticks computing the same function, and the least
   time the card could take (the decode kernels and flash_prefill also at
   the shapes the slices run: ``shapes`` in their rows); then again at
   the other dense configs' heads, each config's own kernels
   (``CONFIG_HEADS``): codeqwen1.5-7b's (32/32, head_dim 128)
   flash_prefill, paged_decode_attention and paged_prefill_write,
   minitron-4b's (24/8, head_dim 128) fused kernels, and at gemma-2b's (8
   query heads over one KV head of 256) every attention kernel and both
   writes (flash_prefill 8 x 512 and 1 x 1280, decode_attention 8 x 768,
   the paged decode kernels 8 x 576, the writes 8 x 512; ``shapes``
   entries labelled "<arch> heads"); then at the windowed configs' heads
   with their windows (``WINDOW_HEADS``): recurrentgemma-9b's (16 query
   heads over one KV head of 256, local window 2048: B6 at group 16) and
   mixtral-8x22b's (48/8, head_dim 128, sliding window 4096),
   flash_prefill on one row of window + 256 tokens and decode_attention
   over 4 rings of one window (3 wrapped, 1 empty); paged_decode_attention
   and fused_rope_decode_append also at pages of 32 and 4 slots
   (``PAGE_SIZES_TIMED``: looked up once per 8 slots, and once per slot);
   then at the frontend families' heads (``check_frontend_heads``):
   flash_prefill with paligemma-3b's bidirectional prefix of 256 before
   128 text slots (8 rows, MQA 8/1, head_dim 256) and as
   seamless-m4t-large-v2's encoder (8 rows of 1024 frames, some invalid,
   16/16, head_dim 64, prefix_len 1024), decode_attention as seamless's
   cross-attention over those frames, each also beside its plain version;
   last the decode loop's condition kernel (``graph_loop``, no Pallas
   kernel's port: the ``lax.while_loop``'s cond) held against its plain
   version over 64 conditions, timed at 8 rows, and its cost a step
   inside a WHILE loop of 1024 steps beside a replay a step with the
   host's test (``check_graph_loop``);
4. reference (run by each transformer slice, phases 5-7 and 13-15, before
   it serves): on a small input, the slice's served path (through its
   kernels) is held against the plain full forward of the same model on
   the card (``transformer.forward``: torch attention, no kernel, no
   cache); then control faults (a wrong slot, swapped KV heads, a lost
   QKV bias) through the same path must move the logits past the
   tolerance, which the script checks after the last slice; the MoE and
   hybrid slices (phases 17-19) hold their family's served functions
   against its plain ``forward`` the same way (``check_family_logits``;
   one gate for every path, ``hold_logits``), the MoE families on a
   float32 model of 4 layers at full width whose capacity drops nothing
   (``moe_check_model``, to ``F32_REF_TOL``), the hybrid on the slice's
   own model, with a control fault each (deepseek's shared experts lost,
   mixtral routed to its 2nd..3rd best experts, the hybrid's recurrent
   state zeroed after the prefill); each MoE slice's own bf16 model at
   its served capacity then runs one decode group's MoE layer on the card
   and on the CPU (``check_served_routing``): the same choices kept and
   dropped, exactly;
4b. ILS parity: the reduced float32 llama3.2-1b, one set of weights on the
   card and on the CPU; small dense and paged ``ContinuousEngine``s and
   the dense ``StaticEngine`` give the same token streams on both (near
   ties recorded), the kernels launch once per layer per prefill / decode
   step, and dense == paged on the card;
4c. config parity: the reduced float32 mamba2-130m (per-head parameters
   drawn apart), codeqwen1.5-7b (QKV biases drawn apart), minitron-4b and
   gemma-2b, and gemma-2b at head_dim 256, mixtral-8x22b,
   deepseek-v2-lite-16b, recurrentgemma-9b (RG-LRU channels drawn
   apart), seamless-m4t-large-v2 (norm gains drawn apart) and
   paligemma-3b (both with seeded frontend embeddings, a dense engine
   per slice over its batch's rows), and the two MoE configs again at their full configs' capacity
   factor, which drops routed choices on both devices, one set of
   weights on the card and on the CPU; the dense ``StaticEngine`` and,
   for the dense transformers, the paged unfused and fused ones give the
   same token streams on both
   over two slices, each path's kernels launching once per layer per
   prefill stage / decode step and no other, the CPU engine's plain
   versions as often;
5. unfused slice: full-width llama3.2-1b in bf16 with random weights, cut
   to 8 of its 16 layers (``DEPTH_CUTS``, as in phases 6-8: the script's
   time limit),
   built by ``repro_torch.launch.serve`` (SCLS, one worker, persistent
   paged KV with ``kv_retain="request"`` and prefix sharing; the
   estimator fixed to the paper testbed's, ``fixed_fit``), serves a
   CodeFuse trace plus requests that repeat an earlier prompt's leading
   pages.  Every request must complete, prefix sharing must hit, and each
   unfused kernel must have launched exactly once per layer per prefill
   stage / decode step (flash_prefill once per layer per stage-A prefill,
   the tail prefills attend over gathered pages); then one more slice (8
   fresh 256-token requests, 32 decode steps) under ``torch.profiler``,
   for the device's busy share;
6. fused slice: the launcher's build once more, its paged engines swapped
   for ``StaticEngine(attn_impl="fused")`` workers on its model, weights,
   estimator and memory model; first small fused and unfused engines
   serve the same batches (token streams equal but for recorded
   near-ties), then the same trace: every request completes, prefix
   sharing hits, nothing is re-prefilled, and only the fused kernels
   launch, once per layer per prefill stage / decode step; then the
   profiler window of phase 5 on a fused engine;
7. dense slice: the launcher with ``--kv-layout dense --kv-retain slice``
   (the paper's SCLS, which re-prefills prompt + generated tokens at every
   reschedule) serves the same trace: every request completes, re-prefill
   is above zero, and only flash_prefill and decode_attention launch, once
   per layer per prefill stage / decode step;
8. ILS: the paper's baseline, ``ContinuousEngine.serve`` at full width on
   the trace's 40 prompts with their output lengths forced, dense (16
   slots of 1280) and paged (64 rows, the same token budget): every
   request completes, the paged engine runs more rows at once, its pages
   all return, and only flash_prefill and the layout's decode kernel
   launch, once per layer per join / decode iteration;
9. Mamba-2 slice: the launcher with ``--arch mamba2-130m --kv-layout dense
   --kv-retain slice`` at full width, cut to 12 of its 24 layers (bf16,
   random weights from a seeded ``torch.Generator``) serves the same
   trace: every request completes, re-prefill is above zero, ssd_scan
   launches exactly once per layer per prefill stage and no other kernel
   launches, and each
   stage's scan shape (rows, tokens, each row's valid tokens) is recorded
   (``StageRecorder``); then a full-width prefill of a 300-token prompt
   (two full 128-token chunks, where the JAX oracle overflows to NaN:
   ROADMAP C2) gives finite logits;
10. engine steps (run after phase 8, and after phase 15 for the configs):
   while the paged slices and the paged ILS run served, the index inputs
   of each paged decode step (block table, slot_pos, write slots, q_pos)
   were recorded (``StepRecorder``: rebuilt from each loop's static
   buffers and the steps it read back); paged_decode_attention at the llama unfused slice's,
   the paged ILS run's and the codeqwen1.5-7b slice's typical step, and
   fused_rope_decode_append at the llama fused slice's, the ILS run's and
   the minitron-4b slice's (the step whose live slots are the run's
   median), each over random pools of the engine's size at its model's
   heads, are held against their plain versions and timed as in phase 3
   (``shapes`` entries with the run's statistics);
11. Mamba-2 stages (run after phase 9): ssd_scan at the recorded stage
   that is the run's median by rows x tokens and at its largest, random
   float32 inputs with the stages' pads, held against its plain version
   and timed as in phase 3 (``shapes`` entries with the run's statistics);
12. prefill stages (run after phase 11, and after phase 15 for the
   configs): while the paged slices served, the index inputs of each
   prefill stage's write (positions, block table, stage-A' tails
   included) were recorded (``PrefillRecorder``: rebuilt from each
   prefill graph's static buffers); paged_prefill_write at
   the llama unfused slice's and the codeqwen1.5-7b slice's median stage
   (by valid tokens) and largest, and fused_rope_prefill_write at the
   llama fused slice's and the minitron-4b slice's, each over random pools
   of the engine's size and random K/V, are held against their plain
   versions and timed as in phase 3, beside an empty launch timed the
   same way (``shapes`` entries with the run's statistics);
13-15. the other dense configs at full width (bf16, random weights from
   a seeded ``torch.Generator``), each built by the launcher's
   ``build_server`` (its wall time, weights and engines included, is
   reported as ``build_s``; the estimator fixed by ``fixed_fit``, as in
   every run_slice phase) and serving a CodeFuse trace (rate 2/s over
   6 s, ``max_gen`` 128 over slices of 32, a 40 GB KV budget):
   codeqwen1.5-7b (MHA 32/32, QKV bias, untied head) cut to 16 of its 32
   layers (``DEPTH_CUTS``: the script's time limit) on the persistent
   paged unfused path with two shared-prefix pairs, minitron-4b (GQA
   24/8, untied head) cut to 16 of its 32 layers on fused engines built
   as phase 6 builds them, gemma-2b at full depth (18 layers, MQA 8/1,
   head_dim 256, GeGLU, embeddings scaled by sqrt(d)) on dense SCLS, each
   checked as phases 4-7 check llama's slices (phase 4 first).

16. the launcher's serving path (``run_launcher_path``; codeqwen1.5-7b
   cut to 16 of its 32 layers, ``DEPTH_CUTS``);
17-19. the MoE and hybrid families through dense SCLS, each built by the
   launcher's ``build_server`` on the configs' trace (bf16, random
   weights from a seeded ``torch.Generator``): deepseek-v2-lite-16b at
   full width and depth (27 layers, MLA, 64 routed + 2 shared experts,
   top-6; a 30 GB KV budget beside ~31 GB of weights; no kernel launches:
   MLA attention and the MoE dispatch are plain torch by design),
   recurrentgemma-9b at full width and depth (38 layers, flash_prefill and
   decode_attention in its 12 local-attention layers, B6 at group 16)
   with one more request of 2,100 prompt tokens, so that the local ring
   of 2048 wraps in prefill and decode, and mixtral-8x22b at full width
   cut to 4 of its 56 layers (``DEPTH_CUTS``: all 56 hold ~281 GB in
   bf16) with one request of 4,200 prompt tokens, past the sliding window
   of 4096; each checked as phases 13-15 (phase 4 first);
20. a fleet (``run_fleet``): two minitron-4b instances at full width and
   depth (32 layers, GQA 24/8, bf16, random weights from the seed), each
   built by the launcher's ``parse_args`` and ``build_server`` on the
   persistent paged unfused path at pages of 32 slots (B1, B2, stage A on
   B5), one worker and a 15 GB KV budget each, and fronted by its HTTP
   front end on an ephemeral port as ``serve_http`` fronts it, both in
   this process, behind ``python -m repro_torch.launch.route --placer
   retention_affinity`` (a child process, stopped by SIGINT, whose exit
   prints its stats); the configs' trace, cut to 5 s of arrivals, through
   the router (token-id
   prompts on ``/v1/completions``, every third streamed), one instance
   drained once half of it is placed, then two two-turn chat sessions,
   each closed by ``DELETE /v1/sessions/<id>``: every request answered
   and completed, the streams' chunks equal to the tokens (one chunk a
   slice at least), no placement on the drained instance after the
   drain, each turn 2 on its turn 1's instance joining its whole pages,
   each session's pages given back, the router's count exact with no
   eviction, and the unfused kernels' launches, summed over the two
   instances' engines (the counts are taken under a lock: two event
   loops run on two threads), once per layer per decode step / stage;
21. the frontend families (``run_frontend_family``), through the JAX
   package's entry point for them, ``StaticEngine(model, params,
   extra_inputs=...).serve_batch``, on dense SCLS (slices of 32, an engine
   per slice over its batch's rows, prompt + generated re-prefilled):
   paligemma-3b at full width and depth (18 layers, MQA 8/1, head_dim
   256, 256 seeded patch embeddings a request, bidirectional in
   flash_prefill) on 8 requests of 16-96 text tokens, and
   seamless-m4t-large-v2 at full width and depth (24 + 24 layers, 16/16,
   head_dim 64; the encoder re-runs at every prefill) on 8 requests of
   256-1024 seeded frames and 2-8 decoder tokens, then one of 4096 frames
   alone; each first held against its plain forward (phase 4) with a
   control fault (the VLM with a causal prefix, the enc-dec model's
   cross-attention ignoring ``src_valid``); every request gets its
   forced tokens, and flash_prefill (with the prefix: the VLM's every
   launch, the encoder's) and decode_attention (the enc-dec model's
   cross-attention calls counted apart) launch as the stages and steps
   imply;
22. training (``run_training``), which launches no kernel (checked: the
   training forwards are the families' plain ``forward``s): one
   ``launch.steps.make_train_step`` of each family's reduced float32
   model (llama3.2-1b, mamba2-130m, deepseek-v2-lite-16b, mixtral-8x22b,
   recurrentgemma-9b, seamless-m4t-large-v2, paligemma-3b; weights drawn
   apart as phase 4c's) on the card and on the CPU from one set of
   weights and one batch, TF32 off: the loss and every updated leaf
   within ``TRAIN_TOL`` 1e-4 (the leaf's largest |value|), and the card's
   step without AdamW's bias correction (control) past it; then
   llama3.2-1b and mamba2-130m at full width and depth (bf16, seeded
   random weights) through the launcher's loop (``launch.train.train``)
   for 20 steps of 8 x 128 tokens of ``SyntheticCorpus`` at lr 1e-3 with
   its warm-up: every loss and parameter finite, the mean of the last 5
   losses below the first 5's, ms a step (AdamW's update between CUDA
   events, with no host wait), tokens/s and ``max_memory_allocated``
   printed beside the card; llama's trained weights and AdamW state saved
   (``checkpoint.store``, the JAX package's npz format, under ``build/``,
   removed after) and loaded into a fresh model on the card, every leaf
   and the plain forward's logits bit-equal; one more step of each under
   ``torch.profiler`` for the device's busy share; and every kernel
   wrapper whose inputs can require grad (all but ``graph_loop``'s),
   called on the card with an input that requires grad, raises and
   launches nothing;
23. scale-out (``run_scale_out``, within about 90 s): (a) the dry-run
   (``repro_torch.launch.dryrun``, CPU only, the card hidden from it) of
   paligemma-3b x train_4k and codeqwen1.5-7b x decode_32k on the fake
   (16, 16) production mesh, in two child processes that run while (b)
   and (c) do: each ``status`` ok, FLOPs > 0 and a collective, its
   roofline line printed (H100 SXM datasheet figures); (b) a real
   one-card mesh (``launch.mesh.make_mesh((1, 1), ...)``: an NCCL group
   of one rank over a ``FileStore`` under ``build/``): full-width
   llama3.2-1b at ``DEPTH_CUTS``' depth, params and cache placed by
   ``launch.sharding``, runs ``make_prefill_step`` and 32
   ``make_decode_step``s greedily, its tokens equal to the unsharded
   steps' on the card (a ``stream_tie`` allowed), B5 once a layer and B6
   once a layer a step launched on the DTensor shards (no plain call);
   then mamba2-130m at ``DEPTH_CUTS``' depth the same way, B7 once a
   layer of the prefill launched on the shards (``SCALE_SERVE``); one
   sharded ``make_train_step`` of the reduced float32 llama gives
   the loss and every leaf within ``TRAIN_TOL`` of the unsharded step;
   (c) a fake (1, 8) mesh with real CUDA tensors: codeqwen1.5-7b at full
   width (32/32 heads, 4 a rank) placed with a dense cache of 8 x 2048
   (decode): the bytes allocated for the arguments equal the dry-run's
   ``argument_bytes`` on the same mesh, and one decode step launches B6
   once a layer at 4 heads (the fake group's collectives move nothing,
   so (c) checks shapes, launches and bytes, not values).
24. examples (``run_examples``, within about a minute): the port's
   ``examples/torch_quickstart.py`` (the reduced llama served by dense
   SCLS over two engines, token parity with one-shot generation 8/8, B5
   and B6 launched) and the real section of
   ``examples/torch_serving_cluster.py`` (``--kv-retain request`` over a
   paged engine: ``reprefill_tokens == 0``, B1 and B2 launched), each in a
   child process on the card (both at once) with its exit code checked;
   their wall seconds and launches go on an ``{"examples": ...}`` line.
25. public heads (``run_public_heads``): (a) B1, B4, B5 and B6 in bf16
   at the heads of six public models the kernels took no earlier
   (``PUBLIC_HEADS``: Phi-3-mini 32/32 and GPT-NeoX-20B 64/64 at head
   dim 96, Phi-2 32/32 at 80, StarCoder2-15B 48/4 and Llama-3.1-405B
   128/8 at 128, Falcon-7B 71/1 at 64), each held against its plain
   version at 8 x 576 (the decode kernels) or 8 x 512 (B5) to
   ``DECODE_TOL`` and timed beside SDPA and its bound (entries of the
   kernels' ``shapes``); (b) llama3.2-1b's widths at 2 layers with
   Phi-3-mini's and Falcon-7B's heads (``public_config``: a config of
   the script, not of the registry): phase 4's gate on the unfused,
   fused and dense paths, then the persistent paged unfused engine, the
   fused engine and dense SCLS ``StaticEngine`` serve 4 requests in two
   slices, each stream equal to ``transformer.forward``'s greedy one but
   for a near-tie, the kernels launched as the stages and steps imply;
   a ``{"public_heads": ...}`` line.
26. graphs (``run_graphs``, run after phase 4c): each captured path
   (``GRAPH_PATHS``: llama3.2-1b paged unfused, paged fused, dense, ILS
   dense and ILS paged; mamba2-130m dense; minitron-4b fused;
   codeqwen1.5-7b unfused; mixtral-8x22b and recurrentgemma-9b dense;
   full width at ``DEPTH_CUTS``' depth, bf16, seeded weights) serves one
   fixed batch (8 fresh requests of 256 tokens, 32 decode steps) on one
   engine with its prefills and loops captured and under
   ``graphs.disabled()``, in turns, then once each way under
   ``torch.profiler`` and once each way counting the host's waits
   (``host_waits``): every serve's streams and decode steps equal, one
   capture a distinct bucket of each kind, a static engine's slice one
   loop call (one host read a dense slice, two a paged one), the decode
   kernel launched once a layer a replayed step and ``graph_loop`` once
   a step and once a slice; ms a slice and a decode step, the device's
   busy share (prefill included) and host waits both ways, captures and
   their seconds by kind and the graph pool's bytes go on a ``{"graphs":
   ...}`` line a path, after the card's reading.

Each phase's seconds (and the kernels' build) are logged as it ends and
printed on a ``{"seconds": ...}`` line.

One function (``run_slice``) runs phases 5-7, 9, 13-15 and 17-19, each a
``SLICES`` entry (launcher arguments and path).  Phase 22 alone:
``PYTHONPATH=src python3 -c "import chip_smoke as c;
c.run_training(c.card_reading())"``; phase 23 alone: the same with
``c.run_scale_out(c.card_reading())`` (it needs the kernels built:
``from repro_torch.kernels import build; build.build_all()`` first).

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it is the ``nvidia-smi`` reading and the one before that the
per-kernel JSON (launches from each kernel's llama3.2-1b or mamba2-130m
slice, phases 5 to 7 and 9, graph_loop's from the dense slice, with
every path's beside them, phases 13 to
21 included, paged_decode_attention's at pg 32, the fleet's, as
``pg32_launches``, decode_attention's at group 16, recurrentgemma-9b's
slice, as ``group16_launches``, flash_prefill's with a prefix, phase
21's, as ``prefix_launches``, decode_attention's as cross-attention,
the seamless slice's, as ``cross_launches``, and B5's, B6's and B7's on
DTensor shards, phase 23's, as ``sharded_launches``; times from phase
3, the public heads' from phase 25).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
from unittest import mock

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory rate
BF16_FLOP_PER_S = 989e12     # H100 SXM dense bf16 tensor-core peak
F32_FLOP_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
TF32_FLOP_PER_S = 495e12     # H100 SXM dense TF32 tensor-core peak
DECODE_TOL = 2e-2            # bf16 decode attention vs its plain version
REF_TOL = 3.5e-2             # logits, a served path vs the plain forward,
                             # relative to the largest |logit| (bf16): sound
                             # paths read <= 1.85e-2 on the H100, the weakest
                             # control fault 6.98e-2 (a wrong slot, gemma-2b)
F32_REF_TOL = 1e-3           # the same in float32 (the MoE check models):
                             # sound 2.8e-6 (deepseek) and 1.1e-5 (mixtral)
                             # on the H100 (700 W), controls 0.90 and 1.39
ROUTE_TOL = 2e-2             # a bf16 MoE layer, card vs CPU, relative to
                             # the CPU's largest |y|
ROUTE_WEIGHT_TOL = 1e-5      # its renormalised float32 top-k weights
MAX_ULPS = 1                 # rotated K, fused kernel vs its plain version
SSD_TOL = 1e-4               # ssd_scan vs its plain version, relative to the
                             # largest |value|: float32 sums of <= 128 terms
                             # in another order, through 4 chunk states, stay
                             # near 1e-6; an indexing fault moves O(1) of it
ITERS = 50
SLEEP_CYCLES = 2_000_000     # ~1 ms of device sleep at the H100's clocks
SLEEP_MARGIN = 3             # device sleep / the host's enqueue time, least
MAX_SLEEP_MS = 200.0         # a longer enqueue is a fault, not a timing


T_START = time.perf_counter()


def log(msg: str) -> None:
    """A line of the run's log, headed by the seconds since the start."""
    print(f"[smoke {time.perf_counter() - T_START:6.1f} s] {msg}",
          flush=True)


def card_reading() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


_sleep_rate = []  # device sleep cycles per ms, measured once


def sleep_cycles_per_ms() -> float:
    if not _sleep_rate:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(SLEEP_CYCLES)
        end.record()
        end.synchronize()
        _sleep_rate.append(SLEEP_CYCLES / start.elapsed_time(end))
    return _sleep_rate[0]


def time_ms(fn, flush: torch.Tensor, iters: int = ITERS,
            label: str = "") -> float:
    """Mean device time of ``fn`` over ``iters`` launches, each timed by
    CUDA events with the L2 cache flushed before it (the main path reads
    16 layers' distinct pools, so the kernels find it cold).  A device-side
    sleep before the start event keeps the card busy while the host
    enqueues ``fn``, so the events time the device's work and not the
    wrapper's Python: the host's enqueue time of ``fn`` is measured during
    warm-up and the sleep sized to ``SLEEP_MARGIN`` times it (at least
    ``SLEEP_CYCLES``); the run raises where that would pass ``MAX_SLEEP_MS``.
    A host synchronisation inside ``fn`` (the plain write's boolean
    indexing) still counts, as it does on the main path."""
    fn()  # warm-up
    enqueue = 0.0
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        enqueue = max(enqueue, (time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    rate = sleep_cycles_per_ms()
    cycles = max(SLEEP_CYCLES, int(SLEEP_MARGIN * enqueue * rate))
    if cycles > MAX_SLEEP_MS * rate:
        raise SystemExit(f"timing {label}: the host's enqueue takes "
                         f"{enqueue:.3f} ms, beyond a device sleep of "
                         f"{MAX_SLEEP_MS} ms")
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    log(f"  timed {label}: host enqueue {enqueue:.4f} ms, device sleep "
        f"{cycles / rate:.3f} ms before each of {iters} launches")
    return total / iters


def bound(n_bytes: float, n_flops: float, flop_rate: float = BF16_FLOP_PER_S):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type (bf16 by default)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in units in the last place between two tensors of
    one float type (same-sign values)."""
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    ne = a != b
    if not bool(ne.any()):
        return 0
    return int((a[ne].view(ints[a.dtype]).long()
                - b[ne].view(ints[b.dtype]).long()).abs().max().item())


# ---------------------------------------------------------------------------
# phase 3: the kernels at full width
# ---------------------------------------------------------------------------
def pool_pages(cfg, m_available: float, page_tokens: int) -> int:
    from repro_torch.core.memory import PagedMemoryEstimator
    from repro_torch.models.registry import get_model
    mem = PagedMemoryEstimator(
        delta_bytes=get_model(cfg).kv_bytes_per_token(),
        m_available=m_available, zeta=0.9, page_tokens=page_tokens,
        bucket=8, kv_retain="request")
    return mem.total_blocks


#: (label, rows, nb) of the paged decode kernels' synthetic shape, the
#: row's own: 8 rows of ~512 tokens, a batch pad last.  A row is (live
#: tokens, on the null page): its own pages drawn from the pool, or a pad
#: row whose block table is all null page 0 (0 live tokens: every slot
#: masked).  nb None is the static engine's bucket of the rows' pages.
#: fused_rope_decode_append takes the same rows, the pad row's one live
#: slot its own append.  Both kernels are also timed at a decode step that
#: the engines themselves ran (``StepRecorder``, phase 10).
PAGED_SMOKE = ("8x576", tuple((n, False) for n in (512, 497, 530, 505, 520,
                                                   489, 515)) + ((0, True),),
               None)
#: page sizes at which both paged decode kernels are also held and timed
#: at ``PAGED_SMOKE``, over pools of the same tokens: 32 (phase 20's,
#: looked up once per 8 slots) and 4 (looked up once per slot)
PAGE_SIZES_TIMED = (32, 4)


def paged_pools(cfg, n_pages: int, pg: int, gen: torch.Generator):
    """Random K and V pools of the slice's size (page 0 the null page)."""
    shape = (n_pages + 1, pg, cfg.n_kv_heads, cfg.head_dim)
    return tuple(torch.randn(shape, generator=gen,
                             device="cuda").to(cfg.dtype) for _ in range(2))


def paged_decode_inputs(cfg, n_pages: int, pg: int, rows, nb,
                        gen: torch.Generator, fused: bool = False):
    """(q, block_table, slot_pos, q_pos) of one paged decode step over
    ``rows`` (``PAGED_SMOKE``): row b holds positions 0..n-1 in pages drawn
    at random from the pool, or on the null page; q_pos = n - 1.  With
    ``fused`` a null row holds at least its own slot, and k_new, v_new
    and the new slots (n - 1) follow."""
    from repro_torch.core.request import bucket_len
    from repro_torch.engine.static_engine import NB_BUCKET
    dev = torch.device("cuda")
    B, Hq, Hkv, D = len(rows), cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n_live = [max(n, 1) if fused and null else n for n, null in rows]
    if nb is None:
        nb = bucket_len(max(-(-n // pg) for n in n_live), NB_BUCKET)
    perm = torch.randperm(n_pages, generator=gen, device=dev) + 1
    bt = torch.zeros((B, nb), dtype=torch.int32, device=dev)
    used = 0
    for b, (n, null) in enumerate(rows):
        if not null:
            k = -(-n // pg)
            bt[b, :k] = perm[used:used + k]
            used += k
    slots = torch.arange(nb * pg, device=dev)[None]
    lens = torch.tensor(n_live, device=dev)[:, None]
    slot_pos = torch.where(slots < lens, slots, -1).to(torch.int32)
    q_pos = (torch.tensor(n_live, device=dev) - 1).clamp(min=0).to(torch.int32)
    q = torch.randn((B, Hq, D), generator=gen, device=dev).to(cfg.dtype)
    if not fused:
        return q, bt, slot_pos, q_pos
    k_new = torch.randn((B, Hkv, D), generator=gen, device=dev).to(cfg.dtype)
    v_new = torch.randn((B, Hkv, D), generator=gen, device=dev).to(cfg.dtype)
    return q, k_new, v_new, bt, slot_pos, q_pos.clone(), q_pos


def appended_rows(bt, slots, pg: int) -> torch.Tensor:
    """Pool rows (page * pg + offset) of each row's appended slot."""
    slots = slots.long()
    return (torch.gather(bt.long(), 1, (slots // pg)[:, None])[:, 0] * pg
            + slots % pg)


def paged_shape(q, k_pages, bt, slot_pos, slots=None) -> dict:
    """The call's shape and the live pool slots it must read: the distinct
    pool rows its live slots name (the null page's slot 0 once, however
    many rows attend it), less, for the fused call (``slots`` given), the
    rows it appends, whose K/V it takes from k/v_new."""
    P, pg, Hkv, D = k_pages.shape
    B, nb = bt.shape
    s = torch.arange(nb * pg, device=bt.device)
    rows = bt.long()[:, s // pg] * pg + s % pg
    live = torch.unique(rows[slot_pos >= 0])
    if slots is not None:
        live = live[~torch.isin(live, appended_rows(bt, slots, pg))]
    return dict(B=B, Hq=q.shape[1], Hkv=Hkv, D=D, pg=pg, nb=nb,
                n_valid_tokens=int(live.numel()),
                null_rows=int((bt == 0).all(dim=1).sum()), pool_pages=P)


def sdpa_window(q, k_pages, v_pages, bt, slot_pos):
    """SDPA over the window gathered beforehand, the G query heads of a KV
    head taken as G queries of that head: a closure and the gathered
    window's inputs."""
    B, Hq, D = q.shape
    pg, Hkv = k_pages.shape[1], k_pages.shape[2]
    nb = bt.shape[1]
    kw = k_pages[bt.long()].reshape(B, nb * pg, Hkv, D).transpose(1, 2)
    vw = v_pages[bt.long()].reshape(B, nb * pg, Hkv, D).transpose(1, 2)
    kw, vw = kw.contiguous(), vw.contiguous()
    mask = (slot_pos >= 0)[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda qq: sdpa(qq.reshape(B, Hkv, Hq // Hkv, D), kw, vw,
                           attn_mask=mask)


def paged_bound(shape: dict, elt: int, fused: bool):
    """(bound_ms, bound_by) of one paged decode call: live K/V slots, q in
    and out, the int32 tables (and for the fused call the new k/v read and
    appended, the slots and the inverse frequencies)."""
    B, Hq, Hkv, D = shape["B"], shape["Hq"], shape["Hkv"], shape["D"]
    n_valid, nb, pg = shape["n_valid_tokens"], shape["nb"], shape["pg"]
    n_bytes = (2 * n_valid * Hkv * D * elt          # live K and V slots
               + 2 * B * Hq * D * elt               # q in, out
               + B * nb * 4 + B * nb * pg * 4 + B * 4)
    if fused:
        n_bytes += 2 * 2 * B * Hkv * D * elt + B * 4 + D // 2 * 4
    n_flops = 4 * n_valid * Hq * D                  # QK^T and PV
    return bound(n_bytes, n_flops)


def time_paged_decode(kmod, k_pages, v_pages, args, flush: torch.Tensor,
                      label: str):
    """(kernel ms, SDPA ms, bound ms, bound_by, shape) of
    paged_decode_attention on these inputs; the library yardstick is SDPA
    over the window gathered beforehand."""
    q, bt, slot_pos, q_pos = args
    sdpa = sdpa_window(q, k_pages, v_pages, bt, slot_pos)
    t_kernel = time_ms(lambda: kmod.paged_decode_attention(
        q, k_pages, v_pages, bt, slot_pos, q_pos), flush,
                       label=f"paged_decode_attention {label} kernel")
    t_lib = time_ms(lambda: sdpa(q), flush,
                    label=f"paged_decode_attention {label} SDPA")
    shape = paged_shape(q, k_pages, bt, slot_pos)
    b_ms, b_by = paged_bound(shape, q.element_size(), fused=False)
    log(f"paged_decode_attention {label}: kernel {t_kernel:.4f} ms, SDPA "
        f"{t_lib:.4f} ms, bound {b_ms:.4f} ms")
    return t_kernel, t_lib, b_ms, b_by, shape


def hold_paged_decode(kmod, k_pages, v_pages, args, flush: torch.Tensor,
                      label: str) -> dict:
    """B1 on ``args`` held against its plain version (rows without a live
    slot also against the mean of their V), then timed beside SDPA: the
    entry of ``shapes``, and the largest error."""
    from repro_torch.kernels import ref
    q, bt, slot_pos, q_pos = args
    G = q.shape[1] // k_pages.shape[2]
    out = kmod.paged_decode_attention(q, k_pages, v_pages, bt, slot_pos,
                                      q_pos)
    want = ref.paged_decode_attention_ref(q, k_pages, v_pages, bt, slot_pos,
                                          q_pos)
    torch.cuda.synchronize()
    e = (out.float() - want.float()).abs().max().item()
    dead = (slot_pos < 0).all(dim=1).nonzero()[:, 0].tolist()
    e_mean = max((out[b].float() - v_pages[bt[b].long()].float().mean(
        dim=(0, 1)).repeat_interleave(G, dim=0)).abs().max().item()
                  for b in dead) if dead else 0.0
    log(f"paged_decode_attention {label}: max |kernel - plain| = {e:.3e}, "
        f"rows without a live slot vs the mean of their V {e_mean:.3e} "
        f"(tolerance {DECODE_TOL})")
    if not (e <= DECODE_TOL and e_mean <= DECODE_TOL):
        raise SystemExit(f"paged_decode_attention {label} disagrees with its "
                         f"plain version")
    del out, want
    t_kernel, t_lib, b_ms, b_by, shape = time_paged_decode(
        kmod, k_pages, v_pages, args, flush, label)
    return dict(shape=label, ms=t_kernel, library_ms=t_lib, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=e, **shape)


def check_decode(cfg, n_pages: int, pg: int, gen: torch.Generator,
                 flush: torch.Tensor) -> dict:
    """B1 at ``PAGED_SMOKE`` held against the plain version (the pad row
    against the mean of its V) and timed beside SDPA and the plain
    version; phase 10 adds the engines' own steps to ``shapes``."""
    from repro_torch.kernels import paged_decode_attention as kmod
    from repro_torch.kernels import ref
    k_pages, v_pages = paged_pools(cfg, n_pages, pg, gen)
    label, rows, nb = PAGED_SMOKE
    args = paged_decode_inputs(cfg, n_pages, pg, rows, nb, gen)
    own = hold_paged_decode(kmod, k_pages, v_pages, args, flush, label)
    t_plain = time_ms(lambda: ref.paged_decode_attention_ref(
        *args[:1], k_pages, v_pages, *args[1:]), flush,
                      label=f"paged_decode_attention {label} plain")
    log(f"paged_decode_attention {label}: plain {t_plain:.4f} ms")
    shape = {k: v for k, v in own.items()
             if k not in ("shape", "ms", "library_ms", "bound_ms",
                          "bound_by", "max_abs_err")}
    del k_pages, v_pages
    shapes = [own]
    for p in PAGE_SIZES_TIMED:
        n = n_pages * pg // p
        pools = paged_pools(cfg, n, p, gen)
        args = paged_decode_inputs(cfg, n, p, rows, nb, gen)
        shapes.append(hold_paged_decode(kmod, *pools, args, flush,
                                        f"{label} pg {p}"))
        del pools, args
    return dict(name="paged_decode_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/paged_decode_attention.cu",
                replaces="src/repro/kernels/paged_decode_attention.py:107",
                max_abs_err=own["max_abs_err"], ms=own["ms"],
                kernel_ms=own["ms"], plain_ms=t_plain,
                bound_ms=own["bound_ms"], bound_by=own["bound_by"],
                library_ms=own["library_ms"],
                library="scaled_dot_product_attention on the pre-gathered "
                "window", shape=shape, shapes=shapes)


#: (label, each row's valid tokens, each row's first position, T) of the
#: write kernels' phase-3 shape: a stage-A prefill batch of left-padded
#: rows of their own lengths, the last a stage-A' tail whose positions
#: start past a 2-page shared prefix (its slots below 32 stay untouched).
#: Both kernels are also timed at the prefill stages that the slices
#: themselves ran (``PrefillRecorder``, phase 12).
WRITE_SMOKE = ("8x512", (512, 497, 480, 505, 460, 489, 300, 512),
               (0,) * 7 + (32,), 512)


def smoke_write_indices(n_pages: int, pg: int, gen: torch.Generator,
                        device: str = "cuda"):
    """(positions, block_table) of ``WRITE_SMOKE``: left-padded rows at
    their first positions, each row's pages drawn at random from a pool of
    ``n_pages`` (page 0 the null page)."""
    _, lengths, starts, T = WRITE_SMOKE
    dev = torch.device(device)
    idx = torch.arange(T, device=dev)[None]
    n = torch.tensor(lengths, device=dev)[:, None]
    start = torch.tensor(starts, device=dev)[:, None]
    positions = torch.where(idx >= T - n, idx - (T - n) + start,
                            -1).to(torch.int32)
    nb = -(-int((n + start).max()) // pg)
    perm = torch.randperm(n_pages, generator=gen, device=dev) + 1
    bt = perm[:len(lengths) * nb].reshape(len(lengths), nb)
    return positions, bt.to(torch.int32).contiguous()


def write_targets(positions: torch.Tensor, bt: torch.Tensor, pg: int):
    """The pool row (page * pg + offset) that each valid token names, in
    the order of ``positions[positions >= 0]``."""
    slot = positions.clamp(min=0).long().clamp(max=bt.shape[1] * pg - 1)
    page = torch.gather(bt.long(), 1, slot // pg)
    return (page * pg + slot % pg)[positions >= 0]


def written_slots(positions: torch.Tensor, bt: torch.Tensor, pg: int,
                  n_pool: int, times: int = 1) -> torch.Tensor:
    """(P, pg) mask of the pool slots that exactly ``times`` valid tokens
    name (``times`` 0: at least one)."""
    count = torch.bincount(write_targets(positions, bt, pg),
                           minlength=n_pool * pg).reshape(n_pool, pg)
    return count > 0 if times == 0 else count == times


def write_bound(positions: torch.Tensor, Hkv: int, D: int, elt: int,
                fused: bool):
    """(bound_ms, bound_by, valid tokens) of one prefill write: each valid
    token's K and V rows read and written once, the positions, one page
    index per valid token (and for the fused write the inverse frequencies
    and the rotation's 3 float32 operations per K value)."""
    n_valid = int((positions >= 0).sum())
    n_bytes = (2 * 2 * n_valid * Hkv * D * elt
               + positions.numel() * 4 + n_valid * 4)
    if not fused:
        return (*bound(n_bytes, 0.0), n_valid)
    return (*bound(n_bytes + D // 2 * 4, 3 * n_valid * Hkv * D,
                   F32_FLOP_PER_S), n_valid)


def empty_launch_ms(flush: torch.Tensor) -> float:
    """An empty kernel (a device sleep of 0 cycles) timed by ``time_ms``:
    the fixed cost of one launch under the method that times the
    kernels."""
    return time_ms(lambda: torch.cuda._sleep(0), flush,
                   label="empty launch")


def hold_write(kmods, cfg, pools, positions: torch.Tensor,
               bt: torch.Tensor, gen: torch.Generator, flush: torch.Tensor,
               label: str, fused: bool) -> dict:
    """One prefill write at (positions, block_table) over random pools,
    random K/V (B, T, Hkv, D) of the model's type: held against its plain
    version (on every slot one token names, paged_prefill_write
    bit-identical, fused_rope_prefill_write V bit-identical and K within
    ``MAX_ULPS``; a slot several tokens name holds one writer's V value in
    every place; every other slot untouched), then timed as in phase 3
    beside the plain version,
    its yardsticks (``index_put_`` of the valid rows at precomputed
    indices; for the fused write torch RoPE + that ``index_put_``, and the
    unfused chain) and its bound.  ``kmods`` are the write kernels'
    modules (paged_prefill_write, fused_rope_prefill_write).  Returns the
    entry."""
    from repro_torch.kernels import ref
    from repro_torch.models.common import apply_rope
    unfused_kmod, fused_kmod = kmods
    k_pool, v_pool = pools
    B, T = positions.shape
    Hkv, D, theta = cfg.n_kv_heads, cfg.head_dim, cfg.rope_theta
    P, pg = k_pool.shape[:2]
    dev = positions.device
    k_new, v_new = (torch.randn((B, T, Hkv, D), generator=gen,
                                device=dev).to(cfg.dtype) for _ in range(2))
    if fused:
        def kernel(ka, va):
            fused_kmod.fused_rope_prefill_write(k_new, v_new, positions, bt,
                                                ka, va, theta=theta)

        def plain(ka, va):
            ref.fused_rope_prefill_write_ref(k_new, v_new, positions, bt,
                                             ka, va, theta=theta)
    else:
        def kernel(ka, va):
            unfused_kmod.paged_prefill_write(k_new, v_new, positions, bt,
                                             ka, va)

        def plain(ka, va):
            ref.paged_prefill_write_ref(k_new, v_new, positions, bt, ka, va)

    k_a, v_a = k_pool.clone(), v_pool.clone()
    kernel(k_a, v_a)
    k_b, v_b = k_pool.clone(), v_pool.clone()
    plain(k_b, v_b)
    torch.cuda.synchronize()
    # a slot that several tokens name (the engine's batch-pad rows all
    # write the null page's first slot, which is never read) holds
    # whichever write lands last, value by value, in the kernel and in the
    # plain version alike: there each value of V must be one writer's
    named = written_slots(positions, bt, pg, P, times=0)
    once = written_slots(positions, bt, pg, P)
    rows = write_targets(positions, bt, pg)
    dup = ~once.reshape(-1)[rows]
    raced, which = torch.unique(rows[dup], return_inverse=True)
    got = v_a.reshape(P * pg, Hkv * D)[rows[dup]]
    hits = torch.zeros((raced.numel(), Hkv * D), dtype=torch.long,
                       device=dev)
    hits.index_add_(0, which, (got == v_new[positions >= 0][dup]
                               .reshape(-1, Hkv * D)).long())
    raced_ok = bool((hits > 0).all())
    v_exact = torch.equal(v_a[once], v_b[once])
    untouched = (torch.equal(k_a[~named], k_pool[~named])
                 and torch.equal(v_a[~named], v_pool[~named]))
    ulps = max_ulps(k_a[once], k_b[once])
    err = max((k_a[once].float() - k_b[once].float()).abs().max().item(),
              (v_a[once].float() - v_b[once].float()).abs().max().item())
    name = "fused_rope_prefill_write" if fused else "paged_prefill_write"
    k_tol = MAX_ULPS if fused else 0
    log(f"{name} {label}: V bit-identical {v_exact}, unwritten slots "
        f"untouched {untouched}, K within {ulps} ulp (max |diff| "
        f"{err:.3e}; tolerance: V exact, K {k_tol} ulp); "
        f"{int((named & ~once).sum())} slots named by several tokens hold "
        f"a writer's V value in every place: {raced_ok}")
    if not (v_exact and untouched and ulps <= k_tol and raced_ok):
        raise SystemExit(f"{name} {label} disagrees with its plain version")
    del k_b, v_b, k_pool, v_pool

    flat = (positions >= 0).reshape(-1).nonzero().squeeze(1)
    page, off = rows // pg, rows % pg
    rope_pos = positions.clamp(min=0)
    k_rows = k_new.reshape(B * T, Hkv, D)[flat]
    v_rows = v_new.reshape(B * T, Hkv, D)[flat]

    def index_put():
        k_a.index_put_((page, off), k_rows)
        v_a.index_put_((page, off), v_rows)

    def rope_index_put():
        kr = apply_rope(k_new, rope_pos, theta).reshape(B * T, Hkv, D)
        k_a.index_put_((page, off), kr[flat])
        v_a.index_put_((page, off), v_rows)

    def unfused_chain():
        kr = apply_rope(k_new, rope_pos, theta)
        unfused_kmod.paged_prefill_write(kr, v_new, positions, bt, k_a, v_a)

    t_kernel = time_ms(lambda: kernel(k_a, v_a), flush,
                       label=f"{name} {label} kernel")
    t_plain = time_ms(lambda: plain(k_a, v_a), flush,
                      label=f"{name} {label} plain")
    b_ms, b_by, n_valid = write_bound(positions, Hkv, D,
                                      k_new.element_size(), fused)
    entry = dict(label=label, ms=t_kernel, plain_ms=t_plain, bound_ms=b_ms,
                 bound_by=b_by, max_abs_err=err,
                 shape=dict(B=B, T=T, Hkv=Hkv, D=D, pg=pg, nb=bt.shape[1],
                            n_valid_tokens=n_valid, pool_pages=P))
    if fused:
        entry.update(max_ulps=ulps, yardsticks_ms={
            "torch apply_rope + index_put_ at precomputed (page, offset) "
            "indices": time_ms(rope_index_put, flush,
                               label=f"{name} {label} yardstick (a)"),
            "unfused chain: torch apply_rope + paged_prefill_write kernel":
                time_ms(unfused_chain, flush,
                        label=f"{name} {label} yardstick (b)")})
    else:
        entry["library_ms"] = time_ms(index_put, flush,
                                      label=f"{name} {label} index_put_")
    log(f"{name} {label}: kernel {t_kernel:.4f} ms, plain {t_plain:.4f} ms, "
        f"yardsticks {entry.get('library_ms', entry.get('yardsticks_ms'))}, "
        f"bound {b_ms:.4f} ms ({b_by}, {n_valid} valid tokens)")
    return entry


def check_write(cfg, n_pages: int, pg: int, gen: torch.Generator,
                flush: torch.Tensor, fused: bool = False) -> dict:
    """Phase 3's row of paged_prefill_write (``fused``:
    fused_rope_prefill_write) at ``WRITE_SMOKE`` over pools of the slice's
    size; phase 12 adds the slices' own prefill stages to ``shapes``."""
    from repro_torch.kernels import fused_rope_prefill_write as fkmod
    from repro_torch.kernels import paged_prefill_write as kmod
    positions, bt = smoke_write_indices(n_pages, pg, gen)
    entry = hold_write((kmod, fkmod), cfg, paged_pools(cfg, n_pages, pg, gen),
                       positions, bt, gen, flush, WRITE_SMOKE[0], fused)
    if fused:
        row = dict(name="fused_rope_prefill_write", route="cuda",
                   source="src/repro_torch/kernels/csrc/"
                          "fused_rope_prefill_write.cu",
                   replaces="src/repro/kernels/fused_rope_prefill_write.py"
                            ":117", library_ms=None)
    else:
        row = dict(name="paged_prefill_write", route="cuda",
                   source="src/repro_torch/kernels/csrc/"
                          "paged_prefill_write.cu",
                   replaces="src/repro/kernels/paged_prefill_write.py:85",
                   library="index_put_ of the valid K and V rows at "
                           "precomputed (page, offset) indices")
    row.update({k: v for k, v in entry.items() if k != "label"},
               kernel_ms=entry["ms"], shapes=[entry])
    return row


def time_fused_decode(kmod, unfused_kmod, k_pages, v_pages, args,
                      theta: float, flush: torch.Tensor, label: str):
    """(kernel ms, yardstick (a) ms, yardstick (b) ms, bound ms, bound_by,
    shape) of fused_rope_decode_append on these inputs (appending into the
    pools).  No single PyTorch call computes it: (a) torch RoPE +
    ``index_put_`` + SDPA over the window gathered beforehand; (b) the
    unfused chain, torch RoPE + scatter + ``unfused_kmod``'s
    paged_decode_attention."""
    from repro_torch.models.common import apply_rope
    q, k_new, v_new, bt, slot_pos, new_slot, q_pos = args
    pg = k_pages.shape[1]
    sdpa = sdpa_window(q, k_pages, v_pages, bt, slot_pos)
    page = torch.gather(bt.long(), 1, (new_slot.long() // pg)[:, None])[:, 0]
    off = new_slot.long() % pg
    pos = q_pos[:, None]

    def rope_put_sdpa():
        qr = apply_rope(q[:, None], pos, theta)[:, 0]
        kr = apply_rope(k_new[:, None], pos, theta)[:, 0]
        k_pages.index_put_((page, off), kr)
        v_pages.index_put_((page, off), v_new)
        return sdpa(qr)

    def unfused_chain():
        qr = apply_rope(q[:, None], pos, theta)[:, 0]
        kr = apply_rope(k_new[:, None], pos, theta)[:, 0]
        k_pages[page, off] = kr
        v_pages[page, off] = v_new
        return unfused_kmod.paged_decode_attention(
            qr.contiguous(), k_pages, v_pages, bt, slot_pos, q_pos)

    t_kernel = time_ms(lambda: kmod.fused_rope_decode_append(
        q, k_new, v_new, bt, slot_pos, new_slot, q_pos, k_pages, v_pages,
        theta=theta), flush,
                       label=f"fused_rope_decode_append {label} kernel")
    t_sdpa = time_ms(rope_put_sdpa, flush,
                     label=f"fused_rope_decode_append {label} yardstick (a)")
    t_chain = time_ms(unfused_chain, flush,
                      label=f"fused_rope_decode_append {label} yardstick (b)")
    shape = paged_shape(q, k_pages, bt, slot_pos, slots=new_slot)
    b_ms, b_by = paged_bound(shape, q.element_size(), fused=True)
    log(f"fused_rope_decode_append {label}: kernel {t_kernel:.4f} ms, torch "
        f"RoPE + index_put_ + SDPA {t_sdpa:.4f} ms, unfused chain "
        f"{t_chain:.4f} ms, bound {b_ms:.4f} ms")
    return t_kernel, t_sdpa, t_chain, b_ms, b_by, shape


def hold_fused_decode(kmod, unfused_kmod, k_pages, v_pages, args,
                      theta: float, flush: torch.Tensor, label: str) -> dict:
    """B4 on ``args``: outputs and pools held against the plain version
    (V bit-identical, K within ``MAX_ULPS``), then timed beside the two
    yardsticks: the entry of ``shapes``, with the largest error and ulps.
    Where several rows append at the null page, which append lands there
    is unspecified: their outputs and page 0 are left out of the
    comparison."""
    from repro_torch.kernels import ref
    q, k_new, v_new, bt, slot_pos, slots, q_pos = args
    pg = k_pages.shape[1]
    k_a, v_a = k_pages.clone(), v_pages.clone()
    out = kmod.fused_rope_decode_append(*args, k_a, v_a, theta=theta)
    want = ref.fused_rope_decode_append_ref(*args, k_pages, v_pages,
                                            theta=theta)
    torch.cuda.synchronize()
    on_null = appended_rows(bt, slots, pg) < pg
    n_null = int(on_null.sum())
    keep = ~on_null if n_null > 1 else torch.ones_like(on_null)
    first = 1 if n_null > 1 else 0   # page 0 where its appends race
    e = (out[keep].float() - want[keep].float()).abs().max().item()
    v_exact = torch.equal(v_a[first:], v_pages[first:])
    ulps = max_ulps(k_a[first:], k_pages[first:])
    log(f"fused_rope_decode_append {label}: max |kernel - plain| = "
        f"{e:.3e} (tolerance {DECODE_TOL}; {int(keep.sum())} of "
        f"{len(keep)} rows); pool V bit-identical {v_exact}, K within "
        f"{ulps} ulp (tolerance {MAX_ULPS})")
    if not (e <= DECODE_TOL and v_exact and ulps <= MAX_ULPS):
        raise SystemExit(f"fused_rope_decode_append {label} disagrees with "
                         f"its plain version")
    del k_a, v_a, out, want
    t_kernel, t_sdpa, t_chain, b_ms, b_by, shape = time_fused_decode(
        kmod, unfused_kmod, k_pages, v_pages, args, theta, flush, label)
    return dict(shape=label, ms=t_kernel, yardstick_a_ms=t_sdpa,
                yardstick_b_ms=t_chain, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=e, max_ulps=ulps, **shape)


def check_fused_decode(cfg, n_pages: int, pg: int, gen: torch.Generator,
                       flush: torch.Tensor) -> dict:
    """B4 at ``PAGED_SMOKE`` held against the plain version and timed
    beside the two yardsticks and the plain version; phase 10 adds the
    engines' own steps to ``shapes``."""
    from repro_torch.kernels import fused_rope_decode_append as kmod
    from repro_torch.kernels import paged_decode_attention as unfused_kmod
    from repro_torch.kernels import ref
    theta = cfg.rope_theta
    k_pages, v_pages = paged_pools(cfg, n_pages, pg, gen)
    label, rows, nb = PAGED_SMOKE
    args = paged_decode_inputs(cfg, n_pages, pg, rows, nb, gen, fused=True)
    own = hold_fused_decode(kmod, unfused_kmod, k_pages, v_pages, args,
                            theta, flush, label)
    t_plain = time_ms(lambda: ref.fused_rope_decode_append_ref(
        *args, k_pages, v_pages, theta=theta), flush,
                      label=f"fused_rope_decode_append {label} plain")
    log(f"fused_rope_decode_append {label}: plain {t_plain:.4f} ms")
    del k_pages, v_pages
    shapes = [own]
    for p in PAGE_SIZES_TIMED:
        n = n_pages * pg // p
        pools = paged_pools(cfg, n, p, gen)
        args = paged_decode_inputs(cfg, n, p, rows, nb, gen, fused=True)
        shapes.append(hold_fused_decode(kmod, unfused_kmod, *pools, args,
                                        theta, flush, f"{label} pg {p}"))
        del pools, args
    shape = {k: v for k, v in own.items()
             if k not in ("shape", "ms", "yardstick_a_ms", "yardstick_b_ms",
                          "bound_ms", "bound_by", "max_abs_err", "max_ulps")}
    return dict(name="fused_rope_decode_append", route="cuda",
                source="src/repro_torch/kernels/csrc/"
                       "fused_rope_decode_append.cu",
                replaces="src/repro/kernels/fused_rope_decode_append.py:158",
                max_abs_err=own["max_abs_err"], max_ulps=own["max_ulps"],
                ms=own["ms"], kernel_ms=own["ms"], plain_ms=t_plain,
                bound_ms=own["bound_ms"], bound_by=own["bound_by"],
                library_ms=None,
                yardsticks_ms={
                    "torch apply_rope + index_put_ + "
                    "scaled_dot_product_attention on the pre-gathered "
                    "window": own["yardstick_a_ms"],
                    "unfused chain: torch apply_rope + scatter + "
                    "paged_decode_attention kernel": own["yardstick_b_ms"]},
                shape=shape, shapes=shapes)


#: flash_prefill's smoke rows: left-padded lengths of 8 rows of 512
PREFILL_LENGTHS = (512, 497, 300, 505, 460, 489, 333, 512)
#: (label, row lengths, T) of flash_prefill's timed shapes, the row's own
#: last: one row of 1280 (an ILS join, and the longest dense re-prefill of
#: the smoke trace: a 1024-token prompt and 256 generated tokens, which
#: the dense slice's ~1.4 rows often prefill alone), then 8 x 512
PREFILL_TIMED = (("1x1280", (1280,), 1280), ("8x512", PREFILL_LENGTHS, 512))
#: (label, (left pads, live tokens) per row, W) of decode_attention's
#: checked and timed shapes, each with an empty last row, the row's own
#: last: the dense SCLS slice (~1.4 rows bucketed to 2, L + 64 slots; the
#: second row a batch pad), the dense ILS engine's 16 slots of 1280 (one
#: free), then 8 rows over 768 slots
DECODE_TIMED = (
    ("2x1344", ((44, 1300), (0, 0)), 1344),
    ("16x1280", tuple((0, n) for n in (1280, 1100, 960, 850, 700, 640, 512,
                                       480, 400, 350, 300, 256, 200, 150,
                                       100, 0)), 1280),
    ("8x768", ((0, 768), (16, 700), (64, 600), (5, 512), (100, 400),
               (0, 333), (200, 520), (0, 0)), 768))


def prefill_inputs(cfg, lengths, T: int, gen: torch.Generator):
    """Left-padded rows of the given lengths: bf16 q, k, v and positions
    (pads -1), as ``models.transformer.make_positions`` builds them."""
    from repro_torch.models.transformer import make_positions
    dev = torch.device("cuda")
    B = len(lengths)
    positions = make_positions(torch.zeros((B, T), dtype=torch.int32,
                                           device=dev),
                               torch.tensor(lengths, device=dev))
    shapes = ((B, T, cfg.n_heads, cfg.head_dim),
              (B, T, cfg.n_kv_heads, cfg.head_dim),
              (B, T, cfg.n_kv_heads, cfg.head_dim))
    q, k, v = (torch.randn(s, generator=gen, device=dev).to(cfg.dtype)
               for s in shapes)
    return q, k, v, positions


def time_prefill(kmod, q, k, v, pos, flush: torch.Tensor, label: str,
                 window=None, prefix_len: int = 0):
    """(kernel ms, SDPA ms, bound ms, bound_by, shape) of flash_prefill on
    these inputs, with ``window`` (none by default) and ``prefix_len`` (a
    bidirectional prefix; 0 by default).  The library yardstick is SDPA
    with the boolean mask (window, prefix and diagonal rule included) over
    K/V expanded to the query heads beforehand."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    pq, pk = pos[:, :, None], pos[:, None, :]
    mask = (pk >= 0) & (pk <= pq)
    if window is not None:
        mask = mask & (pq - pk < window)
    if prefix_len:
        mask = mask | ((pk >= 0) & (pk < prefix_len) & (pq >= 0))
    mask = mask | torch.eye(T, dtype=torch.bool, device=q.device)
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
    vt = v.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t_kernel = time_ms(lambda: kmod.flash_prefill(
        q, k, v, pos, window=window, prefix_len=prefix_len), flush,
        label=f"flash_prefill {label} kernel")
    t_lib = time_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask[:, None]), flush,
                    label=f"flash_prefill {label} SDPA")
    n_pairs = int(mask.sum())                       # (query, key) pairs
    elt = q.element_size()
    n_bytes = (2 * q.numel() * elt                  # q in, out
               + 2 * k.numel() * elt                # k, v
               + pos.numel() * 4)
    n_flops = 4 * n_pairs * Hq * D                  # QK^T and PV
    b_ms, b_by = bound(n_bytes, n_flops)
    log(f"flash_prefill {label}: kernel {t_kernel:.4f} ms, SDPA "
        f"{t_lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
        f"{n_bytes / 1e6:.1f} MB, {n_flops / 1e9:.2f} GFLOP)")
    shape = dict(B=B, T=T, Hq=Hq, Hkv=Hkv, D=D, window=window,
                 prefix_len=prefix_len, valid_tokens=int((pos >= 0).sum()),
                 attended_pairs=n_pairs, gflop=n_flops / 1e9)
    return t_kernel, t_lib, b_ms, b_by, shape


def hold_prefill(cfg, lens, T: int, window, gen: torch.Generator,
                 label: str):
    """B5 on left-padded rows of ``lens`` held against its plain version
    (finite, within ``DECODE_TOL``): (the largest error, the inputs)."""
    from repro_torch.kernels import flash_prefill as kmod
    from repro_torch.kernels import ref
    q, k, v, pos = prefill_inputs(cfg, lens, T, gen)
    out = kmod.flash_prefill(q, k, v, pos, window=window)
    want = ref.flash_prefill_ref(q, k, v, pos, window=window)
    torch.cuda.synchronize()
    e = (out.float() - want.float()).abs().max().item()
    finite = bool(torch.isfinite(out).all())
    log(f"flash_prefill {label}: max |kernel - plain| = {e:.3e} "
        f"(tolerance {DECODE_TOL}), finite {finite}")
    if not (finite and e <= DECODE_TOL):
        raise SystemExit(f"flash_prefill {label} disagrees with its "
                         f"plain version")
    return e, (q, k, v, pos)


def check_flash_prefill(cfg, gen: torch.Generator,
                        flush: torch.Tensor) -> dict:
    """B5 at the dense prefill's shapes: 8 left-padded rows of 512 (300 to
    512 valid), with and without a window, and one row of 1280; timed at
    ``PREFILL_TIMED`` without a window (8 x 512 gives the row's keys, each
    shape an entry of ``shapes``)."""
    from repro_torch.kernels import flash_prefill as kmod
    from repro_torch.kernels import ref
    lengths = PREFILL_LENGTHS
    cases = [("8x512", lengths, 512, None), ("8x512 window 128", lengths,
                                             512, 128),
             ("1x1280", [1280], 1280, None)]
    err = max(hold_prefill(cfg, lens, T, window, gen, label)[0]
              for label, lens, T, window in cases)

    shapes = []
    for label, lens, T in PREFILL_TIMED:
        q, k, v, pos = prefill_inputs(cfg, lens, T, gen)
        t_kernel, t_lib, b_ms, b_by, shape = time_prefill(
            kmod, q, k, v, pos, flush, label)
        shapes.append(dict(shape=label, ms=t_kernel, library_ms=t_lib,
                           bound_ms=b_ms, bound_by=b_by, **shape))
    # the 8 x 512 inputs are the row's own
    t_plain = time_ms(lambda: ref.flash_prefill_ref(q, k, v, pos), flush,
                      iters=10, label="flash_prefill 8x512 plain")
    log(f"flash_prefill 8x512: plain {t_plain:.4f} ms")
    return dict(name="flash_prefill", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_prefill.cu",
                replaces="src/repro/kernels/flash_prefill.py:96",
                max_abs_err=err, ms=t_kernel, kernel_ms=t_kernel,
                plain_ms=t_plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=t_lib, library="scaled_dot_product_attention "
                "with the boolean mask, K/V expanded to the query heads "
                "beforehand", shape=shape, shapes=shapes)


def dense_decode_inputs(cfg, rows, W: int, gen: torch.Generator):
    """q, k_cache, v_cache, slot_pos, q_pos of a dense decode step: row b
    holds positions 0..n-1 behind ``rows[b] = (left pads, n)``; a row with
    n = 0 is empty (every slot masked)."""
    dev = torch.device("cuda")
    B, Hq, Hkv, D = len(rows), cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    slot_pos = torch.full((B, W), -1, dtype=torch.int32, device=dev)
    q_pos = torch.zeros((B,), dtype=torch.int32, device=dev)
    for b, (pad, n) in enumerate(rows):
        slot_pos[b, pad:pad + n] = torch.arange(n, dtype=torch.int32,
                                                device=dev)
        q_pos[b] = max(n - 1, 0)
    q = torch.randn((B, Hq, D), generator=gen, device=dev).to(cfg.dtype)
    k_cache = torch.randn((B, W, Hkv, D), generator=gen,
                          device=dev).to(cfg.dtype)
    v_cache = torch.randn((B, W, Hkv, D), generator=gen,
                          device=dev).to(cfg.dtype)
    return q, k_cache, v_cache, slot_pos, q_pos


def time_dense_decode(kmod, args, flush: torch.Tensor, label: str,
                      window=None):
    """(kernel ms, SDPA ms, bound ms, bound_by, shape) of decode_attention
    on these inputs, with ``window`` (none by default).  The library
    yardstick is SDPA with the boolean slot mask over caches transposed
    beforehand.  The bound counts this step's live slots (a row with none
    weighs every slot alike, so all of its V is read)."""
    from repro_torch.models import attention as attn
    q, k_cache, v_cache, slot_pos, q_pos = args
    B, Hq, D = q.shape
    W, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    kt = k_cache.transpose(1, 2).contiguous()
    vt = v_cache.transpose(1, 2).contiguous()
    qg = q.reshape(B, Hkv, G, D)
    mask = attn.decode_mask(q_pos, slot_pos, window)
    live = mask[:, 0, 0]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t_kernel = time_ms(lambda: kmod.decode_attention(*args, window=window),
                       flush, label=f"decode_attention {label} kernel")
    t_lib = time_ms(lambda: sdpa(qg, kt, vt, attn_mask=mask), flush,
                    label=f"decode_attention {label} SDPA")
    n_live = int(live.sum())
    n_empty = int((live.sum(dim=1) == 0).sum())
    elt = q.element_size()
    row_bytes = Hkv * D * elt
    n_bytes = (2 * n_live * row_bytes               # live K and V slots
               + n_empty * W * row_bytes            # V of the empty rows
               + 2 * q.numel() * elt                # q in, out
               + slot_pos.numel() * 4 + B * 4)
    n_flops = (4 * n_live * Hq * D                  # QK^T and PV; the mean
               + 2 * n_empty * W * Hq * D)
    b_ms, b_by = bound(n_bytes, n_flops)
    log(f"decode_attention {label}: kernel {t_kernel:.4f} ms, SDPA "
        f"{t_lib:.4f} ms, bound {b_ms:.4f} ms")
    shape = dict(B=B, W=W, Hq=Hq, Hkv=Hkv, D=D, window=window,
                 n_live_tokens=n_live, empty_rows=n_empty)
    return t_kernel, t_lib, b_ms, b_by, shape


def hold_dense_decode(args, flush: torch.Tensor, label: str,
                      window=None, empty_row: bool = True) -> dict:
    """B6 on ``args`` (the last row empty where ``empty_row``) with
    ``window`` held against its plain version and the empty row against
    the mean of its V, then timed beside SDPA: the entry of ``shapes``."""
    from repro_torch.kernels import decode_attention as kmod
    from repro_torch.kernels import ref
    q, v_cache = args[0], args[2]
    G = q.shape[1] // v_cache.shape[2]
    out = kmod.decode_attention(*args, window=window)
    want = ref.decode_attention_ref(*args, window=window)
    torch.cuda.synchronize()
    e = (out.float() - want.float()).abs().max().item()
    mean_v = v_cache[-1].float().mean(dim=0).repeat_interleave(G, dim=0)
    e_mean = ((out[-1].float() - mean_v).abs().max().item() if empty_row
              else 0.0)
    log(f"decode_attention {label}: max |kernel - plain| = {e:.3e}, "
        f"empty row vs the mean of its V {e_mean:.3e} (tolerance "
        f"{DECODE_TOL})")
    if not (e <= DECODE_TOL and e_mean <= DECODE_TOL):
        raise SystemExit(f"decode_attention {label} disagrees with its "
                         f"plain version")
    del out, want
    t_kernel, t_lib, b_ms, b_by, shape = time_dense_decode(
        kmod, args, flush, label, window)
    return dict(shape=label, ms=t_kernel, library_ms=t_lib, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=e, **shape)


def check_dense_decode(cfg, gen: torch.Generator,
                       flush: torch.Tensor) -> dict:
    """B6 at the dense decode's shapes ``DECODE_TIMED``: rows at different
    positions behind left pads, one row fully masked, each shape held
    against the plain version and timed against SDPA (``shapes``; 8 x 768
    gives the row's own numbers)."""
    from repro_torch.kernels import ref
    shapes = []
    for label, rows, W in DECODE_TIMED:
        args = dense_decode_inputs(cfg, rows, W, gen)
        shapes.append(hold_dense_decode(args, flush, label))
    err = max(e["max_abs_err"] for e in shapes)
    t_kernel, t_lib, b_ms, b_by = (shapes[-1][k] for k in (
        "ms", "library_ms", "bound_ms", "bound_by"))
    shape = {k: v for k, v in shapes[-1].items()
             if k not in ("shape", "ms", "library_ms", "bound_ms", "bound_by",
                          "max_abs_err")}
    t_plain = time_ms(lambda: ref.decode_attention_ref(*args), flush,
                      label="decode_attention 8x768 plain")
    log(f"decode_attention 8x768: plain {t_plain:.4f} ms")
    return dict(name="decode_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/decode_attention.cu",
                replaces="src/repro/kernels/decode_attention.py:81",
                max_abs_err=err, ms=t_kernel, kernel_ms=t_kernel,
                plain_ms=t_plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=t_lib, library="scaled_dot_product_attention "
                "with the boolean slot mask, caches transposed beforehand",
                shape=shape, shapes=shapes)


def ssd_inputs(cfg, lengths, T: int, gen: torch.Generator, G=None):
    """The scan's float32 inputs for left-padded rows of the given lengths,
    as ``models.mamba2.mixer_forward`` hands them over: x, B, C normal,
    dt = softplus(normal) on real tokens and 0 on pads, A = -exp(0.5 z)
    per head (so that heads differ)."""
    dev = torch.device("cuda")
    B, H, P, N = len(lengths), cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state
    G = G or cfg.ssm_n_groups
    valid = (torch.arange(T, device=dev)[None]
             >= T - torch.tensor(lengths, device=dev)[:, None])
    x = torch.randn((B, T, H, P), generator=gen, device=dev)
    dt = torch.nn.functional.softplus(
        torch.randn((B, T, H), generator=gen, device=dev)) * valid[..., None]
    A = -torch.exp(0.5 * torch.randn((H,), generator=gen, device=dev))
    Bm = torch.randn((B, T, G, N), generator=gen, device=dev)
    Cm = torch.randn((B, T, G, N), generator=gen, device=dev)
    return x, dt, A, Bm, Cm


def scan_error(kmod, ref, args, chunk: int):
    """(max |kernel - plain|, the same relative to the plain version's
    largest |value|), the larger of y's and the state's; inf where the
    kernel is not finite."""
    y, st = kmod.ssd_scan(*args, chunk)
    y_ref, st_ref = ref.ssd_scan_ref(*args, chunk)
    torch.cuda.synchronize()
    if not (bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())):
        return float("inf"), float("inf")
    errs = [(a - b).abs().max().item() for a, b in ((y, y_ref), (st, st_ref))]
    scales = [b.abs().max().item() for b in (y_ref, st_ref)]
    return max(errs), max(e / m for e, m in zip(errs, scales))


#: (label, row lengths, T) of phase 3's B7 case: 8 left-padded rows of 512
SSD_SMOKE = ("8x512", [512, 497, 300, 505, 460, 489, 333, 512], 512)
#: B7's products: 3xTF32 on the tensor cores, three TF32 products per
#: multiply-add
SSD_ROUTE = ("3xTF32 on the tensor cores: 3 TF32 products per multiply-add "
             "at 495 TFLOP/s")


def ssd_bound(x, Bm, Q: int):
    """(bound_ms, bound_by, bytes, GFLOP) of one ssd_scan call on x
    (B,T,H,P) and B (B,T,G,N): x, y, dt, A, B, C and the final state moved
    once; C·B once per group over the causal pairs, scores·x, the state
    update, and C·state in every chunk but a row's first (its entering
    state is zero); each multiply-add three TF32 products (``SSD_ROUTE``)."""
    B, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc = T // Q
    n_bytes = 4 * (2 * x.numel() + B * T * H + H + 2 * Bm.numel()
                   + B * H * P * N)
    tri = Q * (Q + 1) // 2                          # causal (t, s) pairs
    macs = (B * nc * (G * tri * N                   # C.B per group
                      + H * (tri * P                # scores . x
                             + Q * N * P))          # state update
            + B * (nc - 1) * H * Q * N * P)         # C.state, zero at chunk 0
    b_ms, b_by = bound(n_bytes, 3 * 2 * macs, TF32_FLOP_PER_S)
    return b_ms, b_by, n_bytes, 2 * macs / 1e9


def hold_ssd_scan(cfg, lengths, T: int, gen: torch.Generator,
                  flush: torch.Tensor, label: str, G=None) -> dict:
    """B7 on left-padded rows of ``lengths`` (T tokens each): held against
    its plain version within ``SSD_TOL`` (finite), then timed beside it;
    the entry of a ``shapes`` list."""
    import math
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as kmod
    Q = cfg.ssm_chunk
    args = ssd_inputs(cfg, lengths, T, gen, G=G)
    err, rel = scan_error(kmod, ref, args, Q)
    x, dt, A, Bm, _ = args
    B, _, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    log(f"ssd_scan {label} G={G}: max |kernel - plain| = {err:.3e}, relative "
        f"to max |plain| {rel:.3e} (tolerance {SSD_TOL})")
    if not rel <= SSD_TOL:
        raise SystemExit(f"ssd_scan ({label}, G={G}) disagrees with its "
                         f"plain version")
    nc = T // Q
    overflow = int(((dt * -A).reshape(B, nc, Q, H).sum(2)
                    > math.log(torch.finfo(torch.float32).max)).sum())
    t_kernel = time_ms(lambda: kmod.ssd_scan(*args, Q), flush,
                       label=f"ssd_scan {label}")
    t_plain = time_ms(lambda: ref.ssd_scan_ref(*args, Q), flush, iters=10,
                      label=f"ssd_scan plain {label}")
    b_ms, b_by, n_bytes, gflop = ssd_bound(x, Bm, Q)
    log(f"ssd_scan {label}: kernel {t_kernel:.4f} ms, plain {t_plain:.4f} "
        f"ms, bound {b_ms:.4f} ms ({b_by}; {n_bytes / 1e6:.1f} MB, "
        f"{gflop:.2f} GFLOP at 3xTF32); {overflow} of {B * nc * H} "
        f"(row, chunk, head) sums of dt*|A| pass ln(float32 max)")
    return dict(label=label, ms=t_kernel, plain_ms=t_plain, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=err, max_rel_err=rel,
                B=B, T=T, H=H, P=P, N=N, G=G, Q=Q, lengths=list(lengths),
                valid_tokens=sum(lengths), gflop=gflop,
                oracle_overflow_chunks=overflow)


def check_ssd_scan(gen: torch.Generator, flush: torch.Tensor) -> dict:
    """B7 at the Mamba-2 prefill's shapes: 8 left-padded rows of 512 tokens
    (4 chunks of 128; 300 to 512 valid), mamba2-130m's 24 heads of P 64,
    N 128, one group, float32; also with two groups.  Most of these chunks
    sum dt·|A| past ln(float32 max), where the JAX oracle gives NaN (C2).
    Phase 11 adds the Mamba-2 slice's own prefill stages to ``shapes``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as kmod
    cfg = get_config("mamba2-130m")
    label, lengths, T = SSD_SMOKE
    args = ssd_inputs(cfg, lengths, T, gen, G=2)
    err2, rel2 = scan_error(kmod, ref, args, cfg.ssm_chunk)
    log(f"ssd_scan {label} G=2: max |kernel - plain| = {err2:.3e}, relative "
        f"to max |plain| {rel2:.3e} (tolerance {SSD_TOL})")
    if not rel2 <= SSD_TOL:
        raise SystemExit("ssd_scan (G=2) disagrees with its plain version")
    del args
    entry = hold_ssd_scan(cfg, lengths, T, gen, flush, label)
    return dict(name="ssd_scan", route="cuda",
                source="src/repro_torch/kernels/csrc/ssd_scan.cu",
                replaces="src/repro/kernels/ssd_scan.py:89",
                max_abs_err=max(err2, entry["max_abs_err"]),
                max_rel_err=max(rel2, entry["max_rel_err"]),
                ms=entry["ms"], kernel_ms=entry["ms"],
                plain_ms=entry["plain_ms"], bound_ms=entry["bound_ms"],
                bound_by=entry["bound_by"], bound_route=SSD_ROUTE,
                library_ms=None,
                library="none: no single PyTorch call computes the SSD scan",
                shape=entry, shapes=[entry])


#: the decode loop's condition kernel at the main path's shapes: rows of
#: the dense slice's batch bucket and its slice length; and the steps of
#: the loop whose per-step cost phase 3 times (a body of one add)
LOOP_ROWS, LOOP_LIMIT, LOOP_TIMED_STEPS = 8, 32, 1024


def check_graph_loop(flush: torch.Tensor) -> dict:
    """The decode loop's condition kernel (``graph_loop``; no Pallas
    kernel's port: the ``lax.while_loop``'s cond of the JAX engines'
    ``_serve_fn``): its predicate launched alone held against
    ``graph_loop_ref`` over steps below, at and past the limit and done
    flags none, all and all but one (rows 1 to 300), then timed at
    ``LOOP_ROWS`` rows beside its plain version; and the cost it adds per
    step inside a replay: a ``graphs.Loop`` whose body is one add, run for
    ``LOOP_TIMED_STEPS`` steps in one replay, beside the same body
    replayed as a one-step graph with the host's test between steps (the
    port's loop before the WHILE node)."""
    from repro_torch.engine import graphs
    from repro_torch.kernels import graph_loop as kmod
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    wrong = 0
    for B in (1, 8, 64, 300):
        for s_ in (0, LOOP_LIMIT - 1, LOOP_LIMIT, LOOP_LIMIT + 1):
            for live in (None, 0, B - 1, "all"):
                done = torch.ones(B, dtype=torch.bool, device=dev)
                if live == "all":
                    done.zero_()
                elif live is not None:
                    done[live] = False
                step = torch.tensor(s_, dtype=torch.int64, device=dev)
                got = kmod.graph_loop(step, done, LOOP_LIMIT)
                want = ref.graph_loop_ref(step, done, LOOP_LIMIT)
                wrong += int(got.item() != want.item())
    log(f"graph_loop: {wrong} of 64 conditions differ from the plain "
        f"version")
    if wrong:
        raise SystemExit("graph_loop disagrees with its plain version")
    step = torch.zeros((), dtype=torch.int64, device=dev)
    done = torch.zeros(LOOP_ROWS, dtype=torch.bool, device=dev)
    t_kernel = time_ms(lambda: kmod.graph_loop(step, done, LOOP_LIMIT),
                       flush, label="graph_loop kernel")
    t_plain = time_ms(lambda: ref.graph_loop_ref(step, done, LOOP_LIMIT),
                      flush, label="graph_loop plain")
    b_ms, b_by = bound(8 + LOOP_ROWS + 4, LOOP_ROWS)
    # the loop's cost per step: one replay of LOOP_TIMED_STEPS steps
    cache = graphs.GraphCache(dev)
    bufs = dict(step=step, done=done, out=torch.zeros(1, device=dev),
                cur=torch.zeros(1, device=dev))

    def body() -> None:
        bufs["out"].add_(1.0)
        step.add_(1)

    with torch.no_grad():
        loop = cache.add_loop("loop", body, bufs, LOOP_TIMED_STEPS)
        loop()  # warm-up and capture
        single = cache.add("step", body, bufs)
        step.zero_()
        single()  # warm-up and capture
    n = LOOP_TIMED_STEPS

    def by_loop() -> None:
        step.zero_()
        loop.graph.replay()

    def by_host() -> None:
        step.zero_()
        while bool(ref.graph_loop_ref(step, done, n)):
            single.graph.replay()

    t_loop = time_ms(by_loop, flush, iters=5, label="graph_loop loop") / n
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        by_host()
    torch.cuda.synchronize()
    t_host = (time.perf_counter() - t0) / 3 / n * 1e3
    if int(step) != n or float(bufs["out"]) <= 0:
        raise SystemExit(f"graph_loop: the timed loop ran {int(step)} of "
                         f"{n} steps")
    log(f"graph_loop {LOOP_ROWS} rows: kernel {t_kernel:.4f} ms, plain "
        f"{t_plain:.4f} ms, bound {b_ms:.2e} ms; a step of a one-add body "
        f"{t_loop * 1e3:.2f} us in the WHILE loop, {t_host * 1e3:.2f} us "
        f"replayed a step at a time with the host's test")
    return dict(name="graph_loop", route="cuda",
                source="src/repro_torch/kernels/csrc/graph_loop.cu",
                replaces="src/repro/engine/static_engine.py:177",
                replaces_note="not a Pallas kernel: the lax.while_loop "
                "cond of the JAX engines' _serve_fn, (step < slice_len) & "
                "~all(done)",
                max_abs_err=float(wrong), ms=t_kernel, kernel_ms=t_kernel,
                plain_ms=t_plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, loop_step_ms=t_loop,
                host_step_ms=t_host,
                shape=dict(B=LOOP_ROWS, limit=LOOP_LIMIT,
                           loop_steps_timed=n))


#: the KV budget of phases 13-15 (bytes; the paged slices' page pool),
#: which also sizes phase 3's pools at the other configs' heads
CONFIG_M_AVAILABLE = 40e9
#: (arch, kernels) of phase 3 at the other dense configs' heads: the
#: kernels of each config's slice (phases 13-15) at its heads, and at
#: gemma-2b's (head_dim 256) every attention kernel and both writes
CONFIG_HEADS = (
    ("codeqwen1.5-7b", ("flash_prefill", "paged_decode_attention",
                        "paged_prefill_write")),
    ("minitron-4b", ("fused_rope_decode_append", "fused_rope_prefill_write")),
    ("gemma-2b", ("flash_prefill", "decode_attention",
                  "paged_decode_attention", "fused_rope_decode_append",
                  "paged_prefill_write", "fused_rope_prefill_write")))


def check_config_heads(arch: str, names, rows: dict,
                       flush: torch.Tensor) -> None:
    """Phase 3 at ``arch``'s heads (bf16, 16-token pages over pools of the
    size ``CONFIG_M_AVAILABLE`` holds): of the kernels in ``names``,
    flash_prefill at 8 x 512 and 1 x 1280, decode_attention at 8 x 768,
    paged_decode_attention and fused_rope_decode_append at 8 x 576, the two
    prefill writes at 8 x 512, each held against its plain version and
    timed beside its yardsticks with its bound, as at llama3.2-1b's heads.
    The entries go to the rows' ``shapes``, labelled "<arch> heads", and
    each row's ``max_abs_err`` covers them."""
    from repro_torch.configs import get_config
    check_heads(get_config(arch), f"{arch} heads", names, rows, flush)


def check_heads(cfg, tag: str, names, rows: dict, flush: torch.Tensor,
                prefill_timed=PREFILL_TIMED,
                dense_timed=DECODE_TIMED[-1]) -> None:
    """``check_config_heads`` at ``cfg``'s heads: flash_prefill at
    ``prefill_timed``, decode_attention at ``dense_timed``, the paged
    decode kernels at ``PAGED_SMOKE`` and the writes at ``WRITE_SMOKE``,
    those of ``names``, each entry labelled "<tag> <shape>"."""
    from repro_torch.kernels import flash_prefill as pkmod
    from repro_torch.kernels import fused_rope_decode_append as fkmod
    from repro_torch.kernels import fused_rope_prefill_write as fwkmod
    from repro_torch.kernels import paged_decode_attention as ukmod
    from repro_torch.kernels import paged_prefill_write as wkmod
    pg = 16
    n_pages = pool_pages(cfg, CONFIG_M_AVAILABLE, pg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)

    def add(name: str, entry: dict) -> None:
        rows[name]["shapes"].append(entry)
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                        entry["max_abs_err"])
        if "max_ulps" in entry:
            rows[name]["max_ulps"] = max(rows[name]["max_ulps"],
                                         entry["max_ulps"])

    if "flash_prefill" in names:
        for label, lens, T in prefill_timed:
            label = f"{tag} {label}"
            e, (q, k, v, pos) = hold_prefill(cfg, lens, T, None, gen, label)
            t_kernel, t_lib, b_ms, b_by, shape = time_prefill(
                pkmod, q, k, v, pos, flush, label)
            add("flash_prefill", dict(shape=label, ms=t_kernel,
                                      library_ms=t_lib, bound_ms=b_ms,
                                      bound_by=b_by, max_abs_err=e, **shape))
            del q, k, v, pos
    if "decode_attention" in names:
        label, drows, W = dense_timed
        add("decode_attention", hold_dense_decode(
            dense_decode_inputs(cfg, drows, W, gen), flush,
            f"{tag} {label}"))
    release_cuda()

    label, prows, nb = PAGED_SMOKE
    if "paged_decode_attention" in names or \
            "fused_rope_decode_append" in names:
        k_pages, v_pages = paged_pools(cfg, n_pages, pg, gen)
        if "paged_decode_attention" in names:
            args = paged_decode_inputs(cfg, n_pages, pg, prows, nb, gen)
            add("paged_decode_attention", hold_paged_decode(
                ukmod, k_pages, v_pages, args, flush, f"{tag} {label}"))
        if "fused_rope_decode_append" in names:
            args = paged_decode_inputs(cfg, n_pages, pg, prows, nb, gen,
                                       fused=True)
            add("fused_rope_decode_append", hold_fused_decode(
                fkmod, ukmod, k_pages, v_pages, args, cfg.rope_theta, flush,
                f"{tag} {label}"))
        del k_pages, v_pages, args
        release_cuda()

    positions, bt = smoke_write_indices(n_pages, pg, gen)
    for fused, name in ((False, "paged_prefill_write"),
                        (True, "fused_rope_prefill_write")):
        if name in names:
            add(name, hold_write((wkmod, fwkmod), cfg,
                                 paged_pools(cfg, n_pages, pg, gen),
                                 positions, bt, gen, flush,
                                 f"{tag} {WRITE_SMOKE[0]}", fused))
            release_cuda()


#: phase 3 at the windowed configs' heads: recurrentgemma-9b (MQA 16/1,
#: head_dim 256, local window 2048; B6 at group 16) and mixtral-8x22b (GQA
#: 48/8, head_dim 128, sliding window 4096)
WINDOW_HEADS = ("recurrentgemma-9b", "mixtral-8x22b")
#: rows of phase 3's ring decode step: three rows whose ring of one window
#: has wrapped (each row's newest position past the window), one empty
RING_ROWS = 4


def attn_window(cfg):
    """The window of a config's attention: the hybrid's local window, or
    the sliding window (None: full causal)."""
    return cfg.local_window if cfg.family == "hybrid" else cfg.sliding_window


def ring_decode_inputs(cfg, n_rows: int, W: int, gen: torch.Generator):
    """q, k_cache, v_cache, slot_pos, q_pos of a decode step over rings of
    W slots, as a windowed model's dense cache holds them once it has
    wrapped: row b's newest position is P = W + 57 + 300 b, and position p
    in (P - W, P] sits at slot p % W (so slot_pos is out of index order);
    the last row is empty (every slot masked)."""
    dev = torch.device("cuda")
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    slot_pos = torch.full((n_rows, W), -1, dtype=torch.int32, device=dev)
    q_pos = torch.zeros((n_rows,), dtype=torch.int32, device=dev)
    for b in range(n_rows - 1):
        P = W + 57 + 300 * b
        p = torch.arange(P - W + 1, P + 1, dtype=torch.int32, device=dev)
        slot_pos[b, p % W] = p
        q_pos[b] = P
    q = torch.randn((n_rows, Hq, D), generator=gen, device=dev).to(cfg.dtype)
    k_cache, v_cache = (torch.randn((n_rows, W, Hkv, D), generator=gen,
                                    device=dev).to(cfg.dtype)
                        for _ in range(2))
    return q, k_cache, v_cache, slot_pos, q_pos


def check_window_heads(arch: str, rows: dict, flush: torch.Tensor) -> None:
    """Phase 3 at ``arch``'s heads with its window (bf16): flash_prefill on
    one row of window + 256 tokens (the window bites), decode_attention
    over ``RING_ROWS`` rings of one window each (wrapped, one row empty),
    each held against its plain version within ``DECODE_TOL`` and timed
    beside SDPA under the same mask, with its bound.  The entries go to
    the rows' ``shapes``, labelled "<arch> heads"."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_prefill as pkmod
    cfg = get_config(arch)
    window = attn_window(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    T = window + 256
    label = f"{arch} heads 1x{T} window {window}"
    e, (q, k, v, pos) = hold_prefill(cfg, [T], T, window, gen, label)
    t_kernel, t_lib, b_ms, b_by, shape = time_prefill(
        pkmod, q, k, v, pos, flush, label, window)
    entry = dict(shape=label, ms=t_kernel, library_ms=t_lib, bound_ms=b_ms,
                 bound_by=b_by, max_abs_err=e, **shape)
    del q, k, v, pos
    release_cuda()
    label = f"{arch} heads {RING_ROWS}x{window} ring window {window}"
    entries = {"flash_prefill": entry, "decode_attention": hold_dense_decode(
        ring_decode_inputs(cfg, RING_ROWS, window, gen), flush, label,
        window)}
    for name, entry in entries.items():
        rows[name]["shapes"].append(entry)
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                        entry["max_abs_err"])
    release_cuda()


#: phase 3 at the frontend families' heads (bf16): paligemma-3b's B5 over
#: its prefix of 256 patches before 128 text slots, 8 rows whose text
#: lengths these are (left-padded: the pads sit between prefix and text);
#: seamless-m4t-large-v2's B5 as its encoder and its B6 as cross-attention
#: over 8 rows of 1024 frames whose valid counts these are (the rest
#: invalid, right-padded)
FRONTEND_TEXT = (128, 97, 64, 120, 33, 80, 16, 101)
FRONTEND_FRAMES = (1024, 1000, 900, 777, 640, 512, 400, 256)


def prefix_prefill_inputs(cfg, lens, T: int, gen: torch.Generator):
    """bf16 q, k, v and positions of a VLM prefill: the prefix of
    ``cfg.n_prefix_tokens`` at positions 0..P-1, then each row's left pads
    and ``lens[b]`` text tokens at P.., as ``transformer.prefill`` lays
    them out."""
    from repro_torch.models.transformer import make_positions
    dev = torch.device("cuda")
    B, P = len(lens), cfg.n_prefix_tokens
    text = make_positions(torch.zeros((B, T), dtype=torch.int32, device=dev),
                          torch.tensor(lens, device=dev))
    prefix = torch.arange(P, dtype=torch.int32, device=dev)[None].expand(B, P)
    positions = torch.cat([prefix, torch.where(text >= 0, text + P, -1)],
                          dim=1).to(torch.int32)
    N = P + T
    q, k, v = (torch.randn(sh, generator=gen, device=dev).to(cfg.dtype)
               for sh in ((B, N, cfg.n_heads, cfg.head_dim),
                          (B, N, cfg.n_kv_heads, cfg.head_dim),
                          (B, N, cfg.n_kv_heads, cfg.head_dim)))
    return q, k, v, positions


def frame_valid(frames, S: int) -> torch.Tensor:
    """(B, S) bool on the card: row b's first ``frames[b]`` frames valid."""
    dev = torch.device("cuda")
    return (torch.arange(S, device=dev)[None]
            < torch.tensor(frames, device=dev)[:, None])


def encoder_inputs(cfg, frames, S: int, gen: torch.Generator):
    """bf16 q, k, v of the encoder's self-attention over S frames and its
    masking positions ``where(valid, arange, -1)`` (``encdec.encode``)."""
    valid = frame_valid(frames, S)
    pos = torch.where(valid, torch.arange(S, device=valid.device)[None],
                      -1).to(torch.int32)
    B = len(frames)
    q, k, v = (torch.randn((B, S, h, cfg.head_dim), generator=gen,
                           device=valid.device).to(cfg.dtype)
               for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    return q, k, v, pos


def hold_prefix_prefill(args, prefix_len: int, flush: torch.Tensor,
                        label: str) -> dict:
    """B5 with ``prefix_len`` on ``args`` (q, k, v, positions) held against
    its plain version (finite, within ``DECODE_TOL``), then timed beside
    SDPA under the same boolean mask and beside its plain version, with
    its bound: the entry of ``shapes``."""
    from repro_torch.kernels import flash_prefill as kmod
    from repro_torch.kernels import ref
    out = kmod.flash_prefill(*args, prefix_len=prefix_len)
    want = ref.flash_prefill_ref(*args, prefix_len=prefix_len)
    torch.cuda.synchronize()
    e = (out.float() - want.float()).abs().max().item()
    finite = bool(torch.isfinite(out).all())
    log(f"flash_prefill {label}: max |kernel - plain| = {e:.3e} "
        f"(tolerance {DECODE_TOL}), finite {finite}")
    if not (finite and e <= DECODE_TOL):
        raise SystemExit(f"flash_prefill {label} disagrees with its "
                         f"plain version")
    del out, want
    t_kernel, t_lib, b_ms, b_by, shape = time_prefill(
        kmod, *args, flush, label, prefix_len=prefix_len)
    t_plain = time_ms(lambda: ref.flash_prefill_ref(
        *args, prefix_len=prefix_len), flush, iters=10,
        label=f"flash_prefill {label} plain")
    log(f"flash_prefill {label}: plain {t_plain:.4f} ms")
    return dict(shape=label, ms=t_kernel, library_ms=t_lib,
                plain_ms=t_plain, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=e, **shape)


def check_frontend_heads(rows: dict, flush: torch.Tensor) -> None:
    """Phase 3 at the frontend families' heads (bf16): flash_prefill with
    paligemma-3b's prefix of 256 before 128 text slots (8 x 384, MQA 8/1,
    head_dim 256), and as seamless-m4t-large-v2's encoder (8 x 1024 frames
    of ``FRONTEND_FRAMES`` valid, 16/16, head_dim 64, prefix_len 1024);
    decode_attention as seamless's cross-attention over those frames
    (slot_pos 0 / -1, q_pos 0; no row empty).  Each held against its
    plain version within ``DECODE_TOL`` and timed beside SDPA under the
    same mask and beside its plain version, with its bound; the entries go
    to the rows' ``shapes``, labelled "<arch> heads"."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.models import attention as attn
    vlm, ed = get_config("paligemma-3b"), get_config("seamless-m4t-large-v2")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    P, T = vlm.n_prefix_tokens, max(FRONTEND_TEXT)
    S = max(FRONTEND_FRAMES)
    entries = [("flash_prefill", hold_prefix_prefill(
        prefix_prefill_inputs(vlm, FRONTEND_TEXT, T, gen), P, flush,
        f"paligemma-3b heads 8x{P + T} prefix {P}"))]
    release_cuda()
    entries.append(("flash_prefill", hold_prefix_prefill(
        encoder_inputs(ed, FRONTEND_FRAMES, S, gen), S, flush,
        f"seamless-m4t-large-v2 heads 8x{S} encoder")))
    release_cuda()
    valid = frame_valid(FRONTEND_FRAMES, S)
    B = len(FRONTEND_FRAMES)
    args = (torch.randn((B, ed.n_heads, ed.head_dim), generator=gen,
                        device="cuda").to(ed.dtype),
            *(torch.randn((B, S, ed.n_kv_heads, ed.head_dim), generator=gen,
                          device="cuda").to(ed.dtype) for _ in range(2)),
            attn.cross_slot_pos(valid),
            torch.zeros((B,), dtype=torch.int32, device="cuda"))
    label = f"seamless-m4t-large-v2 heads 8x{S} cross-attention"
    entry = hold_dense_decode(args, flush, label, empty_row=False)
    entry["plain_ms"] = time_ms(lambda: ref.decode_attention_ref(*args),
                                flush, label=f"decode_attention {label} "
                                f"plain")
    entries.append(("decode_attention", entry))
    for name, entry in entries:
        rows[name]["shapes"].append(entry)
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                        entry["max_abs_err"])
    del args
    release_cuda()


# ---------------------------------------------------------------------------
# phase 4: each slice's served path against the plain forward, small input
# ---------------------------------------------------------------------------
def cache_slot(cache, b: int, p: int, pad: int):
    """(k, v) views, every layer, of row ``b``'s position ``p`` in a paged
    cache (slot = position) or a dense one (left layout: ``pad`` slots of
    the row's left padding first)."""
    from repro_torch.kvcache import PagedKVCache
    if isinstance(cache, PagedKVCache):
        pg = cache.k_pages.shape[2]
        page = int(cache.block_table[b, p // pg])
        return cache.k_pages[:, page, p % pg], cache.v_pages[:, page, p % pg]
    return cache.k[:, b, pad + p], cache.v[:, b, pad + p]


def left_padded(cfg, lens, dev) -> tuple:
    """(tokens (B, max(lens)), lengths (B,)) on ``dev``: rows of random
    tokens from a seed, left-padded with zeros to the longest."""
    import numpy as np
    rng = np.random.default_rng(1)
    T = max(lens)
    toks = np.zeros((len(lens), T), np.int32)
    for b, n in enumerate(lens):
        toks[b, T - n:] = rng.integers(2, cfg.vocab_size, size=n)
    return (torch.from_numpy(toks).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


@contextlib.contextmanager
def zeroed(tensors):
    """Inside ``with``, ``tensors`` hold zeros; their values after."""
    kept = [t.clone() for t in tensors]
    for t in tensors:
        t.zero_()
    try:
        yield
    finally:
        for t, k in zip(tensors, kept):
            t.copy_(k)


def hold_logits(label: str, served: list, refs: list, serve, faults: dict,
                tol: float, what: str) -> dict:
    """Phase 4's gate for every served path: ``served``, each step's
    last-token logits (B, vocab), within ``tol`` of ``refs`` relative to
    the reference's largest |logit|.  Then ``serve(cache_fault)`` runs once
    per control fault of ``faults`` (name: (context, cache_fault): the
    context held around the serve, ``cache_fault`` applied to the cache
    after the prefill, or None), and each must move the logits past
    ``tol``.  Their readings go to the returned ``controls`` beside
    ``tolerance``; ``main`` fails the run if one is within it."""
    def gaps(out) -> list:
        for step, (x, r) in enumerate(zip(out, refs)):
            if not (bool(torch.isfinite(x).all()) and x.shape == r.shape):
                raise SystemExit(f"{label}: served logits of step {step} "
                                 f"not finite or not (B, vocab)")
        return [(x.float() - r).abs().max().item() / r.abs().max().item()
                for x, r in zip(out, refs)]

    with torch.no_grad():
        worst = gaps(served)
        controls = {}
        for name, (context, cache_fault) in faults.items():
            with context:
                controls[name] = max(gaps(serve(cache_fault)))
        torch.cuda.synchronize()
    log(f"{label}: served logits vs the plain forward over {what}, max "
        f"relative difference {max(worst):.3e} (per step "
        f"{[f'{w:.2e}' for w in worst]}; tolerance {tol}); control faults "
        f"{ {k: f'{v:.3e}' for k, v in controls.items()} } (each must "
        f"exceed {tol})")
    if max(worst) > tol:
        raise SystemExit(f"{label}: the served path disagrees with the "
                         f"plain forward")
    return dict(max_rel_logit_diff=max(worst), rel_logit_diff_by_step=worst,
                controls=controls, tolerance=tol)


def check_served_logits(model, params, path: str, pg: int) -> dict:
    """Phase 4: one prefill of 4 left-padded prompts and 4 greedy decode
    steps through ``path``'s serving functions (the kernels): the dense
    ``prefill`` / ``decode_step``, or ``prefill_paged`` /
    ``decode_step_paged`` with ``attn_impl=path``.  After each, the
    last-token logits are held against ``transformer.forward`` of the same
    tokens on the card (plain torch attention under the causal left-pad
    mask, no kernel and no cache), to ``REF_TOL`` of the reference's
    largest |logit|: the paths round to bf16 in other places (the kernels
    keep each weight as a bf16 pair, the plain attention rounds P to bf16
    once; the layers' outputs are rounded after sums in another order),
    which moved the logits of these random models by 0.90e-2 (gemma-2b)
    to 1.85e-2 (minitron-4b) of their largest value on the H100, while
    the weakest control fault below moved them by 6.98e-2: the tolerance
    sits about 2x from each.  The QKV biases, where the config has them
    (zero at init, as JAX's ``dense_param`` makes them), are drawn first,
    N(0, 0.5^2) from a seeded generator, and the slice then serves with
    them.

    Control faults (``hold_logits``): ``slot`` (after the prefill, each
    row's last prompt token holds its first token's K and V in every
    layer: a write to the wrong slot), ``head`` (KV heads 0 and 1 swapped
    in every layer: a wrong head; where there are two or more), ``bias``
    (the QKV biases zeroed; where the config has them)."""
    from repro_torch.kvcache import PagedKVCache, init_page_pools
    from repro_torch.models import transformer as tfm
    cfg = model.cfg
    dev = params.embed.table.device
    lens = [40, 33, 17, 48]
    seq, lengths = left_padded(cfg, lens, dev)
    (B, T), n_steps = seq.shape, 4
    biased = [d for layer in params.layers if cfg.qkv_bias
              for d in (layer.attn.wq, layer.attn.wk, layer.attn.wv)]
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    refs = []
    with torch.no_grad():
        for d in biased:
            d.b.copy_(0.5 * torch.randn(d.b.shape, generator=g, device=dev))
        for step in range(n_steps + 1):
            pos = tfm.make_positions(seq, lengths + step)
            refs.append(tfm.forward(params, cfg, seq, pos)[:, -1].float())
            cur = torch.argmax(refs[-1], -1).to(torch.int32)
            seq = torch.cat([seq, cur[:, None]], dim=1)

    def serve(cache_fault=None) -> list:
        """Each step's logits, fed the reference's tokens."""
        if path == "dense":
            logits, cache = model.prefill(params, {"tokens": seq[:, :T],
                                                   "lengths": lengths},
                                          T + n_steps)
        else:
            nb = -(-(T + n_steps) // pg)
            bt = (torch.arange(B * nb, dtype=torch.int32, device=dev)
                  .reshape(B, nb) + 1)
            k_pages, v_pages = init_page_pools(cfg.n_layers, B * nb, pg,
                                               cfg.n_kv_heads, cfg.head_dim,
                                               cfg.dtype, dev)
            cache = PagedKVCache(k_pages, v_pages, bt, torch.full(
                (B, nb * pg), -1, dtype=torch.int32, device=dev), lengths)
            logits, cache = tfm.prefill_paged(params, cfg, seq[:, :T],
                                              lengths, cache, attn_impl=path)
        if cache_fault is not None:
            cache_fault(cache)
        out = [logits]
        for step in range(n_steps):
            cur = seq[:, T + step].contiguous()
            q_pos = lengths + step
            if path == "dense":
                logits, cache = model.decode_step(params, cache, cur, step)
            else:
                logits, cache = tfm.decode_step_paged(
                    params, cfg, cache, cur, q_pos, q_pos, attn_impl=path)
            out.append(logits)
        return out

    def wrong_slot(cache) -> None:
        for b, n in enumerate(lens):
            k_dst, v_dst = cache_slot(cache, b, n - 1, T - n)
            k_src, v_src = cache_slot(cache, b, 0, T - n)
            k_dst.copy_(k_src)
            v_dst.copy_(v_src)

    def wrong_head(cache) -> None:
        pools = ((cache.k_pages, cache.v_pages)
                 if isinstance(cache, PagedKVCache) else (cache.k, cache.v))
        for x in pools:
            x[..., :2, :] = x[..., [1, 0], :].clone()

    faults = {"slot": (contextlib.nullcontext(), wrong_slot)}
    if cfg.n_kv_heads > 1:
        faults["head"] = (contextlib.nullcontext(), wrong_head)
    if biased:
        faults["bias"] = (zeroed([d.b for d in biased]), None)
    with torch.no_grad():
        served = serve()
    return hold_logits(f"{cfg.name} {path}", served, refs, serve, faults,
                       REF_TOL, f"prefill + {n_steps} decode steps")


#: phase 4 of the MoE and hybrid slices: each family's served path
#: (``prefill`` + ``decode_step`` of ``models.moe`` / ``models.rglru``)
#: against its plain ``forward``.  arch: (left-padded row lengths, decode
#: steps, depth of the float32 check model or None).  The hybrid's first
#: row passes its local window of 2048, so the ring wraps in prefill and
#: in decode; mixtral's passes its sliding window of 4096, and 32 steps
#: decode over the wrapped ring.
FAMILY_CHECKS = {"deepseek-v2-lite-16b": ((40, 33, 17, 48), 4, 4),
                 "mixtral-8x22b": ((4200, 40), 32, 4),
                 "recurrentgemma-9b": ((2100, 33, 17, 48), 4, None)}


def moe_check_model(arch: str, n_layers: int):
    """Phase 4's model for an MoE family: the full-width config cut to
    ``n_layers`` (deepseek: its dense first layer and 3 MoE layers), in
    float32 (TF32 off), with a capacity that drops no choice
    (capacity_factor (E + 0.5) / top_k, so cap = int(group (E + 0.5) / E)
    >= group), random weights from a seed on the card.

    Why not the slice's bf16 model: routing is discrete.  The plain
    forward and the served path round differently in bf16 (the attention
    kernels against torch, a one-token decode against a whole-sequence
    product), and a choice whose router probability nearly ties the next
    expert's flips between them, which moves the logits by a share of the
    expert's output, not by a rounding.  In float32 those gaps are ~1e-6
    and no flip was met, so the check holds them to ``F32_REF_TOL``.  A
    group's drops depend on which tokens share it (prefill's B·T against
    decode's B), so the capacity must drop nothing for the two to compute
    one function; the slice's own model at its own capacity is held
    against the CPU by ``check_served_routing``."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model
    cfg = get_config(arch)
    cfg = cfg.replace(n_layers=n_layers, dtype=torch.float32,
                      capacity_factor=(cfg.n_experts + 0.5) / cfg.top_k)
    model = get_model(cfg)
    return model, model.init(3, device="cuda")


def check_family_logits(model, params, lens, n_steps: int) -> dict:
    """Phase 4 for the MoE and hybrid families: one prefill of the
    left-padded rows ``lens`` and ``n_steps`` greedy decode steps through
    the served functions (the dense cache, the kernels where the family has
    them), each step's last-token logits held against the plain
    ``forward`` of the same tokens on the card (plain torch attention, no
    cache), to ``REF_TOL`` of the reference's largest |logit| in bf16 and
    ``F32_REF_TOL`` in float32.  One forward over the final sequence gives
    every step's reference: it is causal, and at phase 4's capacity no
    token's routing depends on the others.  Control faults
    (``hold_logits``), fed the same tokens: ``shared`` (deepseek: the
    shared experts lost, their down projections zeroed), ``route``
    (mixtral: every token routed to its 2nd..(k+1)-th best experts, not
    its k best), ``rec_state`` (the hybrid: every recurrent block's state,
    its LRU state and its conv tail, zeroed after the prefill, as if it
    were not carried into decode).  The LRU state alone is too weak a
    fault at the init recipe: λ = 1 makes a = e^{-8 softplus(1) r} ~ e^{-5}
    per step, so a decode step forgets it almost whole (2.1e-2 of the
    largest logit at the reduced size, under REF_TOL), while the conv tail
    holds 3 of the 4 taps' inputs."""
    from repro_torch.models import moe, rglru
    cfg = model.cfg
    fam = rglru if cfg.family == "hybrid" else moe
    tokens, lengths = left_padded(cfg, lens, params.embed.table.device)
    B, T = tokens.shape

    def serve(cache_fault=None, seq=None) -> tuple:
        """(each step's logits, the tokens fed): greedy, or ``seq``'s."""
        logits, cache = fam.prefill(params, cfg, tokens, lengths,
                                    T + n_steps)
        if cache_fault is not None:
            cache_fault(cache)
        out, fed = [logits], []
        for step in range(n_steps):
            cur = (seq[:, T + step].contiguous() if seq is not None
                   else torch.argmax(out[-1].float(), -1).to(torch.int32))
            fed.append(cur)
            logits, cache = fam.decode_step(params, cfg, cache, cur, step)
            out.append(logits)
        return out, torch.cat([tokens, torch.stack(fed, 1)], dim=1)

    def rec_state(cache) -> None:
        for x in (cache.h, cache.tail_h, cache.conv, cache.tail_conv):
            x.zero_()

    with torch.no_grad():
        served, seq = serve()
        full = fam.forward(params, cfg, seq, lengths + n_steps)
        refs = [full[:, T - 1 + step].float() for step in range(n_steps + 1)]
        del full
    if cfg.family == "hybrid":
        faults = {"rec_state": (contextlib.nullcontext(), rec_state)}
    elif cfg.n_shared_experts:
        faults = {"shared": (zeroed([layer.moe.shared.down.w
                                     for layer in params.layers]), None)}
    else:
        best = moe.top_k
        faults = {"route": (mock.patch.object(
            moe, "top_k",
            lambda p, k: tuple(x[..., 1:] for x in best(p, k + 1))), None)}
    tol = F32_REF_TOL if cfg.dtype == torch.float32 else REF_TOL
    held = hold_logits(
        f"{cfg.name} ({cfg.n_layers} layers, {str(cfg.dtype)[6:]})", served,
        refs, lambda cache_fault: serve(cache_fault, seq)[0], faults, tol,
        f"prefill ({B} rows of up to {T} tokens) + {n_steps} decode steps")
    return dict(held, check_layers=cfg.n_layers, check_dtype=str(cfg.dtype),
                check_rows=list(lens))


#: the decode group of ``check_served_routing``: at 8 tokens deepseek-v2-lite
#: holds 1 slot an expert (int(8·6·1.25/64) = 0, raised to 1), mixtral 2
ROUTE_ROWS = 8


def check_served_routing(model, params) -> dict:
    """Phase 4 of the MoE slices at their served capacity, on the slice's
    own bf16 model: a prefill of ``ROUTE_ROWS`` random rows and one decode
    step, whose first MoE layer's input (the decode group, one token a
    row) is kept.  That layer's routing and ``moe_apply`` run on the card
    and, with the layer's weights copied, on the CPU.  The routing (each
    choice's expert, slot and keep flag) must be equal exactly and drop at
    least one choice; the renormalised weights must lie within
    ``ROUTE_WEIGHT_TOL``, the outputs within ``ROUTE_TOL`` of the CPU's
    largest |y|.  Control: the CPU layer at a capacity that drops nothing
    must move its output past ``ROUTE_TOL``, so that the drops weigh at
    this input."""
    import numpy as np
    from repro_torch.models import moe
    cfg = model.cfg
    dev = params.embed.table.device
    rng = np.random.default_rng(4)
    T = 16
    tokens = torch.from_numpy(rng.integers(
        2, cfg.vocab_size, size=(ROUTE_ROWS, T)).astype(np.int32)).to(dev)
    lengths = torch.full((ROUTE_ROWS,), T, dtype=torch.int32, device=dev)
    seen = []
    apply = moe.moe_apply

    def keep_first(p, x, c):
        if not seen:
            seen.append((p, x.clone()))
        return apply(p, x, c)

    with torch.no_grad():
        logits, cache = moe.prefill(params, cfg, tokens, lengths, T + 1)
        with mock.patch.object(moe, "moe_apply", keep_first):
            moe.decode_step(params, cfg, cache,
                            torch.argmax(logits.float(), -1).to(torch.int32),
                            0)
        del cache
        card, x = seen[0]
        group = x.shape[0] * x.shape[1]
        cap = moe.capacity(cfg, group)
        cpu = moe.MoELayer(cfg, torch.device("cpu"))
        cpu.load_state_dict(card.state_dict())
        xc = x.cpu()
        on_card = moe.route(card, x.reshape(group, -1), cfg, cap)
        on_cpu = moe.route(cpu, xc.reshape(group, -1), cfg, cap)
        y_card = moe.moe_apply(card, x, cfg).float().cpu()
        y_cpu = moe.moe_apply(cpu, xc, cfg).float()
        y_all = moe.moe_apply(cpu, xc, cfg.replace(
            capacity_factor=(cfg.n_experts + 0.5) / cfg.top_k)).float()
        torch.cuda.synchronize()
    equal = all(torch.equal(getattr(on_card, f).cpu(), getattr(on_cpu, f))
                for f in ("expert", "slot", "keep"))
    drops = int((~on_cpu.keep).sum())
    w_diff = (on_card.weight.cpu() - on_cpu.weight).abs().max().item()
    scale = y_cpu.abs().max().item()
    gap = (y_card - y_cpu).abs().max().item() / scale
    control = (y_all - y_cpu).abs().max().item() / scale
    del cpu
    log(f"{cfg.name} served routing, card vs CPU: decode group of {group} "
        f"tokens at {cap} slot(s) an expert, {drops} of {group * cfg.top_k} "
        f"choices dropped, (expert, slot, keep) equal: {equal}; weights "
        f"max |diff| {w_diff:.2e} (tolerance {ROUTE_WEIGHT_TOL}); moe_apply "
        f"max relative difference {gap:.3e} (tolerance {ROUTE_TOL}); "
        f"control, nothing dropped on the CPU: {control:.3e} (must exceed "
        f"{ROUTE_TOL})")
    if not (equal and drops > 0 and w_diff <= ROUTE_WEIGHT_TOL
            and gap <= ROUTE_TOL < control):
        raise SystemExit(f"{cfg.name}: the served MoE routing on the card "
                         f"disagrees with the CPU's, drops nothing, or its "
                         f"control does not exceed {ROUTE_TOL}")
    return dict(route_group=group, route_capacity=cap, route_drops=drops,
                route_weight_max_diff=w_diff, route_max_rel_diff=gap,
                route_control_no_drops=control)


# ---------------------------------------------------------------------------
# phase 4b: the dense attention kernels' engines, card against CPU
# ---------------------------------------------------------------------------
def check_ils_parity() -> None:
    """The reduced float32 llama3.2-1b with one set of weights on the card
    and on the CPU: small dense and paged ``ContinuousEngine``s and the
    dense ``StaticEngine`` serve the same prompts on each.  On the card
    they run flash_prefill, decode_attention and paged_decode_attention
    (each once per layer per prefill / decode step), on the CPU the plain
    maths; the streams must be equal but for recorded near-ties, and the
    dense and paged ILS engines must agree on the card."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.engine.continuous_engine import ContinuousEngine
    from repro_torch.engine.static_engine import StaticEngine
    from repro_torch.kernels import ops
    from repro_torch.models.registry import get_model
    from repro_torch.testing import prefill_logits, stream_tie
    model = get_model(get_config("llama3.2-1b", reduced=True))
    cpu = model.init(0, device="cpu")
    card = model.init(0, device="cuda")
    card.load_state_dict(cpu.state_dict())
    ref_logits = prefill_logits(model, cpu)
    rng = np.random.default_rng(4)
    ps = [rng.integers(2, model.cfg.vocab_size, size=n).astype(np.int32)
          for n in (5, 9, 4, 12, 3, 20, 33, 17)]
    forced = [4, 6, 3, 5, 7, 8, 12, 10]
    L = model.cfg.n_layers
    kw = dict(max_slots=3, max_context=64, eos_id=1, len_bucket=8)
    ties, card_outs = [], {}
    for layout, extra, decode in (
            ("dense", {}, "decode_attention"),
            ("paged", dict(page_tokens=8), "paged_decode_attention")):
        want = ContinuousEngine(model, cpu, kv_layout=layout, device="cpu",
                                **kw, **extra).serve(ps,
                                                     forced_gen_lens=forced)
        eng = ContinuousEngine(model, card, kv_layout=layout, device="cuda",
                               **kw, **extra)
        ops.reset_counts()
        got = eng.serve(ps, forced_gen_lens=forced)
        torch.cuda.synchronize()
        launches = ops.launches()
        expect = {k: 0 for k in launches}
        expect["flash_prefill"] = L * eng.n_prefill_stages
        expect[decode] = L * eng.n_decode_steps
        if launches != expect or any(ops.plain_calls.values()):
            raise SystemExit(f"ILS {layout} on the card: launches "
                             f"{launches} != {expect}, plain calls "
                             f"{ops.plain_calls}")
        if eng.alloc is not None and \
                eng.alloc.free_blocks != eng.alloc.n_pages:
            raise SystemExit("ILS paged on the card: pages leaked")
        for i, (p, a, b) in enumerate(zip(ps, want.outputs, got.outputs)):
            gap = stream_tie(ref_logits, p, a, b)
            if gap is not None:
                ties.append(dict(engine=f"ils_{layout}", request=i, gap=gap))
        card_outs[layout] = got.outputs
    if card_outs["dense"] != card_outs["paged"]:
        raise SystemExit("ILS dense and paged engines disagree on the card")
    want = StaticEngine(model, cpu, eos_id=1, len_bucket=8,
                        device="cpu").serve_batch(ps, slice_len=16,
                                                  forced_gen_lens=forced)
    se = StaticEngine(model, card, eos_id=1, len_bucket=8, device="cuda")
    ops.reset_counts()
    got = se.serve_batch(ps, slice_len=16, forced_gen_lens=forced)
    launches = ops.launches()
    loop = launches.pop("graph_loop")  # once a step and once a slice
    if (launches["flash_prefill"] != L * se.n_prefill_stages
            or launches["decode_attention"] != L * se.n_decode_steps
            or loop != se.n_decode_steps + se.n_loops
            or sum(launches.values()) != L * (se.n_prefill_stages
                                              + se.n_decode_steps)):
        raise SystemExit(f"dense static engine on the card: launches "
                         f"{launches}")
    for i, (p, a, b) in enumerate(zip(ps, want.results, got.results)):
        gap = stream_tie(ref_logits, p, a["tokens"], b["tokens"])
        if gap is not None:
            ties.append(dict(engine="static_dense", request=i, gap=gap))
    log(f"ILS parity (reduced float32 llama3.2-1b): dense and paged "
        f"ContinuousEngine and the dense StaticEngine on the card match the "
        f"CPU over {len(ps)} requests each; dense == paged on the card; "
        f"near-ties {ties}")
    print(json.dumps({"ils_parity": dict(requests=len(ps), near_ties=ties)}),
          flush=True)


# ---------------------------------------------------------------------------
# phase 4c: the other configs' engines, card against CPU
# ---------------------------------------------------------------------------
#: (arch, head_dim) of phase 4c: mamba2-130m, each other dense config, and
#: gemma-2b once more at its published head_dim 256 (the float32 kernels
#: at D 256)
CONFIG_PARITY = (("mamba2-130m", None), ("codeqwen1.5-7b", None),
                 ("minitron-4b", None), ("gemma-2b", None), ("gemma-2b", 256),
                 ("mixtral-8x22b", None), ("deepseek-v2-lite-16b", None),
                 ("recurrentgemma-9b", None), ("seamless-m4t-large-v2", None),
                 ("paligemma-3b", None))
#: the MoE configs of phase 4c once more at their full configs' capacity
#: factor (1.25), at which the reduced engines drop routed choices
SERVED_CAPACITY_PARITY = ("mixtral-8x22b", "deepseek-v2-lite-16b")


def perturb(params, cfg) -> None:
    """Draw apart, from a seeded generator, the parameters that the
    initialiser makes alike, as the CPU tests' shared weights do: the QKV
    biases (zero at init), Mamba-2's A_log, dt_bias, D and conv_b (alike
    per head and channel), the RG-LRU's lambda and conv_b (alike per
    channel) and the encoder-decoder's norm gains (all zero at init)."""
    g = torch.Generator().manual_seed(5)
    if cfg.family == "encdec":
        gains = [params.ln_enc, params.ln_f]
        gains += [w for layer in params.enc_layers
                  for w in (layer.ln_attn, layer.ln_mlp)]
        gains += [w for layer in params.dec_layers
                  for w in (layer.ln_self, layer.ln_cross, layer.ln_mlp)]
        with torch.no_grad():
            for w in gains:
                w.copy_(0.3 * torch.randn(w.shape, generator=g))
        return
    if cfg.family == "hybrid":
        blocks = [rp for grp in params.groups for rp in grp.rec]
        blocks += list(params.tail)
    else:
        blocks = params.layers
    with torch.no_grad():
        for layer in blocks:
            if cfg.family == "ssm":
                m = layer.mixer
                drawn = ((m.A_log, 0.0, 0.5), (m.dt_bias, 0.0, 0.5),
                         (m.D, 1.0, 0.5), (m.conv_b, 0.0, 0.2))
            elif cfg.family == "hybrid":
                drawn = ((layer.lam, 1.0, 0.5), (layer.conv_b, 0.0, 0.2))
            elif cfg.qkv_bias:
                a = layer.attn
                drawn = tuple((d.b, 0.0, 0.5) for d in (a.wq, a.wk, a.wv))
            else:
                drawn = ()
            for p, loc, scale in drawn:
                p.copy_(loc + scale * torch.randn(p.shape, generator=g))


def frontend_extra(cfg, n: int, rng, frames=None) -> dict:
    """The frontend stubs' inputs of ``n`` requests (numpy, float32
    embeddings N(0, 1) from ``rng``): a VLM's ``prefix_embeds`` (n, P, d);
    an encoder-decoder's ``src_embeds`` (n, S, d) and ``src_valid`` (row b's
    first ``frames[b]`` frames of S = max(frames); frames drawn from 4..24
    where not given); {} for the token-only families."""
    import numpy as np
    if cfg.family == "vlm":
        return {"prefix_embeds": rng.standard_normal(
            (n, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)}
    if cfg.family != "encdec":
        return {}
    frames = (np.asarray(frames) if frames is not None
              else rng.integers(4, 25, size=n))
    S = int(frames.max())
    return {"src_embeds": rng.standard_normal(
                (n, S, cfg.d_model)).astype(np.float32),
            "src_valid": np.arange(S)[None] < frames[:, None]}


def check_config_parity(arch: str, head_dim=None,
                        served_capacity: bool = False) -> dict:
    """The reduced float32 ``arch`` (its head_dim replaced where given; an
    MoE config at the full config's capacity factor, which drops routed
    choices, where ``served_capacity``) with one set of weights
    (``perturb``) on the card and on the CPU: the dense ``StaticEngine``,
    and for a dense transformer the paged unfused and fused ones, each
    serve the same prompts over two slices (the dense one re-prefills the
    second, the paged ones resume their pages).  The VLM and the
    encoder-decoder take seeded frontend inputs (``frontend_extra``), and
    each slice builds its dense engines over its batch's rows of them.  On the card each runs its
    path's kernels once per layer per prefill stage / decode step (two
    stages dense, one paged) and nothing else, on the CPU their plain
    versions as often; the streams must equal the CPU's but for recorded
    near-ties.  The MoE dispatch's dropped choices are counted on each
    device; at the served capacity both must drop some."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.engine.static_engine import StaticEngine
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.models.registry import get_model
    from repro_torch.testing import prefill_logits, stream_tie
    cfg = get_config(arch, reduced=True)
    if head_dim is not None:
        cfg = cfg.replace(head_dim=head_dim)
    if served_capacity:
        cfg = cfg.replace(capacity_factor=get_config(arch).capacity_factor)
    model = get_model(cfg)
    # counted on the device, so that a captured decode step counts its
    # drops at every replay (a host read would break the capture)
    drops = {dev: torch.zeros((), dtype=torch.int64, device=dev)
             for dev in ("cpu", "cuda")}
    dispatch = moe._dispatch

    def counting(probs, k, cap):
        r = dispatch(probs, k, cap)
        drops[probs.device.type].add_((~r.keep).sum())
        return r
    cpu = model.init(0, device="cpu")
    perturb(cpu, model.cfg)
    card = model.init(0, device="cuda")
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(8)
    ps = [rng.integers(2, model.cfg.vocab_size, size=n).astype(np.int32)
          for n in (5, 13, 9, 40, 3, 21)]
    forced = [12, 3, 12, 9, 12, 5]
    extra = frontend_extra(model.cfg, len(ps), rng)
    ref_logits = [prefill_logits(model, cpu, {k: v[i:i + 1]
                                              for k, v in extra.items()})
                  for i in range(len(ps))]
    L = kernel_layers(model.cfg)
    paged = dict(kv_layout="paged", page_tokens=8, kv_pool_tokens=512)
    family = model.cfg.family
    paths = ((("dense", {}, SSM),) if family == "ssm" else
             (("dense", {}, () if model.cfg.use_mla else DENSE),)
             if family != "dense" else
             (("dense", {}, DENSE),
              ("unfused", paged, PATH_KERNELS["unfused"]),
              ("fused", dict(paged, attn_impl="fused"), FUSED)))
    ties, result = [], {}
    stat_names = ("n_prefill_stages", "n_tail_prefill_stages",
                  "n_decode_steps", "n_loops")
    for path, kw, used in paths:
        def build(idx):
            """CPU and card engines (over the rows ``idx`` of ``extra``)."""
            rows = {k: v[idx] for k, v in extra.items()} or None
            return {name: StaticEngine(model, params, eos_id=1,
                                       len_bucket=8, extra_inputs=rows,
                                       device=dev, **kw)
                    for name, params, dev in (("cpu", cpu, "cpu"),
                                              ("card", card, "cuda"))}
        engines = None if extra else build(None)
        outs = {dev: [[] for _ in ps] for dev in ("cpu", "card")}
        counts = dict(prefix_hit_tokens=0, reprefill_tokens=0)
        stats = dict.fromkeys(stat_names, 0)  # the card engines', summed
        ops.reset_counts()
        with mock.patch.object(moe, "_dispatch", counting):
            for _ in range(2):
                idx = [i for i in range(len(ps))
                       if len(outs["cpu"][i]) < forced[i]]
                if extra:
                    engines = build(idx)
                skw = dict(forced_gen_lens=[forced[i] - len(outs["cpu"][i])
                                            for i in idx],
                           already_generated=[outs["cpu"][i] for i in idx])
                for dev, eng in engines.items():
                    batch = [ps[i] for i in idx]
                    before = {k: getattr(eng, k) for k in stat_names}
                    res = (eng.serve_batch(batch, 8, **skw)
                           if path == "dense"
                           else eng.serve_batch_paged(batch, 8, idx, **skw))
                    for s_, i in enumerate(idx):
                        outs[dev][i] = (outs[dev][i]
                                        + res.results[s_]["tokens"])
                    if dev == "card":
                        for k in counts:
                            counts[k] += getattr(res, k)
                        for k in stat_names:
                            stats[k] += getattr(eng, k) - before[k]
        torch.cuda.synchronize()
        launches = ops.launches()
        label = f"{arch} {path} engine (reduced, card)"
        check_launches(label, dict(
            n_layers=L, layers_by_kernel=kernel_layers_by_name(model.cfg),
            prefill_stages=stats["n_prefill_stages"],
            tail_prefill_stages=stats["n_tail_prefill_stages"],
            decode_steps=stats["n_decode_steps"], loops=stats["n_loops"],
            launches=launches, n_completed=len(ps), n_requests=len(ps),
            **counts), used)
        stages = 2 if path == "dense" else 1
        if dict(ops.plain_calls) != launches or \
                stats["n_prefill_stages"] != stages:
            raise SystemExit(f"{label}: plain calls {ops.plain_calls} (the "
                             f"CPU engine's) != launches {launches}, or "
                             f"{stats['n_prefill_stages']} prefill stages, "
                             f"not {stages}")
        for i, (p, a, b) in enumerate(zip(ps, outs["cpu"], outs["card"])):
            if len(a) != forced[i]:
                raise SystemExit(f"{arch} {path}: request {i} ended at "
                                 f"{len(a)} of {forced[i]} tokens")
            gap = stream_tie(ref_logits[i], p, a, b)
            if gap is not None:
                ties.append(dict(path=path, request=i, gap=gap))
        result[path] = launches
    drops = {dev: int(n) for dev, n in drops.items()}
    if served_capacity and not min(drops.values()) > 0:
        raise SystemExit(f"{arch} at capacity factor "
                         f"{cfg.capacity_factor}: dropped choices {drops}, "
                         f"none on one device")
    moe_note = (f", capacity factor {cfg.capacity_factor:g}, choices "
                f"dropped {drops}" if family == "moe" else "")
    log(f"{arch} parity (reduced float32, "
        f"{'SSM' if family == 'ssm' else 'head_dim %d' % model.cfg.head_dim}"
        f"{moe_note}): the {', '.join(p for p, _, _ in paths)} "
        f"StaticEngines on the card match the CPU over {len(ps)} requests "
        f"and 2 slices; near-ties {ties}")
    return dict(head_dim=model.cfg.head_dim, requests=len(ps),
                near_ties=ties, launches=result,
                capacity_factor=cfg.capacity_factor, dropped_choices=drops)


# ---------------------------------------------------------------------------
# phases 5-9 and 13-15: the slices, through the launcher's build_server
# ---------------------------------------------------------------------------
#: the launcher's arguments of phases 5-9 (llama3.2-1b; mamba2-130m)
SLICE_ARGV = ["--backend", "real", "--arch", "llama3.2-1b",
              "--strategy", "scls", "--workers", "1", "--rate", "4",
              "--duration", "8", "--slice-len", "64", "--max-gen", "256",
              "--page-tokens", "16", "--m-available", "48e9",
              "--shared-prefix", "3", "--seed", "0"]
PAGED_KV = ["--kv-layout", "paged", "--kv-retain", "request"]
DENSE_KV = ["--kv-layout", "dense", "--kv-retain", "slice"]
DENSE_ARGV = SLICE_ARGV + DENSE_KV
#: the launcher's arguments of phases 13-15: a CodeFuse trace whose
#: requests (up to 128 tokens) outlive slices of 32, over the budget
#: ``CONFIG_M_AVAILABLE``
CONFIG_ARGV = ["--backend", "real", "--strategy", "scls", "--workers", "1",
               "--rate", "2", "--duration", "6", "--slice-len", "32",
               "--max-gen", "128", "--page-tokens", "16",
               "--m-available", str(CONFIG_M_AVAILABLE), "--seed", "0"]
FUSED = ("fused_rope_prefill_write", "fused_rope_decode_append")
UNFUSED = ("paged_prefill_write", "paged_decode_attention")
DENSE = ("flash_prefill", "decode_attention")
SSM = ("ssd_scan",)
#: the kernels of each path; "mla" is dense SCLS for deepseek-v2-lite-16b,
#: whose MLA attention and MoE dispatch are plain torch by design (no
#: kernel launches on it)
PATH_KERNELS = {"unfused": UNFUSED + ("flash_prefill",), "fused": FUSED,
                "dense": DENSE, "ssm": SSM, "mla": ()}
#: summary label: (launcher arguments, path) of each slice.  Phases 5-7:
#: llama3.2-1b on the persistent paged unfused path, on fused engines and
#: on dense SCLS; 9: mamba2-130m on dense SCLS; 13-15: codeqwen1.5-7b (MHA
#: 32/32, QKV bias) paged unfused, minitron-4b (GQA 24/8) fused, gemma-2b
#: (MQA 8/1, head_dim 256) dense
SLICES = {
    "slice": (SLICE_ARGV + PAGED_KV, "unfused"),
    "fused_slice": (SLICE_ARGV + PAGED_KV, "fused"),
    "dense_slice": (DENSE_ARGV, "dense"),
    "mamba_slice": (DENSE_ARGV + ["--arch", "mamba2-130m"], "ssm"),
    "codeqwen_slice": (CONFIG_ARGV + ["--arch", "codeqwen1.5-7b",
                                      "--shared-prefix", "2"] + PAGED_KV,
                       "unfused"),
    "minitron_fused_slice": (CONFIG_ARGV + ["--arch", "minitron-4b",
                                            "--shared-prefix", "2"]
                             + PAGED_KV, "fused"),
    "gemma_dense_slice": (CONFIG_ARGV + ["--arch", "gemma-2b"] + DENSE_KV,
                          "dense"),
    "deepseek_slice": (CONFIG_ARGV + ["--arch", "deepseek-v2-lite-16b",
                                      "--m-available", "30e9"] + DENSE_KV,
                       "mla"),
    "recurrentgemma_slice": (CONFIG_ARGV + ["--arch", "recurrentgemma-9b"]
                             + DENSE_KV, "dense"),
    "mixtral_slice": (CONFIG_ARGV + ["--arch", "mixtral-8x22b"] + DENSE_KV,
                      "dense")}
#: phases 17-19's slices: deepseek-v2-lite-16b (27 layers, ~31.4 GB in
#: bf16: a 30 GB KV budget), recurrentgemma-9b (38 layers, ~18.8 GB) and
#: mixtral-8x22b cut to ``DEPTH_CUTS`` layers (~282 GB in bf16 at its 56)
FAMILY_SLICES = ("deepseek_slice", "recurrentgemma_slice", "mixtral_slice")
#: arch: (layers its served models are cut to, at full width; why).  All
#: 56 of mixtral-8x22b's layers hold ~282 GB in bf16, 4 hold ~20.8 GB; the
#: llama3.2-1b paths (phases 5-8), the Mamba-2 slice (9), the
#: codeqwen1.5-7b and minitron-4b slices (13-14) and the launcher's path
#: (16, codeqwen1.5-7b) are cut to half their depth so that the whole
#: script stays well inside its time limit (their walls followed the
#: start-up estimator's batch, fixed since by ``fixed_fit``, and the host,
#: and reached 75-138 s a slice at full depth; phase 20 still serves
#: minitron-4b at full depth); every
#: kernel keeps its per-layer shapes
DEPTH_CUTS = {"mixtral-8x22b": (4, "past one 80 GB card"),
              "llama3.2-1b": (8, "cut for the script's time limit"),
              "mamba2-130m": (12, "cut for the script's time limit"),
              "codeqwen1.5-7b": (16, "cut for the script's time limit"),
              "minitron-4b": (16, "cut for the script's time limit")}


def served_config(arch: str):
    """``arch``'s full-width config at the depth ``DEPTH_CUTS`` gives it."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return (cfg.replace(n_layers=DEPTH_CUTS[arch][0]) if arch in DEPTH_CUTS
            else cfg)


@contextlib.contextmanager
def fixed_fit():
    """Inside ``with``, the launcher's start-up estimator fit
    (``engine.profiler.fit_estimator``) returns the paper testbed's fitted
    estimator (A100, LLaMA2-13B; ``serving.fitted_estimator`` of
    ``a100_llama13b_profile``), as ``tests/test_torch_serving.py``'s
    affinity case fixes it.  The run_slice phases take it: their checks
    (launches, completions, re-prefill, prefix hits, logits) do not read
    the fit, whose picks set their batches and so their wall time (1.1 to
    12.4 rows across one tree's runs).  Phases 16 and 20 keep the
    launcher's own fit."""
    from repro_torch.core.estimator import a100_llama13b_profile
    from repro_torch.engine import profiler
    from repro_torch.serving import fitted_estimator
    est = fitted_estimator(a100_llama13b_profile())
    with mock.patch.object(profiler, "fit_estimator",
                           lambda *a, **kw: (est, 0.0, 0.0)):
        yield


def served_depth(serve):
    """A patch of the launcher module ``serve``'s ``get_config`` under
    which ``build_server`` builds a full config at the depth
    ``DEPTH_CUTS`` gives its arch (reduced configs as they are)."""
    full_config = serve.get_config
    return mock.patch.object(serve, "get_config", lambda arch, reduced=False:
                             full_config(arch, reduced) if reduced
                             else served_config(arch))


#: a request each slice adds to its trace, whose prompt passes the model's
#: window (2048 local, 4096 sliding): (prompt tokens, tokens to generate,
#: two slices of 32)
LONG_REQUESTS = {"recurrentgemma_slice": (2100, 64),
                 "mixtral_slice": (4200, 64)}
#: the least requests a slice's trace serves (shared-prefix pairs included)
MIN_SLICE_REQUESTS = 12
#: phase 16: the JAX launcher's serving path in the port (ServingConfig ->
#: build_server -> SliceServer) with prediction-aware SCLS, the proxy MLP
#: on the card and a Chrome trace, codeqwen1.5-7b paged unfused
LAUNCHER_ARGV = (CONFIG_ARGV + ["--arch", "codeqwen1.5-7b",
                                "--shared-prefix", "2"] + PAGED_KV
                 + ["--strategy", "scls-pred", "--predictor", "proxy"])
#: where phase 16 writes its trace (and the decision audit beside it)
LAUNCHER_TRACE = os.path.join(ROOT, "build", "smoke_trace.json")
#: phase 16's session: turn 1's new tokens and output, turn 2's new tail
SESSION_TURN1, SESSION_GEN, SESSION_TAIL = 57, 24, 16


def time_engine(engine) -> dict:
    """Sum the wall seconds of every serve call (the engine's own clock),
    of its prefill stages where the engine measures them, and of its
    decode loops (a ``graphs.Loop``'s replay, ``_run_loop``, which for a
    dense slice holds its prefill too, or the eager loop; each ends in a
    host transfer that waits for the device) into the returned dict."""
    acc = {"calls": 0, "wall_s": 0.0, "prefill_s": 0.0, "decode_s": 0.0}
    name = ("serve_batch_paged" if engine.kv_layout == "paged"
            else "serve_batch")
    serve = getattr(engine, name)

    def timed_serve(*args, **kw):
        res = serve(*args, **kw)
        acc["calls"] += 1
        acc["wall_s"] += res.wall_time
        acc["prefill_s"] += res.prefill_time or 0.0
        return res

    def timed(loop):
        def run(*args, **kw):
            t0 = time.perf_counter()
            out = loop(*args, **kw)
            acc["decode_s"] += time.perf_counter() - t0
            return out
        return run

    setattr(engine, name, timed_serve)
    for loop in ("_run_loop", "_decode_loop"):
        setattr(engine, loop, timed(getattr(engine, loop)))
    return acc


def serve_trace(label: str, engines, drive, extra: dict) -> dict:
    """Run ``drive()`` (it serves and returns the run's metrics and every
    request it served) with every kernel count set to 0 just before and
    read just after; check that every request completed with well-formed
    output; print and return the slice's summary (with the engines'
    captures in the run, their seconds and each engine's graph-pool
    bytes after it)."""
    from repro_torch.kernels import ops
    vocab = engines[0].model.cfg.vocab_size
    timers = [time_engine(e) for e in engines]
    for e in engines:
        e.n_prefill_stages = e.n_tail_prefill_stages = e.n_decode_steps = 0
        e.n_loops = 0
    graphs0 = [(e.step_graphs.n_captures, e.step_graphs.capture_seconds)
               for e in engines]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    metrics, requests = drive()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launches()
    plain = dict(ops.plain_calls)
    stages = sum(e.n_prefill_stages for e in engines)
    tail_stages = sum(e.n_tail_prefill_stages for e in engines)
    steps = sum(e.n_decode_steps for e in engines)
    decode_s = sum(a["decode_s"] for a in timers)
    summary = dict(dataclasses.asdict(metrics), wall_s=wall,
                   prefill_stages=stages, tail_prefill_stages=tail_stages,
                   decode_steps=steps,
                   loops=sum(e.n_loops for e in engines),
                   decode_ms_per_step=decode_s / max(steps, 1) * 1e3,
                   launches=launches, plain_calls=plain,
                   n_layers=kernel_layers(engines[0].model.cfg),
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   serve_calls=sum(a["calls"] for a in timers),
                   engine_s=sum(a["wall_s"] for a in timers),
                   engine_prefill_s=sum(a["prefill_s"] for a in timers),
                   engine_decode_s=decode_s,
                   graph_captures=sum(e.step_graphs.n_captures - n for e, (
                       n, _) in zip(engines, graphs0)),
                   graph_capture_s=sum(e.step_graphs.capture_seconds - s
                                       for e, (_, s) in zip(engines,
                                                            graphs0)),
                   graph_captures_by_kind=[dict(e.step_graphs.captures)
                                           for e in engines],
                   graph_pool_bytes=[e.step_graphs.pool_bytes()
                                     for e in engines], **extra)
    print(json.dumps({label: summary}), flush=True)
    bad = [r.rid for r in requests
           if not r.done or r.output_tokens is None
           or len(r.output_tokens) != min(r.gen_len, r.max_gen)
           or not all(0 <= t < vocab for t in r.output_tokens)]
    if metrics.n_completed != metrics.n_requests or \
            metrics.n_requests != len(requests):
        raise SystemExit(f"{label}: {metrics.n_completed} of "
                         f"{len(requests)} requests completed")
    if bad:
        raise SystemExit(f"{label}: requests with missing or malformed "
                         f"output: {bad}")
    if any(plain.values()):
        raise SystemExit(f"{label}: plain versions ran on the card: {plain}")
    return summary


def kernel_layers(cfg) -> int:
    """Layers that launch the path's kernels: every layer, but for the
    hybrid's attention layers (one in three) and none of MLA's."""
    if cfg.family == "hybrid":
        return cfg.n_layers // 3
    return 0 if cfg.use_mla else cfg.n_layers


def kernel_layers_by_name(cfg) -> dict:
    """Launches a kernel makes per prefill stage / decode step where they
    are not ``kernel_layers``: the encoder-decoder's flash_prefill runs in
    every encoder and decoder layer, its decode_attention twice a decoder
    layer (self-attention, then cross-attention over the frames)."""
    if cfg.family != "encdec":
        return {}
    return {"flash_prefill": cfg.n_enc_layers + cfg.n_dec_layers,
            "decode_attention": 2 * cfg.n_dec_layers}


def check_launches(label: str, summary: dict, used) -> None:
    """The kernels in ``used`` launched once per kernel layer
    (``kernel_layers``: ``n_layers`` in the summary) per prefill stage
    (the writes, ssd_scan), stage-A prefill (flash_prefill: the tail
    prefills attend over gathered pages) or decode step (the decode
    attentions), and the decode loop's condition (graph_loop) once per
    step and once more per slice decoded through a ``graphs.Loop``
    (``loops`` in the summary; none in an eager run); every other kernel
    never launched."""
    n_layers = summary["n_layers"]
    stages = summary["prefill_stages"]
    loops = summary.get("loops", 0)
    per = {"paged_prefill_write": stages,
           "fused_rope_prefill_write": stages,
           "flash_prefill": stages - summary["tail_prefill_stages"],
           "ssd_scan": stages,
           "paged_decode_attention": summary["decode_steps"],
           "fused_rope_decode_append": summary["decode_steps"],
           "decode_attention": summary["decode_steps"],
           "graph_loop": summary["decode_steps"] + loops if loops else 0}
    used = set(used) | ({"graph_loop"} if loops else set())
    launches = summary["launches"]
    layers = dict(graph_loop=1, **summary.get("layers_by_kernel", {}))
    want = {k: layers.get(k, n_layers) * per[k] if k in used else 0
            for k in launches}
    if launches != want or any(launches[k] <= 0 for k in used):
        raise SystemExit(f"{label}: kernel launches {launches} != {want} "
                         f"implied by {summary['prefill_stages']} prefill "
                         f"stages and {summary['decode_steps']} decode steps "
                         f"of {n_layers} layers")
    log(f"{label}: {summary['n_completed']}/{summary['n_requests']} "
        f"requests, prefix hits {summary['prefix_hit_tokens']} tokens, "
        f"re-prefill {summary['reprefill_tokens']} tokens, launches "
        f"{launches} as implied")


def recorded_writes(label: str, rec: "PrefillRecorder",
                    summary: dict) -> list:
    """The slice's recorded prefill stages, one per stage it ran."""
    if len(rec.stages) != summary["prefill_stages"]:
        raise SystemExit(f"{label}: {len(rec.stages)} prefill write stages "
                         f"recorded, {summary['prefill_stages']} run")
    return rec.stages


def param_bytes(cfg) -> int:
    """Bytes of ``cfg``'s weights, counted on the meta device."""
    from repro_torch.models import mamba2, moe, rglru, transformer
    cls = {"moe": moe.MoEModel, "hybrid": rglru.RecurrentGemma,
           "ssm": mamba2.Mamba2}.get(cfg.family, transformer.Transformer)
    params = cls(cfg, torch.device("meta"))
    return sum(p.numel() * p.element_size() for p in params.parameters())


def long_request(trace, args, vocab: int, n_prompt: int, gen: int):
    """One more request for a slice's trace, arriving at the start, whose
    prompt (random tokens from a seed) passes the model's window."""
    import numpy as np
    from repro_torch.core.request import Request
    rng = np.random.default_rng(args.seed + 2)
    prompt = rng.integers(2, vocab, size=n_prompt).astype(np.int32)
    return Request(rid=max(r.rid for r in trace) + 1, arrival=0.0,
                   input_len=n_prompt, gen_len=gen, max_gen=args.max_gen,
                   prompt=prompt)


def run_slice(label: str) -> tuple:
    """Phases 5-7, 9, 13-15 and 17-19: the slice ``label`` of ``SLICES``,
    its model at full width, at the depth ``DEPTH_CUTS`` gives its arch
    (else its full depth), in bf16 with seeded random weights,
    built by the launcher's ``build_server`` (weights, the estimator, fixed
    by ``fixed_fit``, the memory model and the core: ``build_s``), whose
    core serves the trace offline (``SchedulerCore.run``).  The fused
    path swaps the launcher's paged engines for
    ``StaticEngine(attn_impl="fused")`` workers on its
    model, estimator and memory model, and first holds small fused and
    unfused engines against each other (``check_fused_engines``).  A
    transformer's served path is held against the plain forward
    (``check_served_logits``), then the slice serves the trace: every
    request completes, each kernel of the path launches once per layer per
    prefill stage or decode step and no other kernel launches, the paged
    paths hit shared prefixes and re-prefill nothing, the dense ones
    re-prefill.  The paged slices record their decode steps
    (``StepRecorder``) and prefill writes (``PrefillRecorder``) and run the
    profiler window; the Mamba-2 slice records its scans
    (``StageRecorder``) and runs ``check_long_prefill``.  Returns (summary,
    record): ``step`` (the typical decode step) and ``writes``, or
    ``stages``."""
    from repro_torch.engine.static_engine import StaticEngine
    from repro_torch.launch import serve
    from repro_torch.serving import RealBackend, SchedulerCore
    from repro_torch.configs import get_config
    argv, path = SLICES[label]
    paged = path in ("unfused", "fused")
    args, opts = serve.parse_args(argv)
    family = get_config(args.arch).family
    rows, n_steps, check_depth = FAMILY_CHECKS.get(args.arch, (None,) * 3)
    pre = {}
    if family == "moe":
        # phase 4 first, on its own float32 model, freed before the build
        pre = check_family_logits(*moe_check_model(args.arch, check_depth),
                                  rows, n_steps)
        release_cuda()
    t0 = time.perf_counter()
    with served_depth(serve), fixed_fit():
        server, vocab = serve.build_server(args)
    core = server.core
    engines = core.backend.engines
    del server
    model, params = engines[0].model, engines[0].params
    cfg = model.cfg
    if path == "fused":
        pool_tokens = engines[0].allocator.n_pages * args.page_tokens
        strategy, est, mem = core.s, core.est, core.mem
        del core, engines
        release_cuda()
        engines = [StaticEngine(model, params, eos_id=1, len_bucket=8,
                                kv_layout="paged",
                                page_tokens=args.page_tokens,
                                kv_pool_tokens=pool_tokens,
                                prefix_sharing=args.prefix_sharing,
                                attn_impl="fused", device="cuda")
                   for _ in range(args.workers)]
        backend = RealBackend(engines, mem=mem, kv_layout="paged",
                              sched_bucket=est.bucket, kv_retain="request")
        core = SchedulerCore(strategy, backend, args.workers, est, mem)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    extra = dict(arch=cfg.name, path=path, build_s=t_build,
                 n_layers_served=cfg.n_layers, m_available=args.m_available,
                 weights_gib=sum(p.numel() * p.element_size()
                                 for p in params.parameters()) / 2 ** 30)
    if args.arch in DEPTH_CUTS:
        full = get_config(args.arch)
        log(f"{label}: {cfg.name} at full width cut to {cfg.n_layers} of "
            f"{full.n_layers} layers ({extra['weights_gib']:.1f} GiB of "
            f"weights; all {full.n_layers} would hold "
            f"{param_bytes(full) / 1e9:.1f} GB in bf16: "
            f"{DEPTH_CUTS[args.arch][1]})")
    log(f"{label}: --m-available {args.m_available:g} bytes of KV budget "
        f"beside {extra['weights_gib']:.1f} GiB of weights")
    if family == "moe":
        extra.update(pre, **check_served_routing(model, params))
    elif family == "hybrid":
        extra.update(check_family_logits(model, params, rows, n_steps))
    elif path != "ssm":
        extra.update(check_served_logits(model, params, path,
                                         args.page_tokens))
    if path == "fused":
        extra["engine_parity"] = check_fused_engines(
            model, params, args.page_tokens, vocab)
    trace = serve.make_trace(args, opts, vocab)
    if label in LONG_REQUESTS:
        trace.append(long_request(trace, args, vocab, *LONG_REQUESTS[label]))
    if len(trace) < MIN_SLICE_REQUESTS or args.max_gen <= args.slice_len:
        raise SystemExit(f"{label}: {len(trace)} requests of max_gen "
                         f"{args.max_gen} over slices of {args.slice_len}")
    extra["prompt_tokens"] = sum(r.input_len for r in trace)
    if paged:
        extra["pool_pages"] = engines[0].allocator.n_pages
    L = cfg.n_layers
    recorders = ((StepRecorder(cfg), PrefillRecorder()) if paged else
                 (StageRecorder(cfg.ssm_chunk),) if path == "ssm" else ())
    with contextlib.ExitStack() as stack:
        for rec in recorders:
            stack.enter_context(rec)
        summary = serve_trace(
            label, engines,
            lambda: (core.run(trace, args.duration), trace), extra)
    if paged and (summary["prefix_hit_tokens"] <= 0
                  or summary["reprefill_tokens"]):
        raise SystemExit(f"{label}: prefix hits "
                         f"{summary['prefix_hit_tokens']} tokens, re-prefill "
                         f"{summary['reprefill_tokens']} tokens")
    if not paged and summary["reprefill_tokens"] <= 0:
        raise SystemExit(f"{label}: nothing re-prefilled, but requests of up "
                         f"to {args.max_gen} tokens outlive slices of "
                         f"{args.slice_len}")
    check_launches(label, summary, PATH_KERNELS[path])
    record = {}
    if paged:
        record["step"] = dict(recorders[0].typical(), arch=cfg.name)
        record["writes"] = [dict(st, arch=cfg.name) for st in
                            recorded_writes(label, recorders[1], summary)]
        profile_window(engines[0], vocab)
    elif path == "ssm":
        record["stages"] = recorders[0].stages
        if len(record["stages"]) != summary["prefill_stages"]:
            raise SystemExit(f"{label}: {len(record['stages'])} scan stages "
                             f"recorded, {summary['prefill_stages']} run")
        summary.update(check_long_prefill(model, params))
    log(f"{label}: {cfg.name} set up in {t_build:.1f} s (weights, the fixed "
        f"estimator, engines), served in {summary['wall_s']:.1f} s")
    return summary, record


def time_calls(obj, names) -> dict:
    """Wrap each method ``names`` of ``obj`` to count its calls and sum
    their wall seconds, the card synchronised before and after each."""
    acc = {n: {"calls": 0, "s": 0.0} for n in names}
    for n in names:
        def timed(*a, _fn=getattr(obj, n), _acc=acc[n], **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*a, **kw)
            torch.cuda.synchronize()
            _acc["calls"] += 1
            _acc["s"] += time.perf_counter() - t0
            return out
        setattr(obj, n, timed)
    return acc


def stream_chunks(handle, core) -> list:
    """Consume ``handle.tokens()`` (it drives the core); the tokens that
    arrive at one core time came with one slice, so each such run is one
    chunk."""
    chunks, at = [], None
    for tok in handle.tokens():
        if core.now != at:
            chunks.append([])
            at = core.now
        chunks[-1].append(int(tok))
    return chunks


def run_launcher_path() -> dict:
    """Phase 16: the launcher's serving path at full width.  The
    launcher's ``parse_args`` and ``build_server`` build codeqwen1.5-7b
    (bf16, random weights, cut to 16 of its 32 layers: ``DEPTH_CUTS``)
    behind ``SliceServer`` with
    ``scls-pred``, the proxy predictor's MLP on the card, metrics, the
    decision audit and a Chrome trace (``--trace-out``).  With every kernel
    count at 0 the server replays the CodeFuse trace (two shared-prefix
    pairs), takes one interactive request mid-run and streams it slice by
    slice, drains, then serves a two-turn ``Session`` (turn 2 resends turn
    1's prompt and output plus a 16-token tail) and closes it.  Fails
    unless every request completes, the streamed tokens equal the
    handle's, turn 2 joins at least turn 1's whole pages, closing the
    session gives back every page it held, the exported trace passes
    ``scripts/validate_obs.py`` and rebuilds ``core.batch_log``, the audit
    holds a batch and an offload entry for each dispatch, the proxy lives
    on the card, and only paged_decode_attention, paged_prefill_write and
    flash_prefill launch, once per layer per decode step / (stage-A)
    prefill stage."""
    import asyncio
    import importlib.util
    import numpy as np
    from repro_torch.launch import serve
    label = "launcher_path"
    cfg, opts = serve.parse_args(LAUNCHER_ARGV
                                 + ["--trace-out", LAUNCHER_TRACE])
    os.makedirs(os.path.dirname(LAUNCHER_TRACE), exist_ok=True)
    t0 = time.perf_counter()
    with served_depth(serve):
        server, vocab = serve.build_server(cfg)
    core = server.core
    engines = core.backend.engines
    pred = core.predictor
    devices = {p.device.type for p in pred.mlp.parameters()}
    if pred.name != "proxy" or devices != {"cuda"}:
        raise SystemExit(f"{label}: predictor {pred.name} on {devices}, not "
                         f"the proxy on the card")
    pred_timers = time_calls(pred, ("predict_remaining", "observe"))
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    model = engines[0].model
    pg = cfg.page_tokens
    trace = serve.make_trace(cfg, opts, vocab)
    rng = np.random.default_rng(5)
    turn1 = rng.integers(2, vocab, size=SESSION_TURN1).astype(np.int32)
    tail = rng.integers(2, vocab, size=SESSION_TAIL).astype(np.int32)
    seen = {}

    async def two_turns():
        s = server.aio.session(max_gen=cfg.max_gen)
        h1 = await s.submit_turn(turn1, gen_len=SESSION_GEN)
        await h1.result()
        hits = core.prefix_hit_tokens
        h2 = await s.submit_turn(tail, gen_len=SESSION_GEN)
        await h2.result()
        seen["turn2_hit_tokens"] = core.prefix_hit_tokens - hits
        seen["free_with_anchor"] = core.backend.free_blocks()
        await s.close()
        return h1, h2

    def drive():
        server.replay(trace)
        live = serve.submit_interactive(server, cfg, vocab,
                                        gen_len=2 * cfg.slice_len + 8)
        chunks = stream_chunks(live, core)
        streamed = [t for c in chunks for t in c]
        if streamed != live.output_tokens or not live.done:
            raise SystemExit(f"{label}: streamed {len(streamed)} tokens, "
                             f"the handle holds {len(live.output_tokens)}")
        if len(chunks) < -(-live.request.gen_len // cfg.slice_len):
            raise SystemExit(f"{label}: {live.request.gen_len} tokens "
                             f"streamed in {len(chunks)} chunks over slices "
                             f"of {cfg.slice_len}")
        seen["served"] = server.drain(cfg.duration)
        seen["chunks"] = [len(c) for c in chunks]
        seen["free_before_session"] = core.backend.free_blocks()
        h1, h2 = asyncio.run(two_turns())
        seen["free_after_session"] = core.backend.free_blocks()
        seen["turn1_tokens"] = len(turn1) + len(h1.output_tokens)
        if not np.array_equal(h2.request.prompt, np.concatenate(
                [turn1, np.asarray(h1.output_tokens, np.int32), tail])):
            raise SystemExit(f"{label}: turn 2's prompt is not turn 1's "
                             f"prompt and output plus the tail")
        return (server.drain(cfg.duration),
                trace + [live.request, h1.request, h2.request])

    extra = dict(arch=model.cfg.name, path="unfused", build_s=t_build,
                 strategy=cfg.strategy, predictor=pred.name)
    summary = serve_trace(label, engines, drive, extra)
    check_launches(label, summary, PATH_KERNELS["unfused"])
    whole = (seen["turn1_tokens"] - 1) // pg * pg
    if seen["turn2_hit_tokens"] < whole:
        raise SystemExit(f"{label}: turn 2 joined "
                         f"{seen['turn2_hit_tokens']} prefix tokens, turn "
                         f"1's whole pages hold {whole}")
    free = [sum(seen[k]) for k in ("free_before_session",
                                   "free_with_anchor", "free_after_session")]
    if free[2] != free[0] or free[1] >= free[0]:
        raise SystemExit(f"{label}: free blocks {seen['free_before_session']}"
                         f" before the session, {seen['free_with_anchor']} "
                         f"with its anchor, {seen['free_after_session']} "
                         f"after release_session")
    paths = serve.export_trace(cfg, server)
    subprocess.run([sys.executable,
                    os.path.join(ROOT, "scripts", "validate_obs.py"),
                    paths[0], "--decisions", paths[1]], check=True)
    spec = importlib.util.spec_from_file_location(
        "validate_obs", os.path.join(ROOT, "scripts", "validate_obs.py"))
    validate_obs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(validate_obs)
    with open(paths[0]) as f:
        trace_events = json.load(f)
    batch_log = json.loads(json.dumps(core.batch_log))
    if validate_obs.trace_slice_log(trace_events) != batch_log:
        raise SystemExit(f"{label}: the trace's slice spans do not rebuild "
                         f"the dispatch log")
    audit = core.obs.audit
    n_static = sum(1 for e in batch_log if e[0] == "static")
    n_batch = len(audit.query(kind="batch"))
    n_offload = len(audit.query(kind="offload"))
    if not n_batch == n_offload == n_static or \
            len(audit) >= audit.capacity:
        raise SystemExit(f"{label}: audit holds {n_batch} batch and "
                         f"{n_offload} offload entries for {n_static} "
                         f"dispatches ({len(audit)} of {audit.capacity})")
    served = seen["served"]
    ms = {n: a["s"] / max(a["calls"], 1) * 1e3
          for n, a in pred_timers.items()}
    reading = dict(
        card=card_reading(), requests=served.n_requests,
        throughput=served.throughput, p99_response=served.p99_response,
        ttft_mean=served.ttft_mean, makespan=served.makespan,
        calibration_scale=core.calibrator.scale,
        empirical_coverage=core.calibrator.empirical_coverage(),
        proxy_ms=ms, proxy_calls={n: a["calls"]
                                  for n, a in pred_timers.items()},
        stream_chunks=seen["chunks"],
        turn2_hit_tokens=seen["turn2_hit_tokens"],
        turn1_tokens=seen["turn1_tokens"],
        free_blocks=free,
        trace_events=len(trace_events["traceEvents"]),
        audit_entries=len(audit), dispatches=n_static)
    print(json.dumps({label + "_reading": reading}), flush=True)
    log(f"{label}: {served.n_requests} requests at {served.throughput:.4f} "
        f"req/s, p99 {served.p99_response:.2f} s, TTFT "
        f"{served.ttft_mean:.2f} s; proxy {ms['predict_remaining']:.3f} ms "
        f"a prediction, {ms['observe']:.3f} ms an update on the card; "
        f"{reading['trace_events']} trace events, {len(audit)} audit entries")
    summary.update(reading)
    return summary


# ---------------------------------------------------------------------------
# phase 20: a fleet of two instances behind the router launcher
# ---------------------------------------------------------------------------
#: phase 20's instances: minitron-4b at full width and depth on the
#: persistent paged unfused path at pages of 32 slots (B1 at pg 32), one
#: worker and a 15 GB KV budget each, each fronted by the HTTP front end on
#: an ephemeral port; the configs' trace cut from 6 s of arrivals to 5
#: (the script passed 800 s with its 6 s: two instances' loops share the
#: interpreter lock, so the phase's wall follows the trace's length)
FLEET_ARGV = (CONFIG_ARGV + ["--arch", "minitron-4b"] + PAGED_KV
              + ["--page-tokens", "32", "--m-available", "15e9",
                 "--http-port", "0", "--duration", "5"])
FLEET_INSTANCES = 2
#: phase 20's chat conversations: (session id, turn 1's and turn 2's user
#: text); turn 1 renders to several pages of 32 byte tokens
FLEET_SESSIONS = (
    (101, "Explain slice-level scheduling: how does cutting generation "
          "into fixed slices make a batch's serving time predictable, and "
          "what does it cost?", "And the memory side?"),
    (102, "Why does a fleet router place whole requests by the load each "
          "instance reports, and when should a session stay where its "
          "pages are?", "What breaks if it moves?"))
#: tokens each chat turn generates, and how long a client waits for one
#: response (seconds)
FLEET_CHAT_TOKENS, FLEET_TIMEOUT = 24, 300
#: how long the router waits for an instance's ``/healthz`` (seconds): an
#: instance answers it on the event loop that runs its engine, so a poll
#: waits out the slice in flight (~1-4 s here, with two instances' loops
#: sharing one host), past the launcher's default of 2 s
FLEET_POLL_TIMEOUT = 30


def http_call(url: str, body=None, method: str = "GET"):
    """(status, raw body) of one request; any status but 200 fails the
    phase."""
    import urllib.error
    import urllib.request
    data = None if body is None else json.dumps(body).encode()
    headers = {"Content-Type": "application/json"} if data else {}
    req = urllib.request.Request(url, data=data, headers=headers,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=FLEET_TIMEOUT) as resp:
            raw = resp.read()
    except urllib.error.HTTPError as e:
        raise SystemExit(f"fleet: {method} {url} answered {e.code}: "
                         f"{e.read()[:300]!r}")
    return raw


def http_json(url: str, body=None, method: str = "GET") -> dict:
    return json.loads(http_call(url, body, method))


def sse_events(raw: bytes) -> list:
    """The ``data:`` payloads of a Server-Sent Events body."""
    return [e[len("data: "):] for e in raw.decode().split("\n\n")
            if e.startswith("data: ")]


def spy_submissions(front) -> list:
    """Record every request ``front`` admits: (wall time, prompt tokens,
    handle), appended on its scheduler loop."""
    seen = []
    submit = front._submit

    async def recorded(kw):
        handle = await submit(kw)
        seen.append((time.time(), tuple(int(t) for t in kw["prompt"]),
                     handle))
        return handle

    front._submit = recorded
    return seen


def start_router(urls) -> tuple:
    """``python -m repro_torch.launch.route`` over ``urls`` on an ephemeral
    port (retention_affinity), as a child process: (process, its URL, the
    queue of its output lines)."""
    import queue
    import re
    import threading
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    argv = [sys.executable, "-m", "repro_torch.launch.route", "--port", "0",
            "--placer", "retention_affinity", "--duration", "1800",
            "--poll-timeout", str(FLEET_POLL_TIMEOUT)]
    for url in urls:
        argv += ["--instance", url]
    proc = subprocess.Popen(argv, cwd=ROOT, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    lines = queue.Queue()

    def pump():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    threading.Thread(target=pump, daemon=True).start()
    while True:
        try:
            line = lines.get(timeout=120)
        except queue.Empty:
            proc.kill()
            raise SystemExit("fleet: the router printed no listening line "
                             "in 120 s")
        if line is None:
            raise SystemExit(f"fleet: the router exited with "
                             f"{proc.wait()} before listening")
        found = re.search(r"listening on (http://\S+)", line)
        if found:
            log(f"fleet: {line.strip()}")
            return proc, found.group(1), lines


def stop_router(proc, lines) -> dict:
    """Interrupt the router (it prints its stats as it exits, as at the
    end of ``--duration``) and return the stats it printed."""
    import queue
    import signal
    proc.send_signal(signal.SIGINT)
    try:
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    out = []
    while True:
        try:
            line = lines.get(timeout=10)
        except queue.Empty:
            break
        if line is None:
            break
        out.append(line)
    text = "".join(out)
    if proc.returncode != 0 or "[route] routed" not in text:
        raise SystemExit(f"fleet: the router exited with {proc.returncode}"
                         f": {text[-2000:]}")
    head, _, tail = text.partition("[route] routed")
    log(f"fleet: [route] routed{tail.splitlines()[0]}")
    return json.loads(tail[tail.index("\n") + 1:])


def find_request(spies, prompt) -> tuple:
    """(instance index, admission time, handle) of the one request whose
    prompt is ``prompt``."""
    key = tuple(int(t) for t in prompt)
    hits = [(i, t, h) for i, seen in enumerate(spies)
            for t, p, h in list(seen) if p == key]
    if len(hits) != 1:
        raise SystemExit(f"fleet: {len(hits)} instances admitted a "
                         f"{len(key)}-token prompt, not one")
    return hits[0]


def run_fleet() -> dict:
    """Phase 20: two minitron-4b instances (``FLEET_ARGV``), each built by
    the launcher's ``parse_args`` and ``build_server`` and fronted by its
    HTTP front end as ``serve_http`` fronts it (``serve.start_http``),
    both in this process, behind ``python -m repro_torch.launch.route``
    (a child process).  With every kernel count at 0 the configs' trace
    goes through the router at its arrival times (token-id prompts on
    ``/v1/completions``, every third one streamed); once half of it is
    placed one instance is drained (``/fleet/drain``); then two chat
    conversations of two turns each (``/v1/chat/completions`` with
    ``session``), each closed with ``DELETE /v1/sessions/<id>``.  Fails
    unless every request is answered 200 and completes, each streamed
    request's chunks join to its tokens in at least one chunk a slice,
    both instances took requests before the drain and the drained one
    none after it, each turn 2 lands on its turn 1's instance and joins
    at least its whole pages, closing a session gives back every page it
    held, the router counts every request with no eviction and no retry,
    and only the unfused kernels launch, once per layer per decode step /
    (stage-A) prefill stage, summed over the two instances' engines."""
    import concurrent.futures
    import numpy as np
    from repro_torch.fleet import imbalance
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serving.tokenizer import for_vocab, render_chat
    label = "fleet"
    t_phase = time.perf_counter()
    insts = []
    try:
        for _ in range(FLEET_INSTANCES):
            cfg, opts = serve.parse_args(FLEET_ARGV)
            t0 = time.perf_counter()
            server, vocab = serve.build_server(cfg)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            front = serve.start_http(cfg, server, vocab)
            insts.append(dict(cfg=cfg, server=server, front=front,
                              url=front.url, build_s=build_s,
                              spy=spy_submissions(front)))
        cfg, pg = insts[0]["cfg"], insts[0]["cfg"].page_tokens
        engines = [e for inst in insts
                   for e in inst["server"].core.backend.engines]
        model = engines[0].model
        trace = serve.make_trace(cfg, opts, vocab)
        urls = [inst["url"] for inst in insts]
        router, router_url, router_lines = start_router(urls)
        try:
            timers = [time_engine(e) for e in engines]
            for e in engines:
                e.n_prefill_stages = e.n_tail_prefill_stages = 0
                e.n_decode_steps = e.n_loops = 0
            spies = [inst["spy"] for inst in insts]
            ops.reset_counts()
            t0 = time.perf_counter()

            def send(i, req):
                time.sleep(max(0.0, t0 + req.arrival - time.perf_counter()))
                body = dict(prompt=[int(t) for t in req.prompt],
                            max_tokens=int(req.gen_len),
                            stream=i % 3 == 0)
                return http_call(router_url + "/v1/completions", body,
                                 "POST")

            with concurrent.futures.ThreadPoolExecutor(len(trace)) as pool:
                futures = [pool.submit(send, i, r)
                           for i, r in enumerate(trace)]
                # the router's own count: an instance admits a request
                # only between its engine's slices, well after placement
                half = len(trace) // 2
                while http_json(router_url + "/metrics.json")[
                        "n_requests"] < half:
                    if any(f.done() and f.exception() for f in futures):
                        break
                    time.sleep(0.02)
                drained = urls[-1]
                t_drain_sent = time.time()
                http_call(router_url + "/fleet/drain", {"url": drained},
                          "POST")
                t_drain = time.time()
                raws = [f.result() for f in futures]
            trace_wall = time.perf_counter() - t0
            n_chunks, n_streamed = [], 0
            for i, (req, raw) in enumerate(zip(trace, raws)):
                _, _, h = find_request(spies, req.prompt)
                if not h.done:
                    raise SystemExit(f"{label}: request {i} did not "
                                     f"complete")
                toks = list(h.output_tokens)
                if i % 3 == 0:
                    events = sse_events(raw)
                    final = json.loads(events[-2])
                    chunks = [json.loads(e)["choices"][0]["text"].split()
                              for e in events[:-2]]
                    got = [int(t) for c in chunks for t in c]
                    if events[-1] != "[DONE]" or got != toks or \
                            len(chunks) < -(-len(toks) // cfg.slice_len) or \
                            final["usage"]["completion_tokens"] != len(toks):
                        raise SystemExit(
                            f"{label}: request {i} streamed {len(got)} "
                            f"tokens in {len(chunks)} chunks, its handle "
                            f"holds {len(toks)}")
                    n_chunks.append(len(chunks))
                    n_streamed += 1
                else:
                    body = json.loads(raw)
                    choice = body["choices"][0]
                    got = [int(t) for t in choice["text"].split()]
                    if got != toks or choice["finish_reason"] not in (
                            "length", "stop") or \
                            body["usage"]["completion_tokens"] != len(toks):
                        raise SystemExit(f"{label}: request {i} answered "
                                         f"{len(got)} tokens, its handle "
                                         f"holds {len(toks)}")
                if not toks or len(toks) > req.gen_len:
                    raise SystemExit(f"{label}: request {i} generated "
                                     f"{len(toks)} of {req.gen_len} tokens")
            places = http_json(router_url
                               + "/debug/placements?kind=fleet_place")
            places = places["events"]
            before = {u: sum(1 for e in places if e["instance"] == u
                             and e["ts"] < t_drain_sent) for u in urls}
            after = sum(1 for e in places
                        if e["instance"] == drained and e["ts"] > t_drain)
            if min(before.values()) < 1 or after:
                raise SystemExit(f"{label}: placements before the drain "
                                 f"{before}, {after} on {drained} after it")

            tok = for_vocab(vocab)
            sessions = []
            for sid, text1, text2 in FLEET_SESSIONS:
                free0 = [http_json(u + "/healthz")["free_blocks"]
                         for u in urls]
                msgs = [{"role": "user", "content": text1}]
                r1 = http_json(router_url + "/v1/chat/completions",
                               dict(messages=msgs, session=sid,
                                    max_tokens=FLEET_CHAT_TOKENS), "POST")
                p1 = tok.encode(render_chat(msgs))
                i1, _, h1 = find_request(spies, p1)
                hits0 = http_json(urls[i1] + "/metrics.json")[
                    "prefix_hit_tokens"]
                msgs += [{"role": "assistant",
                          "content": r1["choices"][0]["message"]["content"]},
                         {"role": "user", "content": text2}]
                http_json(router_url + "/v1/chat/completions",
                          dict(messages=msgs, session=sid,
                               max_tokens=FLEET_CHAT_TOKENS), "POST")
                p2 = tok.encode(render_chat(msgs))
                i2, _, h2 = find_request(spies, p2)
                hit = http_json(urls[i2] + "/metrics.json")[
                    "prefix_hit_tokens"] - hits0
                held = http_json(urls[i1] + "/healthz")["free_blocks"]
                released = http_json(router_url + f"/v1/sessions/{sid}",
                                     method="DELETE")["released"]
                free1 = [http_json(u + "/healthz")["free_blocks"]
                         for u in urls]
                resident = list(p1) + list(h1.output_tokens)[:-1]
                common = 0
                while common < min(len(resident), len(p2)) and \
                        resident[common] == p2[common]:
                    common += 1
                whole = min(common, len(p2) - 1) // pg * pg
                if i2 != i1 or not h1.done or not h2.done or \
                        hit < whole or whole < len(p1) // pg * pg or \
                        not whole:
                    raise SystemExit(
                        f"{label}: session {sid}: turns on instances {i1} "
                        f"and {i2}, turn 2 joined {hit} prefix tokens of "
                        f"{whole} in whole pages ({len(p1)}-token turn 1)")
                if not released or free1 != free0 or \
                        sum(held) >= sum(free0[i1]):
                    raise SystemExit(
                        f"{label}: session {sid}: free blocks {free0} "
                        f"before, {held} on instance {i1} with its anchor, "
                        f"{free1} after DELETE (released {released})")
                sessions.append(dict(session=sid, instance=i1,
                                     turn1_tokens=len(p1),
                                     turn2_tokens=len(p2),
                                     turn2_hit_tokens=hit, whole=whole,
                                     free_blocks=[free0[i1], held,
                                                  free1[i1]]))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = ops.launches()
            plain = dict(ops.plain_calls)
            metrics = [http_json(u + "/metrics.json") for u in urls]
        finally:
            stats = stop_router(router, router_lines)
    finally:
        for inst in insts:
            inst["front"].shutdown(drain=True)
    n_posts = len(trace) + 2 * len(FLEET_SESSIONS)
    if stats["n_requests"] != n_posts or \
            sum(stats["placements"].values()) != n_posts or \
            stats["evictions"] or stats["retries"]:
        raise SystemExit(f"{label}: the router's stats {stats} for "
                         f"{n_posts} requests")
    if any(plain.values()):
        raise SystemExit(f"{label}: plain versions ran on the card: {plain}")
    steps = sum(e.n_decode_steps for e in engines)
    decode_s = sum(a["decode_s"] for a in timers)
    summary = dict(
        n_requests=n_posts, n_completed=sum(m["n_completed"]
                                            for m in metrics),
        wall_s=wall, trace_wall_s=trace_wall,
        prefill_stages=sum(e.n_prefill_stages for e in engines),
        tail_prefill_stages=sum(e.n_tail_prefill_stages for e in engines),
        decode_steps=steps, loops=sum(e.n_loops for e in engines),
        decode_ms_per_step=decode_s / max(steps, 1) * 1e3,
        launches=launches, plain_calls=plain,
        n_layers=kernel_layers(model.cfg),
        prefix_hit_tokens=sum(m["prefix_hit_tokens"] for m in metrics),
        reprefill_tokens=sum(m["reprefill_tokens"] for m in metrics),
        arch=model.cfg.name, path="unfused", page_tokens=pg)
    if summary["n_completed"] != n_posts:
        raise SystemExit(f"{label}: {summary['n_completed']} of {n_posts} "
                         f"requests completed")
    check_launches(label, summary, PATH_KERNELS["unfused"])
    served = stats["served_tokens"]
    reading = dict(
        card=card_reading(), instances=urls, drained=drained,
        requests=stats["placements"], served_tokens=served,
        imbalance=imbalance(served),
        placed_before_drain=before,
        throughput=[m["throughput"] for m in metrics],
        p99_response=[m["p99_response"] for m in metrics],
        ttft_mean=[m["ttft_mean"] for m in metrics],
        build_s=[inst["build_s"] for inst in insts],
        streamed=n_streamed, stream_chunks=n_chunks, sessions=sessions,
        router=stats, phase_wall_s=time.perf_counter() - t_phase)
    print(json.dumps({label + "_reading": reading}), flush=True)
    print(json.dumps({label: summary}), flush=True)
    log(f"{label}: {n_posts} requests through the router "
        f"({stats['placements']}), imbalance {reading['imbalance']:.3f}, "
        f"{steps} decode steps at {summary['decode_ms_per_step']:.2f} ms, "
        f"phase {reading['phase_wall_s']:.1f} s")
    summary.update(reading)
    return summary


def check_fused_engines(model, params, pg: int, vocab: int) -> dict:
    """Small fused and unfused engines on the launcher's model serve the
    same batches: three slices with retention, then a prompt that joins
    two of a resident's pages.  The streams must be equal, but for
    near-ties: where they part, the dense plain path's top-2 logits for
    that token lie within ``REF_TOL`` of its largest |logit| (the paths'
    stated disagreement); each such tie is recorded and the rest of that
    stream, now conditioned on other tokens, is not compared."""
    import numpy as np
    from repro_torch.engine.static_engine import StaticEngine
    from repro_torch.testing import prefill_logits, stream_tie
    rng = np.random.default_rng(3)
    engines = {impl: StaticEngine(model, params, eos_id=1, len_bucket=8,
                                  kv_layout="paged", page_tokens=pg,
                                  kv_pool_tokens=256 * pg, attn_impl=impl,
                                  device="cuda")
               for impl in ("unfused", "fused")}
    ps = [rng.integers(2, vocab, size=n).astype(np.int32)
          for n in (40, 33, 57, 21)]
    totals = [40, 24, 32, 16]
    outs = {impl: [[] for _ in ps] for impl in engines}
    while any(len(o) < t for o, t in zip(outs["unfused"], totals)):
        idx = [i for i in range(len(ps))
               if len(outs["unfused"][i]) < totals[i]]
        kw = dict(forced_gen_lens=[totals[i] - len(outs["unfused"][i])
                                   for i in idx],
                  already_generated=[list(outs["unfused"][i]) for i in idx])
        for impl, eng in engines.items():
            res = eng.serve_batch_paged([ps[i] for i in idx], 16, idx, **kw)
            for s, i in enumerate(idx):
                outs[impl][i].extend(res.results[s]["tokens"])
    joiner = np.concatenate([ps[2][:2 * pg], ps[3][:9]])
    for impl, eng in engines.items():
        res = eng.serve_batch_paged([joiner], 16, [10], forced_gen_lens=[16])
        if res.prefix_hit_tokens != 2 * pg:
            raise SystemExit(f"fused engine check: the {impl} joiner hit "
                             f"{res.prefix_hit_tokens} prefix tokens, not "
                             f"{2 * pg}")
        outs[impl].append(res.results[0]["tokens"])
    ps.append(joiner)
    ties, n_equal = [], 0
    ref_logits = prefill_logits(model, params)
    for p, want, got in zip(ps, outs["unfused"], outs["fused"]):
        gap = stream_tie(ref_logits, p, want, got, rel_tol=REF_TOL)
        if gap is None:
            n_equal += 1
        else:
            ties.append(dict(prompt=len(p), gap=gap))
    for eng in engines.values():
        for rid in list(range(len(ps) - 1)) + [10]:
            eng.release_request(rid)
        if eng.allocator.free_blocks != eng.allocator.n_pages:
            raise SystemExit("fused engine check: pages leaked")
    log(f"fused engines: {n_equal} of {len(ps)} streams equal to the "
        f"unfused engine's, near-ties {ties}")
    return dict(streams=len(ps), streams_equal=n_equal, near_ties=ties)


def run_ils(scls: dict, steps: dict) -> dict:
    """Phase 8: the paper's ILS baseline at full width.  llama3.2-1b with
    the launcher's seeded weights; the smoke trace's 40 prompts go to
    ``ContinuousEngine.serve`` with their output lengths forced and
    ``max_gen`` 256, on a dense engine (16 slots of 1280) and a paged one
    (64 rows over the same 16 x 1280 token budget in 16-token pages).
    Every request must complete, the paged engine must run more rows at
    once, its allocator must end where it began, and only flash_prefill
    (once per layer per join) and the layout's decode kernel (once per
    layer per decode iteration) may launch.  Returns the launches of the
    dense and paged runs; the paged run's typical decode iteration goes to
    ``steps["ils"]``."""
    from repro_torch.engine.continuous_engine import ContinuousEngine
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.registry import get_model
    args, opts = serve.parse_args(DENSE_ARGV)
    model = get_model(served_config("llama3.2-1b"))
    params = model.init(args.seed, device="cuda")
    trace = serve.make_trace(args, opts, model.cfg.vocab_size)
    prompts = [r.prompt for r in trace]
    forced = [r.gen_len for r in trace]
    max_gen, W, L = 256, 1280, model.cfg.n_layers
    runs, launches_by_run = {}, {}
    for layout, kw, decode in (
            ("dense", dict(max_slots=16), "decode_attention"),
            ("paged", dict(max_slots=64, kv_layout="paged", page_tokens=16,
                           total_kv_tokens=16 * W),
             "paged_decode_attention")):
        eng = ContinuousEngine(model, params, max_context=W, eos_id=1,
                               len_bucket=16, device="cuda", **kw)
        free0 = eng.alloc.free_blocks if eng.alloc is not None else None
        torch.cuda.synchronize()
        ops.reset_counts()
        t0 = time.perf_counter()
        with StepRecorder(model.cfg if layout == "paged" else None) as rec:
            res = eng.serve(prompts, forced_gen_lens=forced, max_gen=max_gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launches()
        n_tokens = sum(len(o) for o in res.outputs)
        bad = [i for i, o in enumerate(res.outputs)
               if len(o) != min(forced[i], max_gen)
               and not (o and o[-1] == eng.eos_id)]
        runs[layout] = dict(
            wall_s=wall, iterations=res.iterations,
            joins=eng.n_prefill_stages, decode_steps=eng.n_decode_steps,
            mean_parallel=res.mean_parallel, peak_parallel=res.peak_parallel,
            tokens=n_tokens, tokens_per_s=n_tokens / wall,
            ms_per_iteration=wall / max(res.iterations, 1) * 1e3,
            launches=launches, plain_calls=dict(ops.plain_calls),
            free_pages_before_after=(None if free0 is None
                                     else [free0, eng.alloc.free_blocks]))
        if bad or len(res.outputs) != len(trace):
            raise SystemExit(f"ILS {layout}: requests {bad} ended short of "
                             f"their length without EOS")
        if any(ops.plain_calls.values()):
            raise SystemExit(f"ILS {layout}: plain versions ran on the card")
        expect = {k: 0 for k in launches}
        expect["flash_prefill"] = L * eng.n_prefill_stages
        expect[decode] = L * eng.n_decode_steps
        if launches != expect or eng.n_prefill_stages != len(trace):
            raise SystemExit(f"ILS {layout}: launches {launches} != {expect} "
                             f"implied by {eng.n_prefill_stages} joins and "
                             f"{eng.n_decode_steps} decode iterations")
        if eng.alloc is not None and eng.alloc.free_blocks != free0:
            raise SystemExit(f"ILS paged: {eng.alloc.free_blocks} pages free "
                             f"after serving, {free0} before")
        launches_by_run[layout] = launches
        if layout == "paged":
            steps["ils"] = dict(rec.typical(), arch=model.cfg.name)
        log(f"ILS {layout}: {len(trace)}/{len(trace)} requests, "
            f"{res.iterations} iterations, parallel mean "
            f"{res.mean_parallel:.3f} peak {res.peak_parallel}, "
            f"{n_tokens} tokens in {wall:.3f} s, launches as implied")
        del eng
        release_cuda()
    if not runs["paged"]["peak_parallel"] > runs["dense"]["peak_parallel"]:
        raise SystemExit("ILS: the paged engine ran no more rows at once "
                         "than the dense one")
    n_tokens = runs["dense"]["tokens"]
    beside = {label: dict(wall_s=sm["wall_s"], tokens_per_s=n_tokens
                          / sm["wall_s"], avg_batch=sm.get("avg_batch_size"),
                          throughput=sm["throughput"])
              for label, sm in scls.items()}
    print(json.dumps({"ils": dict(requests=len(trace), max_gen=max_gen,
                                  runs=runs, scls_beside=beside)}),
          flush=True)
    return launches_by_run


def check_long_prefill(model, params) -> dict:
    """Phase 9's last check: a full-width Mamba-2 prefill of a 300-token
    prompt, whose two full chunks sum dt·|A| past ln(float32 max) in layer
    0 (where the JAX oracle gives NaN, ROADMAP C2), must give finite
    logits.  Returns the readings."""
    import math
    import numpy as np
    from repro_torch.models import mamba2
    from repro_torch.models.common import embed_apply, rms_norm, softplus
    cfg = model.cfg
    dev = params.embed.table.device
    rng = np.random.default_rng(7)
    T = 300
    toks = torch.from_numpy(rng.integers(2, cfg.vocab_size, size=(1, T))
                            .astype(np.int32)).to(dev)
    lens = torch.tensor([T], dtype=torch.int32, device=dev)
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": toks,
                                               "lengths": lens}, 0)
        # layer 0's per-chunk sums of dt·|A| over the chunk-padded prompt
        mixer = params.layers[0].mixer
        h = embed_apply(params.embed, toks, cfg)
        h, valid, lead = mamba2._pad_to_chunk(
            h, torch.ones((1, T), dtype=torch.bool, device=dev),
            cfg.ssm_chunk)
        _, _, dt = mamba2._split_zxbcdt(
            mixer, rms_norm(h, params.layers[0].ln, cfg.norm_eps), cfg)
        dt = softplus(dt.float() + mixer.dt_bias) * valid[..., None]
        sums = (dt * torch.exp(mixer.A_log)).reshape(
            -1, cfg.ssm_chunk, cfg.ssm_n_heads).sum(1)
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(logits).all()) and \
        bool(torch.isfinite(cache.state).all())
    over = int((sums > math.log(torch.finfo(torch.float32).max)).sum())
    log(f"mamba slice: a {T}-token prefill ({lead} lead pads, "
        f"{(T + lead) // cfg.ssm_chunk} chunks) gives finite logits and "
        f"states: {finite}; layer 0's largest chunk sum of dt*|A| "
        f"{sums.max().item():.1f}, {over} of {sums.numel()} (chunk, head) "
        f"sums past ln(float32 max) = 88.72")
    if not (finite and logits.shape == (1, cfg.vocab_size)):
        raise SystemExit("mamba slice: the full-width prefill past two "
                         "chunks is not finite")
    return dict(c2_prompt_tokens=T, c2_layer0_max_chunk_sum=sums.max().item(),
                c2_layer0_overflow_chunk_heads=over)


# ---------------------------------------------------------------------------
# phase 10: the paged decode kernels at the engines' own decode steps
# ---------------------------------------------------------------------------
def capturing() -> bool:
    """Whether this thread's current stream is capturing a CUDA graph
    (never without a card)."""
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


class StepRecorder:
    """Inside ``with``, wraps ``engine.graphs.Step.__call__`` (one decode
    iteration of a ``ContinuousEngine``: a CUDA graph's replay, or its
    capture) and ``engine.graphs.Loop.__call__`` (a ``StaticEngine``
    slice's whole decode loop: one replay) and keeps a copy of each decode
    iteration's index inputs, rebuilt from the static buffers after the
    call: block table, slot_pos (marking the new token), write slots and
    q_pos, with a layer's pool shape.  A ``ContinuousEngine`` step's are
    its own buffers; a paged ``StaticEngine`` loop's iteration j (of the
    steps the loop read back) has q_pos = slots = its rows' lengths + j
    and slot_pos marking slots below lengths + j + 1 (the compact layout:
    slot == position).  Calls made while a stream captures are not
    recorded (their buffers hold nothing yet).  ``cfg`` None records
    nothing."""

    def __init__(self, cfg):
        self.cfg, self.steps = cfg, []

    def _paged(self, cache) -> bool:
        return (self.cfg is not None and hasattr(cache, "block_table")
                and not capturing())

    def _keep(self, cache, slot_pos, slots, q_pos) -> None:
        cfg = self.cfg
        self.steps.append(dict(
            bt=cache.block_table.clone(), slot_pos=slot_pos,
            slots=slots.to(torch.int32, copy=True),
            q_pos=q_pos.to(torch.int32, copy=True),
            pool=tuple(cache.k_pages.shape[1:]), Hq=cfg.n_heads,
            window=cfg.sliding_window))

    def __enter__(self):
        from repro_torch.engine import graphs
        step_call = self._step_call = graphs.Step.__call__
        loop_call = self._loop_call = graphs.Loop.__call__

        def recording_step(step):
            step_call(step)
            b = step.bufs
            cache = b.get("cache")
            if "wslots" in b and self._paged(cache):
                self._keep(cache, cache.slot_pos.clone(), b["wslots"],
                           b["q_pos"])

        def recording_loop(loop):
            out = loop_call(loop)
            cache = loop.bufs.get("cache")
            if self._paged(cache):
                lengths = cache.lengths.long()
                slots = torch.arange(cache.slot_pos.shape[1],
                                     device=lengths.device)[None]
                for j in range(int(out["step"])):
                    self._keep(cache, torch.where(
                        slots < (lengths + j + 1)[:, None], slots,
                        -1).to(torch.int32), lengths + j, lengths + j)
            return out

        graphs.Step.__call__ = recording_step
        graphs.Loop.__call__ = recording_loop
        return self

    def __exit__(self, *exc):
        from repro_torch.engine import graphs
        graphs.Step.__call__ = self._step_call
        graphs.Loop.__call__ = self._loop_call

    def typical(self) -> dict:
        """The recorded step whose live slots are the median of the run's
        (the upper median), with the run's statistics: rows of the batch,
        rows with pages of their own (the others are batch pads or idle
        rows on the null page), live slots, the longest row."""
        if not self.steps:
            raise SystemExit("no paged decode step was recorded")
        live = torch.stack([(st["slot_pos"] >= 0).sum()
                            for st in self.steps]).tolist()
        own = torch.stack([(st["bt"] != 0).any(dim=1).sum()
                           for st in self.steps]).tolist()
        i = sorted(range(len(live)), key=live.__getitem__)[len(live) // 2]
        st = self.steps[i]
        n = len(live)
        stats = dict(step=i, steps=n, rows=st["bt"].shape[0],
                     own_rows=own[i], live_slots=live[i],
                     longest_row=int((st["slot_pos"] >= 0).sum(1).max()),
                     slots=st["slot_pos"].shape[1],
                     mean_rows=sum(s["bt"].shape[0] for s in self.steps) / n,
                     mean_own_rows=sum(own) / n, mean_live_slots=sum(live) / n)
        if st["window"] is not None:
            raise SystemExit("phase 10 times the decode kernels without a "
                             "window, but the engine ran one")
        return dict(st, stats=stats)


class StageRecorder:
    """Inside ``with``, wraps ``engine.graphs.Loop.__call__`` (a dense
    ``StaticEngine`` slice: the Mamba-2 prefill, whose scan runs once per
    layer, then the decode loop, in one replay) and keeps the shape of
    each slice's prefill stage, rebuilt from the loop's static inputs:
    rows B, tokens T (the bucketed length, left-padded to a whole chunk as
    the model pads it) and each row's valid tokens (its static length; a
    batch-bucket pad row holds the one pad token the engine gives it).
    Calls made while a stream captures are not recorded."""

    def __init__(self, chunk: int):
        self.chunk, self.stages = chunk, []

    def __enter__(self):
        from repro_torch.engine import graphs
        orig = self._orig = graphs.Loop.__call__

        def recording(loop):
            out = orig(loop)
            b = loop.bufs
            if loop.head is not None and "lengths" in b and \
                    not capturing():
                B, L = b["tokens"].shape
                self.stages.append(dict(
                    B=B, T=-(-L // self.chunk) * self.chunk,
                    chunk=self.chunk, lengths=b["lengths"].tolist()))
            return out

        graphs.Loop.__call__ = recording
        return self

    def __exit__(self, *exc):
        from repro_torch.engine import graphs
        graphs.Loop.__call__ = self._orig


def timed_stages(stages: list) -> list:
    """(label, stage, statistics) of the recorded stages phase 11 times:
    the median stage by B x T (the upper median) and the largest, with the
    run's statistics."""
    if not stages:
        raise SystemExit("no Mamba-2 prefill stage was recorded")
    size = [st["B"] * st["T"] for st in stages]
    order = sorted(range(len(stages)), key=size.__getitem__)
    n = len(stages)
    stats = dict(stages=n, mean_rows=sum(st["B"] for st in stages) / n,
                 mean_tokens=sum(st["T"] for st in stages) / n,
                 max_T=max(st["T"] for st in stages),
                 mean_valid_tokens=sum(sum(st["lengths"])
                                       for st in stages) / n)
    out = []
    for name, i in (("median", order[n // 2]), ("largest", order[-1])):
        st = stages[i]
        out.append((f"{name} stage {st['B']}x{st['T']}", st,
                    dict(stats, stage=i, B_x_T=size[i])))
    return out


def check_ssd_stages(stages: list, row: dict) -> None:
    """Phase 11: B7 at the Mamba-2 slice's own prefill stages (the median
    by B x T and the largest), random float32 inputs with the stages' pads,
    held against the plain version and timed as in phase 3; the entries
    (with the run's statistics) join B7's ``shapes``."""
    from repro_torch.configs import get_config
    cfg = get_config("mamba2-130m")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for label, st, stats in timed_stages(stages):
        log(f"ssd_scan {label}: the engine's stage {stats}")
        entry = hold_ssd_scan(cfg, st["lengths"], st["T"], gen, flush, label)
        entry["engine_stage"] = stats
        row["shapes"].append(entry)
        row["max_abs_err"] = max(row["max_abs_err"], entry["max_abs_err"])
        row["max_rel_err"] = max(row["max_rel_err"], entry["max_rel_err"])
        release_cuda()


# ---------------------------------------------------------------------------
# phase 12: the prefill writes at the slices' own prefill stages
# ---------------------------------------------------------------------------
#: the prefill write kernels, by whether they rotate K
WRITES = ("paged_prefill_write", "fused_rope_prefill_write")


class PrefillRecorder:
    """Inside ``with``, wraps ``engine.graphs.Prefill.__call__`` (a paged
    engine's prefill stage, stage A or a stage-A' tail: one replay that
    runs the prefill write once per layer) and keeps each stage's index
    inputs, rebuilt from the prefill's static buffers: the kernel (by the
    bucket's ``attn_impl``), the positions the model gives the write
    (``transformer.make_positions`` of the tokens and lengths, shifted
    past the shared prefix for a tail), the block table and a layer's
    pool shape; on exit they move to the host with the stage's rows,
    tokens, valid tokens and whether a row starts past a shared prefix (a
    tail).  Calls made while a stream captures are not recorded, nor the
    joins' prefills (``ContinuousEngine``: no paged write)."""

    def __init__(self):
        self.stages = []

    def __enter__(self):
        from repro_torch.engine import graphs
        from repro_torch.models.transformer import make_positions
        orig = self._orig = graphs.Prefill.__call__

        def recording(pre):
            orig(pre)
            b = pre.bufs
            if pre.kind not in ("prefill", "tail") or capturing():
                return
            start = b.get("start")
            if start is None:
                pos = make_positions(b["tokens"], b["lengths"])
            else:
                base = make_positions(b["tokens"], b["lengths"] - start)
                pos = torch.where(base >= 0, base + start[:, None],
                                  -1).to(torch.int32)
            self.stages.append(dict(
                kernel=WRITES[pre.key[1] == "fused"],
                positions=pos, bt=b["block_table"].clone(),
                pool=tuple(b["cache"].k_pages.shape[1:])))

        graphs.Prefill.__call__ = recording
        return self

    def __exit__(self, *exc):
        from repro_torch.engine import graphs
        graphs.Prefill.__call__ = self._orig
        for st in self.stages:
            pos = st["positions"] = st["positions"].cpu()
            st["bt"] = st["bt"].cpu()
            valid = pos >= 0
            first = torch.where(valid, pos, torch.iinfo(torch.int32).max)
            st.update(B=pos.shape[0], T=pos.shape[1],
                      valid=int(valid.sum()),
                      tail=bool((first.min(dim=1).values[valid.any(1)]
                                 > 0).any()))


def timed_writes(stages: list) -> list:
    """(label, stage, statistics) of the recorded write stages phase 12
    times: the median stage by valid tokens (the upper median) and the
    largest, with the run's statistics."""
    if not stages:
        raise SystemExit("no paged prefill stage was recorded")
    order = sorted(range(len(stages)), key=lambda i: stages[i]["valid"])
    n = len(stages)
    stats = dict(stages=n, tail_stages=sum(st["tail"] for st in stages),
                 mean_rows=sum(st["B"] for st in stages) / n,
                 mean_tokens=sum(st["T"] for st in stages) / n,
                 mean_valid_tokens=sum(st["valid"] for st in stages) / n)
    out = []
    for name, i in (("median", order[n // 2]), ("largest", order[-1])):
        st = stages[i]
        out.append((f"{name} stage {st['B']}x{st['T']}", st,
                    dict(stats, stage=i, valid=st["valid"], tail=st["tail"])))
    return out


#: (kernel, recorded run) of phase 12: each write at its own llama3.2-1b
#: slice's stages
ENGINE_WRITES = (("paged_prefill_write", "slice"),
                 ("fused_rope_prefill_write", "fused_slice"))
#: (kernel, recorded run) of phase 12 after phases 13-14: each write at its
#: own slice's stages, codeqwen1.5-7b's and minitron-4b's heads
CONFIG_WRITES = (("paged_prefill_write", "codeqwen_slice"),
                 ("fused_rope_prefill_write", "minitron_fused_slice"))


def check_write_stages(writes: dict, rows: dict, cases) -> None:
    """Phase 12: each ``cases`` kernel (``ENGINE_WRITES``,
    ``CONFIG_WRITES``) at its slice's median and largest recorded prefill
    stage (index tensors as recorded, random pools of the engine's size
    and random K/V at the slice's heads), held against its plain version
    and timed as in phase 3 beside an empty launch; the entries (with the
    run's statistics) join the kernel's ``shapes``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import fused_rope_prefill_write as fkmod
    from repro_torch.kernels import paged_prefill_write as kmod
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    empty = empty_launch_ms(flush)
    log(f"empty launch: {empty:.4f} ms")
    for name, run in cases:
        fused = name == "fused_rope_prefill_write"
        rows[name]["empty_launch_ms"] = empty
        for label, st, stats in timed_writes(writes[run]):
            if st["kernel"] != name:
                raise SystemExit(f"phase 12: the {run} stage ran "
                                 f"{st['kernel']}, not {name}")
            cfg = get_config(st["arch"])
            P, pg = st["pool"][:2]
            log(f"{name} {run} {label}: the engine's stage {stats}")
            entry = hold_write((kmod, fkmod), cfg,
                               paged_pools(cfg, P - 1, pg, gen),
                               st["positions"].cuda(), st["bt"].cuda(), gen,
                               flush, f"{run} {label}", fused)
            entry.update(empty_launch_ms=empty, engine_stage=stats)
            rows[name]["shapes"].append(entry)
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                            entry["max_abs_err"])
            if fused:
                rows[name]["max_ulps"] = max(rows[name]["max_ulps"],
                                             entry["max_ulps"])
            release_cuda()


#: (kernel, recorded run) of phase 10: each paged decode kernel at its own
#: llama3.2-1b slice's typical step, and both at the paged ILS engine's
#: (the fused kernel appending where the engine's write went)
ENGINE_STEPS = (("paged_decode_attention", "slice"),
                ("paged_decode_attention", "ils"),
                ("fused_rope_decode_append", "fused_slice"),
                ("fused_rope_decode_append", "ils"))
#: (kernel, recorded run) of phase 10 after phases 13-14: each paged decode
#: kernel at its own slice's typical step, codeqwen1.5-7b's (MHA) and
#: minitron-4b's (3 query heads a KV head) heads
CONFIG_STEPS = (("paged_decode_attention", "codeqwen_slice"),
                ("fused_rope_decode_append", "minitron_fused_slice"))


def step_inputs(cfg, step: dict, gen: torch.Generator, fused: bool):
    """(label, pools, args) of a recorded step: random pools of the
    engine's size, random q (and k/v_new), the step's own index tensors."""
    dev = torch.device("cuda")
    P, pg, Hkv, D = step["pool"]
    k_pages, v_pages = (torch.randn(step["pool"], generator=gen,
                                    device=dev).to(cfg.dtype)
                        for _ in range(2))
    bt, slot_pos = step["bt"].to(dev), step["slot_pos"].to(dev)
    slots, q_pos = step["slots"].to(dev), step["q_pos"].to(dev)
    B = bt.shape[0]
    q = torch.randn((B, step["Hq"], D), generator=gen,
                    device=dev).to(cfg.dtype)
    label = f"{B}x{slot_pos.shape[1]}"
    if not fused:
        return label, (k_pages, v_pages), (q, bt, slot_pos, q_pos)
    k_new, v_new = (torch.randn((B, Hkv, D), generator=gen,
                                device=dev).to(cfg.dtype) for _ in range(2))
    return label, (k_pages, v_pages), (q, k_new, v_new, bt, slot_pos, slots,
                                       q_pos)


def check_engine_steps(steps: dict, rows: dict, cases) -> None:
    """Phase 10: each ``cases`` kernel (``ENGINE_STEPS``, ``CONFIG_STEPS``)
    on its recorded step's index tensors at the step's model's heads,
    held against its plain version and timed as in phase 3; the entries
    (with the run's statistics) join the kernel's ``shapes``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import fused_rope_decode_append as fkmod
    from repro_torch.kernels import paged_decode_attention as kmod
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for name, run in cases:
        fused = name == "fused_rope_decode_append"
        cfg = get_config(steps[run]["arch"])
        shape, (k_pages, v_pages), args = step_inputs(cfg, steps[run], gen,
                                                      fused)
        label = f"{run} {shape}"
        log(f"{name} {label}: the engine's step {steps[run]['stats']}")
        if fused:
            entry = hold_fused_decode(fkmod, kmod, k_pages, v_pages, args,
                                      cfg.rope_theta, flush, label)
            rows[name]["max_ulps"] = max(rows[name]["max_ulps"],
                                         entry["max_ulps"])
        else:
            entry = hold_paged_decode(kmod, k_pages, v_pages, args, flush,
                                      label)
        entry["engine_step"] = steps[run]["stats"]
        rows[name]["shapes"].append(entry)
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                        entry["max_abs_err"])
        del k_pages, v_pages, args
        release_cuda()


def host_steps(steps: dict) -> dict:
    """The recorded decode steps with their tensors on the host."""
    return {run: {k: (v.cpu() if torch.is_tensor(v) else v)
                  for k, v in st.items()} for run, st in steps.items()}


def save_steps(steps: dict, stages: list, writes: dict, path: str) -> None:
    """The recorded decode steps (on the host), under ``ssd_stages`` the
    Mamba-2 prefill stages and under ``write_stages`` the paged slices'
    prefill stages, for ``scripts/compare_attention.py --steps``."""
    torch.save(dict(steps, ssd_stages=stages, write_stages=writes), path)


def release_cuda() -> None:
    """Free the engines (and their page pools) that went out of scope."""
    gc.collect()
    torch.cuda.empty_cache()


def dev_us(event) -> float:
    """An event of ``torch.profiler``'s ``key_averages`` -> its own device
    time in microseconds (the attribute's name differs across versions)."""
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def profile_window(engine, vocab: int) -> None:
    """One slice of 8 fresh 256-token requests, 32 decode steps, under
    ``torch.profiler``: the device's busy share of the window's wall time
    and the kernel time by name."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(2)
    ps = [rng.integers(2, vocab, size=256).astype(np.int32)
          for _ in range(8)]
    for warm in (True, False):
        rids = [10 ** 6 + i + (0 if warm else 100) for i in range(8)]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = engine.serve_batch_paged(ps, 32, rids,
                                           forced_gen_lens=[32] * 8)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        for rid in rids:
            engine.release_request(rid)
    events = prof.key_averages()
    busy = sum(dev_us(e) for e in events) / 1e6
    top = sorted(events, key=dev_us, reverse=True)[:8]
    print(json.dumps({"profile": dict(
        model=engine.model.cfg.name, attn_impl=engine.attn_impl, rows=8,
        prompt_tokens=256,
        steps=res.steps, wall_s=wall,
        prefill_s=res.prefill_time, device_busy_s=busy,
        device_busy_share=busy / wall,
        top_kernels_ms={e.key[:80]: dev_us(e) / 1e3 for e in top})}),
        flush=True)


# ---------------------------------------------------------------------------
# phase 21: the frontend families through dense SCLS (extra_inputs)
# ---------------------------------------------------------------------------
#: the slice length of phase 21 (SCLS re-prefills at every reschedule)
FRONTEND_SLICE_LEN = 32
#: phase 21's requests per arch: prompt lengths, forced output lengths
#: (rows end in different slices of 32), the source frames of each
#: request (the encoder-decoder; right-padded to the longest in a batch)
#: and one more request served alone (frames, prompt, forced), the dry
#: run's serving shape of 4096 frames
FRONTEND_SERVE = {
    "paligemma-3b": dict(
        label="paligemma_slice", prompts=(16, 96, 40, 72, 25, 60, 88, 33),
        forced=(16, 64, 40, 33, 24, 64, 50, 20)),
    "seamless-m4t-large-v2": dict(
        label="seamless_slice", prompts=(2, 8, 5, 3, 7, 4, 6, 2),
        forced=(16, 96, 40, 70, 33, 64, 90, 25),
        frames=(1024, 256, 700, 512, 900, 333, 640, 480),
        alone=(4096, 4, 40))}
#: phase 21's reference check: left-padded prompt lengths (and the
#: encoder-decoder's source frames, padded to the longest) and decode steps
FRONTEND_CHECK = dict(lens=(40, 33, 17, 48), dec_lens=(8, 5, 2, 7),
                      frames=(300, 256, 120, 40), steps=4)


@contextlib.contextmanager
def swapped(state: dict, key: str, value):
    """Inside ``with``, ``state[key]`` is ``value``; the old one after."""
    old = state[key]
    state[key] = value
    try:
        yield
    finally:
        state[key] = old


def check_vlm_logits(model, params) -> dict:
    """Phase 4 for the VLM: one prefill of 4 left-padded text prompts
    behind 256 seeded patch embeddings each, and 4 greedy decode steps,
    through ``transformer.prefill`` / ``decode_step`` (flash_prefill with
    the prefix, decode_attention), each step's last-token logits held
    against ``transformer.forward`` of the same prefix and tokens (plain
    torch attention under the prefix-LM mask, no cache) to ``REF_TOL``.
    Control fault (``hold_logits``): ``causal_prefix``, the model served
    with ``n_prefix_tokens`` 0, so its image prefix attends causally."""
    import numpy as np
    from repro_torch.models import transformer as tfm
    cfg = model.cfg
    dev = params.embed.table.device
    lens, n_steps = FRONTEND_CHECK["lens"], FRONTEND_CHECK["steps"]
    tokens, lengths = left_padded(cfg, lens, dev)
    B, T = tokens.shape
    pre = torch.from_numpy(frontend_extra(
        cfg, B, np.random.default_rng(21))["prefix_embeds"]).to(dev)
    P = pre.shape[1]
    state = {"cfg": cfg}

    def serve(cache_fault=None, fed=None) -> tuple:
        """(each step's logits, the tokens fed): greedy, or ``fed``'s."""
        c = state["cfg"]
        logits, cache = tfm.prefill(params, c, tokens, lengths,
                                    T + P + n_steps, prefix_embeds=pre)
        out, toks = [logits], []
        for step in range(n_steps):
            cur = (fed[:, step].contiguous() if fed is not None
                   else torch.argmax(out[-1].float(), -1).to(torch.int32))
            toks.append(cur)
            logits, cache = tfm.decode_step(params, c, cache, cur, step)
            out.append(logits)
        return out, torch.stack(toks, 1)

    with torch.no_grad():
        served, fed = serve()
        seq = torch.cat([tokens, fed], dim=1)
        text = tfm.make_positions(seq, lengths + n_steps)
        pos = torch.cat([torch.arange(P, dtype=torch.int32,
                                      device=dev)[None].expand(B, P),
                         torch.where(text >= 0, text + P, -1)],
                        dim=1).to(torch.int32)
        full = tfm.forward(params, cfg, seq, pos, prefix_embeds=pre)
        refs = [full[:, P + T - 1 + j].float() for j in range(n_steps + 1)]
        del full
    faults = {"causal_prefix": (swapped(state, "cfg", cfg.replace(
        n_prefix_tokens=0)), None)}
    return hold_logits(
        f"{cfg.name} (prefix {P})", served, refs,
        lambda cache_fault: serve(cache_fault, fed)[0], faults, REF_TOL,
        f"prefill ({B} rows of a {P}-patch prefix and up to {T} text "
        f"tokens) + {n_steps} decode steps")


def check_encdec_logits(model, params) -> dict:
    """Phase 4 for the encoder-decoder: one prefill of 4 left-padded
    decoder prompts over sources of ``FRONTEND_CHECK["frames"]`` valid
    frames (right-padded with invalid, still random, frames), and 4 greedy
    decode steps, through ``encdec.prefill`` / ``decode_step`` (the
    encoder and decoder self-attention on flash_prefill, decode_attention
    for self- and cross-attention), each step's last-token logits held
    against ``encdec.forward`` (plain torch, no cache) of each row alone,
    its own source and unpadded tokens, to ``REF_TOL``.  Control fault
    (``hold_logits``): ``cross_mask``, cross-attention that ignores
    ``src_valid`` (every frame seen, at prefill and at decode)."""
    import numpy as np
    from repro_torch.models import attention as attn
    from repro_torch.models import encdec
    cfg = model.cfg
    dev = params.embed.table.device
    lens, n_steps = FRONTEND_CHECK["dec_lens"], FRONTEND_CHECK["steps"]
    tokens, lengths = left_padded(cfg, lens, dev)
    B, T = tokens.shape
    src = {k: torch.from_numpy(v).to(dev) for k, v in frontend_extra(
        cfg, B, np.random.default_rng(22), FRONTEND_CHECK["frames"]).items()}

    def serve(cache_fault=None, fed=None) -> tuple:
        logits, cache = model.prefill(params, dict(
            tokens=tokens, lengths=lengths, **src), T + n_steps)
        out, toks = [logits], []
        for step in range(n_steps):
            cur = (fed[:, step].contiguous() if fed is not None
                   else torch.argmax(out[-1].float(), -1).to(torch.int32))
            toks.append(cur)
            logits, cache = model.decode_step(params, cache, cur, step)
            out.append(logits)
        return out, torch.stack(toks, 1)

    with torch.no_grad():
        served, fed = serve()
        seq = torch.cat([tokens, fed], dim=1)
        rows = []
        for b, n in enumerate(lens):
            full = encdec.forward(params, cfg, src["src_embeds"][b:b + 1],
                                  seq[b:b + 1, T - n:],
                                  src["src_valid"][b:b + 1])
            rows.append(full[0, n - 1:].float())
            del full
        refs = [torch.stack([r[j] for r in rows]) for j in range(n_steps + 1)]
    cross = encdec._cross_attend

    @contextlib.contextmanager
    def ignoring_src_valid():
        with mock.patch.object(
                encdec, "_cross_attend", lambda layer, x, ck, cv, valid, c:
                cross(layer, x, ck, cv, torch.ones_like(valid), c)), \
                mock.patch.object(attn, "cross_slot_pos", lambda valid:
                                  torch.zeros(valid.shape, dtype=torch.int32,
                                              device=valid.device)):
            yield

    faults = {"cross_mask": (ignoring_src_valid(), None)}
    return hold_logits(
        f"{cfg.name} (frames {list(FRONTEND_CHECK['frames'])})", served,
        refs, lambda cache_fault: serve(cache_fault, fed)[0], faults,
        REF_TOL, f"encoder + prefill ({B} rows of up to {T} tokens) + "
        f"{n_steps} decode steps")


def serve_frontend(model, params, ps, forced, extra: dict,
                   counts: dict) -> tuple:
    """SCLS over slices of ``FRONTEND_SLICE_LEN`` through the JAX
    package's entry point for these families, ``StaticEngine(model,
    params, extra_inputs=...).serve_batch``: each slice batches the
    unfinished requests, builds a dense engine over their rows of
    ``extra`` and re-prefills prompt + generated (the encoder re-runs).
    Adds the engines' prefill stages, decode steps, re-prefill tokens,
    slices decoded through a ``graphs.Loop``, wall seconds and
    decode-loop seconds (``time_engine``) to ``counts``; returns the
    streams."""
    from repro_torch.engine.static_engine import StaticEngine
    outs = [[] for _ in ps]
    while True:
        idx = [i for i in range(len(ps)) if len(outs[i]) < forced[i]]
        if not idx:
            return outs
        if counts["slices"] > 16:
            raise SystemExit(f"{model.cfg.name}: requests unfinished after "
                             f"{counts['slices']} slices")
        eng = StaticEngine(model, params, eos_id=1, len_bucket=8,
                           extra_inputs={k: v[idx] for k, v in extra.items()},
                           device="cuda")
        timer = time_engine(eng)
        res = eng.serve_batch(
            [ps[i] for i in idx], FRONTEND_SLICE_LEN,
            forced_gen_lens=[forced[i] - len(outs[i]) for i in idx],
            already_generated=[outs[i] for i in idx])
        for s_, i in enumerate(idx):
            outs[i] = outs[i] + res.results[s_]["tokens"]
        counts["prefill_stages"] += eng.n_prefill_stages
        counts["decode_steps"] += eng.n_decode_steps
        counts["loops"] += eng.n_loops
        counts["reprefill_tokens"] += res.reprefill_tokens
        counts["slices"] += 1
        counts["engine_s"] += res.wall_time
        counts["decode_s"] += timer["decode_s"]


def run_frontend_family(arch: str) -> dict:
    """Phase 21 for ``arch`` (paligemma-3b or seamless-m4t-large-v2) at
    full width and depth, bf16, random weights from a seeded
    ``torch.Generator``: its served path held against its plain forward
    with a control fault (``check_vlm_logits`` / ``check_encdec_logits``),
    then ``FRONTEND_SERVE[arch]``'s requests with seeded frontend
    embeddings through dense SCLS (``serve_frontend``), and the enc-dec
    model's request of 4096 frames alone.  Every request must get its
    forced tokens (ids in the vocabulary), re-prefill must be above 0,
    and the kernels launch as the stages and steps imply: flash_prefill
    once a layer per prefill stage (the enc-dec model's encoder layers
    too, with its prefix), decode_attention once a layer per decode step
    (twice a decoder layer in the enc-dec model: its cross-attention
    calls counted apart), no plain version; the launches with a prefix
    and the cross-attention launches must be above 0."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_prefill as pkmod
    from repro_torch.kernels import ops
    from repro_torch.models import attention as attn
    from repro_torch.models.registry import get_model
    cfg = get_config(arch)
    spec = FRONTEND_SERVE[arch]
    label = spec["label"]
    t0 = time.perf_counter()
    model = get_model(cfg)
    params = model.init(0, device="cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    weights_gib = sum(p.numel() * p.element_size()
                      for p in params.parameters()) / 2 ** 30
    log(f"{label}: {cfg.name} at full width and depth ({weights_gib:.2f} "
        f"GiB of bf16 weights) built in {t_build:.1f} s")
    held = (check_encdec_logits if cfg.family == "encdec"
            else check_vlm_logits)(model, params)
    release_cuda()
    rng = np.random.default_rng(23)
    ps = [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
          for n in spec["prompts"]]
    jobs = [(ps, list(spec["forced"]),
             frontend_extra(cfg, len(ps), rng, spec.get("frames")))]
    if "alone" in spec:
        frames, n_prompt, n_gen = spec["alone"]
        jobs.append(([rng.integers(2, cfg.vocab_size, size=n_prompt)
                      .astype(np.int32)], [n_gen],
                     frontend_extra(cfg, 1, rng, [frames])))
    counts = dict(prefill_stages=0, decode_steps=0, loops=0,
                  reprefill_tokens=0, slices=0, engine_s=0.0, decode_s=0.0)
    # each call on the card launches B6 once; counted on the device, so
    # that a captured decode step counts its calls at every replay
    calls = torch.zeros((), dtype=torch.int64, device="cuda")
    cross_attend = attn.cross_decode_attend

    def counted(*a, **kw):
        calls.add_(1)
        return cross_attend(*a, **kw)

    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad(), mock.patch.object(attn, "cross_decode_attend",
                                            counted):
        outs = [serve_frontend(model, params, p, f, x, counts)
                for p, f, x in jobs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, prefix = ops.launches(), pkmod.prefix_launches
    cross = {"calls": int(calls)}
    plain = dict(ops.plain_calls)
    for (p, f, _), out in zip(jobs, outs):
        for i, toks in enumerate(out):
            if len(toks) != f[i] or not all(0 <= t < cfg.vocab_size
                                            for t in toks):
                raise SystemExit(f"{label}: request {i} of {len(p)} gave "
                                 f"{len(toks)} of {f[i]} tokens, or ids "
                                 f"outside the vocabulary")
    stages, steps = counts["prefill_stages"], counts["decode_steps"]
    if cfg.family == "encdec":
        want = {"flash_prefill": (cfg.n_enc_layers + cfg.n_dec_layers)
                * stages, "decode_attention": 2 * cfg.n_dec_layers * steps}
        want_prefix = cfg.n_enc_layers * stages
        want_cross = cfg.n_dec_layers * steps
    else:
        want = {"flash_prefill": cfg.n_layers * stages,
                "decode_attention": cfg.n_layers * steps}
        want_prefix, want_cross = cfg.n_layers * stages, 0
    want["graph_loop"] = steps + counts["loops"]
    want = {k: want.get(k, 0) for k in launches}
    n_req = sum(len(p) for p, _, _ in jobs)
    summary = dict(arch=cfg.name, path="dense", n_requests=n_req,
                   n_completed=n_req, build_s=t_build,
                   weights_gib=weights_gib, wall_s=wall,
                   decode_ms_per_step=counts["decode_s"] / max(
                       counts["decode_steps"], 1) * 1e3,
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   launches=launches, plain_calls=plain,
                   prefix_launches=prefix, cross_launches=cross["calls"],
                   prompt_tokens=sum(len(x) for p, _, _ in jobs for x in p),
                   **counts, **held)
    print(json.dumps({label: summary}), flush=True)
    if launches != want or prefix != want_prefix or \
            cross["calls"] != want_cross or any(plain.values()):
        raise SystemExit(f"{label}: launches {launches} (with a prefix "
                         f"{prefix}, cross-attention {cross['calls']}) != "
                         f"{want} ({want_prefix}, {want_cross}) implied by "
                         f"{stages} prefill stages and {steps} decode steps, "
                         f"or plain versions ran: {plain}")
    if counts["reprefill_tokens"] <= 0:
        raise SystemExit(f"{label}: nothing re-prefilled over "
                         f"{counts['slices']} slices")
    log(f"{label}: {n_req}/{n_req} requests over {counts['slices']} slices "
        f"of {FRONTEND_SLICE_LEN} in {wall:.1f} s, "
        f"{summary['decode_ms_per_step']:.2f} ms a decode step, re-prefill "
        f"{counts['reprefill_tokens']} tokens, launches {launches} as "
        f"implied (with a prefix {prefix}, cross-attention "
        f"{cross['calls']})")
    return summary


# ---------------------------------------------------------------------------
# phase 22: the training path (Model.loss, AdamW, the launcher's loop)
# ---------------------------------------------------------------------------
#: phase 22's families at their reduced float32 configs, card against CPU
TRAIN_PARITY = ("llama3.2-1b", "mamba2-130m", "deepseek-v2-lite-16b",
                "mixtral-8x22b", "recurrentgemma-9b",
                "seamless-m4t-large-v2", "paligemma-3b")
TRAIN_TOL = 1e-4             # one train step, card vs CPU (float32, TF32
                             # off): the loss relative, each updated leaf
                             # relative to its largest |value|
#: the step's AdamW: eps 1e-3, not 1e-8, so that an element whose gradient
#: lies within float32 rounding of zero does not move by ±lr on either
#: device's rounding (the update g / (|g| + eps) has slope 1/eps at 0)
TRAIN_PARITY_OPT = dict(lr=1e-2, warmup_steps=1, total_steps=3, eps=1e-3)
#: the full-width runs through the launcher's loop (bf16, full depth)
TRAIN_FULL = ("llama3.2-1b", "mamba2-130m")
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 20, 8, 128, 1e-3
#: where the llama run's checkpoint goes (removed after the round trip)
TRAIN_CKPT = os.path.join(ROOT, "build", "smoke_ckpt")


def train_parity_batch(cfg, dev) -> dict:
    """Two rows of 12 seeded tokens, with the family's frontend inputs
    (the encoder-decoder's with invalid frames in its last row)."""
    import numpy as np
    rng = np.random.default_rng(12)
    b = {"tokens": rng.integers(2, cfg.vocab_size,
                                size=(2, 12)).astype(np.int32)}
    if cfg.family == "encdec":
        b["src_embeds"] = rng.standard_normal((2, 16, cfg.d_model)).astype(
            np.float32)
        valid = np.ones((2, 16), bool)
        valid[-1, 10:] = False
        b["src_valid"] = valid
    if cfg.family == "vlm":
        b["prefix_embeds"] = rng.standard_normal(
            (2, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def leaf_gap(got, want) -> tuple:
    """(largest gap of a parameter of ``got`` from ``want``'s, relative to
    that leaf's largest |value|, and the parameter's name)."""
    ref = dict(want.named_parameters())
    return max(((p.detach().float().cpu() - ref[n].float()).abs().max().item()
                / max(ref[n].abs().max().item(), 1e-30), n)
               for n, p in got.named_parameters())


def check_train_parity(arch: str) -> dict:
    """One ``make_train_step`` of the reduced float32 ``arch`` on the card
    and on the CPU from one set of weights (drawn apart as phase 4c's) and
    one batch: the loss and every updated leaf within ``TRAIN_TOL``; then
    the card's step with AdamW's bias correction dropped (control) must
    part from the CPU's by more."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.registry import get_model
    from repro_torch.optim import adamw
    torch.backends.cuda.matmul.allow_tf32 = False  # as main sets it
    model = get_model(get_config(arch, reduced=True))
    opt_cfg = adamw.AdamWConfig(**TRAIN_PARITY_OPT)
    step = make_train_step(model, opt_cfg)
    cpu = model.init(0, device="cpu")
    perturb(cpu, model.cfg)
    start = {k: v.clone() for k, v in cpu.state_dict().items()}

    def on_card():
        card = model.init(0, device="cuda")
        card.load_state_dict(start)
        card, _, loss = step(card, adamw.init_adamw(card),
                             train_parity_batch(model.cfg, "cuda"))
        return card, float(loss)

    cpu, _, cpu_loss = step(cpu, adamw.init_adamw(cpu),
                            train_parity_batch(model.cfg, "cpu"))
    card, card_loss = on_card()
    loss_gap = abs(card_loss - float(cpu_loss)) / abs(float(cpu_loss))
    gap, worst = leaf_gap(card, cpu)
    with mock.patch.object(adamw, "bias_corrections",
                           lambda cfg, t: (1.0, 1.0)):
        faulty, _ = on_card()
    control, _ = leaf_gap(faulty, cpu)
    log(f"train step {arch} (reduced, float32), card vs CPU: loss "
        f"{card_loss:.6f} vs {float(cpu_loss):.6f} (relative "
        f"{loss_gap:.2e}), largest leaf gap {gap:.2e} ({worst}; tolerance "
        f"{TRAIN_TOL}); control, no bias correction: {control:.2e}")
    if not (loss_gap <= TRAIN_TOL and gap <= TRAIN_TOL < control):
        raise SystemExit(f"phase 22: {arch}'s train step on the card parts "
                         f"from the CPU's ({loss_gap:.2e}, {gap:.2e}) or "
                         f"its control ({control:.2e}) stays within "
                         f"{TRAIN_TOL}")
    return dict(arch=arch, loss_rel_gap=loss_gap, leaf_gap=gap,
                worst_leaf=worst, control_no_bias_correction=control)


def train_full(arch: str, card: str) -> tuple:
    """``launch.train.train`` at ``arch``'s full config (bf16, full width
    and depth) for ``TRAIN_STEPS`` steps of ``TRAIN_BATCH`` x
    ``TRAIN_SEQ`` on the card: every loss finite, every parameter finite
    after, and the mean of the last 5 losses below that of the first 5.
    Returns the run (for the checkpoint round trip) and its reading."""
    import math
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.launch.train import train
    cfg = get_config(arch)
    update_events = []
    update = steps.adamw_update

    def timed_update(*args):
        """The step's AdamW update between two CUDA events, with no host
        wait, so the step runs as the launcher's own; the events are read
        after the run."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = update(*args)
        end.record()
        update_events.append((start, end))
        return out
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(steps, "adamw_update", timed_update):
        run = train(cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                    seq=TRAIN_SEQ, lr=TRAIN_LR, log_every=5, device="cuda")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    losses, ms = run["losses"], run["step_ms"]
    warm = sorted(ms[1:])
    median = warm[len(warm) // 2]
    median_update = sorted(start.elapsed_time(end) for start, end
                           in update_events[1:])[len(warm) // 2]
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    finite = all(math.isfinite(x) for x in losses) and all(
        bool(torch.isfinite(p).all()) for p in run["params"].parameters())
    reading = dict(arch=arch, n_params=run["n_params"], steps=TRAIN_STEPS,
                   batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR,
                   dtype=str(cfg.dtype).split(".")[-1],
                   first_step_ms=ms[0], median_step_ms=median,
                   median_update_ms=median_update,
                   tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (median / 1e3),
                   max_memory_allocated=peak, loss_first5=first,
                   loss_last5=last, losses=losses, card=card)
    log(f"train {arch} (full width and depth, {reading['dtype']}, "
        f"{run['n_params'] / 1e6:.1f}M params): {TRAIN_STEPS} steps of "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}, loss {first:.4f} -> {last:.4f} "
        f"(means of the first and last 5), {median:.2f} ms a step (median "
        f"after the first, {ms[0]:.1f} ms; AdamW's update {median_update:.2f}"
        f" ms on the card's clock), {reading['tokens_per_s']:,.0f} tokens/s, "
        f"max_memory_allocated {peak / 2 ** 30:.2f} GiB; {card}")
    if not (finite and last < first):
        raise SystemExit(f"phase 22: {arch} at full width: non-finite "
                         f"losses or parameters ({finite}), or no "
                         f"improvement ({first:.4f} -> {last:.4f})")
    return run, reading


def profile_train_step(run: dict) -> dict:
    """Two more launcher steps of ``run`` on a seeded batch of
    ``TRAIN_BATCH`` x ``TRAIN_SEQ``, the second under ``torch.profiler``
    (CUDA activity only): the kernels' device time over the step's wall
    time (the device's busy share), and the kernel time by name."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import AdamWConfig
    model, params, opt = run["model"], run["params"], run["opt"]
    step = make_train_step(model, AdamWConfig(lr=TRAIN_LR))
    rng = np.random.default_rng(14)
    batch = {"tokens": torch.from_numpy(rng.integers(
        2, model.cfg.vocab_size,
        size=(TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)).cuda()}
    params, opt, loss = step(params, opt, batch)
    float(loss)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, batch)
        float(loss)
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    busy = sum(dev_us(e) for e in events) / 1e6
    top = sorted(events, key=dev_us, reverse=True)[:6]
    reading = dict(profiled_step_ms=wall * 1e3, device_busy_ms=busy * 1e3,
                   device_busy_share=busy / wall,
                   kernels=sum(e.count for e in events),
                   top_kernels_ms={e.key[:80]: dev_us(e) / 1e3 for e in top})
    log(f"train {model.cfg.name}: one step under the profiler "
        f"{reading['profiled_step_ms']:.2f} ms, kernels busy "
        f"{reading['device_busy_ms']:.2f} ms ({busy / wall:.1%}) over "
        f"{reading['kernels']} kernel launches")
    return reading


def check_checkpoint_round_trip(run: dict, path: str) -> dict:
    """The trained model and optimiser state of ``run``, saved to ``path``,
    load into a fresh model on the card: every leaf and the plain
    forward's logits on a fixed batch bit-equal."""
    import shutil

    import numpy as np
    from repro_torch.checkpoint.store import load_checkpoint, save_checkpoint
    from repro_torch.optim.adamw import init_adamw
    model, params, opt = run["model"], run["params"], run["opt"]
    t0 = time.perf_counter()
    save_checkpoint(path, params, opt, step=TRAIN_STEPS)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fresh = model.init(1, device="cuda")
    fresh, fresh_opt, step, _ = load_checkpoint(path, fresh,
                                                init_adamw(fresh))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))
    shutil.rmtree(path)
    trained = dict(params.named_parameters())
    equal = all(torch.equal(p, trained[n])
                for n, p in fresh.named_parameters())
    equal &= torch.equal(fresh_opt.step, opt.step) and step == TRAIN_STEPS
    for moment in ("mu", "nu"):
        a, b = getattr(fresh_opt, moment), getattr(opt, moment)
        stack = [(a, b)]
        while stack:
            x, y = stack.pop()
            if isinstance(x, dict):
                equal &= set(x) == set(y)
                stack += [(x[k], y[k]) for k in x]
            else:
                equal &= torch.equal(x, y)
    rng = np.random.default_rng(13)
    tokens = torch.from_numpy(rng.integers(
        2, model.cfg.vocab_size, size=(2, 64)).astype(np.int32)).cuda()
    from repro_torch.models import transformer
    with torch.no_grad():
        same = torch.equal(transformer.forward(params, model.cfg, tokens),
                           transformer.forward(fresh, model.cfg, tokens))
    log(f"checkpoint round trip ({model.cfg.name}, {size / 2 ** 30:.2f} "
        f"GiB on disk, saved in {save_s:.1f} s, loaded in {load_s:.1f} s): "
        f"every leaf bit-equal: {equal}; plain forward logits bit-equal: "
        f"{same}")
    if not (equal and same):
        raise SystemExit("phase 22: the checkpoint round trip changed a "
                         "leaf or the logits")
    return dict(checkpoint_bytes=size, save_s=save_s, load_s=load_s)


#: kernels whose inputs are integers and flags alone, which cannot require
#: grad: their wrappers have nothing to refuse (the decode loop's
#: condition reads the step counter and the done flags)
NO_GRAD_INPUTS = ("graph_loop",)


def kernel_guard_cases(dev):
    """(name, call) of every kernel wrapper of ``kernels.ops`` whose
    inputs can require grad (all but ``NO_GRAD_INPUTS``) on tiny CUDA
    inputs, one of which requires grad."""
    from repro_torch.kernels import ops

    def f(*shape, grad=False):
        return torch.zeros(shape, device=dev, requires_grad=grad)

    def i(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=dev)

    pages = (f(2, 4, 1, 8), f(2, 4, 1, 8))
    return (
        ("paged_prefill_write", lambda: ops.paged_prefill_write(
            f(1, 4, 1, 8, grad=True), f(1, 4, 1, 8), i(1, 4), i(1, 1),
            *pages)),
        ("paged_decode_attention", lambda: ops.paged_decode_attention(
            f(1, 2, 8, grad=True), *pages, i(1, 1), i(1, 4), i(1))),
        ("fused_rope_prefill_write", lambda: ops.fused_rope_prefill_write(
            f(1, 4, 1, 8, grad=True), f(1, 4, 1, 8), i(1, 4), i(1, 1),
            *pages)),
        ("fused_rope_decode_append", lambda: ops.fused_rope_decode_append(
            f(1, 2, 8, grad=True), f(1, 1, 8), f(1, 1, 8), i(1, 1), i(1, 4),
            i(1), i(1), *pages)),
        ("flash_prefill", lambda: ops.flash_prefill(
            f(1, 4, 2, 8, grad=True), f(1, 4, 1, 8), f(1, 4, 1, 8),
            i(1, 4))),
        ("decode_attention", lambda: ops.decode_attention(
            f(1, 2, 8, grad=True), f(1, 4, 1, 8), f(1, 4, 1, 8), i(1, 4),
            i(1))),
        ("ssd_scan", lambda: ops.ssd_chunked_scan(
            f(1, 8, 2, 4, grad=True), f(1, 8, 2), f(2), f(1, 8, 1, 4),
            f(1, 8, 1, 4), chunk=8)),
    )


def check_kernel_guard() -> list:
    """Every kernel wrapper whose inputs can require grad (all but
    ``NO_GRAD_INPUTS``), called on the card with grad mode on and an input
    that requires grad, raises (the kernels have no backward) and launches
    nothing."""
    from repro_torch.kernels import ops
    refused = []
    ops.reset_counts()
    for name, call in kernel_guard_cases("cuda"):
        try:
            call()
        except RuntimeError as e:
            if "no backward" in str(e):
                refused.append(name)
    launched = {k: v for k, v in ops.launches().items() if v}
    guarded = [k for k in ops.launches() if k not in NO_GRAD_INPUTS]
    log(f"kernel guard: {len(refused)} of the {len(guarded)} wrappers whose "
        f"inputs can require grad refuse such inputs "
        f"({', '.join(refused)}); launched: {launched or 'nothing'}")
    if refused != guarded or launched:
        raise SystemExit(f"phase 22: wrappers that did not refuse a grad "
                         f"input, or launches: {refused}, {launched}")
    return refused


def run_training(card: str) -> dict:
    """Phase 22: each family's train step card against CPU, the full-width
    runs through the launcher's loop, llama's checkpoint round trip, a
    profiled step of each full-width run and the kernel guard.  Launches
    no kernel (checked)."""
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    ops.reset_counts()
    parity = [check_train_parity(arch) for arch in TRAIN_PARITY]
    release_cuda()
    full, trip = [], None
    for arch in TRAIN_FULL:
        run, reading = train_full(arch, card)
        full.append(reading)
        if arch == "llama3.2-1b":
            trip = check_checkpoint_round_trip(run, TRAIN_CKPT)
        reading["profile"] = profile_train_step(run)
        del run
        release_cuda()
    ran = {k: (n, ops.plain_calls[k]) for k, n in ops.launches().items()
           if n or ops.plain_calls[k]}
    if ran:
        raise SystemExit(f"phase 22: training reached kernel wrappers: "
                         f"{ran}")
    guard = check_kernel_guard()
    summary = dict(parity=parity, full=full, checkpoint=trip,
                   guard_refused=guard, wall_s=time.perf_counter() - t0)
    print(json.dumps({"training": summary}), flush=True)
    log(f"phase 22: {summary['wall_s']:.1f} s")
    return summary


# ---------------------------------------------------------------------------
# phase 23: scale-out (the dry-run, a real one-card mesh, bytes at a shard)
# ---------------------------------------------------------------------------
#: (a): the dry-run's combinations on the (16, 16) production mesh
SCALE_DRYRUNS = (("paligemma-3b", "train_4k"),
                 ("codeqwen1.5-7b", "decode_32k"))
SCALE_DRYRUN_DIR = os.path.join(ROOT, "build", "smoke_dryrun")
#: (b): the one-card mesh's group store, and the sharded serve's shape:
#: prompt lengths (left-padded to the longest) and greedy decode steps
SCALE_STORE = os.path.join(ROOT, "build", "smoke_nccl_store")
SCALE_PROMPTS, SCALE_STEPS = (96, 160, 224, 256), 32
#: (c): the production shard: arch, mesh, decode batch x cache length
SCALE_SHARD = ("codeqwen1.5-7b", (1, 8), 8, 2048)


def start_dryruns() -> list:
    """Phase 23 (a): one ``python -m repro_torch.launch.dryrun`` process a
    combination, the card hidden from it (it allocates nothing)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    return [(arch, shape, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--out", SCALE_DRYRUN_DIR], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for arch, shape in SCALE_DRYRUNS]


def finish_dryruns(procs, card: str) -> list:
    """Wait for phase 23 (a)'s processes; each record must be ok, with
    FLOPs and at least one collective."""
    recs = []
    for arch, shape, proc in procs:
        out = proc.communicate(timeout=600)[0]
        if proc.returncode != 0:
            raise SystemExit(f"phase 23: the dry-run of {arch} x {shape} "
                             f"failed:\n{out[-4000:]}")
        with open(os.path.join(SCALE_DRYRUN_DIR,
                               f"{arch}_{shape}_pod1.json")) as f:
            rec = json.load(f)
        if not (rec["status"] == "ok" and rec["flops_per_device"] > 0
                and rec["collectives"]):
            raise SystemExit(f"phase 23: dry-run record of {arch} x {shape}:"
                             f" {rec}")
        ok = [ln for ln in out.splitlines() if ln.startswith("OK")]
        log(f"dry-run (CPU, fake (16, 16) mesh; {rec['hardware']}; run on "
            f"{card}): {ok[0] if ok else rec['roofline']}")
        recs.append({k: rec[k] for k in (
            "arch", "shape", "status", "dominant", "roofline",
            "flops_per_device", "bytes_per_device",
            "collective_bytes_per_device", "collectives", "memory",
            "useful_flop_ratio", "trace_s", "hardware")})
    return recs


def greedy_steps(model, params, batch, steps: int, cache_window: int,
                 place=None) -> tuple:
    """``make_prefill_step`` then ``steps`` greedy ``make_decode_step``s;
    ``place`` maps the prefill's cache (the sharded run's placements).
    Returns (each row's tokens, ms a decode step: the host clock over the
    steps, synchronised at both ends)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    logits, cache = make_prefill_step(model, cache_window)(params, batch)
    if place is not None:
        cache = place(cache)
    decode = make_decode_step(model)
    toks = []
    sync = torch.cuda.synchronize if logits.is_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for s in range(steps):
        tok = logits.argmax(-1).to(torch.int32)
        toks.append(tok.full_tensor() if isinstance(tok, DTensor) else tok)
        logits, cache = decode(params, cache, tok, s)
    sync()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    return torch.stack(toks, 1).cpu().tolist(), ms


#: phase 23 (b)'s sharded serving runs: each arch with the kernels its
#: steps launch on the shards, as (kernel, launches a layer of the
#: prefill, launches a layer of a decode step)
SCALE_SERVE = {"llama3.2-1b": (("flash_prefill", 1, 0),
                               ("decode_attention", 0, 1)),
               "mamba2-130m": (("ssd_scan", 1, 0),)}


def check_sharded_serve(dev: str, mesh, arch: str = "llama3.2-1b") -> dict:
    """Phase 23 (b), serving: full-width ``arch`` (``DEPTH_CUTS``' depth)
    through the prefill and decode steps unsharded, then with params,
    batch and cache DTensors on ``mesh``; greedy tokens equal but for a
    ``stream_tie``, the kernels of ``SCALE_SERVE`` (llama: B5 and B6;
    mamba2-130m: B7 in the prefill, its decode a plain recurrence)
    launched on the shards as the steps imply."""
    import numpy as np
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding as shr
    from repro_torch.models.registry import get_model
    from repro_torch.testing import prefill_logits, stream_tie
    cfg = served_config(arch)
    model = get_model(cfg)
    plain = model.init(0, device=dev)
    rng = np.random.default_rng(23)
    T = max(SCALE_PROMPTS)
    ps = [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
          for n in SCALE_PROMPTS]
    tokens = np.zeros((len(ps), T), np.int32)
    for i, p in enumerate(ps):
        tokens[i, T - len(p):] = p
    batch = {"tokens": torch.from_numpy(tokens).to(dev),
             "lengths": torch.tensor(SCALE_PROMPTS, dtype=torch.int32,
                                     device=dev)}
    W = T + SCALE_STEPS
    want, plain_ms = greedy_steps(model, plain, batch, SCALE_STEPS, W)
    sharded = model.init(0, device=dev)
    sharded.load_state_dict(plain.state_dict())
    shr.shard_params(sharded, shr.param_specs(sharded, mesh, cfg), mesh)
    placed = shr.named(batch, shr.batch_spec(batch, mesh, len(ps)), mesh)
    ops.reset_counts()
    with implicit_replication():
        got, sharded_ms = greedy_steps(
            model, sharded, placed, SCALE_STEPS, W,
            place=lambda c: shr.named(c, shr.cache_spec(c, mesh, cfg,
                                                        len(ps)), mesh))
    if dev == "cuda":
        torch.cuda.synchronize()
    launches = ops.launches() if dev == "cuda" else dict(ops.plain_calls)
    L = cfg.n_layers
    expect = {k: 0 for k in launches}
    expect.update({name: L * (pre + SCALE_STEPS * step)
                   for name, pre, step in SCALE_SERVE[arch]})
    if launches != expect or (dev == "cuda" and any(
            ops.plain_calls.values())):
        raise SystemExit(f"phase 23: sharded serve launches {launches} != "
                         f"{expect}, plain calls {ops.plain_calls}")
    ref = prefill_logits(model, plain)
    ties = []
    for i, (p, a, b) in enumerate(zip(ps, want, got)):
        gap = stream_tie(ref, p, a, b)
        if gap is not None:
            ties.append(dict(request=i, gap=gap))
    log(f"sharded serve ({arch}, {L} layers, full width, mesh "
        f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}): {len(ps)} x "
        f"{SCALE_STEPS} greedy tokens equal to the unsharded steps' "
        f"(near-ties {ties}); launches {launches}; ms a decode step "
        f"{sharded_ms:.2f} sharded vs {plain_ms:.2f} plain (host clock, "
        f"the DTensor dispatch included)")
    return dict(arch=arch, launches=launches, near_ties=ties, rows=len(ps),
                steps=SCALE_STEPS, layers=L, ms_decode_step=sharded_ms,
                ms_decode_step_plain=plain_ms)


def check_sharded_train(dev: str, mesh) -> dict:
    """Phase 23 (b), training: one ``make_train_step`` of the reduced
    float32 llama3.2-1b unsharded and with params, AdamW state and batch
    DTensors on ``mesh``: the loss and every leaf within ``TRAIN_TOL``."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as shr
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.registry import get_model
    from repro_torch.optim import adamw
    model = get_model(get_config("llama3.2-1b", reduced=True))
    cfg = model.cfg
    step = make_train_step(model, adamw.AdamWConfig(**TRAIN_PARITY_OPT))
    plain = model.init(0, device=dev)
    perturb(plain, cfg)
    start = {k: v.clone() for k, v in plain.state_dict().items()}
    batch = {"tokens": train_parity_batch(cfg, dev)["tokens"]}
    plain, _, loss = step(plain, adamw.init_adamw(plain), batch)
    sharded = model.init(0, device=dev)
    sharded.load_state_dict(start)
    opt = adamw.init_adamw(sharded)
    shr.shard_params(sharded, shr.param_specs(sharded, mesh, cfg), mesh)
    ospecs = shr.opt_state_specs(opt, sharded, mesh, cfg)
    opt = adamw.AdamWState(step=opt.step,
                           mu=shr.named(opt.mu, ospecs.mu, mesh),
                           nu=shr.named(opt.nu, ospecs.nu, mesh))
    placed = shr.named(batch, shr.batch_spec(batch, mesh, 2), mesh)
    with implicit_replication():
        sharded, _, sloss = step(sharded, opt, placed)
    sloss = float(sloss.full_tensor() if isinstance(sloss, DTensor)
                  else sloss)
    loss_gap = abs(sloss - float(loss)) / abs(float(loss))
    ref = dict(plain.named_parameters())
    gap, worst = max((((p.full_tensor() if isinstance(p, DTensor) else p)
                       .detach().float() - ref[n].detach().float()).abs()
                      .max().item() / max(ref[n].abs().max().item(), 1e-30),
                      n) for n, p in sharded.named_parameters())
    log(f"sharded train step (reduced float32 llama3.2-1b): loss {sloss:.6f}"
        f" vs {float(loss):.6f} (relative {loss_gap:.2e}), largest leaf "
        f"gap {gap:.2e} ({worst}; tolerance {TRAIN_TOL})")
    if not (loss_gap <= TRAIN_TOL and gap <= TRAIN_TOL):
        raise SystemExit(f"phase 23: the sharded train step parts from the "
                         f"unsharded one ({loss_gap:.2e}, {gap:.2e})")
    return dict(loss_rel_gap=loss_gap, leaf_gap=gap, worst_leaf=worst)


def check_shard_bytes(dev: str) -> dict:
    """Phase 23 (c): ``SCALE_SHARD``'s arch at full width on a fake mesh
    (this process rank 0) with real tensors on ``dev``: params, a dense
    decode cache and the tokens allocated as ``launch.sharding`` places
    them hold the dry-run's ``argument_bytes`` for the same arch, shape
    and mesh; one decode step launches B6 once a layer at the local
    heads.  The fake group's collectives move nothing: shapes, launches
    and bytes are checked, not values."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.kernels import decode_attention as b6
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch import sharding as shr
    from repro_torch.launch.mesh import fake_mesh
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models.registry import get_model, skeleton
    arch, mesh_shape, B, W = SCALE_SHARD
    names = ("data", "model")
    cfg = get_config(arch)
    shape = InputShape(f"decode_{B}x{W}", W, B, "decode")
    with fake_mesh(mesh_shape, names) as mesh:
        rec = dryrun.run_one(arch, shape, False, None, mesh=mesh)
    want = rec["memory"]["argument_bytes"]
    model = get_model(cfg)
    with FakeTensorMode(allow_non_fake_inputs=True):
        template = dryrun._cache_template(model, cfg, shape, W, None)
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    with fake_mesh(mesh_shape, names, device_type=dev) as mesh:
        base = torch.cuda.memory_allocated() if dev == "cuda" else 0

        def local(_name, p, spec):
            return (torch.randn(shr.local_shape(p.shape, spec, mesh),
                                generator=gen, device=dev) * 0.02
                    ).to(p.dtype)

        params = skeleton(cfg)
        params = shr.shard_params(params, shr.param_specs(params, mesh, cfg),
                                  mesh, make=local)

        def fill(node, spec):
            if not hasattr(node, "shape"):
                if hasattr(node, "_fields"):
                    return type(node)(*(fill(getattr(node, f),
                                             getattr(spec, f))
                                        for f in node._fields))
                return node
            t = torch.zeros(shr.local_shape(node.shape, spec, mesh),
                            dtype=node.dtype, device=dev)
            if len(node.shape) == 2:  # slot_pos: a full prefill of W
                t.copy_(torch.arange(W, dtype=node.dtype))
            elif len(node.shape) == 1:  # lengths
                t.fill_(W)
            return shr.from_local(t, node.shape, spec, mesh)

        cache = fill(template, shr.cache_spec(template, mesh, cfg, B))
        tok = shr.place(torch.full((B,), 7, dtype=torch.int32, device=dev),
                        (None,), mesh)
        locals_ = [t._local_tensor for t in
                   [p for p in params.parameters()]
                   + [getattr(cache, f) for f in cache._fields
                      if isinstance(getattr(cache, f), DTensor)] + [tok]]
        got = sum(t.untyped_storage().nbytes() for t in locals_)
        allocated = (torch.cuda.memory_allocated() - base if dev == "cuda"
                     else got)
        if got != want:
            raise SystemExit(f"phase 23: placed arguments hold {got} bytes,"
                             f" the dry-run's argument_bytes {want}")
        heads = []
        real = b6.decode_attention

        def spy(q, *a, **kw):
            heads.append(q.shape[1])
            return real(q, *a, **kw)

        ops.reset_counts()
        with mock.patch.object(b6, "decode_attention", spy), \
                implicit_replication():
            logits, _ = make_decode_step(model)(params, cache, tok, 0)
        if dev == "cuda":
            torch.cuda.synchronize()
        launches = ops.launches() if dev == "cuda" else dict(ops.plain_calls)
        local_heads = cfg.n_heads // mesh_shape[1]
        if launches["decode_attention"] != cfg.n_layers or (
                dev == "cuda" and set(heads) != {local_heads}):
            raise SystemExit(f"phase 23: decode step on the {mesh_shape} "
                             f"mesh launched {launches} at heads "
                             f"{sorted(set(heads))}")
        del params, cache, tok, locals_
    log(f"bytes at a shard ({arch}, fake {mesh_shape} mesh, decode {B} x "
        f"{W}; values not checked: the fake group moves nothing): placed "
        f"arguments {got} bytes == the dry-run's argument_bytes {want} "
        f"(allocator: {allocated}); B6 launched {launches['decode_attention']}"
        f" times at {sorted(set(heads))} heads a rank")
    return dict(argument_bytes=want, placed_bytes=got,
                allocated_bytes=allocated, launches=launches,
                b6_local_heads=sorted(set(heads)), dryrun=rec)


def run_scale_out(card: str, dev: str = "cuda") -> dict:
    """Phase 23: (a) the dry-run in two child processes while (b) the real
    one-card mesh serves and trains and (c) a fake (1, 8) mesh places
    codeqwen1.5-7b's arguments.  Returns ``scls``-style entries (each
    path's launches) for the kernel line."""
    from repro_torch.launch import mesh as meshes
    t0 = time.perf_counter()
    procs = start_dryruns()
    try:
        if os.path.exists(SCALE_STORE):
            os.remove(SCALE_STORE)
        os.makedirs(os.path.dirname(SCALE_STORE), exist_ok=True)
        mesh = meshes.make_mesh((1, 1), ("data", "model"), dev,
                                init_method=f"file://{SCALE_STORE}")
        try:
            serve = check_sharded_serve(dev, mesh)
            if dev == "cuda":
                release_cuda()
            mamba = check_sharded_serve(dev, mesh, "mamba2-130m")
            train = check_sharded_train(dev, mesh)
        finally:
            meshes.teardown()
        if dev == "cuda":
            release_cuda()
        shard = check_shard_bytes(dev)
        if dev == "cuda":
            release_cuda()
        dry = finish_dryruns(procs, card)
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    summary = dict(dryrun=dry, serve=serve, serve_mamba=mamba, train=train,
                   shard_bytes={k: v for k, v in shard.items()
                                if k != "dryrun"},
                   card=card, wall_s=time.perf_counter() - t0)
    print(json.dumps({"scale_out": summary}), flush=True)
    log(f"phase 23: {summary['wall_s']:.1f} s ({card})")
    return {"sharded_slice": dict(launches=serve["launches"]),
            "sharded_mamba": dict(launches=mamba["launches"]),
            "shard_bytes": dict(launches=shard["launches"])}


# ---------------------------------------------------------------------------
# phase 24: the port's examples on the card
# ---------------------------------------------------------------------------
#: (label, the example's arguments, kernels that must launch, checks of its
#: JSON summary line)
EXAMPLES = (
    ("quickstart", ["examples/torch_quickstart.py"],
     ("flash_prefill", "decode_attention"),
     lambda r: r["parity"] == r["checked"] == 8
     and r["n_completed"] == r["n_requests"]),
    ("serving_cluster_real", ["examples/torch_serving_cluster.py",
                              "--section", "real"],
     ("paged_prefill_write", "paged_decode_attention"),
     lambda r: r["reprefill_tokens"] == 0 and r["n_completed"] == 3),
)


def run_examples(card: str) -> dict:
    """Phase 24: the ``EXAMPLES`` in child processes on the card, started
    together (the kernels' libraries already built), each one's exit
    code, its summary line's checks and its kernels' launches checked."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    procs = [(label, args, kernels, ok, subprocess.Popen(
        [sys.executable, *args], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True))
        for label, args, kernels, ok in EXAMPLES]
    out = {}
    try:
        for label, args, kernels, ok, proc in procs:
            stdout, stderr = proc.communicate(timeout=300)
            wall = time.perf_counter() - t0
            if proc.returncode != 0:
                raise SystemExit(f"phase 24: {args[0]} exited "
                                 f"{proc.returncode}:\n{stdout[-3000:]}"
                                 f"\n{stderr[-3000:]}")
            res = json.loads(stdout.strip().splitlines()[-1])
            if not ok(res) or res["device"].split(":")[0] != "cuda":
                raise SystemExit(f"phase 24: {label} failed its checks: "
                                 f"{res}")
            idle = [k for k in kernels if res["launches"][k] <= 0]
            if idle or any(res["plain_calls"].values()):
                raise SystemExit(f"phase 24: {label} launched no {idle}, "
                                 f"or took a plain version: {res}")
            out[label] = dict(wall_s=wall, example_wall_s=res["wall_s"],
                              launches={k: res["launches"][k]
                                        for k in kernels},
                              **{k: res[k] for k in ("parity", "checked",
                                                     "reprefill_tokens",
                                                     "slices") if k in res})
            log(f"phase 24: {label}: {wall:.1f} s, launches "
                f"{out[label]['launches']}")
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(json.dumps({"examples": dict(out, card=card)}), flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 25: the attention kernels at public heads outside the old instances
# ---------------------------------------------------------------------------
#: (label, n_heads, n_kv_heads, head_dim) of phase 25 (a): public models
#: whose attention the kernels refused before every head dim that is a
#: multiple of 16 up to 256 and every group ran: Phi-3-mini
#: [arXiv:2404.14219], GPT-NeoX-20B [arXiv:2204.06745], Phi-2
#: (hf:microsoft/phi-2), StarCoder2-15B [arXiv:2402.19173], Llama-3.1-405B
#: [arXiv:2407.21783], Falcon-7B [arXiv:2311.16867]
PUBLIC_HEADS = (("phi-3-mini", 32, 32, 96), ("gpt-neox-20b", 64, 64, 96),
                ("phi-2", 32, 32, 80), ("starcoder2-15b", 48, 4, 128),
                ("llama-3.1-405b", 128, 8, 128), ("falcon-7b", 71, 1, 64))
#: the attention kernels phase 25 holds at each of ``PUBLIC_HEADS``
DOMAIN_KERNELS = ("flash_prefill", "decode_attention",
                  "paged_decode_attention", "fused_rope_decode_append")
#: phase 25's dense decode shape: 8 rows over 576 slots (left pads, live
#: tokens), the last empty, as the paged kernels' ``PAGED_SMOKE``
DECODE_576 = ("8x576", ((0, 576), (16, 500), (64, 512), (5, 530),
                        (100, 400), (0, 333), (40, 520), (0, 0)), 576)
#: phase 25 (b): the engines at two of ``PUBLIC_HEADS`` on llama3.2-1b's
#: widths cut to this many layers (a config of the script, not of the
#: registry), prompts of these lengths, tokens each (two slices of 12)
PUBLIC_ENGINE_HEADS = ("phi-3-mini", "falcon-7b")
PUBLIC_LAYERS = 2
PUBLIC_PROMPTS, PUBLIC_GEN, PUBLIC_SLICE = (40, 33, 57, 21), 24, 12


def public_config(label: str, n_layers=None):
    """llama3.2-1b's config with the heads of ``PUBLIC_HEADS``' ``label``
    (and ``n_layers`` where given)."""
    from repro_torch.configs import get_config
    _, hq, hkv, d = next(h for h in PUBLIC_HEADS if h[0] == label)
    cfg = get_config("llama3.2-1b").replace(
        name=f"llama3.2-1b at {label}'s heads", n_heads=hq, n_kv_heads=hkv,
        head_dim=d)
    return cfg if n_layers is None else cfg.replace(n_layers=n_layers)


def plain_streams(model, params, ps, n: int) -> tuple:
    """Each prompt's ``n`` greedy tokens from ``transformer.forward`` (torch
    attention, no kernel, no cache) and that forward as ``stream_tie``'s
    reference (an int32 context in, its last-token logits out)."""
    from repro_torch.models import transformer as tfm
    cfg = model.cfg

    def logits_of(ctx):
        seq = torch.as_tensor(ctx, dtype=torch.int32, device="cuda")[None]
        with torch.no_grad():
            pos = tfm.make_positions(seq, torch.tensor(
                [seq.shape[1]], dtype=torch.int32, device="cuda"))
            return tfm.forward(params, cfg, seq, pos)[0, -1].float().cpu() \
                .numpy()

    streams = []
    for p in ps:
        ctx = list(p)
        for _ in range(n):
            ctx.append(int(logits_of(ctx).argmax()))
        streams.append(ctx[len(p):])
    return streams, logits_of


def serve_public(model, params, path: str, ps, pg: int = 16) -> tuple:
    """``ps`` served in slices of ``PUBLIC_SLICE`` to ``PUBLIC_GEN``
    tokens each by a ``StaticEngine`` on ``path``: the persistent paged
    unfused or fused engine (pages retained between slices) or dense SCLS
    (each slice re-prefills prompt + generated).  Returns the streams and
    the summary ``check_launches`` reads (launches counted over the run
    alone)."""
    from repro_torch.engine.static_engine import StaticEngine
    from repro_torch.kernels import ops
    paged = path != "dense"
    kw = (dict(kv_layout="paged", page_tokens=pg, kv_pool_tokens=64 * pg,
               attn_impl=path) if paged else {})
    eng = StaticEngine(model, params, eos_id=1, len_bucket=8, device="cuda",
                       **kw)
    outs = [[] for _ in ps]
    ops.reset_counts()
    reprefill = 0
    while any(len(o) < PUBLIC_GEN for o in outs):
        skw = dict(forced_gen_lens=[PUBLIC_GEN - len(o) for o in outs],
                   already_generated=[list(o) for o in outs])
        res = (eng.serve_batch_paged(ps, PUBLIC_SLICE, list(range(len(ps))),
                                     **skw) if paged
               else eng.serve_batch(ps, PUBLIC_SLICE, **skw))
        reprefill += res.reprefill_tokens
        for o, r in zip(outs, res.results):
            o.extend(r["tokens"])
    torch.cuda.synchronize()
    launches = ops.launches()
    if any(ops.plain_calls.values()):
        raise SystemExit(f"phase 25: {path} took plain versions "
                         f"{ops.plain_calls}")
    if paged:
        for rid in range(len(ps)):
            eng.release_request(rid)
        if eng.allocator.free_blocks != eng.allocator.n_pages:
            raise SystemExit(f"phase 25: the {path} engine leaked pages")
    return outs, dict(n_layers=model.cfg.n_layers,
                      prefill_stages=eng.n_prefill_stages,
                      tail_prefill_stages=eng.n_tail_prefill_stages,
                      decode_steps=eng.n_decode_steps, loops=eng.n_loops,
                      launches=launches, n_completed=len(ps),
                      n_requests=len(ps), prefix_hit_tokens=0,
                      reprefill_tokens=reprefill)


def check_public_engines(label: str) -> dict:
    """Phase 25 (b) at ``label``'s heads: llama3.2-1b's widths at
    ``PUBLIC_LAYERS`` layers, seeded random weights.  Phase 4's gate on
    each path (the serving functions' logits within ``REF_TOL`` of the
    plain forward, control faults past it); then the paged unfused, the
    fused and the dense SCLS engine serve ``PUBLIC_PROMPTS``: each stream
    equals the plain forward's greedy stream but for a near-tie
    (``stream_tie`` at ``REF_TOL``), and the kernels launch as the stages
    and steps imply (``check_launches``)."""
    import numpy as np
    from repro_torch.models.registry import get_model
    from repro_torch.testing import stream_tie
    cfg = public_config(label, PUBLIC_LAYERS)
    model = get_model(cfg)
    params = model.init(0, device="cuda")
    pg = 16
    gates = {path: check_served_logits(model, params, path, pg)
             for path in ("unfused", "fused", "dense")}
    weak = {f"{path} {fault}": gap for path, g in gates.items()
            for fault, gap in g["controls"].items()
            if not gap > g["tolerance"]}
    if weak:
        raise SystemExit(f"phase 25 {label}: control faults within the "
                         f"tolerance of the plain forward: {weak}")
    rng = np.random.default_rng(25)
    ps = [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
          for n in PUBLIC_PROMPTS]
    want, ref = plain_streams(model, params, ps, PUBLIC_GEN)
    out = {}
    for path in ("unfused", "fused", "dense"):
        got, summary = serve_public(model, params, path, ps, pg)
        check_launches(f"phase 25 {label} {path}", summary,
                       PATH_KERNELS[path])
        ties = []
        for i, (p, a, b) in enumerate(zip(ps, want, got)):
            gap = stream_tie(ref, p, a, b, rel_tol=REF_TOL)
            if gap is not None:  # the tokens before ``at`` were equal
                at = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
                ties.append(dict(request=i, at=at, gap=gap))
        log(f"phase 25 {label} ({cfg.n_heads}/{cfg.n_kv_heads}, D "
            f"{cfg.head_dim}) {path}: {len(ps)} x {PUBLIC_GEN} tokens equal "
            f"to the plain forward's but for near-ties {ties} (request, "
            f"first token apart, the plain forward's top-2 gap there)")
        out[path] = dict(summary, near_ties=ties,
                         logits=gates[path])
    del params
    release_cuda()
    return out


def run_public_heads(rows: dict, card: str) -> dict:
    """Phase 25: (a) B1, B4, B5 and B6 in bf16 at each of
    ``PUBLIC_HEADS`` (llama3.2-1b's config with those heads): held
    against their plain versions at 8 x 576 (the decode kernels; pages of
    16) and 8 x 512 (B5) to ``DECODE_TOL`` and timed beside SDPA and the
    bound (entries of the rows' ``shapes``, labelled "<label> heads");
    (b) ``check_public_engines`` at ``PUBLIC_ENGINE_HEADS``.  Returns the
    ``scls``-style entries of (b)'s runs."""
    t0 = time.perf_counter()
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for label, *_ in PUBLIC_HEADS:
        check_heads(public_config(label), f"{label} heads", DOMAIN_KERNELS,
                    rows, flush, prefill_timed=(PREFILL_TIMED[-1],),
                    dense_timed=DECODE_576)
        release_cuda()
    del flush
    release_cuda()
    engines = {label: check_public_engines(label)
               for label in PUBLIC_ENGINE_HEADS}
    print(json.dumps({"public_heads": engines}), flush=True)
    log(f"phase 25: {time.perf_counter() - t0:.1f} s ({card})")
    return {f"public_{label}_{path}": dict(launches=run["launches"])
            for label, runs in engines.items()
            for path, run in runs.items()}


# ---------------------------------------------------------------------------
# phase 26: the captured prefills and decode loops beside the eager paths
# ---------------------------------------------------------------------------
#: phase 26's paged engines: a pool for the batch and room to spare
GRAPH_POOL = dict(kv_layout="paged", page_tokens=16, kv_pool_tokens=8 * 512)
#: phase 26's paths: label -> (arch, engine, its keyword arguments); each
#: model at full width and ``served_config``'s depth, bf16, seeded weights
GRAPH_PATHS = {
    "llama_unfused": ("llama3.2-1b", "static", GRAPH_POOL),
    "llama_fused": ("llama3.2-1b", "static",
                    dict(GRAPH_POOL, attn_impl="fused")),
    "llama_dense": ("llama3.2-1b", "static", {}),
    "llama_ils_dense": ("llama3.2-1b", "continuous",
                        dict(max_slots=8, max_context=512)),
    "llama_ils_paged": ("llama3.2-1b", "continuous",
                        dict(max_slots=8, max_context=512, kv_layout="paged",
                             page_tokens=16)),
    "mamba2": ("mamba2-130m", "static", {}),
    "minitron_fused": ("minitron-4b", "static",
                       dict(GRAPH_POOL, attn_impl="fused")),
    "codeqwen_unfused": ("codeqwen1.5-7b", "static", GRAPH_POOL),
    "mixtral_dense": ("mixtral-8x22b", "static", {}),
    "recurrentgemma_dense": ("recurrentgemma-9b", "static", {}),
}
#: phase 26's fixed batch: rows of fresh prompts, prompt tokens, decode
#: steps (every row forced to run them all)
GRAPH_ROWS, GRAPH_PROMPT, GRAPH_STEPS = 8, 256, 32
#: each path's decode kernel (mamba2's decode step launches none)
GRAPH_DECODE = {"unfused": "paged_decode_attention",
                "fused": "fused_rope_decode_append",
                "dense": "decode_attention"}
#: host reads a serve of the fixed batch makes with graphs: a dense slice
#: one (its loop's results), a paged slice two (the prefill's first tokens,
#: then the loop's), ILS one a join and one a decode iteration
GRAPH_HOST_READS = {"dense": 1, "ssm": 1, "unfused": 2, "fused": 2}


def graph_engine(model, params, kind: str, kw: dict):
    from repro_torch.engine.continuous_engine import ContinuousEngine
    from repro_torch.engine.static_engine import StaticEngine
    if kind == "continuous":
        return ContinuousEngine(model, params, eos_id=1, len_bucket=16,
                                device="cuda", **kw)
    return StaticEngine(model, params, eos_id=1, len_bucket=16,
                        device="cuda", **kw)


def graph_serve(eng, ps) -> tuple:
    """(every row's tokens, decode steps, host seconds of the serve, host
    seconds of its prefill stages where the engine clocks them (the paged
    ones), else None) of one serve of the fixed batch ``ps``: a
    ``ContinuousEngine`` serves it whole, a ``StaticEngine`` as one slice
    of ``GRAPH_STEPS`` (the paged one under fresh rids, released after).
    Each serve ends in a host read that waits for the device."""
    forced = [GRAPH_STEPS] * len(ps)
    steps0 = eng.n_decode_steps
    prefill_s = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if not hasattr(eng, "serve_batch"):
        out = eng.serve(ps, forced_gen_lens=forced).outputs
    elif eng.kv_layout == "paged":
        rids = list(range(len(ps)))
        res = eng.serve_batch_paged(ps, GRAPH_STEPS, rids,
                                    forced_gen_lens=forced)
        for rid in rids:
            eng.release_request(rid)
        out = [r["tokens"] for r in res.results]
        prefill_s = res.prefill_time
    else:
        res = eng.serve_batch(ps, GRAPH_STEPS, forced_gen_lens=forced)
        out = [r["tokens"] for r in res.results]
    spent = time.perf_counter() - t0
    return out, eng.n_decode_steps - steps0, spent, prefill_s


@contextlib.contextmanager
def host_waits():
    """Inside ``with``, counts the host's reads of CUDA tensors
    (``cpu``, ``item``, ``tolist``, ``bool``, ``int``, ``float``: each
    waits for the device to reach the value) and the blocking copies of
    host tensors into CUDA ones (``copy_`` from the CPU: each waits for the
    stream to drain) in the yielded dict; not for timing (it wraps every
    ``copy_``)."""
    counts = {"reads": 0, "h2d_copies": 0}
    names = ("cpu", "item", "tolist", "__bool__", "__int__", "__float__")
    orig = {n: getattr(torch.Tensor, n) for n in names + ("copy_",)}

    def reader(fn):
        def read(t, *a, **kw):
            if t.is_cuda:
                counts["reads"] += 1
            return fn(t, *a, **kw)
        return read

    def copier(dst, src, *a, **kw):
        if dst.is_cuda and isinstance(src, torch.Tensor) and not src.is_cuda:
            counts["h2d_copies"] += 1
        return orig["copy_"](dst, src, *a, **kw)

    try:
        for n in names:
            setattr(torch.Tensor, n, reader(orig[n]))
        torch.Tensor.copy_ = copier
        yield counts
    finally:
        for n, fn in orig.items():
            setattr(torch.Tensor, n, fn)


def graph_window(eng, ps) -> dict:
    """One serve of ``ps`` under ``torch.profiler`` (device activity
    only): the device's busy share of the window's wall time (kernels of
    the prefill and the decode steps) and the kinds of device event."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _, _, _ = graph_serve(eng, ps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if dev_us(e) > 0]
    busy = sum(dev_us(e) for e in events) / 1e6
    return dict(tokens=out, wall_s=wall, device_busy_s=busy,
                device_busy_share=busy / wall,
                device_event_kinds=len(events))


def run_graph_path(label: str, model, params) -> dict:
    """Phase 26 for ``label``: one engine serves the fixed batch with its
    prefills and decode loops captured (the first serve captures) and
    under ``graphs.disabled()`` (its eager paths), in turns (eager, graph,
    graph, eager), then once each way under the profiler and once each way
    counting the host's waits.  Every serve's streams and decode steps
    must be equal; the engine must have captured exactly one graph per
    distinct bucket of each kind (a static engine: one loop replay per
    slice, and a dense slice one host read); a graph serve must launch
    the path's decode kernel once a layer a step and the loop's condition
    once a step and once a slice."""
    import numpy as np
    from collections import Counter
    from repro_torch.engine import graphs
    from repro_torch.kernels import ops
    arch, kind, kw = GRAPH_PATHS[label]
    eng = graph_engine(model, params, kind, kw)
    rng = np.random.default_rng(26)
    ps = [rng.integers(2, model.cfg.vocab_size, size=GRAPH_PROMPT)
          .astype(np.int32) for _ in range(GRAPH_ROWS)]
    streams, steps = {}, {}
    ms = {m: dict(slice=[], step=[], step_after_prefill=[])
          for m in ("graph", "eager")}
    loop_calls = [0]
    loop_call = graphs.Loop.__call__

    def counted_loop(loop):
        loop_calls[0] += 1
        return loop_call(loop)

    with torch.no_grad(), mock.patch.object(graphs.Loop, "__call__",
                                            counted_loop):
        with graphs.disabled():
            streams["eager warm-up"], steps["eager warm-up"], _, _ = \
                graph_serve(eng, ps)
        ops.reset_counts()
        streams["graph capture"], steps["graph capture"], cap_s, _ = \
            graph_serve(eng, ps)
        torch.cuda.synchronize()
        first = dict(ops.launches())
        replayed, loops = None, []
        for i, mode in enumerate(("eager", "graph", "graph", "eager")):
            ops.reset_counts()
            calls0 = loop_calls[0]
            with (graphs.disabled() if mode == "eager"
                  else contextlib.nullcontext()):
                key = f"{mode} {i}"
                streams[key], n, sec, pre_s = graph_serve(eng, ps)
            torch.cuda.synchronize()
            steps[key] = n
            ms[mode]["slice"].append(sec * 1e3)
            ms[mode]["step"].append(sec / n * 1e3)
            if pre_s is not None:
                ms[mode]["step_after_prefill"].append((sec - pre_s) / n * 1e3)
            if mode == "graph":
                replayed = dict(ops.launches())
                loops.append(loop_calls[0] - calls0)
        windows, waits = {}, {}
        for mode in ("eager", "graph"):
            with (graphs.disabled() if mode == "eager"
                  else contextlib.nullcontext()):
                windows[mode] = graph_window(eng, ps)
                streams[f"{mode} profiled"] = windows[mode].pop("tokens")
                with host_waits() as waits[mode]:
                    streams[f"{mode} counted"], _, _, _ = graph_serve(eng, ps)
    gc_ = eng.step_graphs
    ref = streams["eager warm-up"]
    differ = [k for k, v in streams.items() if v != ref]
    if len(set(steps.values())) != 1:
        differ.append(f"decode steps {steps}")
    path = kw.get("attn_impl", "unfused") if kw.get("kv_layout") == "paged" \
        else ("ssm" if model.cfg.family == "ssm" else "dense")
    decode = GRAPH_DECODE.get(path)
    L = kernel_layers(model.cfg)
    n = steps["graph 1"]
    buckets = Counter(graphs._kind(k) for k in gc_.keys())
    summary = dict(
        arch=model.cfg.name, engine=kind, path=path,
        layers=model.cfg.n_layers, kernel_layers=L, rows=GRAPH_ROWS,
        prompt_tokens=GRAPH_PROMPT, decode_steps=n,
        ms_per_slice={m: v["slice"] for m, v in ms.items()},
        ms_per_decode_step={m: v["step"] for m, v in ms.items()},
        ms_per_decode_step_after_prefill={
            m: v["step_after_prefill"] for m, v in ms.items()},
        eager_over_graph=sum(ms["eager"]["slice"])
        / sum(ms["graph"]["slice"]),
        capture_serve_ms=cap_s * 1e3,
        device_busy_share={m: w["device_busy_share"]
                           for m, w in windows.items()},
        windows=windows, host_waits_per_serve=waits,
        loop_calls_per_graph_serve=loops, captures=gc_.n_captures,
        captures_by_kind=dict(gc_.captures),
        capture_s_by_kind=dict(gc_.seconds), capture_s=gc_.capture_seconds,
        buckets=[str(k) for k in gc_.keys()],
        graph_pool_bytes=gc_.pool_bytes(),
        arena_bytes=getattr(getattr(eng, "_arena", None), "nbytes", None),
        launches_capture_serve=first, launches_graph_serve=replayed,
        equal_streams=not differ)
    print(json.dumps({"graphs": {label: summary}}), flush=True)
    if differ:
        raise SystemExit(f"phase 26 {label}: {differ} differ from the eager "
                         f"path's")
    if dict(gc_.captures) != dict(buckets):
        raise SystemExit(f"phase 26 {label}: captures {gc_.captures} of "
                         f"{gc_.keys()}, not one a bucket of each kind")
    if decode and replayed.get(decode) != L * n:
        raise SystemExit(f"phase 26 {label}: a graph serve launched "
                         f"{replayed} over {n} decode steps of {L} layers")
    if kind == "static":
        reads = waits["graph"]["reads"]
        if loops != [1, 1] or replayed.get("graph_loop") != n + 1 or \
                reads != GRAPH_HOST_READS[path]:
            raise SystemExit(f"phase 26 {label}: {loops} loop calls, "
                             f"graph_loop launched {replayed} over {n} "
                             f"steps, {reads} host reads per slice")
    elif replayed.get("graph_loop"):
        raise SystemExit(f"phase 26 {label}: the ILS engine ran a loop")
    log(f"phase 26 {label}: {model.cfg.name} ({model.cfg.n_layers} layers) "
        f"{kind} {path}, {GRAPH_ROWS} x {GRAPH_PROMPT} tokens, {n} decode "
        f"steps: ms a slice graph "
        f"{[f'{x:.3f}' for x in ms['graph']['slice']]} vs eager "
        f"{[f'{x:.3f}' for x in ms['eager']['slice']]}; device busy "
        f"{summary['device_busy_share']}; host waits {waits}; captures "
        f"{dict(gc_.captures)} in {gc_.capture_seconds:.3f} s, graph pool "
        f"{summary['graph_pool_bytes']} bytes; streams and steps equal")
    return summary


def run_graphs(card: str) -> dict:
    """Phase 26: every captured path (``GRAPH_PATHS``) through
    ``run_graph_path``, one model at a time, after one profiled matrix
    product (the profiler's own start-up is then outside the paths'
    windows); the card's reading on the line before the summaries."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.registry import get_model
    print(card, flush=True)
    x = torch.ones((256, 256), device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]):
        (x @ x).sum().item()
    out, built = {}, None
    for label, (arch, _, _) in GRAPH_PATHS.items():
        if built is None or built[0] != arch:
            built = None
            release_cuda()
            model = get_model(served_config(arch))
            built = (arch, model, model.init(0, device="cuda"))
        out[label] = run_graph_path(label, *built[1:])
        release_cuda()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    save_to = None
    if sys.argv[1:2] == ["--save-steps"] and len(sys.argv) == 3:
        save_to = sys.argv[2]
    elif len(sys.argv) > 1:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    card = card_reading()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; TF32 off for float32 matmul and cuDNN")

    laps, last = {}, [time.perf_counter()]

    def lap(name: str) -> None:
        """Logs and keeps the seconds since the previous lap."""
        now = time.perf_counter()
        laps[name] = round(now - last[0], 1)
        last[0] = now
        log(f"{name}: {laps[name]:.1f} s")

    logs = build.build_all()
    lap(f"build ({len(build.KERNELS)} kernels, one nvcc each, at once)")
    for name, text in logs.items():  # registers, shared memory, spills
        for line in text.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                log(f"  {name}: {line.strip()}")

    cfg = get_config("llama3.2-1b")
    pg = 16
    n_pages = pool_pages(cfg, 48e9, pg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows = [check(cfg, n_pages, pg, gen, flush)
            for check in (check_decode, check_write,
                          lambda *a: check_write(*a, fused=True),
                          check_fused_decode)]
    rows += [check(cfg, gen, flush)
             for check in (check_flash_prefill, check_dense_decode)]
    rows.append(check_ssd_scan(gen, flush))
    rows.append(check_graph_loop(flush))
    by_name = {row["name"]: row for row in rows}
    release_cuda()
    for arch, names in CONFIG_HEADS:
        check_config_heads(arch, names, by_name, flush)
    for arch in WINDOW_HEADS:
        check_window_heads(arch, by_name, flush)
    check_frontend_heads(by_name, flush)
    del flush
    release_cuda()
    lap("phase 3 (the kernels at full width)")
    check_ils_parity()
    release_cuda()
    lap("phase 4b (ILS engines, card vs CPU)")
    parity = [dict(arch=arch, **check_config_parity(arch, head_dim))
              for arch, head_dim in CONFIG_PARITY]
    parity += [dict(arch=arch, **check_config_parity(
        arch, served_capacity=True)) for arch in SERVED_CAPACITY_PARITY]
    print(json.dumps({"config_parity": parity}), flush=True)
    release_cuda()
    lap("phase 4c (the configs' engines, card vs CPU)")
    run_graphs(card)
    release_cuda()
    lap("phase 26 (captured prefills and loops beside the eager paths)")

    scls, steps, writes = {}, {}, {}
    for label in ("slice", "fused_slice", "dense_slice"):
        scls[label], record = run_slice(label)
        if record:
            steps[label], writes[label] = record["step"], record["writes"]
        del record
        release_cuda()
    lap("phases 5-7 (llama3.2-1b's slices)")
    ils = run_ils(scls, steps)
    release_cuda()
    lap("phase 8 (ILS)")
    check_engine_steps(steps, by_name, ENGINE_STEPS)
    steps = host_steps(steps)
    release_cuda()
    lap("phase 10 (the decode kernels at llama's steps)")
    scls["mamba_slice"], record = run_slice("mamba_slice")
    stages = record["stages"]
    release_cuda()
    lap("phase 9 (mamba2-130m's slice)")
    check_ssd_stages(stages, by_name["ssd_scan"])
    release_cuda()
    lap("phase 11 (ssd_scan at the slice's stages)")
    check_write_stages(writes, by_name, ENGINE_WRITES)
    if save_to:
        save_steps(steps, stages, writes, save_to)
    steps, writes = {}, {}
    release_cuda()
    lap("phase 12 (the writes at llama's stages)")
    for label in ("codeqwen_slice", "minitron_fused_slice",
                  "gemma_dense_slice"):
        scls[label], record = run_slice(label)
        if record:
            steps[label] = host_steps({label: record["step"]})[label]
            writes[label] = record["writes"]
        del record
        release_cuda()
    lap("phases 13-15 (the configs' slices)")
    check_engine_steps(steps, by_name, CONFIG_STEPS)
    release_cuda()
    check_write_stages(writes, by_name, CONFIG_WRITES)
    release_cuda()
    lap("phases 10 and 12 at the configs' steps and stages")
    scls["launcher_path"] = run_launcher_path()
    release_cuda()
    lap("phase 16 (the launcher's path)")
    for label in FAMILY_SLICES:  # phases 17-19
        scls[label], _ = run_slice(label)
        release_cuda()
    lap("phases 17-19 (the MoE and hybrid slices)")
    scls["fleet"] = run_fleet()  # phase 20
    release_cuda()
    lap("phase 20 (the fleet)")
    for arch, spec in FRONTEND_SERVE.items():  # phase 21
        scls[spec["label"]] = run_frontend_family(arch)
        release_cuda()
    lap("phase 21 (the frontend families)")
    run_training(card)  # phase 22
    release_cuda()
    lap("phase 22 (training)")
    scls.update(run_scale_out(card))  # phase 23
    release_cuda()
    lap("phase 23 (scale-out)")
    run_examples(card)  # phase 24
    release_cuda()
    lap("phase 24 (the examples)")
    scls.update(run_public_heads(by_name, card))  # phase 25
    lap("phase 25 (public heads)")
    print(json.dumps({"seconds": laps}), flush=True)
    # every control fault of phase 4 must have failed its slice's gate
    weak = {f"{label} {fault}": gap for label, sm in scls.items()
            for fault, gap in sm.get("controls", {}).items()
            if not gap > sm["tolerance"]}
    if weak:
        raise SystemExit(f"phase 4: control faults within their slice's "
                         f"tolerance of the plain forward: {weak}")
    # each kernel's launches on its own slice's main path, all paths beside
    by_path = {label: sm["launches"] for label, sm in scls.items()}
    by_path.update({f"ils_{k}": v for k, v in ils.items()})
    main_path = {**dict.fromkeys(UNFUSED, "slice"),
                 **dict.fromkeys(FUSED, "fused_slice"),
                 **dict.fromkeys(DENSE, "dense_slice"),
                 **dict.fromkeys(SSM, "mamba_slice"),
                 "graph_loop": "dense_slice"}
    for row in rows:
        row["launches"] = by_path[main_path[row["name"]]][row["name"]]
        row["launches_by_path"] = {k: v[row["name"]]
                                   for k, v in by_path.items()}
    # B6 at 16 query heads per KV head: recurrentgemma-9b's slice
    g16 = by_path["recurrentgemma_slice"]["decode_attention"]
    if g16 <= 0:
        raise SystemExit("decode_attention never launched at group 16")
    by_name["decode_attention"]["group16_launches"] = g16
    # B1 at pages of 32 slots: the fleet's instances (phase 20)
    pg32 = by_path["fleet"]["paged_decode_attention"]
    if pg32 <= 0:
        raise SystemExit("paged_decode_attention never launched at pg 32")
    by_name["paged_decode_attention"]["pg32_launches"] = pg32
    # B5 with a bidirectional prefix and B6 as cross-attention: phase 21
    prefix = sum(scls[spec["label"]]["prefix_launches"]
                 for spec in FRONTEND_SERVE.values())
    cross = scls["seamless_slice"]["cross_launches"]
    if prefix <= 0 or cross <= 0:
        raise SystemExit(f"flash_prefill launched {prefix} times with a "
                         f"prefix, decode_attention {cross} times as "
                         f"cross-attention")
    by_name["flash_prefill"]["prefix_launches"] = prefix
    by_name["decode_attention"]["cross_launches"] = cross
    # B5, B6 and B7 on DTensor shards: phase 23's one-card mesh
    for name, path in (("flash_prefill", "sharded_slice"),
                       ("decode_attention", "sharded_slice"),
                       ("ssd_scan", "sharded_mamba")):
        n = by_path[path][name]
        if n <= 0:
            raise SystemExit(f"{name} never launched on DTensor shards")
        by_name[name]["sharded_launches"] = n
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
