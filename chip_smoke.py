#!/usr/bin/env python3
"""Proof that the PyTorch port (``src/repro_torch``) runs on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (``nvcc``) and PyTorch built for
CUDA; imports nothing of JAX or of the JAX package.  Phases, each of which
ends the run with a non-zero exit code if it fails:

1. builds every CUDA kernel of the port from the sources in the checkout
   (one nvcc per source, all started together) and prints the compiler's
   register and spill report, one line per flash-attention and SSD-scan
   kernel;
2. kernels: each kernel's wrapper against its plain PyTorch version on
   the card, at the main paths' shapes and edge cases, timed with CUDA
   events (L2 overwritten before each launch), beside its bound and, where
   one PyTorch call computes the same function, that call's time
   (``scatter_add_`` and ``index_add_`` for the segmented sum,
   ``scaled_dot_product_attention`` for flash attention); the segmented sum
   runs each case with sorted ids through both of its routes (``sorted``,
   the single pass the main paths take, and ``atomic``), each held to the
   plain version, the sorted one also bit for bit to a second call, both
   timed in turns in the same run, with its fixed cost at the served
   queries' S (4,096 rows); each radix case
   names its route (``onepass`` up to 256 buckets, ``threepass`` above),
   and the radix kernel's main shapes are also timed through the shuffle's
   sorted bucketize (stable sort, ``searchsorted``, ``scatter_add_``); the
   SSD scan's three kernels (chunk state, state pass, chunk scan) are also
   timed one by one under ``torch.profiler`` at the mamba2-780m prefill's
   shape, and it is also held and timed at the mamba2-780m train step's
   shape (BH 384, T 1,024) and at the jamba-v0.1-52b prefill's (BH 512,
   state N 16),
   and its strong-decay case is also held to the float64 recurrence; the
   radix kernel and the segmented sum are also held and timed at the
   shapes one process of a process group hands them (one rank: (1,
   4,718,592, 9) and (1, 18,874,368)) and on skewed traffic (one bucket, one segment with 99% of the rows); the radix
   kernel also at the MoE dispatch's shapes (olmoe-1b-7b and
   jamba-v0.1-52b prefill and decode, the shuffle dispatch's two shuffles
   and local group), beside the reference's stable sort and
   ``searchsorted``; flash attention also at the olmoe-1b-7b prefill's
   shape (16 heads, no grouping), beside ``scaled_dot_product_attention``,
   and at gemma-7b's head dim 256 (its prefill's shape, ragged queries
   and non-causal over ragged keys, each in f32 and bf16, all on the simt
   route), beside ``scaled_dot_product_attention`` at the prefill's, and
   at the musicgen-large (32 heads of 64) and llava-next-34b (56 q heads
   over 8: GQA group 7) prefills' shapes in f32, beside it;
3. Fig-9: the paper's pipeline (join -> groupby(sum) -> sort ->
   add_scalar) through ``execute`` at 2 x 2**25 rows over 8 ranks stacked
   on the card, in ``bsp``, ``bsp_staged`` and ``amt``, twice each, with
   kernel launch counts reset just before each run and read just after
   it: each shuffle of ``bsp`` and ``bsp_staged`` launches the radix
   kernel once, 3 a run, all on its onepass route (``amt`` shuffles by
   all-gather and launches it never), and
   every sum, count and size of every local groupby launches the
   segmented-sum kernel once, in every mode (the count is read off the
   lowered plan), on its sorted route (every launch-count read of every
   phase checks that no segmented-sum launch took the atomic route);
   results are held against a numpy computation on the
   host, and one cached ``bsp`` run is profiled; one more ``bsp`` run
   records the valid rows per rank of the radix kernel's calls, and the
   kernel is then held to its plain version and timed at those layouts
   (``main:join-layout``, ``main:sort-layout``: a uniform prefix of valid
   rows, the rest in the pad bucket p); every run is at the default
   ``adaptive`` (hot-key detection on, nothing salted on these keys), and
   ``adaptive=False`` runs once more per mode: the same stage-cache keys,
   no miss, and five alternating ``bsp`` pairs give the detection's cost;
4. frontend: the same pipeline with a mean, written against
   ``repro_torch.df`` on the same data, in every mode, twice each, with
   the same launch checks; held to the host reference and to the
   ``Plan``-built pipeline (equal EXPLAIN, equal result, no stage built
   anew); one ``bsp`` run of the same frames under
   ``session(devices=lease)``, a lease of 8 slots of a ``DevicePool``,
   with the same launch checks, bit-identical in every slot to the cached
   ``bsp`` run of ``session(parallelism=8)``, its wall printed beside the
   card's name and power limit; then a string-keyed run (2 x 2**22
   ``<U12`` keys from 2**18 words, two dictionaries, so EXPLAIN shows
   ``recode[...]``) held to numpy on the host, one cached run of it
   profiled;
5. out-of-core: Fig-9 (optimized, ``bsp``) through ``execute(
   morsel_rows=...)`` at 2 x 2**25 rows, 8x oversubscribed, the left input
   a host dict (the JAX package's out-of-core parity recipe: integer-valued
   float32 payloads), first and cached: bit-identical to the in-core run,
   no rows dropped, no degrade, at least 16 morsels, the same rows
   shuffled, no stage built anew on the repeat, the radix and
   segmented-sum launches equal to the counts derived from the plan and
   the stats (radix all onepass), and peak device memory below the
   in-core run's; transfer volumes, per-segment times and a profile of a
   cached run (copy rates from its memcpy events); then the radix and
   segmented-sum kernels held to their plain versions and timed on the
   inputs one out-of-core run handed them (first call at each shape:
   ``ooc:n=...``), and on rank 0's slice of them, the shapes one process
   of a group hands them (``process:ooc:n=...``);
6. ingest and analyze: the out-of-core phase's data written as 8
   Parquet files a side (row groups of 2**20 rows; CSV if pyarrow does not
   import, the lane printed) and read back with ``repro_torch.df.
   read_parquet``: host ingest time and rate, ``IngestInfo`` held to what
   was written, a second read recode-free; Fig-9 from the files in-core
   (``bsp``, default scan capacity and the Fig-9 phase's) and out-of-core
   8x oversubscribed, first and cached, each bit-identical to the same
   pipeline over the columns in memory and equal to the host reference,
   with the kernels' launches held to their derivation (the files'
   round-robin batches placed as the ingest places them); EXPLAIN ANALYZE
   in ``bsp_staged`` with the card's roofline (fractions at most 1.05),
   the Chrome trace and the metrics record checked; the cached run with
   tracing off and on (same result, launches and stages: the difference
   of the walls is what tracing costs); ``debug_overflow`` warning once
   per rank; string keys with 10% nulls at 2**22 rows over 4 Parquet
   files (recodes on the first read, a cache hit with none on the
   second, a merge, filter, groupby and sort equal to numpy), and the
   same at 2**18 rows through both CSV lanes;
7. Fig-9 parity: the plan at 2**16 rows, optimizer on and off, on the
   card and on the CPU (plain kernels), compared slot for slot; the
   default ``degrade`` policy on an under-capacitated join (every row
   recovered, card == CPU); groupbys, a join and a sort over uint16 and
   uint32 columns, card == CPU slot for slot;
8. skew: the salted operators (``benchmarks/bench_skew.py``'s keys:
   uniform, Zipf(1.5), 99% one key; ``skew_parity.py``'s raw groupby +
   sort and join) on 8 ranks, in-core and out-of-core at 2**24 rows
   (``morsel_rows`` 262,144, capacity_factor 2), adaptive on
   and off, first and cached: held to numpy (join placement included), no
   drop with adaptive on, the kernels' launches, degrade attempts and
   morsels equal to their derivation from the plan and the data, rows
   routed per rank (hottest over median) and peak memory printed; then
   faults: Fig-9 recovered bit for bit from one fault at each in-core site
   (2 x 2**25 rows, ``bsp`` and ``bsp_staged``) and each out-of-core site
   (2 x 2**23 rows), ``corrupt-capacity``, three ``random_plan`` seeds and
   a ``hang`` fenced by ``timeout=``; then Fig-9 over a
   ``torch.distributed`` process group, one rank per process (ROADMAP
   item 12): 8 gloo processes spawned on the one card,
   meeting through a ``file://`` rendezvous in a temporary directory,
   loading the kernels built above (never rebuilding them), at 2 x 2**25
   rows in ``bsp`` (first and cached) and ``amt``, and with ``ring`` and
   ``bruck`` at 2 x 2**22 rows; each process's result equal slot for
   slot to rank r of the stacked ``xla`` run, its radix and
   segmented-sum launches equal to their derivation (3 and 1 a ``bsp``
   run); then NCCL at world size 1 (NCCL takes one rank per device) at
   2 x 2**22 rows, equal to the stacked one-rank run; each wall, the
   share of it spent in host-staged collectives (gloo stages every
   collective through pinned host buffers) and the phase's time printed
   beside the card's name and power limit; in the same 8 processes the
   group's out-of-core paths: Fig-9 streamed 8x oversubscribed at 2 x
   2**25 rows (``morsel_rows`` 524,288, ``capacity_factor`` 4; first and
   cached), Fig-9 from 8 Parquet files a side at the default batches,
   in-core and out-of-core (every process reads the same files and keeps
   its rank's batches), and the faults cell's out-of-core size (2 x
   2**23) under a ``raise`` at ``spill:append``, ``random_plan`` seeds
   1-3 and a ``hang`` under ``timeout=`` (``QueryTimeout`` on every
   process, then a clean run); NCCL at world size 1 also streams Fig-9
   out-of-core at 2 x 2**22 rows; each process's result equal by digest
   to rank r of the same run stacked on the card (the out-of-core,
   ingest and faults phases' own runs, their files kept for it), a
   recovered run to the fault-free one, retries equal on every process,
   the radix and
   segmented-sum launches of each process equal to their derivation;
   each run's wall, its share in host-staged collectives and host
   exchanges, its h2d / d2h bytes and each process's peak memory;
9. serving: qwen3-8b, mamba2-780m, olmoe-1b-7b, jamba-v0.1-52b (cut
   to 8 of its 32 layers, one layout period), llama3.2-3b, gemma-7b (head
   dim 256), qwen3-32b (cut to 16 of its 64 layers),
   deepseek-v2-lite-16b (MLA, a dense prefix layer, 64 experts with 2
   shared) and musicgen-large (audio: prompts of 4 codebook ids a
   position, 4 logit heads) at full width (float32 weights from a seeded
   generator, batch 4, prompt 4096, 32 new tokens, greedy) through
   ``ServeEngine``, and llava-next-34b (cut to 15 of its 60 layers; 576
   patch embeddings from the seed ahead of 3,520 text tokens) through
   ``VlmServe``'s loop over ``transformer.prefill`` / ``decode_step``,
   twice each; launch counts reset just before each prefill and each decode
   step and read just after it, each equal to its derivation from the
   layers (flash attention once per GQA attention layer in prefill, on
   the route its head dim takes, never for MLA; the SSD scan once per
   mamba layer, neither in decode; the radix kernel once per MoE layer in
   prefill and in every decode step); time to first token, decode time
   per step, tokens per
   second and peak device memory; a profiled prefill and 8 decode steps
   per arch, with the MoE layers' device time (CUDA events) and their
   dispatch ranks' (the radix kernel); each prefill's model FLOPs
   (``launch/roofline.py::model_flops``) over its time and the card's f32
   peak;
   then a qwen3-8b prefill at the same width with bfloat16 weights,
   twice: finite logits, first tokens in the vocab, 36 flash launches,
   all on the kernel's bf16 tensor-core (wgmma) route; time to first
   token;
10. serving parity: the ten SMOKE configs with the same weights on the
   card (kernels forced, prompts longer than a tile; llava's 160
   positions 8 patch embeddings and 152 tokens; gemma's widened to
   head dim 256; jamba's and deepseek's at 2,100 tokens with ``auto``,
   past the flash threshold and, for MLA, on its chunked branch) and on
   the CPU (plain versions), launches as derived: prefill logits within
   1e-3, greedy tokens equal; then one olmoe-1b-7b MoE layer at full
   width on x (4,
   4,096, 2,048) at capacity factor 8 through ``moe_apply_shuffle`` (the
   dataframe shuffle over 8 stacked ranks, ``xla``) and through
   ``moe_apply_grouped``: y within atol 2e-4 / rtol 1e-3 and aux within
   1e-4 of each other, no row dropped (derived from the routing), 3 and 1
   radix launches, both timed (median of 5) with their peak memory;
11. query serving (run after the faults phase; ``benchmarks/
   bench_pipeline.py:383-472``): a ``DevicePool`` of 8 rank slots on the
   card, 4 gangs of 2 stacked ranks, each query gang on its worker's CUDA
   stream; two 2**24-row tables (integer-valued payloads) ingested once,
   pinned to no env; the three query kinds (join + filter + groupby sum +
   sort, groupby sum/mean + sort, filter + sort) pre-warmed on every
   partition through one shared stage cache; a serial sweep
   (``max_inflight=1``) and a concurrent one (``max_inflight=4``) of 24
   queries, then the concurrent one again under ``torch.profiler``:
   queries per second, p50 and largest latency (submit to result; with
   24 queries the p99 is the largest), the speedup, peak memory, the
   device's busy share and the time kernels of two gangs' streams ran at
   once; held: results bit-identical to the pre-warm runs and equal to
   numpy, ``cache_misses == 0`` on every handle, the shared cache
   unchanged, radix and segmented-sum launches equal to the lowered plans'
   count (radix all onepass), overlapping queries on disjoint slots; the
   radix and segmented-sum inputs of one query of each kind on a gang
   (p = 2) are recorded and, after the phase, each kernel is held to its
   plain version on them and timed beside its bound; then ``tests/md_scripts/serving_stress.py``'s checks at
   this size (16 submissions from 8 threads, ``collect()`` inside
   ``session(scheduler=)`` from 8 threads, a mid-queue cancellation, a
   faulted run recovered bit for bit); last, Fig-9 ``bsp`` at 2 x 2**25
   rows over 8 ranks with each communicator (``xla``, ``ring``,
   ``bruck``): bit-identical to ``xla``, stage keys distinct, each run's
   wall and its data all-to-alls' device time.
12. training (ROADMAP item 13.1; after serving parity): the §IV-C
   preprocessing application (``repro_torch.data.preprocess``: dedup by a
   groupby ``min`` joined back, the quality filter, the weights join, a
   balancing repartition at ``capacity_factor`` 4) over 2**17 documents of
   1,024 tokens on a gang of 8 stacked ranks, ``put`` into a
   ``CylonStore`` and ``get`` at 4 ranks, held to
   ``tests/md_scripts/data_pipeline.py``'s numpy oracle (no drop, payloads
   and weights intact, ranks within 2x of the mean), its radix launches
   derived from the dataframe operators the application ran (a groupby
   shuffles once, a join both sides, a repartition once: 6); then mamba2-780m at full width and depth in
   float32 trained on batches of 8 x 1,024 tokens from that table (AdamW
   as ``repro.launch.train`` sets it, remat on, CE chunk 64): one warm-up
   and 4 timed steps, finite losses and gradient norms, parameters
   changed, the SSD kernel's forward launches (96: every layer's forward
   and its recomputation) and the plain backward passes (48) counted per
   step; step time, tokens/s, peak memory, and one step profiled (busy
   share, top operators, the SSD backward's device time); then
   olmoe-1b-7b at full width cut to 4 of 16 layers, trained the same way
   on a second run of the pipeline (8 radix launches a step: the forward
   and the recomputation of every MoE layer; the aux term printed; the
   MoE layers' device time in the profiled step); the ten SMOKE
   configs trained 3 steps on the card and on the CPU from one state
   (losses and gradient norms within 1e-3), a checkpoint resumed bit for
   bit on the card; the SSD scan's autograd path at the training shape
   (BH 384, T 1,024, P 64, N 128): the kernel's y and final state held to
   ``ssd_scan_chunked`` within 3e-3, and the Function's gradients to the
   plain version's (its backward is the plain version recomputed, so this
   checks the Function's wiring, not the kernel's accuracy), its forward
   and backward timed.
13. sharding (ROADMAP item 13.6; ``sharding_phase``): a ``("data",
   "model")`` mesh of one rank over NCCL (world size 1) in this process.
   olmoe-1b-7b (4 of 16 layers) and mamba2-780m take one train step each
   under ``rules_for_mesh`` from ``train_phase``'s seed and first batch,
   the state placed by ``state_specs`` as DTensors: olmoe's MoE layers
   through ``moe_apply_shuffle`` over the mesh's model group (24 radix
   launches a step: 3 a layer, forward and recomputation), mamba2's SSD
   kernel and its autograd ``Function`` under ``local_map`` (96 forward
   launches, 48 plain backward passes); loss and gradient norm held to
   ``train_phase``'s warm-up step (olmoe at the reference script's rtol
   2e-3 / 2e-2, mamba2 at 1e-5 / 1e-4); then qwen3-8b (batch 4, prompt
   4096) through ``ServeEngine(rules=serve_rules_for_mesh)``, the model
   placed by ``param_specs`` and the KV cache by ``cache_specs``: two
   timed prefills (first and cached, 36 flash launches each), then 8
   greedy tokens equal to the first 8 of ``serve_phase``'s first run;
   each train arch also takes a second step (the same batch) for the
   steady state; each run's wall time and peak memory beside the
   unsharded run's, and each first step's and first prefill's own peak
   (above what was alive before its state).
14. dry run (ROADMAP item 13.7; ``dryrun_phase``, ``launch/dryrun.py``):
   four spawned processes, each holding rank 0 of a fake process group
   and running on fake card tensors (nothing allocated, no kernel
   launched): the sharding phase's three configurations on a group of
   one rank, each step run twice (the first fills DTensor's propagation
   cache, the second is counted), their kernel-operator calls equal to
   the launches the sharding phase read (24 radix, 96 SSD, 36 flash) and
   their predicted peaks (arguments + temporaries) within 10% of the
   measured ones; and olmoe-1b-7b ``train_4k`` at full width on a fake
   256-rank (16, 16) mesh, its roofline row (``format_table``: the bf16
   tensor-core, HBM and NVLink terms of an H100).
15. examples (``examples_phase``, after the process-group phase): each
   ``examples/torch/*.py`` run on the card as a user runs it (a
   subprocess at its defaults, ``--out`` added): exit code 0 and the
   example's own check line; the four dataframe examples' results held
   to their CPU runs (keys and integer-valued payloads exactly, other
   floats within rtol 1e-3; the CPU runs go in a spawned process beside
   the train phases), their radix and segmented-sum launches to the
   counts derived from their frames and plans; serve_batch launches no
   kernel, train_e2e only the radix kernel of its preprocessing (6)
   and its loss falls ("OK: improved"); the six run at once, train_e2e
   at 30 of its 300 steps (time); each example's wall time and printed
   timings, train_e2e's first and last loss and its seconds a step,
   beside the card.

The last lines are the training JSON line, the process-group,
sharding and dry-run JSON lines, the query-serving JSON line, the
examples JSON line, the card's ``nvidia-smi`` name and power limit, one
JSON object describing each kernel, and ``{"ok": true, "device": ...}``.
"""

import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FULL_ROWS = 1 << 25      # rows per input table on the main path
PARITY_ROWS = 1 << 16
#: rows of each skewed table (skew phase): out-of-core at 2**25 until the
#: script's run grew past half its time limit, in-core 2**24 at most
SKEW_ROWS = 1 << 24
HOT_KEY = 7              # the one-key table's hot key
P = 8                    # ranks stacked on the card
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS = 67e12           # float32 outside the tensor cores, H100 SXM
BF16_FLOPS = 989e12         # dense bf16 tensor cores, H100 SXM
L2_BYTES = 50 * 1024 * 1024
#: the serving phase's full-width cases: arch, batch, prompt, new tokens
SERVE_CASES = (("qwen3-8b", 4, 4096, 32), ("mamba2-780m", 4, 4096, 32),
               ("olmoe-1b-7b", 4, 4096, 32), ("jamba-v0.1-52b", 4, 4096, 32),
               ("llama3.2-3b", 4, 4096, 32), ("gemma-7b", 4, 4096, 32),
               ("qwen3-32b", 4, 4096, 32),
               ("deepseek-v2-lite-16b", 4, 4096, 32),
               ("musicgen-large", 4, 4096, 32))
#: the served vlm: ``ServeEngine`` takes token prompts only, so its
#: prompt's patch embeddings (``vlm_patches``: 576 of its 4,096
#: positions) go through ``transformer.prefill`` in ``VlmServe``'s loop
VLM_CASES = (("llava-next-34b", 4, 4096, 32),)
#: layers kept of a served arch, at full width.  Those that do not fit
#: the card whole: jamba-v0.1-52b's 49.3 B parameters (197 GB in float32)
#: cut to one layout period, 8 of 32 layers (13.27 B, 49.4 GiB);
#: qwen3-32b's 32.76 B (122 GiB) cut to 16 of 64 layers (9.36 B, 34.9
#: GiB); llava-next-34b's 34.39 B (128.1 GiB) cut to 15 of 60 layers
#: (9.285 B, 34.59 GiB).  Those cut to keep the script inside its time
#: limit, their full depth served by earlier runs (``PERF.md`` §4):
#: gemma-7b 7 of 28 and llama3.2-3b 7 of 28 (qwen3-8b keeps their GQA
#: f32 flash path at full depth; gemma keeps D = 256)
SERVE_LAYERS = {"jamba-v0.1-52b": 8, "qwen3-32b": 16, "llava-next-34b": 15,
                "gemma-7b": 7, "llama3.2-3b": 7}
#: the serving parity phase's impl and prompt per SMOKE config: the
#: kernels forced (``flash`` / ``kernel``), or reached by a prompt past
#: 2,048 keys where one ``impl`` serves both layer kinds (the hybrid) or
#: where MLA takes its chunked branch (it never reaches flash)
PARITY_CASES = {"qwen3-8b": ("flash", 160), "mamba2-780m": ("kernel", 160),
                "olmoe-1b-7b": ("flash", 160),
                "jamba-v0.1-52b": ("auto", 2100),
                "llama3.2-3b": ("flash", 160), "qwen3-32b": ("flash", 160),
                "gemma-7b": ("flash", 160),
                "deepseek-v2-lite-16b": ("auto", 2100),
                "musicgen-large": ("flash", 160),
                "llava-next-34b": ("flash", 160)}
#: patch embeddings ahead of a SMOKE vlm prompt (parity phases): 8 of
#: its 160 positions
SMOKE_PATCHES = 8
#: SMOKE fields the parity phase widens: gemma-7b's head dim to its full
#: config's 256, so that the flash kernel's D = 256 instance runs inside
#: a model
PARITY_WIDEN = {"gemma-7b": dict(head_dim=256)}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def make_table_data(rows, seed, cardinality=0.9, exact_values=False):
    """The paper's §V data recipe (``benchmarks/common.py``): uniform int32
    keys at 90% cardinality, float32 values (integer-valued in [0, 256)
    with ``exact_values``, so sums are exact in any order)."""
    rng = np.random.default_rng(seed)
    n_unique = max(1, int(rows * cardinality))
    keys = rng.integers(0, n_unique, rows).astype(np.int32)
    vals = (rng.integers(0, 256, rows).astype(np.float32) if exact_values
            else rng.random(rows).astype(np.float32))
    return {"k": keys, "v0": vals}


def capacity_for(rows, p):
    """Per-rank capacity: the balanced share plus 1/8 headroom, so the
    hash shuffles' receive tables (capacity = input capacity) hold the
    spread of a uniform hash without dropping rows."""
    per = -(-rows // p)
    return -(-(per + per // 8) // 8) * 8


def fig9_plan(Plan, capacity, bench_capacities=False):
    """``benchmarks/bench_pipeline.py:40-48``.  The explicit bucket
    capacities there exist for the unoptimized re-shuffle; the full-size
    run keeps only the join's ``out_capacity``."""
    if not bench_capacities:
        return (Plan.scan("l")
                .join(Plan.scan("r"), on="k", out_capacity=capacity * 4)
                .groupby(["k"], {"v0": ["sum"]}).sort(["k"])
                .add_scalar(1.0, cols=["v0_sum"]))
    return (Plan.scan("l")
            .join(Plan.scan("r"), on="k", out_capacity=capacity * 4,
                  bucket_capacity=capacity)
            .groupby(["k"], {"v0": ["sum"]}, bucket_capacity=capacity * 4)
            .sort(["k"], bucket_capacity=capacity * 4)
            .add_scalar(1.0, cols=["v0_sum"]))


def time_cuda(torch, fn, iters, flush):
    """Median milliseconds of ``fn`` over ``iters`` launches, each timed
    with CUDA events after overwriting a buffer larger than L2 (the
    caller finds its input cold)."""
    return float(np.median(time_cuda_samples(torch, fn, iters, flush)))


def time_cuda_samples(torch, fn, iters, flush):
    """``time_cuda``'s milliseconds, one per launch."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


#: the segmented sum's launches per route at the last ``reset_counts()``
_SEGSUM_ROUTES0 = {}
#: its launches per route between that reset and the last
#: ``launch_counts()``
SEGSUM_ROUTES = {}


def reset_counts():
    """``reset_launches()``, noting the segmented sum's launches per route
    (which keep running) so that ``launch_counts`` can tell the routes of
    the launches that follow."""
    from repro_torch.kernels import reset_launches, segmented_sum_cuda
    reset_launches()
    _SEGSUM_ROUTES0.update(segmented_sum_cuda.route_launches)


def launch_counts():
    """Each kernel's launches since ``reset_counts()``.  Every main path
    hands the segmented sum the groupby's sorted ids, so every one of its
    launches in that time must have taken the sorted route."""
    from repro_torch.kernels import CUDA_KERNELS, segmented_sum_cuda
    counts = {k.name: k.launches for k in CUDA_KERNELS}
    routes = {r: c - _SEGSUM_ROUTES0.get(r, 0)
              for r, c in segmented_sum_cuda.route_launches.items()}
    check(routes == {"atomic": 0, "sorted": counts["segmented_sum"]},
          f"segmented_sum launches by route {routes}, want all "
          f"{counts['segmented_sum']} on the sorted route")
    SEGSUM_ROUTES.clear()
    SEGSUM_ROUTES.update(routes)
    return counts


def sorted_bucketize(torch, dest, nb):
    """The shuffle's ``impl="sorted"`` bucketize (``dataframe/shuffle.py``):
    a stable sort of ``dest``, each row's rank from ``searchsorted``, the
    counts from ``scatter_add_``; the radix kernel's comparator."""
    srt = torch.sort(dest, dim=1, stable=True)
    pos = torch.arange(dest.shape[1], device=dest.device)
    row_rank = pos - torch.searchsorted(srt.values, srt.values, side="left")
    counts = torch.zeros((dest.shape[0], nb), dtype=torch.int32,
                         device=dest.device).scatter_add_(
        1, dest.to(torch.int64), torch.ones_like(dest))
    return srt.indices, row_rank, counts


#: the radix kernel's MoE dispatch shapes (case, p, n, nb): the
#: olmoe-1b-7b prefill (4 rows of 4,096 tokens, top-8 of 64 experts) and
#: decode step (one token a row), jamba-v0.1-52b's (top-2 of 16), and the
#: shuffle dispatch at olmoe width over 8 stacked ranks
#: (``moe_shuffle_phase``): its outbound shuffle, its return shuffle and
#: its local group-by-expert (8 local experts and the padding bucket)
MOE_RADIX_CASES = (("moe:olmoe-prefill", 4, 32_768, 64),
                   ("moe:olmoe-decode", 4, 8, 64),
                   ("moe:jamba-prefill", 4, 8_192, 16),
                   ("moe:jamba-decode", 4, 2, 16),
                   ("moe:shuffle-out", 8, 16_384, 9),
                   ("moe:shuffle-back", 8, 131_072, 9),
                   ("moe:local-group", 8, 131_072, 9))


def radix_phase(torch, cap, flush, layouts=None, skewed=False,
                recorded=None, moe=False, ranks=P):
    """Radix kernel vs ``radix_partition_ref`` on the card, each case
    labelled with its route.  Without ``layouts``: the main path's shapes
    with uniform buckets, a wide case, a large bucket count (the threepass
    route) and n = 0.  With ``layouts`` ({case: (n, valid rows per rank)},
    read off a Fig-9 run): the shuffle's own layout, a uniform hashed
    prefix of the valid rows and a tail of padding in bucket p, over
    ``ranks`` ranks (1: one process of a group, which still hashes to
    ``P`` destinations).  With
    ``skewed``: the salted shuffles' traffic, ``onepass`` at (8,
    4,194,304, 9) with 99% of every rank's rows in one bucket, so the
    in-bucket ranks reach about 4.15 M.  With ``recorded`` ([(case, dest,
    nb)], the inputs a run handed the kernel), those cases alone.  With
    ``moe``, ``MOE_RADIX_CASES`` with uniform experts.  The main, skewed
    and MoE shapes are also timed through the shuffle's sorted bucketize
    (for the MoE dispatch: the reference's stable ``argsort`` and
    ``searchsorted``)."""
    from repro_torch.kernels import radix_partition_cuda, radix_partition_ref
    from repro_torch.kernels.radix_partition.cuda import route_for
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    if recorded is not None:
        cases = [(name, *dest.shape, nb, dest) for name, dest, nb in recorded]
    elif moe:
        cases = [(name, p, n, nb, None) for name, p, n, nb in MOE_RADIX_CASES]
    elif skewed:
        cases = [("skew:one-bucket", P, 4_194_304, P + 1, "hot")]
    elif layouts is None:
        # (p, n, nb): the join's shuffles (n = cap) and the sort's (n = 4
        # cap) on the main path, then a wide case, a large bucket count and
        # n = 0
        cases = [("main:join", P, cap, P + 1, None),
                 ("main:sort", P, 4 * cap, P + 1, None),
                 ("p8", P, 4_194_304, P + 1, None),
                 # one rank per process: the join's shuffle of each process
                 ("process:join", 1, cap, P + 1, None),
                 ("nb4096", 1, 1_000_003, 4096, None),
                 ("empty", P, 0, P + 1, None)]
    else:
        cases = [(name, ranks, n, P + 1, valid[:ranks])
                 for name, (n, valid) in layouts.items()]
    out = []
    for name, p, n, nb, valid in cases:
        if isinstance(valid, torch.Tensor):     # a recorded input
            dest, valid = valid, (valid < nb - 1).sum(dim=1).tolist()
        elif valid == "hot":
            valid = None
            dest = torch.where(
                torch.rand((p, n), generator=gen, device=dev) < 0.99, 3,
                torch.randint(0, nb, (p, n), generator=gen, device=dev,
                              dtype=torch.int32)).to(torch.int32)
        elif valid is None:
            dest = torch.randint(0, nb, (p, n), generator=gen, device=dev,
                                 dtype=torch.int32)
        else:
            dest = torch.randint(0, nb - 1, (p, n), generator=gen,
                                 device=dev, dtype=torch.int32)
            pad = torch.arange(n, device=dev)[None, :] >= torch.as_tensor(
                valid, device=dev)[:, None]
            dest[pad] = nb - 1
        route = route_for(nb)
        before = radix_partition_cuda.route_launches[route]
        ranks, hist = radix_partition_cuda(dest, nb)
        want_r, want_h = radix_partition_ref(dest, nb)
        torch.cuda.synchronize()
        check(radix_partition_cuda.route_launches[route] == before + 1,
              f"radix_partition {name}: not launched on its {route} route")
        check(torch.equal(ranks, want_r) and torch.equal(hist, want_h),
              f"radix_partition CUDA != plain at {name} {(p, n, nb)}")
        err = max(int((ranks - want_r).abs().max()) if n else 0,
                  int((hist - want_h).abs().max()))
        del ranks, hist, want_r, want_h
        ms = time_cuda(torch, lambda: radix_partition_cuda(dest, nb), 20,
                       flush)
        plain_ms = time_cuda(torch, lambda: radix_partition_ref(dest, nb),
                             3, flush)
        sorted_ms = (time_cuda(torch, lambda: sorted_bucketize(torch, dest,
                                                               nb), 5, flush)
                     if name.startswith(("main:", "skew:", "moe:"))
                     else None)
        # bytes the function must move: dest read once, ranks and the
        # histogram written once; it does no arithmetic worth counting
        nbytes = 4 * p * n * 2 + 4 * p * nb
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        out.append(dict(case=name, route=route, p=p, n=n, nb=nb, ms=ms,
                        plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by="bytes", library_ms=None,
                        sorted_ms=sorted_ms, valid_rows=valid,
                        max_abs_err=err))
        print(f"kernel radix_partition {name:16s} [{route}] p={p} n={n} "
              f"nb={nb}: {ms:.4f} ms (plain {plain_ms:.3f} ms, bound "
              f"{bound_ms:.4f} ms), exact"
              + (f"; valid rows per rank {valid}" if valid else ""),
              flush=True)
        if sorted_ms is not None:
            print(f"comparator radix_partition {name:16s} sorted bucketize "
                  f"(stable sort, searchsorted, scatter_add_): "
                  f"{sorted_ms:.4f} ms", flush=True)
        del dest
    torch.cuda.empty_cache()
    return out


def recording(env, run, notes):
    """Run ``run()`` with each ``(module, function, note)`` of ``notes``
    wrapped so that ``note`` sees the arguments of every call, keywords
    included (the module's own name for the function, as its callers there
    use it)."""
    import importlib
    patched = []
    for mod_name, attr, note in notes:
        mod = importlib.import_module(mod_name)
        real = getattr(mod, attr)

        def wrapped(*args, _real=real, _note=note, **kw):
            _note(*args, **kw)
            return _real(*args, **kw)
        setattr(mod, attr, wrapped)
        patched.append((mod, attr, real))
    try:
        run()
        env.synchronize()
    finally:
        for mod, attr, real in patched:
            setattr(mod, attr, real)


def radix_layouts(env, run):
    """{case: (n, valid rows per rank)} of the radix kernel's calls in one
    run: the first call at the join's shape and the first at the sort's
    (the valid rows are those below the pad bucket p)."""
    seen = []
    recording(env, run, [(
        "repro_torch.dataframe.shuffle", "radix_partition",
        lambda dest, nb: seen.append(
            (dest.shape[1], (dest < nb - 1).sum(dim=1).tolist())))])
    ns = sorted({n for n, _ in seen})
    check(len(ns) == 2, f"radix calls at shapes {ns}, want the join's and "
          f"the sort's")
    return {f"main:{name}-layout": next((n, v) for n, v in seen if n == want)
            for name, want in zip(("join", "sort"), ns)}


def fig9_join_ids(torch, rows, p, cap, gen, dev):
    """Segment ids and values of the Fig-9 groupby's own ``segmented_sum``
    call, made on the card: per rank, the join output of ``rows / p`` left
    and right rows over ``0.9 rows / p`` keys (each key repeated
    ``cnt_l * cnt_r`` times, sorted), then padding rows at ``cap - 1``
    with value 0, as ``groupby_local`` hands them to the kernel."""
    per, keys = rows // p, int(0.9 * rows) // p
    seg = torch.full((p, cap), cap - 1, dtype=torch.int32, device=dev)
    vals = torch.zeros((p, cap), dtype=torch.float32, device=dev)
    for r in range(p):
        cl, cr = (torch.bincount(torch.randint(0, keys, (per,), generator=gen,
                                               device=dev), minlength=keys)
                  for _ in range(2))
        mult = cl * cr
        hit = torch.nonzero(mult).flatten()
        ids = torch.repeat_interleave(
            torch.arange(hit.numel(), dtype=torch.int32, device=dev),
            mult[hit])
        seg[r, :ids.numel()] = ids
        vals[r, :ids.numel()] = torch.rand(ids.numel(), generator=gen,
                                           device=dev)
    return seg, vals


def segsum_phase(torch, cap, flush, recorded=None, skewed=False):
    """Segmented-sum kernel vs ``segmented_sum_ref`` on the card, through
    both routes where the ids are sorted (``segsum_cases``); the first case
    is the Fig-9 groupby's call (n = S = the join's out_capacity), timed
    beside ``scatter_add_`` and ``index_add_`` at that shape, and
    ``fixed:n=4096`` splits the fixed cost from the streaming cost (4,096
    rows at the served queries' S = 8,388,608).  With
    ``recorded`` ([(case, ids, values, S)], the inputs a run handed the
    kernel), those cases alone.  With ``skewed``: the salted groupby's
    traffic, (8, n = S = 4,194,304) with one segment holding 99% of every
    rank's rows (sorted ids, as ``groupby_local`` hands them over; int32
    values, exact), timed beside the same two calls."""
    if recorded is not None:
        return segsum_cases(torch, recorded, flush)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    if skewed:
        n = 4_194_304
        ids = torch.where(
            torch.rand((P, n), generator=gen, device=dev) < 0.99, 7,
            torch.randint(0, n, (P, n), generator=gen, device=dev,
                          dtype=torch.int32)).to(torch.int32)
        ids = torch.sort(ids, dim=1).values
        # int32 values, held exactly: a float32 sum of 4 M values passes
        # 2**24, where the plain version's own order loses more than the
        # repo's 1e-5 (the contention on one address is the same)
        vals = torch.randint(0, 100, (P, n), generator=gen, device=dev,
                             dtype=torch.int32)
        out = segsum_cases(torch, [("skew:hot-segment", ids, vals, n)],
                           flush)
        del ids, vals
        torch.cuda.empty_cache()
        return out

    def sorted_ids(p, n, s):
        return torch.sort(torch.randint(0, s, (p, n), generator=gen,
                                        device=dev, dtype=torch.int32),
                          dim=1).values

    def floats(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    main_seg, main_vals = fig9_join_ids(torch, FULL_ROWS, P, 4 * cap, gen,
                                        dev)
    # (name, ids, values, S): the main path's call, then unsorted ids, C=4,
    # int32 (exact), a row count off the 8192-row tile, n = 0, ids outside
    # [0, S), and the small sweep of tests/test_kernels.py:17-37
    cases = [("main", main_seg, main_vals, 4 * cap),
             # one rank per process: each process's groupby call
             ("process:main", main_seg[:1].contiguous(),
              main_vals[:1].contiguous(), 4 * cap),
             ("unsorted", torch.randint(0, 1 << 20, (P, 1 << 22),
                                        generator=gen, device=dev,
                                        dtype=torch.int32),
              floats(P, 1 << 22), 1 << 20),
             ("c4", sorted_ids(P, 1 << 20, 1 << 18), floats(P, 1 << 20, 4),
              1 << 18),
             ("int32", main_seg, torch.randint(
                 -50, 50, main_seg.shape, generator=gen, device=dev,
                 dtype=torch.int32) * (main_seg < 4 * cap - 1), 4 * cap),
             ("ragged", sorted_ids(3, 1_000_003, 50_000),
              floats(3, 1_000_003), 50_000),
             ("empty", torch.zeros((P, 0), dtype=torch.int32, device=dev),
              floats(P, 0), 16),
             ("oob", torch.randint(-5, 1005, (2, 1 << 20), generator=gen,
                                   device=dev, dtype=torch.int32),
              floats(2, 1 << 20), 1000)]
    # the fixed cost at the served queries' S (2, 8,388,608): 4,096 rows
    # counting up from 0 as the groupby's do, the rest of S one gap
    cases.append(("fixed:n=4096", (torch.arange(
        4096, device=dev, dtype=torch.int32) // 2).expand(2, 4096)
        .contiguous(), floats(2, 4096), 8_388_608))
    for n, segs, cols in ((64, 5, 1), (500, 37, 3), (1024, 512, 2),
                          (300, 1, 4)):
        ids = sorted_ids(1, n, segs)
        cases.append((f"sweep{n}f", ids, floats(1, n, cols), segs))
        cases.append((f"sweep{n}i", ids, torch.randint(
            -50, 50, (1, n, cols), generator=gen, device=dev,
            dtype=torch.int32), segs))
    out = segsum_cases(torch, cases, flush)
    del cases, main_seg, main_vals
    torch.cuda.empty_cache()
    return out


def segsum_cases(torch, cases, flush):
    """Each ``(case, ids, values, S)`` through both of the kernel's routes
    where the ids are non-decreasing within each rank (the ``atomic``
    route alone otherwise), each held to the plain version and the
    ``sorted`` route also bit for bit to a second call of itself; both
    timed in turns in this run (atomic, sorted, sorted, atomic; as
    ``time_cuda`` times every kernel) with each route's host time a call
    beside it, the bound, the plain version and, for the main,
    hot-segment, fixed-cost, out-of-core, served and per-process cases, one
    ``scatter_add_`` and one ``index_add_`` call."""
    from repro_torch.kernels import segmented_sum_cuda, segmented_sum_ref
    dev = torch.device("cuda")
    out = []
    for name, seg, vals, s in cases:
        p, n = seg.shape
        c = vals.shape[2] if vals.dim() == 3 else 1
        ordered = n < 2 or bool((seg[:, 1:] >= seg[:, :-1]).all())
        routes = ("atomic", "sorted") if ordered else ("atomic",)
        want = segmented_sum_ref(seg, vals, s)
        errs, tol, identical = {}, "exact", None
        for route in routes:
            before = segmented_sum_cuda.route_launches[route]
            got = segmented_sum_cuda(seg, vals, s,
                                     sorted_ids=route == "sorted")
            torch.cuda.synchronize()
            check(n == 0 or segmented_sum_cuda.route_launches[route]
                  == before + 1, f"segmented_sum {name}: not launched on "
                  f"its {route} route")
            if vals.dtype in (torch.int32, torch.int64):
                ok = torch.equal(got, want)
                err = float((got - want).abs().max()) if got.numel() else 0.
            else:
                # tests/test_kernels.py's tolerance: float sums in another
                # order
                diff = (got - want).abs()
                ok = bool((diff <= 1e-5 * want.abs() + 1e-5).all())
                tol = "1e-5 |want| + 1e-5"
                err = float(diff.max()) if got.numel() else 0.0
            check(ok, f"segmented_sum CUDA ({route}) != plain at {name}: "
                  f"max |err| {err} beyond {tol}")
            errs[route] = err
            if route == "sorted":
                # the sorted route adds in a fixed order: bit-identical
                again = segmented_sum_cuda(seg, vals, s, sorted_ids=True)
                identical = torch.equal(got.view(torch.uint8),
                                        again.view(torch.uint8))
                check(identical, f"segmented_sum sorted route at {name}: "
                      f"two calls differ")
                del again
            del got
        main = name in ("main", "unsorted", "int32", "skew:hot-segment") \
            or name.startswith(("ooc:", "serve:", "fixed:", "process:"))
        iters = 10 if main else 3
        samples = {r: [] for r in routes}
        for route in (("atomic", "sorted", "sorted", "atomic") if ordered
                      else ("atomic", "atomic")):
            samples[route] += time_cuda_samples(
                torch, lambda r=route: segmented_sum_cuda(
                    seg, vals, s, sorted_ids=r == "sorted"), iters, flush)
        ms = {r: float(np.median(v)) for r, v in samples.items()}
        # the wrapper's host time a call (checks, allocations, launches):
        # where it passes the L2 overwrite's device time, the rest shows in
        # the CUDA-event time above
        host_us = {}
        for route in routes:
            torch.cuda.synchronize()
            t = []
            for _ in range(10):
                t0 = time.perf_counter()
                segmented_sum_cuda(seg, vals, s, sorted_ids=route == "sorted")
                t.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            host_us[route] = float(np.median(t)) * 1e6
        plain_ms = float(np.median(time_cuda_samples(
            torch, lambda: segmented_sum_ref(seg, vals, s),
            3 if main else 2, flush)))
        lib = None
        if name in ("main", "skew:hot-segment") or name.startswith(
                ("ooc:", "serve:", "fixed:", "process:")):
            # one PyTorch call each over the same inputs (zero-filled
            # output included)
            idx = seg.to(torch.int64)
            if vals.dim() == 3:
                idx = idx[..., None].expand(vals.shape)
            rows = idx if vals.dim() == 2 else idx[..., 0]
            flat = (rows + torch.arange(p, device=dev)[:, None] * s).flatten()
            lib = {"scatter_add_": float(np.median(time_cuda_samples(
                       torch, lambda: torch.zeros(
                           (p, s) + tuple(vals.shape[2:]), dtype=vals.dtype,
                           device=dev).scatter_add_(1, idx, vals), 5, flush))),
                   "index_add_": float(np.median(time_cuda_samples(
                       torch, lambda: torch.zeros(
                           (p * s,) + tuple(vals.shape[2:]),
                           dtype=vals.dtype, device=dev).index_add_(
                           0, flat, vals.flatten(0, 1)), 5, flush)))}
            del idx, flat, rows
        # bytes the function must move: ids and values read once, the sums
        # written once; one addition per value is far below the f32 peak
        nbytes = 4 * p * n + vals.element_size() * c * (p * n + p * s)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        route = routes[-1]  # the route the main paths take where they can
        valid = int((seg < s - 1).sum()) if name == "main" else None
        out.append(dict(case=name, route=route, p=p, n=n, segments=s,
                        cols=c, dtype=str(vals.dtype).split(".")[-1],
                        ms=ms[route], atomic_ms=ms["atomic"],
                        sorted_ms=ms.get("sorted"), plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by="bytes",
                        library_ms=lib["scatter_add_"] if lib else None,
                        library=lib, max_abs_err=max(errs.values()),
                        bit_identical=identical, host_us=host_us))
        extra = (f", scatter_add_ {lib['scatter_add_']:.3f} ms, index_add_ "
                 f"{lib['index_add_']:.3f} ms" if lib else "")
        if valid is not None:
            extra += f", {valid} valid rows of {p * n}"
        timing = " ".join(f"{r} {ms[r]:.4f} ms ({bound_ms / ms[r]:.0%} of "
                          f"bound; host {host_us[r]:.1f} us)" for r in routes)
        print(f"kernel segmented_sum {name:10s} p={p} n={n} S={s} C={c} "
              f"{out[-1]['dtype']}: {timing} (plain {plain_ms:.3f} ms, bound "
              f"{bound_ms:.4f} ms{extra}), max |err| {max(errs.values()):.2e}"
              f" ({tol})" + ("; sorted route bit-identical across calls"
                             if identical else ""), flush=True)
        del want
    torch.cuda.empty_cache()
    return out


def segsum_launches_expected(pplan, mode):
    """``segmented_sum`` launches one run of ``pplan`` makes on the card:
    one per sum, count and size aggregate of every ``groupby_local`` call.
    A groupby calls it once, or twice when it shuffles with
    pre-aggregation (``bsp`` / ``bsp_staged`` only; ``amt`` ships raw
    rows)."""
    from repro_torch.dataframe.groupby import _normalize
    total = 0
    for n in pplan.order:
        if n.op != "groupby":
            continue
        physical, _ = _normalize(n.params["aggs"])
        sums = sum(a in ("sum", "count", "size")
                   for names in physical.values() for a in names)
        two = (mode != "amt" and not n.params.get("elide_shuffle")
               and n.params.get("pre_aggregate", False))
        total += sums * (2 if two else 1)
    return total


def check_launches(counts, pplan, mode, st, on_card, label, routes=None):
    """One radix launch per direct shuffle (none on ``amt``'s all-gather),
    every one on the onepass route when ``routes`` (launches per route in
    the run) is given, and one segmented_sum launch per sum / count / size
    aggregate of every ``groupby_local`` call (``amt`` included), on the
    card; none on the CPU (plain versions)."""
    want = st.num_shuffles if on_card and mode != "amt" else 0
    check(counts["radix_partition"] == want, f"{label}: radix_partition "
          f"launched {counts['radix_partition']} times, want {want}")
    if routes is not None:
        check(routes == {"onepass": want, "threepass": 0}, f"{label}: "
              f"radix_partition routes {routes}, want {want} onepass")
    want = segsum_launches_expected(pplan, mode) if on_card else 0
    check(counts["segmented_sum"] == want and (want or not on_card),
          f"{label}: segmented_sum launched {counts['segmented_sum']} "
          f"times, want {want} > 0")


def host_reference(ld, rd):
    """What the Fig-9 result must be, from numpy on the host."""
    n_keys = int(max(ld["k"].max(), rd["k"].max())) + 1
    cnt_l = np.bincount(ld["k"], minlength=n_keys).astype(np.int64)
    cnt_r = np.bincount(rd["k"], minlength=n_keys).astype(np.int64)
    sum_l = np.bincount(ld["k"], weights=ld["v0"].astype(np.float64),
                        minlength=n_keys)
    both = (cnt_l * cnt_r) > 0
    keys = np.nonzero(both)[0].astype(np.int32)
    # the join keeps the left v0; each left row meets cnt_r partners
    sums = (sum_l * cnt_r)[both] + 1.0
    return int((cnt_l * cnt_r).sum()), keys, sums


def check_fig9(res, stats, ref, label):
    _, keys, sums = ref
    out = res.to_numpy()
    check(stats.rows_dropped == 0, f"{label}: {stats.rows_dropped} rows "
          f"dropped")
    check(len(out["k"]) == len(keys), f"{label}: {len(out['k'])} groups, "
          f"want {len(keys)}")
    check(bool(np.all(np.diff(out["k"]) > 0)), f"{label}: keys not in "
          f"global order")
    check(np.array_equal(out["k"], keys), f"{label}: group keys differ")
    got = out["v0_sum"].astype(np.float64)
    check(abs(got.sum() - sums.sum()) <= 1e-3 * abs(sums.sum()),
          f"{label}: v0_sum total {got.sum()} vs {sums.sum()}")
    rel = np.abs(got - sums) / np.maximum(np.abs(sums), 1.0)
    check(float(rel.max()) <= 1e-3, f"{label}: v0_sum off by {rel.max()}")
    join_out = [r for r in stats.shuffle_records
                if r.label == "join(k):overflow"]
    check(bool(join_out) and join_out[0].dropped == 0,
          f"{label}: join output overflowed")


def main_path_phase(torch, rows=FULL_ROWS, device=None):
    """Fig-9 at ``rows`` per table; returns (kernel launches per run, radix
    launches per route per run, segmented-sum launches per route per run,
    wall times), each keyed by ``"<mode>/<first|cached>"``, and the radix
    kernel's call layouts of one more ``bsp`` run (``radix_layouts``).
    ``device=None`` is the card, as a user calling the port gets it."""
    from repro_torch.core import CylonEnv, DistTable, Plan, execute
    from repro_torch.kernels import radix_partition_cuda
    from repro_torch.planner import compile_plan
    t0 = time.perf_counter()
    ld, rd = make_table_data(rows, 0), make_table_data(rows, 1)
    cap = capacity_for(rows, P)
    env = CylonEnv(P, device=device)
    tables = {"l": DistTable.from_numpy(ld, P, capacity=cap, device=device),
              "r": DistTable.from_numpy(rd, P, capacity=cap, device=device)}
    ref = host_reference(ld, rd)
    env.synchronize()
    on_card = env.device.type == "cuda"
    print(f"main path: 2 x {rows} rows over {P} stacked ranks, "
          f"capacity {cap}/rank; set-up {time.perf_counter() - t0:.2f} s; "
          f"expect {ref[0]} join rows, {len(ref[1])} groups", flush=True)
    plan = fig9_plan(Plan, cap)
    print(plan.explain(tables), flush=True)
    pplan = compile_plan(plan, tables)
    walls, launches, route_launches, segsum_routes = {}, {}, {}, {}
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    for mode in ("bsp", "bsp_staged", "amt"):
        for run in ("first", "cached"):
            env.synchronize()
            reset_counts()
            routes0 = dict(radix_partition_cuda.route_launches)
            t = time.perf_counter()
            res, st = execute(plan, env, tables, mode=mode,
                              collect_stats=True)
            env.synchronize()
            wall = time.perf_counter() - t
            counts = launch_counts()
            routes = {r: radix_partition_cuda.route_launches[r] - routes0[r]
                      for r in routes0}
            walls[f"{mode}/{run}"] = wall
            launches[f"{mode}/{run}"] = counts
            route_launches[f"{mode}/{run}"] = routes
            segsum_routes[f"{mode}/{run}"] = dict(SEGSUM_ROUTES)
            check_launches(counts, pplan, mode, st, on_card, f"{mode}/{run}",
                           routes if on_card else None)
            if on_card and mode != "amt":
                check(counts["radix_partition"] == 3, f"{mode}/{run}: "
                      f"{counts['radix_partition']} radix launches, want 3")
            if run == "cached":
                check(st.cache_misses == 0, f"{mode}: {st.cache_misses} "
                      f"cache misses on the repeat run")
            stages = ", ".join(f"{n}={s * 1e3:.1f}ms"
                               for n, s in st.stage_times)
            print(f"fig9 {mode:10s} {run:6s} wall {wall * 1e3:9.2f} ms  "
                  f"dispatches={st.dispatches} shuffles={st.num_shuffles} "
                  f"rows_shuffled={st.rows_shuffled} "
                  f"cache_hits={st.cache_hits} "
                  f"cache_misses={st.cache_misses} launches={counts} "
                  f"radix routes={routes} [{stages}]", flush=True)
            check_fig9(res, st, ref, f"{mode}/{run}")
            check(st.adaptive and st.salted_shuffles == 0,
                  f"{mode}/{run}: adaptive {st.adaptive}, "
                  f"{st.salted_shuffles} salted shuffles on uniform keys")
            del res
    detection_overhead(env, plan, tables, walls)
    # the join's row count, from the join alone (after the counts are read)
    joined = execute(Plan.scan("l").join(Plan.scan("r"), on="k",
                                         out_capacity=4 * cap),
                     env, tables, collect_stats=True)[0]
    check(joined.total_rows() == ref[0], f"join: {joined.total_rows()} "
          f"rows, want {ref[0]}")
    peak = (f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
            if on_card else "not measured")
    print(f"peak device memory {peak}", flush=True)
    layouts = radix_layouts(env, lambda: execute(plan, env, tables,
                                                 mode="bsp"))
    print(f"radix call layouts of a bsp run (n, valid rows per rank): "
          f"{layouts}", flush=True)
    if on_card:
        profile_run(env, lambda: execute(plan, env, tables, mode="bsp"),
                    "bsp (cached run under the profiler)")
    return launches, route_launches, segsum_routes, walls, layouts


def detection_overhead(env, plan, tables, walls, reps=5):
    """The default (adaptive on) against ``adaptive=False`` on the
    uniform Fig-9 keys: the default builds no stage that ``adaptive=False``
    does not (the stage-cache keys are equal, no miss on either), and
    the cached walls of the two, each mode once and ``bsp`` ``reps``
    times alternating, go into ``walls`` (``<mode>/cached_adaptive_off``
    and the ``bsp`` medians)."""
    from repro_torch.core import execute
    keys = set(env._cache)
    for mode in ("bsp", "bsp_staged", "amt"):
        env.synchronize()
        t = time.perf_counter()
        res, st = execute(plan, env, tables, mode=mode, collect_stats=True,
                          adaptive=False)
        env.synchronize()
        walls[f"{mode}/cached_adaptive_off"] = time.perf_counter() - t
        check(st.cache_misses == 0 and not st.adaptive, f"{mode} "
              f"adaptive=False: {st.cache_misses} stages built anew")
        del res
    check(set(env._cache) == keys, "adaptive=False used stage-cache keys "
          "the default (adaptive on) run did not")
    bsp = {True: [], False: []}
    for _ in range(reps):
        for adaptive in (True, False):
            env.synchronize()
            t = time.perf_counter()
            execute(plan, env, tables, mode="bsp", adaptive=adaptive)
            env.synchronize()
            bsp[adaptive].append(time.perf_counter() - t)
    walls["bsp/cached_median_default"] = float(np.median(bsp[True]))
    walls["bsp/cached_median_adaptive_off"] = float(np.median(bsp[False]))
    print(f"fig9 detection overhead (uniform keys, nothing salted, same "
          f"stages): cached wall adaptive=False "
          + ", ".join(f"{m} {walls[f'{m}/cached_adaptive_off'] * 1e3:.2f} ms"
                      for m in ("bsp", "bsp_staged", "amt"))
          + f"; bsp median of {reps} alternating runs: default "
          f"{walls['bsp/cached_median_default'] * 1e3:.2f} ms, "
          f"adaptive=False {walls['bsp/cached_median_adaptive_off'] * 1e3:.2f}"
          f" ms", flush=True)


def fig9_frontend(l_df, r_df, cap):
    """The Fig-9 pipeline written against ``repro_torch.df`` (the shape of
    ``tests/test_df_frontend.py::fig9_frontend``, without its filter)."""
    from repro_torch.expr import col
    return (l_df.merge(r_df, on="k", out_capacity=4 * cap)
            .groupby("k").agg({"v0": ["sum", "mean"]})
            .sort_values("k")
            .assign(v0_sum=col("v0_sum") + 1.0))


def fig9_with_plan(Plan, cap):
    """The same pipeline built with ``Plan``."""
    from repro_torch.expr import col
    return (Plan.scan("l").join(Plan.scan("r"), on="k", out_capacity=4 * cap)
            .groupby(["k"], {"v0": ["sum", "mean"]}).sort(["k"])
            .with_columns({"v0_sum": col("v0_sum") + 1.0}))


def frontend_phase(torch, rows=FULL_ROWS, device=None, smi=""):
    """Fig-9 through ``repro_torch.df`` at ``rows`` per table over ``P``
    stacked ranks, with the main path's data and capacities, in every mode,
    first and cached; held to the host reference, and to the same
    pipeline built with ``Plan`` and run through ``execute`` (equal
    EXPLAIN, equal result, and no stage built anew).  Then one ``bsp`` run
    of the same frames under ``session(devices=lease)``, a lease of ``P``
    slots of a ``DevicePool``: the lease's slots are the env's ranks, and
    its result holds the cached ``bsp`` run's bits in every slot
    (``same_slots``).  Returns (launches, wall times) by
    ``"<mode>/<run>"``."""
    import repro_torch.df as rdf
    from repro_torch.core import DevicePool, Plan, execute
    from repro_torch.planner import compile_plan
    t0 = time.perf_counter()
    ld, rd = make_table_data(rows, 0), make_table_data(rows, 1)
    cap = capacity_for(rows, P)
    ref = host_reference(ld, rd)
    cnt_l = np.bincount(ld["k"])[ref[1]]
    means = np.bincount(ld["k"], weights=ld["v0"].astype(np.float64)
                        )[ref[1]] / cnt_l
    walls, launches = {}, {}
    with rdf.session(parallelism=P, device=device) as env:
        front = fig9_frontend(rdf.read_numpy(ld, capacity=cap, name="l"),
                              rdf.read_numpy(rd, capacity=cap, name="r"), cap)
        env.synchronize()
        on_card = env.device.type == "cuda"
        print(f"frontend: 2 x {rows} rows over {P} stacked ranks through "
              f"repro_torch.df; set-up {time.perf_counter() - t0:.2f} s",
              flush=True)
        text = front.explain()
        print(text, flush=True)
        plan = fig9_with_plan(Plan, cap)
        check(plan.explain(front.sources) == text,
              "frontend EXPLAIN differs from the Plan-built pipeline's")
        pplan = compile_plan(front.plan, front.sources)
        for mode in ("bsp", "bsp_staged", "amt"):
            for run in ("first", "cached"):
                env.synchronize()
                reset_counts()
                t = time.perf_counter()
                res, st = front.collect(mode=mode, collect_stats=True)
                env.synchronize()
                wall = time.perf_counter() - t
                counts = launch_counts()
                label = f"frontend {mode}/{run}"
                walls[f"{mode}/{run}"], launches[f"{mode}/{run}"] = \
                    wall, counts
                check_launches(counts, pplan, mode, st, on_card, label)
                if run == "cached":
                    check(st.cache_misses == 0, f"{label}: "
                          f"{st.cache_misses} cache misses")
                print(f"fig9 frontend {mode:10s} {run:6s} wall "
                      f"{wall * 1e3:9.2f} ms  dispatches={st.dispatches} "
                      f"cache_hits={st.cache_hits} "
                      f"cache_misses={st.cache_misses} launches={counts}",
                      flush=True)
                check_fig9(res, st, ref, label)
                if (mode, run) == ("bsp", "cached"):
                    kept = res
                got = res.to_numpy()
                rel = (np.abs(got["v0_mean"] - means)
                       / np.maximum(np.abs(means), 1.0))
                check(float(rel.max()) <= 1e-3, f"{label}: v0_mean off by "
                      f"{rel.max()}")
                del res
            # the Plan-built pipeline reuses the frontend's stages
            built, st = execute(plan, env, front.sources, mode=mode,
                                collect_stats=True)
            check(st.cache_misses == 0, f"Plan-built {mode}: "
                  f"{st.cache_misses} stages built anew")
            want = built.to_numpy()
            check(sorted(want) == sorted(got) and all(
                np.array_equal(got[c], want[c]) for c in got),
                f"frontend {mode}: result differs from the Plan-built one")
            print(f"fig9 frontend {mode}: equal to the Plan-built pipeline "
                  f"({len(got['k'])} groups)", flush=True)
            del built, want, got
        env.synchronize()
        t = time.perf_counter()
        _, st = front.collect(mode="bsp", collect_stats=True, adaptive=False)
        env.synchronize()
        walls["bsp/cached_adaptive_off"] = time.perf_counter() - t
        check(st.cache_misses == 0, f"frontend adaptive=False: "
              f"{st.cache_misses} stages built anew")
        print(f"fig9 frontend bsp cached adaptive=False wall "
              f"{walls['bsp/cached_adaptive_off'] * 1e3:9.2f} ms (same "
              f"stages)", flush=True)
    # the same frames (not pinned to an env) on a lease's rank slots
    t_added = time.perf_counter()
    with DevicePool(slots=P, device=device).reserve(P) as lease:
        with rdf.session(devices=lease) as lenv:
            check(lenv.slot_ids == lease.indices and lenv.parallelism == P
                  and lenv.device == env.device,
                  f"session(devices=lease): env on slots {lenv.slot_ids} "
                  f"of {lenv.device}, lease {lease.indices}")
            label = "frontend bsp/devices=lease"
            lenv.synchronize()
            reset_counts()
            t = time.perf_counter()
            res, st = front.collect(mode="bsp", collect_stats=True)
            lenv.synchronize()
            wall = time.perf_counter() - t
            counts = launch_counts()
            check_launches(counts, pplan, "bsp", st, on_card, label)
            check(st.rows_dropped == 0, f"{label}: rows dropped")
            check(same_slots(torch, res, kept), f"{label}: differs from "
                  f"session(parallelism={P})'s cached bsp run")
            del res, kept
    walls["bsp/devices_lease"], launches["bsp/devices_lease"] = wall, counts
    walls["devices_lease_added"] = time.perf_counter() - t_added
    print(f"fig9 frontend bsp under session(devices=DevicePool(slots={P})"
          f".reserve({P})) wall {wall * 1e3:9.2f} ms (first run on the "
          f"lease's env: its stages built); bit-identical in every slot to "
          f"session(parallelism={P})'s cached bsp run; launches={counts}; "
          f"added {walls['devices_lease_added']:.2f} s to the script; "
          f"card: {smi}", flush=True)
    return launches, walls


def strings_phase(torch, rows=1 << 22, vocab=1 << 18, device=None):
    """A string-keyed run through ``repro_torch.df``: two tables of
    ``rows`` fixed-width ``<U12`` keys drawn from ``vocab`` words, whose
    dictionaries differ (left from the first 3/4 of the words, right from
    the last 3/4), merged (EXPLAIN shows ``recode[...]``), grouped with
    sum and count, sorted, and held to numpy on the host.  Returns
    (launches, wall times) by run."""
    import repro_torch.df as rdf
    from repro_torch.planner import compile_plan
    rng = np.random.default_rng(5)
    words = np.array([f"w{i:011d}" for i in range(vocab)])
    li = rng.integers(0, 3 * vocab // 4, rows)
    ri = rng.integers(vocab // 4, vocab, rows)
    ld = {"s": words[li], "v": rng.random(rows).astype(np.float32)}
    rd = {"s": words[ri], "w": rng.random(rows).astype(np.float32)}
    # the host reference works on the word indices, not on the encoder's
    # codes: the words sort as their indices do
    cnt_l = np.bincount(li, minlength=vocab)
    cnt_r = np.bincount(ri, minlength=vocab)
    pairs = cnt_l * cnt_r
    both = pairs > 0
    keys, sizes = words[both], pairs[both]
    sums = (np.bincount(li, weights=ld["v"].astype(np.float64),
                        minlength=vocab) * cnt_r)[both]
    cap, out_cap = capacity_for(rows, P), capacity_for(int(pairs.sum()), P)
    walls, launches = {}, {}
    with rdf.session(parallelism=P, device=device) as env:
        t = time.perf_counter()
        l_df = rdf.read_numpy(ld, capacity=cap, name="ls")
        r_df = rdf.read_numpy(rd, capacity=cap, name="rs")
        env.synchronize()
        print(f"strings: 2 x {rows} {ld['s'].dtype} keys from {vocab} words "
              f"over {P} stacked ranks; host encode + copy "
              f"{time.perf_counter() - t:.2f} s; expect {int(pairs.sum())} "
              f"join rows, {len(keys)} groups", flush=True)
        on_card = env.device.type == "cuda"
        q = (l_df.merge(r_df, on="s", out_capacity=out_cap)
             .groupby("s").agg({"v": ["sum", "count"]}).sort_values("s"))
        text = q.explain()
        print(text, flush=True)
        check("recode[s:|D|=" in text and "recode: join(s)" in text,
              "strings: EXPLAIN shows no recode")
        pplan = compile_plan(q.plan, q.sources)
        for run in ("first", "cached"):
            env.synchronize()
            reset_counts()
            t = time.perf_counter()
            res, st = q.collect(collect_stats=True)
            env.synchronize()
            wall = time.perf_counter() - t
            counts = launch_counts()
            walls[run], launches[run] = wall, counts
            label = f"strings bsp/{run}"
            check_launches(counts, pplan, "bsp", st, on_card, label)
            check(st.rows_dropped == 0, f"{label}: {st.rows_dropped} rows "
                  f"dropped")
            if run == "cached":
                check(st.cache_misses == 0, f"{label}: {st.cache_misses} "
                      f"cache misses")
            t = time.perf_counter()
            out = res.to_numpy()
            decode = time.perf_counter() - t
            check(res.dictionaries["s"] == tuple(
                words[(cnt_l + cnt_r) > 0]), f"{label}: the result's "
                f"dictionary is not the merged one")
            check(np.array_equal(out["s"], keys), f"{label}: group keys "
                  f"differ")
            check(np.array_equal(out["v_count"], sizes), f"{label}: "
                  f"counts differ")
            rel = np.abs(out["v_sum"] - sums) / np.maximum(np.abs(sums), 1.0)
            check(float(rel.max()) <= 1e-3, f"{label}: v_sum off by "
                  f"{rel.max()}")
            print(f"strings {run:6s} wall {wall * 1e3:9.2f} ms "
                  f"(decode {decode * 1e3:.1f} ms) dispatches="
                  f"{st.dispatches} cache_misses={st.cache_misses} "
                  f"launches={counts}: {len(keys)} groups equal to numpy",
                  flush=True)
            del res, out
        # the host's share of a run: planning alone (every collect
        # compiles the plan, dictionaries and recode tables included)
        t = time.perf_counter()
        compile_plan(q.plan, q.sources)
        print(f"strings: compile_plan (host) {time.perf_counter() - t:.3f} s "
              f"of the cached run's {walls['cached']:.3f} s", flush=True)
        if on_card:
            profile_run(env, q.collect,
                        "strings bsp (cached run under the profiler)")
    return launches, walls


def profile_run(env, run, title, top=10):
    """One more cached run, ``run()``, under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    env.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        env.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    report_profile(prof, wall_ms, title, top)


def report_profile(prof, wall_ms, title, top=10):
    """Device time by PyTorch operator and by kernel, and the device's
    busy share of the window's wall time (the profiler's own overhead is
    in that wall time)."""
    from torch.autograd import DeviceType

    def dev_ms(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0)) / 1e3
    events = [e for e in prof.key_averages() if dev_ms(e) > 0]
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    # host-side rows other than aten operators (e.g. the profiler's
    # "Command Buffer Full", a wait on a full launch queue) are not work
    ops = [e for e in events if e.key.startswith("aten::")]
    busy = sum(dev_ms(e) for e in kernels)
    if not busy:
        print(f"profile {title}: the profiler recorded no device time; "
              f"device busy share not measured", flush=True)
        return None
    print(f"profile {title}: wall {wall_ms:.1f} ms, device busy "
          f"{busy:.1f} ms ({100 * busy / wall_ms:.1f}%, idle "
          f"{100 - 100 * busy / wall_ms:.1f}%), {sum(e.count for e in kernels)}"
          f" kernel launches", flush=True)
    for name, rows in (("by operator", ops), ("by kernel", kernels)):
        print(f"profile {title}, device time {name}:")
        for e in sorted(rows, key=dev_ms, reverse=True)[:top]:
            print(f"  {dev_ms(e):9.2f} ms {100 * dev_ms(e) / busy:5.1f}% "
                  f"{e.count:5d}x  {e.key[:100]}")
    return busy


def profile_serve(torch, engine, prompts, arch, steps=8, top=8, offset=0):
    """One prefill, then ``steps`` greedy decode steps, each window under
    ``torch.profiler``: where the device time goes and how much of the
    wall time the device is idle.  ``offset``: positions ahead of the
    prompts (a vlm's patch embeddings)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    tokens = torch.as_tensor(prompts, dtype=torch.long, device="cuda")
    torch.cuda.synchronize()
    spans = []
    with moe_timed(torch, spans), profile(activities=acts) as prof:
        t = time.perf_counter()
        logits, caches = engine.prefill(tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    report_profile(prof, wall_ms, f"{arch} prefill", top)
    moe = {"prefill": moe_split(prof, spans)} if engine.cfg.moe else None
    s0 = offset + tokens.shape[1]
    spans = []
    with moe_timed(torch, spans), profile(activities=acts) as prof:
        t = time.perf_counter()
        for step in range(steps):
            tok = torch.argmax(logits, dim=-1)
            pos = torch.full((tokens.shape[0],), s0 + step,
                             dtype=torch.int32, device="cuda")
            logits = engine.decode_step(caches, tok[:, None], pos)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    report_profile(prof, wall_ms, f"{arch} decode x{steps}", top)
    if moe is None:
        return None
    moe[f"decode_x{steps}"] = moe_split(prof, spans)
    for window, split in moe.items():
        print(f"profile {arch} {window}: {split['moe_layer_calls']} MoE "
              f"layer calls {split['moe_layer_ms']:.3f} ms on the device, "
              f"their dispatch ranks (radix kernel) "
              f"{split['dispatch_ms']:.3f} ms", flush=True)
    return moe


#: the radix-partition kernels' names in ``radix_partition.cu``
RADIX_KERNELS = ("rp_onepass", "rp_count", "rp_scan", "rp_rank")


@contextlib.contextmanager
def moe_timed(torch, spans):
    """While the block lasts, every MoE layer's forward (router, dispatch,
    expert FFNs and combine) runs between two CUDA events, whose pair
    lands in ``spans`` when the call returns.  (A recomputation under
    remat returns no pair: torch's non-reentrant checkpoint stops it once
    the tensors the backward needs are rebuilt.)"""
    from repro_torch.models import transformer
    real = transformer.moe_apply

    def timed(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*args, **kw)
        end.record()
        spans.append((start, end))
        return out
    transformer.moe_apply = timed
    try:
        yield
    finally:
        transformer.moe_apply = real


def moe_split(prof, spans):
    """A profiled window's MoE layers: their time on the device (the CUDA
    events of ``moe_timed``, summed; the caller has synchronized) and the
    device time of their dispatch ranks (the radix kernels)."""
    from torch.autograd import DeviceType
    radix = sum((getattr(e, "self_device_time_total", None)
                 or getattr(e, "self_cuda_time_total", 0)) / 1e3
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and any(k in e.key for k in RADIX_KERNELS))
    return {"moe_layer_ms": sum(a.elapsed_time(b) for a, b in spans),
            "moe_layer_calls": len(spans), "dispatch_ms": radix}


def parity_phase(devices=("cuda", "cpu")):
    from repro_torch.core import CylonEnv, DistTable, Plan, execute
    ld, rd = make_table_data(PARITY_ROWS, 0), make_table_data(PARITY_ROWS, 1)
    cap = capacity_for(PARITY_ROWS, P)
    plan = fig9_plan(Plan, cap, bench_capacities=True)
    results = {}
    for device in devices:
        env = CylonEnv(P, device=device)
        tables = {n: DistTable.from_numpy(d, P, capacity=cap, device=device)
                  for n, d in (("l", ld), ("r", rd))}
        for mode in ("bsp", "bsp_staged", "amt"):
            for opt in (True, False):
                res, st = execute(plan, env, tables, mode=mode,
                                  optimize=opt, collect_stats=True)
                check(st.rows_dropped == 0, f"parity {device} {mode}: drops")
                results[(device, mode, opt)] = res.to_reference()
    for mode in ("bsp", "bsp_staged", "amt"):
        for opt in (True, False):
            (gc, gn), (cc, cn) = (results[(devices[0], mode, opt)],
                                  results[(devices[-1], mode, opt)])
            tag = f"parity {mode} optimize={opt}"
            check(np.array_equal(gn, cn), f"{tag}: row counts differ")
            check(sorted(gc) == sorted(cc), f"{tag}: columns differ")
            check(np.array_equal(gc["k"], cc["k"]), f"{tag}: keys differ")
            check(np.allclose(gc["v0_sum"], cc["v0_sum"], rtol=1e-5,
                              atol=0), f"{tag}: v0_sum differs beyond 1e-5")
            print(f"{tag}: card == cpu ({int(gn.sum())} rows)", flush=True)


def make_exact_data(rows, seed, payload):
    """The JAX package's out-of-core parity recipe
    (``tests/md_scripts/out_of_core_parity.py:24-29``): uniform int32 keys
    at 90% cardinality and an integer-valued float32 ``payload`` in
    [0, 100), so sums are exact in any order and a morsel run can be held
    to an in-core run bit for bit."""
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, int(rows * 0.9), rows).astype(np.int32),
            payload: rng.integers(0, 100, rows).astype(np.float32)}


def ooc_launches_expected(pplan, ld, keys, out_widest, morsel, p,
                          pos=None):
    """Kernel launches, morsels and dispatches of one out-of-core Fig-9
    run, derived from the plan and the data, not from the run's stats.

    ``ld`` is the streamed left input, ``pos`` each of its rows' position
    on its rank (default: block-distributed over ``p`` ranks; an ingested
    file's batches go round-robin, ``round_robin_pos``), ``keys`` the
    result's sorted group keys (``host_reference``),
    ``out_widest`` the result's fullest rank.  A key lives on rank
    ``hash(k) % p`` (``hash_columns_np`` mirrors the card's hash).  The
    segment shape is the optimized Fig-9's: groupby (join + groupby),
    sort, stream (add_scalar).  Morsels per segment are its input's
    fullest rank over ``morsel``: the left input's share, the groupby
    result's rank (one row per key), the result's.  Morsel ``m`` leaves
    on rank ``r`` one partial row per key of its left rows that has a
    partner and hashes to ``r``; the combiner splits the partials into
    their fullest rank over ``morsel`` sub-buckets, as ``_combine_groupby``
    does.  The radix kernel runs once per direct shuffle of every morsel
    and once per resident join build; ``segmented_sum`` once per sum /
    count / size aggregate of every ``groupby_local`` call (each morsel's
    partial, each combine sub-bucket).  One dispatch per morsel, resident
    build and sub-bucket."""
    from repro_torch.dataframe.groupby import _normalize
    from repro_torch.dataframe.ops_local import hash_columns_np
    from repro_torch.planner.morsel import _seg_stat_labels, segments, spine
    chain = spine(pplan)
    segs = segments(chain[1:])
    check([t for _, t in segs] == ["groupby", "sort", "stream"],
          f"out-of-core segments {[t for _, t in segs]}")

    def ceil_m(rows):
        return max(1, -(-int(rows) // morsel))

    def widest_rank(k):
        h = hash_columns_np({"k": k}, ["k"]) % np.uint32(p)
        return int(np.bincount(h, minlength=p).max())

    k = ld["k"]
    if pos is None:
        pos = np.arange(len(k)) % -(-len(k) // p)
    per = int(pos.max()) + 1                       # the fullest rank's rows
    n_keys = int(max(k.max(), keys.max())) + 1 if len(keys) else 1
    partner = np.zeros(n_keys, bool)
    partner[keys] = True
    has = partner[k]
    m_of = pos // morsel
    seen = np.zeros(ceil_m(per) * n_keys, bool)   # (morsel, key) pairs
    seen[m_of[has] * n_keys + k[has]] = True
    partials = widest_rank((np.flatnonzero(seen) % n_keys).astype(np.int32))
    combines = ceil_m(partials)
    morsels = (ceil_m(per), ceil_m(widest_rank(keys)), ceil_m(out_widest))
    joins = [n for n in chain if n.op == "join"]
    radix = sum(not n.params.get("elide_right") for n in joins)
    for (nodes, term), m in zip(segs, morsels):
        if term == "sort":
            radix += m * (not nodes[0].params.get("elide_shuffle"))
        else:
            radix += m * sum(not lbl.endswith(":overflow")
                             for lbl in _seg_stat_labels(nodes))
    g = segs[0][0][-1]
    physical, _ = _normalize(g.params["aggs"])
    sums = sum(a in ("sum", "count", "size")
               for names in physical.values() for a in names)
    calls = (1 if g.params.get("elide_shuffle")
             else 1 + bool(g.params.get("pre_aggregate")))
    launches = {"radix_partition": radix,
                "segmented_sum": sums * (calls * morsels[0] + combines)}
    return launches, morsels, sum(morsels) + len(joins) + combines


def memcpy_ms(prof):
    """Device time of the copies between host and device in a
    ``torch.profiler`` window, in ms, by the profiler's name for each kind
    (e.g. ``Memcpy HtoD (Pinned -> Device)``)."""
    out = {}
    for e in prof.key_averages():
        if e.key.startswith(("Memcpy HtoD", "Memcpy DtoH")):
            out[e.key] = out.get(e.key, 0.0) + (
                getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0)) / 1e3
    return out


def out_of_core_phase(torch, rows=FULL_ROWS, device=None, keep=None):
    """Fig-9 (``fig9_plan``, optimized, ``bsp``) streamed out-of-core at
    ``rows`` per table over ``P`` stacked ranks, 8x oversubscribed
    (``morsel_rows`` = the per-rank share / 8, ``capacity_factor`` 4): the
    left input is a host column dict, the right a ``DistTable``.  Held to
    the in-core ``bsp`` run of the same plan on the same data bit for bit,
    and to the host reference; first and cached run, with the launch
    counts derived from the plan and the stats, the transfer volumes and
    the peak device memory beside the in-core run's; one cached run is
    profiled.  Returns the numbers for the JSON lines; ``keep["ooc"]``
    gets the first run's digests and derived launches, which the
    process-group phase holds its processes to."""
    from repro_torch.core import CylonEnv, DistTable, Plan, execute
    from repro_torch.kernels import radix_partition_cuda
    from repro_torch.planner import compile_plan
    t_phase = time.perf_counter()
    ld, rd = make_exact_data(rows, 0, "v0"), make_exact_data(rows, 1, "w")
    cap = capacity_for(rows, P)
    per = -(-rows // P)
    morsel = -(-(-(-per // 8)) // 8) * 8
    env = CylonEnv(P, device=device)
    on_card = env.device.type == "cuda"
    rt = DistTable.from_numpy(rd, P, capacity=cap, device=device)
    lt = DistTable.from_numpy(ld, P, capacity=cap, device=device)
    plan = fig9_plan(Plan, cap)
    ref = host_reference(ld, rd)

    def reset_peak():
        env.synchronize()
        if on_card:
            torch.cuda.reset_peak_memory_stats()

    def peak():
        env.synchronize()
        return torch.cuda.max_memory_allocated() if on_card else None

    reset_peak()
    res, st_in = execute(plan, env, {"l": lt, "r": rt}, mode="bsp",
                         collect_stats=True)
    peak_in = peak()
    check_fig9(res, st_in, ref, "out-of-core: in-core bsp")
    want = res.to_numpy()
    del res, lt
    tables = {"l": ld, "r": rt}
    pplan = compile_plan(plan, tables)
    print(f"out-of-core: 2 x {rows} rows over {P} stacked ranks, left "
          f"input a host dict, morsel_rows {morsel} ({per} rows per rank, "
          f"8x oversubscribed), capacity_factor 4.0", flush=True)
    walls, launches, peaks = {}, {}, {"in-core": peak_in}
    for run in ("first", "cached"):
        reset_peak()
        reset_counts()
        routes0 = dict(radix_partition_cuda.route_launches)
        t = time.perf_counter()
        out, st = execute(plan, env, tables, mode="bsp", collect_stats=True,
                          morsel_rows=morsel, capacity_factor=4.0)
        env.synchronize()
        wall = time.perf_counter() - t
        peaks[run] = peak()
        counts = launch_counts()
        routes = {r: radix_partition_cuda.route_launches[r] - routes0[r]
                  for r in routes0}
        walls[run], launches[run] = wall, counts
        label = f"out-of-core {run}"
        got = out.to_numpy()
        check(sorted(got) == sorted(want) and all(
            np.array_equal(got[c], want[c]) for c in want),
            f"{label}: result differs from the in-core run")
        check_fig9(out, st, ref, label)
        check(st.rows_dropped == 0 and st.degraded == 0,
              f"{label}: {st.rows_dropped} rows dropped, {st.degraded} "
              f"degrade replays")
        check(st.morsels >= 16, f"{label}: {st.morsels} morsels, want >= 16")
        check(min(st.spill_bytes, st.h2d_bytes, st.d2h_bytes) > 0,
              f"{label}: spill/h2d/d2h bytes {st.spill_bytes}/"
              f"{st.h2d_bytes}/{st.d2h_bytes}")
        check(st.rows_shuffled == st_in.rows_shuffled, f"{label}: "
              f"{st.rows_shuffled} rows shuffled, in-core "
              f"{st_in.rows_shuffled}")
        if run == "cached":
            check(st.cache_misses == 0, f"{label}: {st.cache_misses} "
                  f"cache misses on the repeat run")
        want_launches, seg_morsels, want_dispatches = ooc_launches_expected(
            pplan, ld, ref[1], max(out.rank_rows(r) for r in range(P)),
            morsel, P)
        if keep is not None and run == "first":
            keep.update(ooc_rows=rows, ooc=(spill_digests(out), {
                k: n * on_card for k, n in want_launches.items()}))
        check((st.morsels, st.dispatches) == (sum(seg_morsels),
                                              want_dispatches),
              f"{label}: {st.morsels} morsels, {st.dispatches} dispatches; "
              f"derived {sum(seg_morsels)} ({seg_morsels}), "
              f"{want_dispatches}")
        if on_card:
            for name, n in want_launches.items():
                check(counts[name] == n and n > 0, f"{label}: {name} "
                      f"launched {counts[name]} times, want {n} > 0")
            check(routes == {"onepass": want_launches["radix_partition"],
                             "threepass": 0},
                  f"{label}: radix routes {routes}, want all onepass")
        else:
            check(not any(counts.values()), f"{label}: kernels launched "
                  f"on the CPU: {counts}")
        stages = ", ".join(f"{n}={s * 1e3:.1f}ms" for n, s in st.stage_times)
        print(f"fig9 out-of-core {run:6s} wall {wall * 1e3:9.2f} ms  "
              f"morsels={st.morsels} (by segment {seg_morsels}) "
              f"dispatches={st.dispatches} rows_shuffled={st.rows_shuffled} "
              f"cache_hits={st.cache_hits} cache_misses={st.cache_misses} "
              f"spill_bytes={st.spill_bytes} h2d_bytes={st.h2d_bytes} "
              f"d2h_bytes={st.d2h_bytes} "
              f"d2h_copied_bytes={st.d2h_copied_bytes} launches={counts} "
              f"(derived {want_launches}) radix routes={routes} [{stages}]",
              flush=True)
        del out, got
    keys = set(env._cache)
    for adaptive in (False, True):
        env.synchronize()
        t = time.perf_counter()
        out, st = execute(plan, env, tables, mode="bsp", collect_stats=True,
                          morsel_rows=morsel, capacity_factor=4.0,
                          adaptive=adaptive)
        env.synchronize()
        walls["cached_adaptive_off" if not adaptive
              else "cached_default_again"] = time.perf_counter() - t
        check(st.cache_misses == 0 and st.salted_shuffles == 0,
              f"out-of-core adaptive={adaptive}: {st.cache_misses} stages "
              f"built anew, {st.salted_shuffles} salted")
        del out
    check(set(env._cache) == keys, "out-of-core adaptive=False used "
          "stage-cache keys the default run did not")
    print(f"fig9 out-of-core cached wall adaptive=False "
          f"{walls['cached_adaptive_off'] * 1e3:.2f} ms, default again "
          f"{walls['cached_default_again'] * 1e3:.2f} ms (same stages)",
          flush=True)
    gib = {k: (f"{v / 2**30:.2f} GiB" if v is not None else "not measured")
           for k, v in peaks.items()}
    print(f"out-of-core peak device memory: first {gib['first']}, cached "
          f"{gib['cached']}; in-core bsp {gib['in-core']}", flush=True)
    if on_card:
        check(max(peaks["first"], peaks["cached"]) < peak_in,
              f"out-of-core peak {peaks} not below the in-core run's")
        from torch.profiler import ProfilerActivity, profile
        env.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            _, stp = execute(plan, env, tables, mode="bsp",
                             collect_stats=True, morsel_rows=morsel,
                             capacity_factor=4.0)
            env.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        report_profile(prof, wall_ms, "out-of-core bsp (cached run under "
                       "the profiler)")
        copies = memcpy_ms(prof)
        h2d_ms = sum(v for k, v in copies.items() if "HtoD" in k)
        d2h_ms = sum(v for k, v in copies.items() if "DtoH" in k)
        print(f"out-of-core copies under the profiler: h2d "
              f"{stp.h2d_bytes} B in {h2d_ms:.2f} ms of device time "
              f"({stp.h2d_bytes / max(h2d_ms, 1e-9) / 1e6:.2f} GB/s), d2h "
              f"{stp.d2h_copied_bytes} B copied in {d2h_ms:.2f} ms "
              f"({stp.d2h_copied_bytes / max(d2h_ms, 1e-9) / 1e6:.2f} "
              f"GB/s; d2h_bytes counted as the JAX package counts them "
              f"{stp.d2h_bytes} B); by kind (ms): {copies}", flush=True)
    recorded = None
    if on_card:
        # the kernels' inputs at this path's shapes, first call at each
        layouts, sums = {}, {}

        def note_radix(dest, nb):
            layouts.setdefault(f"ooc:n={dest.shape[1]}-layout", (
                dest.shape[1], (dest < nb - 1).sum(dim=1).tolist()))

        def note_sum(ids, vals, s, sorted_ids=False):
            check(sorted_ids, "out-of-core: a groupby sum not on the "
                  "sorted route")
            sums.setdefault(f"ooc:n={ids.shape[1]},S={s}",
                            (ids.clone(), vals.clone(), s))
        recording(env, lambda: execute(
            plan, env, tables, mode="bsp", morsel_rows=morsel,
            capacity_factor=4.0), [
            ("repro_torch.dataframe.shuffle", "radix_partition", note_radix),
            ("repro_torch.dataframe.ops_local", "segmented_sum", note_sum)])
        recorded = (layouts, [(k, i, v, s) for k, (i, v, s) in sums.items()])
    print(f"phase out-of-core took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {"wall_s": walls, "launches": launches, "peak_bytes": peaks,
            "morsel_rows": morsel, "h2d_bytes": st.h2d_bytes,
            "d2h_bytes": st.d2h_bytes,
            "d2h_copied_bytes": st.d2h_copied_bytes,
            "spill_bytes": st.spill_bytes,
            "morsels": st.morsels}, recorded


def round_robin_pos(file_rows, batch_rows, p):
    """Position on its rank of every row read back from files of
    ``file_rows`` rows each, in ``batch_rows``-row batches: batch ``b``
    (counted across files) lands on rank ``b % p`` after that rank's
    earlier batches (``repro_torch.io.TableBuilder``)."""
    sizes = np.array([min(batch_rows, n - j) for n in file_rows
                      for j in range(0, n, batch_rows)], np.int64)
    rank = np.arange(len(sizes)) % p
    start = np.zeros(len(sizes), np.int64)
    for r in range(p):
        idx = np.flatnonzero(rank == r)
        start[idx] = np.cumsum(sizes[idx]) - sizes[idx]
    batch = np.repeat(np.arange(len(sizes)), sizes)
    offset = np.arange(int(sizes.sum())) - np.repeat(
        np.cumsum(sizes) - sizes, sizes)
    return start[batch] + offset


def write_parquet_files(d, side, data, nfiles, group_rows):
    """``data`` split into ``nfiles`` uncompressed Parquet files of row
    groups of ``group_rows`` rows, written with pyarrow; returns the
    paths."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    n = len(next(iter(data.values())))
    paths = []
    for f in range(nfiles):
        sl = slice(f * n // nfiles, (f + 1) * n // nfiles)
        path = os.path.join(d, f"{side}{f}.parquet")
        pq.write_table(pa.table({c: v[sl] for c, v in data.items()}), path,
                       row_group_size=group_rows, compression="none")
        paths.append(path)
    return paths


def write_csv_files(d, side, data, nfiles):
    """``data`` split into ``nfiles`` CSV files with a header row; ``None``
    and NaN become empty fields; returns the paths."""
    n = len(next(iter(data.values())))
    names = list(data)
    paths = []
    for f in range(nfiles):
        lo, hi = f * n // nfiles, (f + 1) * n // nfiles
        cols = []
        for c in names:
            v = data[c][lo:hi]
            if v.dtype.kind == "f":
                txt = np.where(np.isnan(v), "",
                               np.nan_to_num(v).astype(np.int64).astype(str)
                               + ".0")
            else:
                txt = np.array(["" if x is None else str(x) for x in v])
            cols.append(txt)
        path = os.path.join(d, f"{side}{f}.csv")
        with open(path, "w") as fh:
            fh.write(",".join(names) + "\n")
            fh.write("\n".join(",".join(row) for row in zip(*cols)) + "\n")
        paths.append(path)
    return paths


def fig9_sum_frontend(l_df, r_df, cap):
    """``fig9_plan`` written against ``repro_torch.df``."""
    from repro_torch.expr import col
    return (l_df.merge(r_df, on="k", out_capacity=4 * cap)
            .groupby("k").agg({"v0": "sum"}).sort_values("k")
            .assign(v0_sum=col("v0_sum") + 1.0))


def same_columns(got, want):
    """Equal names, dtypes and values (NaN, a null, equal to NaN)."""
    return sorted(got) == sorted(want) and all(
        got[c].dtype == want[c].dtype and np.array_equal(
            got[c], want[c], equal_nan=got[c].dtype.kind == "f")
        for c in want)


def ingest_phase(torch, rows=FULL_ROWS, device=None, nfiles=8,
                 group_rows=1 << 20, peaks=None, keep=None):
    """Fig-9 from files: the out-of-core phase's data (``make_exact_data``)
    written as ``nfiles`` Parquet files a side (row groups of
    ``group_rows``; CSV when pyarrow does not import) and read back with
    ``repro_torch.df.read_parquet`` at its default batch size; then, first
    and cached, in-core ``bsp`` at the default scan capacity and at the
    Fig-9 phase's, and out-of-core 8x oversubscribed, each bit-identical
    to the same pipeline over the same columns in memory and equal to the
    host reference, with the kernels' launches held to their derivation;
    EXPLAIN ANALYZE in ``bsp_staged`` (card roofline, Chrome trace,
    metrics), tracing on and off, and ``debug_overflow``.  The roofline
    uses the card's own peaks, or ``peaks`` (a rehearsal on the CPU has
    none).  Returns the numbers for the JSON line and the launches by
    run.  With ``keep``, the files are written to ``keep["dir"]`` and
    stay there, and ``keep`` gets their paths and reader and the first
    in-core and out-of-core runs' digests and launches, which the
    process-group phase holds its processes to."""
    import repro_torch.df as rdf
    from repro_torch.core import CylonEnv
    from repro_torch.io import DictionaryCache, have_pyarrow
    from repro_torch.io.parquet import DEFAULT_BATCH_ROWS
    from repro_torch.kernels import radix_partition_cuda
    from repro_torch.obs import METRICS
    from repro_torch.planner import compile_plan
    t_phase = time.perf_counter()
    lane = "parquet" if have_pyarrow() else "csv"
    ld, rd = make_exact_data(rows, 0, "v0"), make_exact_data(rows, 1, "w")
    ref = host_reference(ld, rd)
    cap = capacity_for(rows, P)
    per = -(-rows // P)
    morsel = -(-(-(-per // 8)) // 8) * 8
    env = CylonEnv(P, device=device)
    on_card = env.device.type == "cuda"
    out = {"lane": lane, "rows": rows, "files": nfiles}
    walls, launches = {}, {}
    with (tempfile.TemporaryDirectory(prefix="chip_smoke_ingest_")
          if keep is None else contextlib.nullcontext(keep["dir"])) as d:
        t = time.perf_counter()
        if lane == "parquet":
            paths = {s: write_parquet_files(d, s, data, nfiles, group_rows)
                     for s, data in (("l", ld), ("r", rd))}
        else:
            paths = {s: write_csv_files(d, s, data, nfiles)
                     for s, data in (("l", ld), ("r", rd))}
        nbytes = {s: sum(os.path.getsize(f) for f in ps)
                  for s, ps in paths.items()}
        if keep is not None:
            keep.update(paths=paths, lane=lane, files_rows=rows)
        print(f"ingest: lane {lane}; wrote {nfiles} files a side of "
              f"{rows} rows in {time.perf_counter() - t:.2f} s ({nbytes} B)",
              flush=True)
        reader = rdf.read_parquet if lane == "parquet" else rdf.read_csv
        cache = DictionaryCache()
        frames, host = {}, {}
        for side in ("l", "r"):
            t = time.perf_counter()
            frames[side] = reader(paths[side], env=env, dict_cache=cache,
                                  name=side)
            secs = time.perf_counter() - t
            info = frames[side].sources[side].provenance
            batches = nfiles * -(-(rows // nfiles) // DEFAULT_BATCH_ROWS)
            check(info.rows == rows and len(info.files) == nfiles
                  and info.bytes_read == nbytes[side]
                  and (lane != "parquet" or info.batches == batches),
                  f"ingest {side}: {info} ({info.batches} batches, "
                  f"{info.bytes_read} B), want {rows} rows, {nfiles} files, "
                  f"{batches} batches, {nbytes[side]} B")
            host[side] = {"seconds": secs, "file_MB_per_s":
                          nbytes[side] / secs / 1e6,
                          "rows_per_s": rows / secs,
                          "info": {"format": info.format,
                                   "files": len(info.files),
                                   "rows": info.rows,
                                   "bytes_read": info.bytes_read,
                                   "batches": info.batches,
                                   "recodes": info.recodes,
                                   "dict_cache_hit": info.dict_cache_hit}}
            print(f"ingest {side}: {secs:.3f} s on the host, "
                  f"{nbytes[side] / secs / 1e6:.1f} file MB/s, "
                  f"{rows / secs / 1e6:.2f} M rows/s; {info} "
                  f"({info.batches} batches)", flush=True)
        # a second read: numeric-only sources leave nothing in the cache,
        # so it misses and recodes nothing, with the same chunks
        again = reader(paths["l"], env=env, dict_cache=cache, name="l2")
        info2 = again.sources["l2"].provenance
        first = frames["l"].sources["l"]
        check(not info2.dict_cache_hit and info2.recodes == 0
              and len(cache) == 0 and cache.hits == 0,
              f"second read: {info2}, cache {len(cache)} entries, "
              f"{cache.hits} hits")
        check(all(same_columns(first.rank_concat(r),
                               again.sources["l2"].rank_concat(r))
                  for r in range(P)), "second read: chunks differ")
        out["host_ingest"] = host
        out["second_read"] = {"dict_cache_hit": info2.dict_cache_hit,
                              "recodes": info2.recodes,
                              "cache_misses": cache.misses}
        del again
        # the same pipeline over the same columns in memory
        mem = fig9_sum_frontend(rdf.read_numpy(ld, env=env, capacity=cap,
                                               name="l"),
                                rdf.read_numpy(rd, env=env, capacity=cap,
                                               name="r"), cap)
        res, st = mem.collect(collect_stats=True)
        want = res.to_numpy()
        check_fig9(res, st, ref, "ingest: in memory")
        check(np.array_equal(want["v0_sum"],
                             ref[2].astype(np.float32)),
              "ingest: in-memory sums not the exact host sums")
        del res, mem
        files_q = fig9_sum_frontend(frames["l"], frames["r"], cap)
        pplan = compile_plan(files_q.plan, files_q.sources)
        text = files_q.explain()
        print(text, flush=True)
        check(f"scan[{lane}: {nfiles} files, ~{rows} rows]" in text,
              "ingest: EXPLAIN does not name the source files")
        pos = round_robin_pos([(f + 1) * rows // nfiles - f * rows // nfiles
                               for f in range(nfiles)],
                              DEFAULT_BATCH_ROWS, P)
        runs = (("in-core", {}), ("in-core/scan_capacity",
                                  {"scan_capacity": cap}),
                ("out-of-core", {"morsel_rows": morsel,
                                 "capacity_factor": 4.0}))
        for name, kw in runs:
            for run in ("first", "cached"):
                env.synchronize()
                reset_counts()
                routes0 = dict(radix_partition_cuda.route_launches)
                t = time.perf_counter()
                res, st = files_q.collect(collect_stats=True, **kw)
                env.synchronize()
                wall = time.perf_counter() - t
                counts = launch_counts()
                routes = {r: radix_partition_cuda.route_launches[r]
                          - routes0[r] for r in routes0}
                label = f"ingest {name}/{run}"
                walls[f"{name}/{run}"] = wall
                launches[f"{name}/{run}"] = counts
                got = res.to_numpy()
                check(same_columns(got, want), f"{label}: result differs "
                      f"from the same pipeline in memory")
                check_fig9(res, st, ref, label)
                check(st.rows_read == 2 * rows and
                      st.bytes_read == nbytes["l"] + nbytes["r"],
                      f"{label}: rows_read {st.rows_read}, bytes_read "
                      f"{st.bytes_read}")
                if run == "cached":
                    check(st.cache_misses == 0, f"{label}: "
                          f"{st.cache_misses} cache misses")
                if keep is not None and run == "first" and name in (
                        "in-core", "out-of-core"):
                    # what the process-group phase holds its processes to
                    want_k = (ooc_launches_expected(
                        pplan, ld, ref[1],
                        max(res.rank_rows(r) for r in range(P)), morsel, P,
                        pos)[0] if kw else {
                        "radix_partition": st.num_shuffles,
                        "segmented_sum": segsum_launches_expected(pplan,
                                                                  "bsp")})
                    keep["files ooc" if kw else "files in-core"] = (
                        digests_of(res),
                        {k: n * on_card for k, n in want_k.items()})
                if "morsel_rows" in kw:
                    check(st.degraded == 0, f"{label}: degraded")
                    want_l, seg_morsels, want_d = ooc_launches_expected(
                        pplan, ld, ref[1],
                        max(res.rank_rows(r) for r in range(P)), morsel, P,
                        pos)
                    check((st.morsels, st.dispatches) ==
                          (sum(seg_morsels), want_d), f"{label}: "
                          f"{st.morsels} morsels, {st.dispatches} "
                          f"dispatches; derived {seg_morsels}, {want_d}")
                    if on_card:
                        for k, n in want_l.items():
                            check(counts[k] == n and n > 0, f"{label}: {k} "
                                  f"launched {counts[k]} times, want {n}")
                        check(routes == {"onepass":
                                         want_l["radix_partition"],
                                         "threepass": 0},
                              f"{label}: radix routes {routes}")
                    else:
                        check(not any(counts.values()), f"{label}: "
                              f"kernels launched on the CPU")
                else:
                    check_launches(counts, pplan, "bsp", st, on_card, label,
                                   routes if on_card else None)
                stages = ", ".join(f"{n}={s * 1e3:.1f}ms"
                                   for n, s in st.stage_times)
                print(f"fig9 from files {name:22s} {run:6s} wall "
                      f"{wall * 1e3:9.2f} ms  rows_read={st.rows_read} "
                      f"bytes_read={st.bytes_read} "
                      f"rows_shuffled={st.rows_shuffled} "
                      f"cache_misses={st.cache_misses} launches={counts} "
                      f"[{stages}]", flush=True)
                del res, got
        for name, kw in (runs[0], runs[2]):
            env.synchronize()
            t = time.perf_counter()
            res, st = files_q.collect(collect_stats=True, adaptive=False,
                                      **kw)
            env.synchronize()
            walls[f"{name}/cached_adaptive_off"] = time.perf_counter() - t
            check(st.cache_misses == 0 and same_columns(res.to_numpy(),
                                                        want),
                  f"ingest {name} adaptive=False: {st.cache_misses} stages "
                  f"built anew, or the result differs")
            print(f"fig9 from files {name:22s} cached adaptive=False wall "
                  f"{walls[f'{name}/cached_adaptive_off'] * 1e3:9.2f} ms "
                  f"(same stages)", flush=True)
            del res
        out["wall_s"] = walls
        out["launches"] = launches
        out["analyze"] = analyze_phase(env, files_q, cap, nbytes, want,
                                       peaks)
        out["debug_overflow"] = debug_overflow_check(rdf, env, paths,
                                                     reader, morsel)
    print(f"phase ingest took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return out


def analyze_phase(env, files_q, cap, nbytes, want, peaks=None):
    """EXPLAIN ANALYZE of Fig-9 from files in ``bsp_staged`` (at the
    Fig-9 phase's scan capacity), against the card's peaks; then the
    cached run with tracing off and on, three times each, alternating
    (host wall around the collect, and ``ExecStats.wall_time_s``, which
    leaves out the host scatter of the spills)."""
    from repro_torch.obs import METRICS
    kw = dict(mode="bsp_staged", scan_capacity=cap)
    files_q.collect(collect_stats=True, **kw)   # builds the stages
    env.synchronize()
    t = time.perf_counter()
    res, report = files_q.collect(analyze=True, peaks=peaks, **kw)
    env.synchronize()
    wall = time.perf_counter() - t
    st = report.stats
    check(same_columns(res.to_numpy(), want),
          "analyze: result differs from the pipeline in memory")
    del res
    print(report.explain_analyze(), flush=True)
    print(report.roofline_table(), flush=True)
    stages = [s for n, s in st.stage_times]
    check(all(s > 0 for s in stages) and sum(stages) <= st.wall_time_s,
          f"analyze: stage times {st.stage_times}, wall {st.wall_time_s}")
    d = report.to_dict()
    check(d["rows_shuffled"] == st.rows_shuffled
          and d["bytes_shuffled"] == st.bytes_shuffled,
          "analyze: report totals differ from ExecStats")
    rows = report.stage_table()
    fracs = [r["roofline_fraction"] for r in rows]
    check(all(f <= 1.05 for f in fracs), f"analyze: roofline fractions "
          f"{fracs} above 1.05: the bound is wrong")
    check(st.bytes_read == nbytes["l"] + nbytes["r"],
          f"analyze: bytes_read {st.bytes_read}")
    payload = json.loads(json.dumps(report.to_chrome_trace()))
    evs = payload["traceEvents"]
    roots = [e for e in evs if e["cat"] == "query"]
    check(len(roots) == 1 and roots[0]["ph"] == "X"
          and {"query", "stage", "shuffle"} <= {e["cat"] for e in evs}
          and all({"name", "cat", "ph", "ts", "pid", "tid"} <= set(e)
                  and roots[0]["ts"] <= e["ts"]
                  <= roots[0]["ts"] + roots[0]["dur"] + 1e-3 for e in evs),
          "analyze: Chrome trace is not one query span over stage and "
          "shuffle spans")
    rec = METRICS.query_records[-1]
    check(rec["fingerprint"] == report.pplan.fingerprint
          and rec["mode"] == "bsp_staged"
          and rec["bytes_read"] == st.bytes_read
          and METRICS.counter("queries_total").value(mode="bsp_staged") >= 1,
          "analyze: METRICS lacks the query record")
    # tracing is invisible: same result, launches and stages; its cost is
    # the difference of the cached walls
    timed = {"off": [], "on": []}
    exec_s = {"off": [], "on": []}
    results = {}
    for trace in ("off", "on", "on", "off", "off", "on"):
        env.synchronize()
        reset_counts()
        t = time.perf_counter()
        res, s = files_q.collect(collect_stats=True,
                                 trace=(trace == "on"), **kw)
        env.synchronize()
        timed[trace].append(time.perf_counter() - t)
        exec_s[trace].append(s.wall_time_s)
        counts = launch_counts()
        check(s.cache_misses == 0, f"trace {trace}: {s.cache_misses} "
              f"cache misses")
        got = res.to_numpy()
        prev = results.setdefault(trace, (got, counts))
        check(same_columns(got, want) and counts == prev[1]
              and counts == results["off"][1],
              f"trace {trace}: result or launches differ ({counts})")
        del res, got
    print(f"tracing: cached bsp_staged wall off {timed['off']} s, on "
          f"{timed['on']} s; ExecStats.wall_time_s off {exec_s['off']} s, "
          f"on {exec_s['on']} s", flush=True)
    return {"wall_s": wall, "stage_times": st.stage_times,
            "wall_time_s": st.wall_time_s,
            "device": d["device"],
            "stages": [{k: r[k] for k in ("stage", "ops", "rows_shuffled",
                                          "wire_bytes", "elapsed_s",
                                          "bound_s", "dominant",
                                          "roofline_fraction")}
                       for r in rows],
            "trace_events": len(evs),
            "cached_wall_trace_off_s": timed["off"],
            "cached_wall_trace_on_s": timed["on"],
            "cached_exec_wall_trace_off_s": exec_s["off"],
            "cached_exec_wall_trace_on_s": exec_s["on"]}


def debug_overflow_check(rdf, env, paths, reader, morsel):
    """``debug_overflow=True`` on an under-capacitated shuffle of the
    first left file: one warning per (label, rank), each naming both."""
    import warnings
    from repro_torch.io import DictionaryCache
    df = reader(paths["l"][:1], env=env, dict_cache=DictionaryCache(),
                name="one")
    rows = df.sources["one"].total_rows()
    share = -(-rows // P)
    q = df.repartition("k", out_capacity=share // 2, debug_overflow=True)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        _, st = q.collect(collect_stats=True, overflow="warn",
                          optimize=False)
    named = [str(x.message) for x in w if "dropped rows" in
             str(x.message) and "@ rank" in str(x.message)]
    ranks = sorted(int(m.split("@ rank ")[1].split()[0]) for m in named)
    check(ranks == list(range(P)) and all(
        m.startswith("shuffle(k) @ rank") for m in named),
        f"debug_overflow: warnings {named}")
    check(st.rows_dropped > 0, "debug_overflow: nothing dropped")
    print(f"debug_overflow: {len(named)} warnings, one per rank, "
          f"{st.rows_dropped} rows dropped; first: {named[0]}", flush=True)
    return {"warnings": len(named), "rows_dropped": st.rows_dropped}


def ingest_parity_data(rows, nfiles, nk, seed=23):
    """``tests/md_scripts/ingest_parity.py``'s recipe at ``rows`` rows and
    ``nk`` keys: file ``f`` draws its keys from the last ``(f + 1) / nfiles``
    of the key space, so every later file adds lexicographically earlier
    keys (the dictionary grows and chunks are recoded); 10% nulls in keys
    and in the integer-valued float values.  Key and value columns come as
    key indices (-1 for null) and float64 with NaN for the oracle, and as
    object / float arrays with ``None`` for the files."""
    rng = np.random.default_rng(seed)
    names = np.array([f"key{i:06d}" for i in range(nk)], dtype=object)
    per = rows // nfiles
    kidx = np.concatenate([
        rng.integers(nk - (f + 1) * (nk // nfiles), nk, per)
        for f in range(nfiles)])
    kidx[rng.random(len(kidx)) < 0.1] = -1
    v0 = rng.integers(0, 256, len(kidx)).astype(np.float64)
    v0[rng.random(len(kidx)) < 0.1] = np.nan
    w = np.arange(nk, dtype=np.float64)
    w[np.arange(nk) % 7 == 0] = np.nan
    facts = {"k": np.where(kidx >= 0, names[np.maximum(kidx, 0)], None),
             "v0": v0}
    dim = {"k": np.concatenate([names, [None]]).astype(object),
           "w": np.concatenate([w, [3.0]])}
    return names, kidx, v0, w, facts, dim


def ingest_parity_oracle(names, kidx, v0, w, pivot_idx):
    """merge on the key (nulls never match) -> (v0 > 4) & (k < pivot) ->
    groupby k: v0 sum and count, w max -> sorted by k, in numpy."""
    sel = (kidx >= 0) & ~np.isnan(v0) & (v0 > 4) & (kidx < pivot_idx)
    nk = len(names)
    cnt = np.bincount(kidx[sel], minlength=nk)
    sums = np.bincount(kidx[sel], weights=v0[sel], minlength=nk)
    keys = np.flatnonzero(cnt)
    return names[keys], sums[keys], cnt[keys], w[keys]


def ingest_parity_pipeline(facts, dim, pivot, cap):
    from repro_torch.expr import col
    return (facts.merge(dim, on="k", out_capacity=cap)
            [(col("v0") > 4) & (col("k") < pivot)]
            .groupby("k").agg({"v0": ["sum", "count"], "w": "max"})
            .sort_values("k"))


def check_parity_result(res, oracle, label):
    keys, sums, cnt, wmax = oracle
    got = res.to_numpy()
    check(len(got["k"]) == len(keys) and all(
        a == b for a, b in zip(got["k"], keys)), f"{label}: keys differ")
    check(np.array_equal(got["v0_sum"], sums.astype(np.float32)),
          f"{label}: v0 sums differ")
    check(np.array_equal(got["v0_count"], cnt.astype(got["v0_count"].dtype)),
          f"{label}: v0 counts differ")
    check(np.array_equal(np.isnan(got["w_max"]), np.isnan(wmax)) and
          np.array_equal(np.nan_to_num(got["w_max"]),
                         np.nan_to_num(wmax).astype(np.float32)),
          f"{label}: w maxima differ")
    return got


def ingest_strings_phase(torch, rows=1 << 22, csv_rows=1 << 18, nfiles=4,
                         nk=1 << 16, device=None):
    """String keys and nulls from files: ``ingest_parity_data`` as
    ``nfiles`` Parquet files (and ``nfiles`` CSV files at ``csv_rows``):
    the first read recodes, the second hits the dictionary cache and
    recodes nothing with the same physical (mask) layout, and a merge,
    filter, groupby and sort over it equals a numpy oracle; the CSV
    python lane passes the same checks and the arrow CSV lane agrees with
    it.  Returns the numbers for the JSON line."""
    import tempfile
    import repro_torch.df as rdf
    from repro_torch.core import CylonEnv
    from repro_torch.io import DictionaryCache, have_pyarrow
    t_phase = time.perf_counter()
    env = CylonEnv(P, device=device)
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_strings_") as d:
        lanes = [("parquet", rows)] if have_pyarrow() else []
        lanes += [("csv-python", csv_rows)]
        if have_pyarrow():
            lanes += [("csv-arrow", csv_rows)]
        results = {}
        for lane, n in lanes:
            names, kidx, v0, w, facts, dim = ingest_parity_data(n, nfiles,
                                                                nk)
            pivot_idx = nk // 2
            oracle = ingest_parity_oracle(names, kidx, v0, w, pivot_idx)
            sub = os.path.join(d, lane)
            os.makedirs(sub)
            t = time.perf_counter()
            if lane == "parquet":
                import pyarrow as pa
                import pyarrow.parquet as pq
                paths = []
                for f in range(nfiles):
                    sl = slice(f * n // nfiles, (f + 1) * n // nfiles)
                    path = os.path.join(sub, f"facts{f}.parquet")
                    pq.write_table(pa.table({
                        "k": pa.array(facts["k"][sl], type=pa.string()),
                        "v0": pa.array(facts["v0"][sl],
                                       mask=np.isnan(facts["v0"][sl]))}),
                        path, row_group_size=1 << 20)
                    paths.append(path)
                dim_path = os.path.join(sub, "dim.parquet")
                pq.write_table(pa.table({
                    "k": pa.array(dim["k"], type=pa.string()),
                    "w": pa.array(dim["w"], mask=np.isnan(dim["w"]))}),
                    dim_path)
                reader = rdf.read_parquet
            else:
                if lane == "csv-arrow":
                    paths, dim_path = results["csv-python"]["paths"]
                else:
                    paths = write_csv_files(sub, "facts", facts, nfiles)
                    dim_path = write_csv_files(sub, "dim", dim, 1)[0]
                reader = rdf.read_csv
            write_s = time.perf_counter() - t
            saved = os.environ.pop("REPRO_NO_PYARROW", None)
            if lane == "csv-python":
                os.environ["REPRO_NO_PYARROW"] = "1"
            try:
                cache = DictionaryCache()
                t = time.perf_counter()
                fdf = reader(paths, env=env, dict_cache=cache, name="facts")
                read_s = time.perf_counter() - t
                ddf = reader(dim_path, env=env, dict_cache=cache, name="dim")
                again = reader(paths, env=env, dict_cache=cache,
                               name="again")
            finally:
                os.environ.pop("REPRO_NO_PYARROW", None)
                if saved is not None:
                    os.environ["REPRO_NO_PYARROW"] = saved
            info = fdf.sources["facts"].provenance
            info2 = again.sources["again"].provenance
            label = f"strings {lane}"
            check(info.rows == n and info.recodes > 0
                  and not info.dict_cache_hit, f"{label}: first read {info} "
                  f"({info.recodes} recodes)")
            check(info2.dict_cache_hit and info2.recodes == 0,
                  f"{label}: second read {info2} ({info2.recodes} recodes)")
            a = fdf.sources["facts"].to_numpy(decode=False, nulls="mask")
            b = again.sources["again"].to_numpy(decode=False, nulls="mask")
            check("__m_k" in a and "__m_v0" in a and same_columns(a, b),
                  f"{label}: second read's layout differs")
            share = -(-n // P)
            q = ingest_parity_pipeline(fdf, ddf, names[pivot_idx],
                                       4 * share)
            t = time.perf_counter()
            res, st = q.collect(collect_stats=True)
            env.synchronize()
            wall = time.perf_counter() - t
            check(st.rows_dropped == 0, f"{label}: {st.rows_dropped} rows "
                  f"dropped")
            got = check_parity_result(res, oracle, label)
            del res
            results[lane] = {"paths": (paths, dim_path), "got": got,
                             "dicts": fdf.sources["facts"].dictionaries}
            if lane == "csv-arrow":
                py = results["csv-python"]
                check(py["dicts"] == results[lane]["dicts"] and
                      same_columns(py["got"], got),
                      "strings: the arrow CSV lane differs from the python "
                      "lane")
            out[lane] = {"rows": n, "write_s": write_s, "read_s": read_s,
                         "rows_per_s": n / read_s, "recodes": info.recodes,
                         "batches": info.batches, "groups": len(got["k"]),
                         "wall_s": wall}
            print(f"{label}: {n} rows over {nfiles} files read in "
                  f"{read_s:.3f} s ({n / read_s / 1e6:.2f} M rows/s, "
                  f"{info.recodes} recodes; second read a cache hit, 0 "
                  f"recodes, same layout); merge/filter/groupby/sort "
                  f"{wall * 1e3:.1f} ms, {len(got['k'])} groups == numpy",
                  flush=True)
    print(f"phase ingest strings took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return out


def skew_data(kind, rows, rng):
    """``benchmarks/bench_skew.py:35-48``: int32 keys (uniform over
    ``rows``, Zipf(1.5) over 1000 keys, or 99% ``k = 7``) and an
    integer-valued float32 ``v`` in [0, 100)."""
    if kind == "uniform":
        k = rng.integers(0, max(1, rows), rows).astype(np.int32)
    elif kind == "zipf":
        probs = np.arange(1, 1001, dtype=np.float64) ** -1.5
        k = rng.choice(1000, size=rows, p=probs / probs.sum()
                       ).astype(np.int32)
    else:
        k = np.where(rng.random(rows) < 0.99, HOT_KEY,
                     rng.integers(0, 1000, rows)).astype(np.int32)
    return {"k": k, "v": rng.integers(0, 100, rows).astype(np.float32)}


def skew_plans(Plan, rows, in_core):
    """``gplan`` (raw groupby sum + count, then sort) and ``jplan`` (join
    with the 64-row build table).  In-core they carry
    ``tests/md_scripts/skew_parity.py``'s capacities, which let the
    unsalted run survive the hot rank (``rows + 8192``); out-of-core they
    are ``benchmarks/bench_skew.py``'s (the morsel executor sizes every
    shuffle by its working capacity)."""
    big = rows + 8192
    if in_core:
        g = (Plan.scan("t").groupby(["k"], {"v": ["sum", "count"]},
                                    pre_aggregate=False,
                                    bucket_capacity=big, out_capacity=big)
             .sort(["k"], bucket_capacity=big))
        j = Plan.scan("t").join(Plan.scan("r"), on="k", bucket_capacity=big,
                                shuffle_out_capacity=big, out_capacity=big)
    else:
        g = (Plan.scan("t").groupby(["k"], {"v": ["sum", "count"]},
                                    pre_aggregate=False).sort(["k"]))
        j = Plan.scan("t").join(Plan.scan("r"), on="k", out_capacity=big)
    return {"g": g, "j": j}


def skew_prep(data, p):
    """Host facts of one skewed table, computed once: each row's rank and
    position on it (block distribution, ``SpillTable.from_numpy``), its
    key's hash (``hash_columns_np``, the card's hash), the sorted distinct
    keys with their counts and each row's index among them (keys are
    non-negative int32, so by ``bincount``), and the hot hashes: the keys
    above 2 / p of the rows (the detector's threshold,
    ``AdaptiveConfig.hot_key_factor``), what salting must find."""
    from repro_torch.dataframe.ops_local import hash_columns_np
    keys = data["k"]
    n = len(keys)
    per = -(-n // p)
    full = np.bincount(keys)
    uk = np.flatnonzero(full)
    index = np.cumsum(full > 0) - 1
    cnt = full[uk]
    hot = uk[cnt > n * min(0.5, 2.0 / p)]
    return {"keys": keys, "vals": data["v"], "pos": np.arange(n) % per,
            "src": np.arange(n) // per, "per": per,
            "h": hash_columns_np({"k": keys}, ["k"]), "uk": uk,
            "cnt": cnt, "inv": index[keys],
            "hot": set(int(x) for x in hash_columns_np({"k": hot}, ["k"]))}


def skew_routing(prep, p, slot, hot, plan_kind):
    """Each row's destination rank in the plan's first shuffle: the hash
    home ``h % p``, or with ``hot`` salting, a hot groupby row's home
    plus its slot mod p (``salted_dest``, k = p) and a hot join probe
    row's own rank."""
    h = prep["h"]
    dest = (h % np.uint32(p)).astype(np.int64)
    if hot:
        is_hot = np.isin(h, np.asarray(sorted(hot), np.uint32))
        if plan_kind == "g":
            dest = np.where(is_hot, (dest + slot % p) % p, dest)
        else:
            dest = np.where(is_hot, prep["src"], dest)
    return dest


def skew_launches_in_core(plan_kind, salted):
    """Radix / segmented-sum launches of one in-core ``bsp`` skew run: the
    groupby shuffles once (plus its ``:remerge`` when salted) and the sort
    once; its local groupby sums two aggregates (sum, count) once, and
    salted once more over the partials; the join shuffles both sides (the
    broadcast of hot build rows is an all-gather, no radix) and sums
    nothing."""
    if plan_kind == "g":
        return {"radix_partition": 2 + salted,
                "segmented_sum": 2 * (1 + salted)}
    return {"radix_partition": 2, "segmented_sum": 0}


def skew_launches_out_of_core(plan_kind, prep, hot, p, morsel, factor,
                              tuner, memo):
    """Radix / segmented-sum launches, attempts and morsels of one
    out-of-core skew run, derived from the plan and the data.

    Morsel ``m`` of a rank holds its rows ``[m M, (m + 1) M)``
    (``skew_prep``).  An attempt of the first segment overflows when a
    rank receives more than the working capacity ``W`` rows in one
    morsel (``skew_routing``); the degrade step is the tuner's (``tuner``,
    a ``MorselTuner``, from the observed peak) or the blind halving, as
    the executor picks it, and every attempt streams all its morsels.  Per
    morsel: one radix launch (the groupby's or the join probe's shuffle)
    and, for the groupby, two segmented sums; per attempt the groupby
    combine sums two aggregates once per sub-bucket (``combine_buckets``,
    kept in ``memo`` by (salted, ``M``)).  Then the sort segment (one
    radix launch per morsel of the grouped rows' fullest rank) or, for the
    join, the resident build's one shuffle."""
    from repro_torch.faults import default_degrade_step
    pos, per = prep["pos"], prep["per"]
    M, W = morsel, max(morsel, -(-int(morsel * factor) // 8) * 8)
    radix = segsum = morsels = 0
    attempts = []
    while True:
        nm = -(-per // M)
        dest = skew_routing(prep, p, pos % M, hot, plan_kind)
        recv = np.bincount((pos // M) * p + dest, minlength=nm * p)
        worst = int(max(recv.max() - W, 0))
        attempts.append((M, W, nm))
        morsels += nm
        radix += nm
        if plan_kind == "g":
            segsum += 2 * nm
            if (bool(hot), M) not in memo:
                memo[(bool(hot), M)] = combine_buckets(prep, dest, M, p)
            segsum += 2 * memo[(bool(hot), M)]
        if not worst:
            break
        a = np.zeros((p, 3), np.int64)
        a[0, 2] = worst
        if tuner.enabled:
            M, W = tuner.degrade(M, W, [a], salted=bool(hot))
        else:
            M, W = default_degrade_step(M, W)
    if plan_kind == "g":
        from repro_torch.dataframe.ops_local import hash_columns_np
        home = hash_columns_np({"k": prep["uk"]}, ["k"]) % np.uint32(p)
        sort_m = -(-int(np.bincount(home, minlength=p).max()) // morsel)
        radix += sort_m
        morsels += sort_m
    else:
        radix += 1
    return ({"radix_partition": radix, "segmented_sum": segsum}, attempts,
            morsels)


def combine_buckets(prep, dest, M, p):
    """The groupby combine's sub-buckets: one partial row per (morsel,
    stage-1 rank, key), on the key's home rank after the host re-route;
    the fullest rank over ``M``."""
    inv, nk = prep["inv"], len(prep["uk"])
    code = ((prep["pos"] // M) * p + dest) * nk + inv
    space = (-(-prep["per"] // M)) * p * nk
    seen = (np.flatnonzero(np.bincount(code, minlength=space))
            if space <= 1 << 26 else np.unique(code))
    home = np.zeros(nk, np.int64)
    home[inv] = (prep["h"] % np.uint32(p)).astype(np.int64)
    widest = int(np.bincount(home[seen % nk], minlength=p).max())
    return max(1, -(-widest // M))


def skew_run(torch, env, plan, tables, kw, routed=False):
    """One skew run; with ``routed``, the rows each rank received over all
    the run's shuffles (the radix kernel's destinations, recorded on the
    device) come back beside the result."""
    from repro_torch.core import execute
    got = []

    def run():
        env.synchronize()
        reset_counts()
        t = time.perf_counter()
        res, st = execute(plan, env, tables, optimize=False,
                          collect_stats=True, **kw)
        env.synchronize()
        got.append((res, st, time.perf_counter() - t,
                    launch_counts()))

    if not routed:
        run()
        return got[0] + (None,)
    per_rank = torch.zeros(env.parallelism + 1, dtype=torch.int64,
                           device=env.device)

    def note(dest, nb):
        per_rank.add_(torch.bincount(dest.flatten(), minlength=nb))
    recording(env, run, [("repro_torch.dataframe.shuffle",
                          "radix_partition", note)])
    return got[0] + (per_rank[:-1].cpu().numpy(),)


def skew_oracle(prep, build, p):
    """What every skew run over the table must return, from numpy: the
    groupby's sorted keys, counts and float64 sums; the join's rows and
    probe payload sums per build key, and its rows per rank when the
    probe routes unsalted and salted (``skew_routing``)."""
    keys = prep["keys"]
    sums = np.bincount(prep["inv"], weights=prep["vals"].astype(np.float64))
    nb = len(build["k"])
    join_rows = {salted: np.bincount(
        skew_routing(prep, p, None, prep["hot"] if salted else set(),
                     "j")[keys < nb], minlength=p)
        for salted in (False, True)}
    small = keys < nb
    return {"keys": prep["uk"], "counts": prep["cnt"], "sums": sums,
            "join_counts": np.bincount(keys[small], minlength=nb),
            "join_vsum": np.bincount(keys[small], weights=prep["vals"][
                small].astype(np.float64), minlength=nb),
            "join_rows": join_rows, "build_w": build["w"]}


def check_skew_result(plan_kind, res, st, oracle, salted, p, in_core,
                      label):
    """A run's result against ``skew_oracle``: the groupby's keys and
    counts exactly and its sums within 1e-3 relative (past 2**24 rows a
    float32 sum is not exact in any order); the join's rows per key,
    every row's build payload and each key's probe payload sum exactly,
    and its rows on the ranks the routing sends them to."""
    out = res.to_numpy()
    check(st.rows_dropped == 0, f"{label}: {st.rows_dropped} rows dropped")
    check(bool(st.salted_shuffles) == salted, f"{label}: "
          f"{st.salted_shuffles} salted shuffles, want salted={salted}")
    if plan_kind == "g":
        check(np.array_equal(out["k"], oracle["keys"]),
              f"{label}: group keys differ")
        check(np.array_equal(out["v_count"], oracle["counts"]),
              f"{label}: counts differ")
        sums = oracle["sums"]
        rel = np.abs(out["v_sum"] - sums) / np.maximum(sums, 1.0)
        check(float(rel.max()) <= 1e-3, f"{label}: v_sum off by "
              f"{rel.max()} relative")
        return
    cnt = oracle["join_counts"]
    nb = len(cnt)
    check(len(out["k"]) == int(cnt.sum()), f"{label}: {len(out['k'])} join "
          f"rows, want {int(cnt.sum())}")
    check(np.array_equal(np.bincount(out["k"], minlength=nb), cnt),
          f"{label}: join rows per key differ")
    check(np.array_equal(out["w"], oracle["build_w"][out["k"]]),
          f"{label}: build payloads misplaced")
    check(np.array_equal(np.bincount(out["k"], weights=out["v"].astype(
        np.float64), minlength=nb), oracle["join_vsum"]),
          f"{label}: probe payload sums per key differ")
    want = oracle["join_rows"][salted]
    rows = (res.row_counts.cpu().numpy() if in_core
            else np.array([res.rank_rows(r) for r in range(p)]))
    check(np.array_equal(rows, want), f"{label}: rows per rank {rows}, "
          f"routing says {want}")


def skew_phase(torch, rows=SKEW_ROWS, device=None, morsel=None,
               in_core_rows=None):
    """The salted operators on skewed tables, 8 stacked ranks: ``rows``
    keys uniform, Zipf(1.5) over 1000 and 99% one key, through ``gplan``
    and ``jplan`` in-core (``bsp``) and out-of-core (``morsel`` rows per
    rank, default ``rows / 8 / 8``, capacity_factor 2), adaptive on and
    off, first and cached (in-core a third, recorded run gives the rows
    each rank received; out-of-core the first run is recorded).  In-core
    runs take the first ``in_core_rows`` rows (default all of them, at
    most 2**24): at skew_parity.py's capacities every shuffle of a table
    whose capacity is ``rows + 8192`` per rank stacks p × p × that many
    slots on the one card, and at 2**25 rows the unsalted run's sort
    shuffle alone asked for more than the 80 GB (a 16 GiB receive index
    on top of 66 GiB).  Each run
    is held to numpy (``check_skew_result``), its kernel launches to
    their derivation, adaptive on drops no row, and on uniform keys the
    default salts nothing, builds no stage ``adaptive=False`` does not
    and misses the cache on no repeat.  Returns the runs' numbers."""
    from repro_torch.adapt import AdaptiveConfig, MorselTuner
    from repro_torch.core import CylonEnv, DistTable, Plan
    t_phase = time.perf_counter()
    rng = np.random.default_rng(42)
    build = {"k": np.arange(64, dtype=np.int32),
             "w": rng.integers(0, 100, 64).astype(np.float32)}
    morsel = morsel or -(-(rows // P // 8) // 8) * 8
    n_in = in_core_rows or min(rows, 1 << 24)
    cap = 2 * (n_in // P)
    on_card = resolve_on_card(device)
    results = {"in_core_rows": n_in, "out_of_core_rows": rows,
               "morsel_rows": morsel}
    run_s = 0.0
    print(f"skew: {n_in} rows in-core (at most 2**24 fit the card: see "
          f"skew_phase), capacity {cap}/rank (shuffle capacities "
          f"{n_in + 8192}); {rows} rows out-of-core, morsel_rows {morsel}, "
          f"capacity_factor 2.0; {P} stacked ranks", flush=True)
    for kind in ("uniform", "zipf", "one_key"):
        full = skew_data(kind, rows, rng)
        env = CylonEnv(P, device=device)
        t = DistTable.from_numpy({c: v[:n_in] for c, v in full.items()}, P,
                                 capacity=cap, device=device)
        bt = DistTable.from_numpy(build, P, device=device)
        for where in ("in-core", "out-of-core"):
            in_core = where == "in-core"
            data = ({c: v[:n_in] for c, v in full.items()} if in_core
                    else full)
            prep = skew_prep(data, P)
            hot = prep["hot"]
            oracle = skew_oracle(prep, build, P)
            memo = {}
            plans = skew_plans(Plan, n_in if in_core else rows, in_core)
            for plan_kind in ("g", "j"):
                tables = ({"t": t} if in_core else {"t": data})
                if plan_kind == "j":
                    tables["r"] = bt if in_core else build
                keys_off = None
                for adaptive in (False, True):
                    salted = adaptive and bool(hot)
                    label = (f"skew {kind} {plan_kind}plan {where} "
                             f"adaptive={adaptive}")
                    kw = ({} if in_core else
                          dict(morsel_rows=morsel, capacity_factor=2.0))
                    kw["adaptive"] = adaptive
                    if in_core:
                        want = skew_launches_in_core(plan_kind, salted)
                        detail = ""
                    else:
                        tuner = MorselTuner(
                            AdaptiveConfig() if adaptive
                            else AdaptiveConfig(autotune=False),
                            capacity_factor=2.0)
                        want, attempts, n_m = skew_launches_out_of_core(
                            plan_kind, prep, hot if salted else set(),
                            P, morsel, 2.0, tuner, memo)
                        detail = f" attempts (M, W, morsels) {attempts}"
                    runs = {}
                    order = (("first", False), ("cached", False),
                             ("recorded", True)) if in_core else \
                        (("first", True), ("cached", False))
                    for run, rec in order:
                        if on_card:
                            torch.cuda.reset_peak_memory_stats()
                        res, st, wall, counts, routed = skew_run(
                            torch, env, plans[plan_kind], tables, kw, rec)
                        run_s += wall
                        peak = (torch.cuda.max_memory_allocated() / 2**30
                                if on_card else None)
                        check_skew_result(plan_kind, res, st, oracle,
                                          salted, P, in_core,
                                          f"{label} {run}")
                        if not in_core:
                            check(st.degraded == len(attempts) - 1 and
                                  st.morsels == n_m, f"{label} {run}: "
                                  f"{st.degraded} degrades, {st.morsels} "
                                  f"morsels; derived {len(attempts) - 1}, "
                                  f"{n_m}")
                        counts = {k: counts[k] for k in want}
                        if on_card:
                            check(counts == want, f"{label} {run}: launches "
                                  f"{counts}, derived {want}")
                        if run == "cached":
                            check(st.cache_misses == 0, f"{label}: "
                                  f"{st.cache_misses} misses on the repeat")
                        ratio = None
                        if routed is not None:
                            ratio = float(routed.max()
                                          / max(np.median(routed), 1.0))
                        runs[run] = dict(
                            wall_s=wall, peak_gib=peak,
                            salted_shuffles=st.salted_shuffles,
                            rows_dropped=st.rows_dropped,
                            degraded=st.degraded,
                            autotune_steps=st.autotune_steps,
                            splitter_refreshes=st.splitter_refreshes,
                            cache_misses=st.cache_misses,
                            launches=counts, derived=want,
                            routed_max_over_median=ratio)
                        print(f"{label} {run:8s} wall {wall * 1e3:9.2f} ms "
                              f"peak {'%.2f GiB' % peak if peak else 'n/a'} "
                              f"salted={st.salted_shuffles} "
                              f"dropped={st.rows_dropped} "
                              f"degraded={st.degraded} "
                              f"autotune={st.autotune_steps} "
                              f"refreshes={st.splitter_refreshes} "
                              f"misses={st.cache_misses} launches={counts} "
                              f"(derived {want}){detail}"
                              + (f" routed rows per rank {routed.tolist()}, "
                                 f"hottest / median {ratio:.3f}"
                                 if ratio is not None else ""), flush=True)
                        del res
                    if kind == "uniform":
                        if not adaptive:
                            keys_off = set(env._cache)
                        else:
                            check(set(env._cache) == keys_off, f"{label}: "
                                  f"the default built stages adaptive=False"
                                  f" did not")
                    results[f"{kind}/{plan_kind}/{where}/"
                            f"{'on' if adaptive else 'off'}"] = runs
        del t, bt, env, full, data
        if on_card:
            torch.cuda.empty_cache()
    took = time.perf_counter() - t_phase
    print(f"phase skew took {took:.1f} s, {run_s:.1f} s of it in the runs "
          f"(the rest: making the tables, the numpy oracle and launch "
          f"derivations, reading results back)", flush=True)
    return results


def resolve_on_card(device):
    from repro_torch.core import resolve_device
    return resolve_device(device).type == "cuda"


OOC_SITES = ("segment:launch", "morsel:compile", "morsel:execute",
             "transfer:h2d", "transfer:d2h", "spill:append", "spill:respill",
             "spill:combine", "build:resident")


def fault_visits(run):
    """Visits per fault site of one fault-free run: ``run(faults)`` runs
    the query with an armed plan of no faults, whose occurrence counters
    then hold every site's visits."""
    from repro_torch.faults import FaultPlan
    counter = FaultPlan(()).start()
    run(counter)
    return dict(counter._seen)


def same_result(got, want):
    return sorted(got) == sorted(want) and all(
        got[c].dtype == want[c].dtype and np.array_equal(got[c], want[c])
        for c in want)


def faults_phase(torch, rows=FULL_ROWS, ooc_rows=1 << 23, device=None,
                 keep=None):
    """Fig-9 recovered from injected faults, on integer-valued payloads
    (exact sums, so a recovered result is bit for bit the fault-free one):
    in-core at 2 x ``rows`` rows, one ``raise`` at ``stage:launch`` and at
    ``a2a:chunk``, in ``bsp`` and ``bsp_staged``; out-of-core at 2 x
    ``ooc_rows`` rows, 8x oversubscribed, one ``raise`` at each of the
    nine out-of-core sites, ``corrupt-capacity`` at ``build:resident``
    and ``segment:launch``, three ``random_plan`` seeds, and one ``hang``
    under ``timeout=`` (``QueryTimeout`` within the deadline + 1 s, then a
    fault-free run on the same env).  Each recovered run: bit-identical
    to the fault-free run, no row dropped, ``faults_injected`` what the
    plan fires on this run's site visits and ``retries`` one per fired
    ``raise``.  Returns the walls; ``keep["faults"]`` gets the
    out-of-core clean run's digests and derived launches, which the
    process-group phase holds its processes to."""
    from repro_torch.core import CylonEnv, DistTable, Plan, execute
    from repro_torch.faults import FaultPlan, FaultSpec, QueryTimeout, \
        random_plan
    t_phase = time.perf_counter()
    walls = {}

    def timed(label, fn):
        env.synchronize()
        t = time.perf_counter()
        out = fn()
        env.synchronize()
        walls[label] = time.perf_counter() - t
        return out

    def recovered(label, res, st, want, fired, raises):
        check(same_result(res.to_numpy(), want), f"faults {label}: result "
              f"differs from the fault-free run")
        check(st.rows_dropped == 0 and st.faults_injected == fired
              and st.retries == raises, f"faults {label}: dropped "
              f"{st.rows_dropped}, injected {st.faults_injected} (want "
              f"{fired}), retries {st.retries} (want {raises})")
        print(f"faults {label}: recovered bit-identical in "
              f"{walls[label] * 1e3:.2f} ms, injected {st.faults_injected},"
              f" retries {st.retries}, degraded {st.degraded}, "
              f"autotune {st.autotune_steps}", flush=True)

    # -- in-core ------------------------------------------------------- #
    ld, rd = make_exact_data(rows, 0, "v0"), make_exact_data(rows, 1, "w")
    cap = capacity_for(rows, P)
    env = CylonEnv(P, device=device)
    tables = {"l": DistTable.from_numpy(ld, P, capacity=cap, device=device),
              "r": DistTable.from_numpy(rd, P, capacity=cap, device=device)}
    plan = fig9_plan(Plan, cap)
    for mode in ("bsp", "bsp_staged"):
        want = timed(f"{mode}/clean", lambda: execute(
            plan, env, tables, mode=mode, collect_stats=True))[0].to_numpy()
        for site in ("stage:launch", "a2a:chunk"):
            label = f"{mode}/{site}"
            res, st = timed(label, lambda: execute(
                plan, env, tables, mode=mode, collect_stats=True,
                faults=f"{site}@0=raise"))
            recovered(label, res, st, want, 1, 1)
            del res
    del tables, want, env
    # -- out-of-core --------------------------------------------------- #
    ld, rd = (make_exact_data(ooc_rows, 0, "v0"),
              make_exact_data(ooc_rows, 1, "w"))
    cap = capacity_for(ooc_rows, P)
    morsel = -(-(-(-ooc_rows // P) // 8) // 8) * 8
    env = CylonEnv(P, device=device)
    tables = {"l": ld, "r": DistTable.from_numpy(rd, P, capacity=cap,
                                                 device=device)}
    plan = fig9_plan(Plan, cap)

    def ooc(faults=False, **kw):
        return execute(plan, env, tables, collect_stats=True,
                       morsel_rows=morsel, capacity_factor=4.0,
                       faults=faults, **kw)
    res, st = timed("ooc/clean", ooc)
    want = res.to_numpy()
    check(st.retries == st.faults_injected == 0, "faults: clean run faulted")
    if keep is not None:
        from repro_torch.planner import compile_plan
        want_k = ooc_launches_expected(
            compile_plan(plan, tables), ld, host_reference(ld, rd)[1],
            max(res.rank_rows(r) for r in range(P)), morsel, P)[0]
        keep.update(fault_rows=ooc_rows, faults=(spill_digests(res), {
            k: n * resolve_on_card(device) for k, n in want_k.items()}))
    visits = fault_visits(lambda f: ooc(f))
    print(f"faults: out-of-core Fig-9 at 2 x {ooc_rows} rows, morsel_rows "
          f"{morsel}; site visits of a fault-free run {visits}", flush=True)
    for site in OOC_SITES:
        check(visits.get(site, 0) > 0, f"faults: {site} never visited")
        res, st = timed(f"ooc/{site}", lambda: ooc(f"{site}@0=raise"))
        recovered(f"ooc/{site}", res, st, want, 1, 1)
    for site in ("build:resident", "segment:launch"):
        label = f"ooc/{site}/corrupt-capacity"
        res, st = timed(label, lambda: ooc(f"{site}@0=corrupt-capacity"))
        recovered(label, res, st, want, 1, 0)
        # a quarter of the build's headroom may still hold a uniform hash
        # spread; a quarter of the segment's working capacity cannot
        check(st.degraded > 0 or site == "build:resident",
              f"faults {label}: no degrade replay")
    for seed in (1, 2, 3):
        rp = random_plan(seed, max_occurrence=2, sites=OOC_SITES)
        (spec,) = rp.specs
        fired = int(visits.get(spec.site, 0) > spec.at)
        label = f"ooc/random_plan({seed})={rp}"
        res, st = timed(label, lambda: ooc(rp))
        recovered(label, res, st, want, fired, fired)
    hang = FaultPlan((FaultSpec("morsel:execute", kind="hang", at=1),),
                     hang_s=30.0)
    deadline = 2.0 * walls["ooc/clean"] + 1.0
    t = time.perf_counter()
    try:
        ooc(hang, timeout=deadline)
        check(False, "faults: the hang was not fenced by the deadline")
    except QueryTimeout:
        pass
    took = time.perf_counter() - t
    check(took <= deadline + 1.0, f"faults: QueryTimeout after {took:.2f} s,"
          f" deadline {deadline:.2f} s")
    res, st = timed("ooc/after-timeout", ooc)
    recovered("ooc/after-timeout", res, st, want, 0, 0)
    check(st.cache_misses == 0, "faults: the run after the timeout built "
          "stages anew")
    print(f"faults: hang under timeout={deadline:.2f} s raised QueryTimeout "
          f"after {took:.2f} s; phase took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    walls["ooc/hang-timeout"] = took
    return walls


def degrade_phase(devices=("cuda", "cpu")):
    """The default overflow policy in-core on an under-capacitated join
    (``tests/test_out_of_core.py::
    test_in_core_degrade_recovers_join_overflow``, over ``P`` ranks): the
    run replays out-of-core and returns every row; the card's rows equal
    the CPU's."""
    from repro_torch.core import CylonEnv, DistTable, Plan, execute
    ld = {"k": np.zeros(32, np.int32), "v0": np.arange(32, dtype=np.float32)}
    rd = {"k": np.zeros(32, np.int32), "w": np.arange(32, dtype=np.float32)}
    plan = Plan.scan("l").join(Plan.scan("r"), on="k", out_capacity=64)
    got = {}
    for device in devices:
        env = CylonEnv(P, device=device)
        out, st = execute(plan, env, {
            n: DistTable.from_numpy(d, P, capacity=8, device=device)
            for n, d in (("l", ld), ("r", rd))},
            optimize=False, collect_stats=True)
        check(isinstance(out, DistTable) and out.device == env.device,
              f"degrade {device}: result is not a DistTable on the env")
        check(st.rows_dropped == 0 and st.degraded > 0, f"degrade {device}: "
              f"{st.rows_dropped} dropped, {st.degraded} degrade replays")
        check(out.total_rows() == 32 * 32, f"degrade {device}: "
              f"{out.total_rows()} rows, want {32 * 32}")
        got[device] = out.to_reference()
    (gc, gn), (cc, cn) = got[devices[0]], got[devices[-1]]
    check(np.array_equal(gn, cn) and all(np.array_equal(gc[c], cc[c])
                                         for c in cc),
          "degrade: card and CPU results differ")
    print(f"degrade: under-capacitated join recovered all {32 * 32} rows "
          f"({st.degraded} degrade replays); card == cpu", flush=True)


def unsigned_phase(devices=("cuda", "cpu")):
    """Groupbys, a join and a sort over uint16 and uint32 columns (values
    past 2**31 for uint32) on the card and on the CPU, slot for slot and
    dtype for dtype."""
    from repro_torch.core import CylonEnv, DistTable, Plan, execute
    rng = np.random.default_rng(5)
    n = 4096
    for dt in (np.uint16, np.uint32):
        top = np.iinfo(dt).max
        data = {"k": rng.integers(0, 64, n).astype(np.int32),
                "u": rng.integers(top - 3000, top, n, endpoint=True,
                                  dtype=np.uint64).astype(dt),
                "v0": rng.integers(0, 100, n).astype(np.float32)}
        right = {"k": rng.integers(0, 64, n).astype(np.int32),
                 "w": rng.integers(0, top, n, endpoint=True,
                                   dtype=np.uint64).astype(dt)}
        plans = {
            "groupby(k).u": Plan.scan("l").groupby(
                ["k"], {"u": ["sum", "min", "max"]}),
            "groupby(u).v0": Plan.scan("l").groupby(["u"], {"v0": ["sum"]}),
            "sort(u)": Plan.scan("l").sort(["u"]),
            "join carrying u": Plan.scan("l").join(
                Plan.scan("r"), on="k", out_capacity=1 << 17)}
        got = {}
        for device in devices:
            env = CylonEnv(P, device=device)
            tables = {"l": DistTable.from_numpy(data, P, capacity=1024,
                                                device=device),
                      "r": DistTable.from_numpy(right, P, capacity=1024,
                                                device=device)}
            for name, plan in plans.items():
                res, st = execute(plan, env, tables, collect_stats=True)
                check(st.rows_dropped == 0, f"{dt.__name__} {name} "
                      f"{device}: drops")
                got[(device, name)] = res.to_reference()
        for name in plans:
            (gc, gn), (cc, cn) = (got[(devices[0], name)],
                                  got[(devices[-1], name)])
            check(np.array_equal(gn, cn) and sorted(gc) == sorted(cc)
                  and all(gc[c].dtype == cc[c].dtype
                          and np.array_equal(gc[c], cc[c]) for c in cc),
                  f"{dt.__name__} {name}: card and CPU differ")
            check(cc.get("u", cc.get("u_sum", cc.get("w"))).dtype == dt,
                  f"{dt.__name__} {name}: unsigned column lost its dtype")
            print(f"unsigned {dt.__name__} {name}: card == cpu "
                  f"({int(gn.sum())} rows)", flush=True)


def flash_phase(torch, flush):
    """Flash-attention kernel vs ``attention_ref`` on the card; returns the
    per-case records (the first is the main path's shape, f32)."""
    import torch.nn.functional as F
    from repro_torch.kernels import attention_ref, flash_attention_cuda
    from repro_torch.kernels.flash_attention.cuda import route_for
    from repro_torch.kernels.flash_attention.ops import flash_flops
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    # (b, hq, hkv, sq, sk, d, causal, dtype): the qwen3-8b prefill at a
    # 4096-token prompt in f32 and bf16, Sq != Sk, a length off the 64-
    # and 128-row tiles, non-causal over ragged keys, each in both dtypes
    # (f32 takes the simt route, bf16 at D = 128 the wgmma route); then
    # the same at gemma-7b's head dim 256, simt in both dtypes
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [("main", 4, 32, 8, 4096, 4096, 128, True, f32),
             ("main:bf16", 4, 32, 8, 4096, 4096, 128, True, bf16),
             ("sq<sk", 4, 32, 8, 1024, 4096, 128, True, f32),
             ("sq<sk:bf16", 4, 32, 8, 1024, 4096, 128, True, bf16),
             ("ragged", 2, 32, 8, 4000, 4000, 128, True, f32),
             ("ragged:bf16", 2, 32, 8, 4000, 4000, 128, True, bf16),
             ("noncausal", 2, 32, 8, 1000, 3001, 128, False, f32),
             ("noncausal:bf16", 2, 32, 8, 1000, 3001, 128, False, bf16),
             # the olmoe-1b-7b prefill: 16 heads, no grouping
             ("olmoe", 4, 16, 16, 4096, 4096, 128, True, f32),
             # the gemma-7b prefill: 16 heads of 256, no grouping
             ("gemma", 4, 16, 16, 4096, 4096, 256, True, f32),
             ("gemma:bf16", 4, 16, 16, 4096, 4096, 256, True, bf16),
             ("ragged:d256", 2, 16, 16, 4000, 4000, 256, True, f32),
             ("ragged:d256:bf16", 2, 16, 16, 4000, 4000, 256, True, bf16),
             ("noncausal:d256", 2, 16, 16, 1000, 3001, 256, False, f32),
             ("noncausal:d256:bf16", 2, 16, 16, 1000, 3001, 256, False,
              bf16),
             # the musicgen-large prefill: 32 heads of 64, no grouping;
             # the llava-next-34b prefill: 56 q heads over 8, group 7
             ("musicgen", 4, 32, 32, 4096, 4096, 64, True, f32),
             ("llava", 4, 56, 8, 4096, 4096, 128, True, f32)]
    out = []
    for name, b, hq, hkv, sq, sk, d, causal, dt in cases:
        q = torch.randn(b, hq, sq, d, generator=gen, device=dev).to(dt)
        k = torch.randn(b, hkv, sk, d, generator=gen, device=dev).to(dt)
        v = torch.randn(b, hkv, sk, d, generator=gen, device=dev).to(dt)
        route = route_for(dt, d)
        before = flash_attention_cuda.route_launches[route]
        got = flash_attention_cuda(q, k, v, causal)
        check(flash_attention_cuda.route_launches[route] == before + 1,
              f"flash_attention {name}: the {route} route did not launch")
        want = attention_ref(q, k, v, causal)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        # tests/test_kernels.py's tolerances: 2e-3 in f32; 2e-2 in bf16,
        # held relative to each output (plus 2e-3), since the outputs of
        # late query rows are an order of magnitude under those of the
        # first rows and an absolute 2e-2 would pass a dropped key tile
        if dt == f32:
            ok, tol = err <= 2e-3, "2e-3"
        else:
            ok = bool((diff <= 2e-2 * want.float().abs() + 2e-3).all())
            tol = "2e-2 |want| + 2e-3"
        check(ok, f"flash_attention CUDA != plain at {name}: max |err| "
              f"{err} beyond {tol}")
        del got, want
        ms = time_cuda(torch, lambda: flash_attention_cuda(q, k, v, causal),
                       10, flush)
        plain_ms = time_cuda(torch, lambda: attention_ref(q, k, v, causal),
                             3, flush)
        lib_ms = None
        if name.startswith(("main", "olmoe", "gemma", "musicgen",
                            "llava")):
            lib_ms = time_cuda(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), 10, flush)
        flops = flash_flops(sq, sk, d, b * hq, causal)
        nbytes = (q.numel() * 2 + 2 * k.numel()) * q.element_size()
        peak = F32_FLOPS if dt == f32 else BF16_FLOPS
        bound_ms = max(flops / peak, nbytes / HBM_BYTES_PER_S) * 1e3
        out.append(dict(case=name, shape=[b, hq, hkv, sq, sk, d],
                        causal=causal, dtype=str(dt).split(".")[-1],
                        kernel_route=route, ms=ms,
                        plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=("operations" if flops / peak
                                  >= nbytes / HBM_BYTES_PER_S else "bytes"),
                        peak=("f32 67 TFLOP/s" if dt == f32
                              else "bf16 dense 989 TFLOP/s"),
                        library_ms=lib_ms, max_abs_err=err))
        lib = f", sdpa {lib_ms:.3f} ms" if lib_ms is not None else ""
        print(f"kernel flash_attention {name:19s} {out[-1]['dtype']} "
              f"route={route} "
              f"b={b} hq={hq} hkv={hkv} sq={sq} sk={sk} d={d} "
              f"causal={causal}: {ms:.3f} ms (plain {plain_ms:.3f} ms, "
              f"bound {bound_ms:.3f} ms{lib}), max |err| {err:.2e}",
              flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    return out


def profile_ssd(torch, args, chunk, reps=3):
    """Device time of each of the SSD scan's three kernels in one call,
    the median over ``reps`` calls under ``torch.profiler``; None for a
    kernel the profiler did not see."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ssd_scan, ssd_scan_cuda
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            ssd_scan(*args, chunk=chunk)
        torch.cuda.synchronize()
    times = {k: [] for k in ssd_scan_cuda.kernels}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        for k in times:
            if f"{k}(" in e.name:
                times[k].append(e.time_range.elapsed_us() / 1e3)
    return {k: float(np.median(v)) if v else None for k, v in times.items()}


def ssd_recurrence_f64(torch, x, dt, a, b, c):
    """The SSD recurrence one step at a time in float64 (the exact answer
    to within float64 rounding): y (BH, T, P) and h (BH, N, P)."""
    x, dt, a, b, c = (v.double() for v in (x, dt, a, b, c))
    bh, t, p = x.shape
    h = torch.zeros((bh, b.shape[-1], p), dtype=torch.float64,
                    device=x.device)
    decay = torch.exp(a[:, None, :] * dt.transpose(1, 2))   # (BH, 1, T)
    bdt = b * dt
    ys = []
    for i in range(t):
        h.mul_(decay[:, :, i:i + 1])
        h.baddbmm_(bdt[:, i, :, None], x[:, i, None, :])
        ys.append(torch.bmm(c[:, i, None, :], h))
    return torch.cat(ys, dim=1), h


def ssd_phase(torch, flush):
    """SSD-scan kernel vs ``ssd_scan_chunked`` on the card; the first case
    is the mamba2-780m prefill at a 4096-token prompt (B*nh = 4*48), whose
    three kernels are then timed one by one under the profiler."""
    from repro_torch.kernels import ssd_scan, ssd_scan_chunked
    from repro_torch.kernels.ssd_scan.ops import ssd_counts
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    # (name, bh, t, p, n, chunk, a): a None draws a in (-1.05, -0.05] and
    # dt in [0.01, 0.11); a number fixes a there and draws dt in [0.01, 1)
    cases = [("main", 192, 4096, 64, 128, 128, None),
             ("ragged", 192, 4000, 64, 128, 128, None),  # last chunk 32 rows
             ("short", 48, 13, 64, 128, 128, None),      # T < chunk, off 8
             ("smoke", 8, 100, 16, 16, 32, None),        # the SMOKE dims
             ("chunk32", 192, 4096, 64, 128, 32, None),  # 128 chunks deep
             ("decay", 192, 4096, 64, 128, 128, -8.0),   # exp(total) -> 0
             # the mamba2-780m train step: B 8 x 48 heads, 1,024 tokens
             ("train", TRAIN_BATCH * 48, TRAIN_SEQ, 64, 128, 128, None),
             # the jamba-v0.1-52b prefill: B 4 x 128 heads, state N = 16
             # (half of the kernel's 32-column slice of B and C)
             ("jamba", 4 * 128, 4096, 64, 16, 128, None)]
    out = []
    for name, bh, t, p, n, chunk, a_fix in cases:
        x = torch.randn(bh, t, p, generator=gen, device=dev)
        if a_fix is None:
            dt = torch.rand(bh, t, 1, generator=gen, device=dev) * 0.1 + 0.01
            a = -torch.rand(bh, 1, generator=gen, device=dev) - 0.05
        else:
            dt = torch.rand(bh, t, 1, generator=gen, device=dev) * 0.99 + 0.01
            a = torch.full((bh, 1), a_fix, device=dev)
        b = torch.randn(bh, t, n, generator=gen, device=dev)
        c = torch.randn(bh, t, n, generator=gen, device=dev)
        ch = min(chunk, -(-t // 8) * 8)
        y, h = ssd_scan(x, dt, a, b, c, chunk=chunk)
        y_p, h_p = ssd_scan_chunked(x, dt, a, b, c, chunk=ch)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(y).all() and torch.isfinite(h).all()),
              f"ssd_scan CUDA at {name}: output not finite")

        def max_err(want_y, want_h):
            return max(float((y - want_y).abs().max()),
                       float((h - want_h).abs().max()))
        err = max_err(y_p, h_p)
        check(err <= 3e-3, f"ssd_scan CUDA != plain at {name}: {err} > 3e-3")
        if a_fix is not None:
            # under strong decay the float32 plain version's own error is
            # of the order of the tolerance (its cum differences round at
            # |cum| ~ 500): also hold the kernel to the float64 recurrence
            y_e, h_e = ssd_recurrence_f64(torch, x, dt, a, b, c)
            plain_err = max(float((y_p - y_e).abs().max()),
                            float((h_p - h_e).abs().max()))
            exact_err = max_err(y_e, h_e)
            print(f"kernel ssd_scan {name}: CUDA vs ssd_scan_chunked "
                  f"{err:.2e}; vs the float64 recurrence: CUDA "
                  f"{exact_err:.2e}, ssd_scan_chunked {plain_err:.2e}",
                  flush=True)
            check(exact_err <= 3e-3, f"ssd_scan CUDA != the float64 "
                  f"recurrence at {name}: {exact_err} > 3e-3")
            del y_e, h_e
        del y, h, y_p, h_p
        ms = time_cuda(torch, lambda: ssd_scan(x, dt, a, b, c, chunk=chunk),
                       10, flush)
        plain_ms = time_cuda(torch, lambda: ssd_scan_chunked(
            x, dt, a, b, c, chunk=ch), 3, flush)
        flops, nbytes = ssd_counts(bh, t, p, n, chunk)
        op_ms, byte_ms = flops / F32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        out.append(dict(case=name, shape=[bh, t, p, n, chunk], ms=ms,
                        plain_ms=plain_ms, bound_ms=max(op_ms, byte_ms),
                        bound_by="operations" if op_ms >= byte_ms else "bytes",
                        library_ms=None, max_abs_err=err))
        print(f"kernel ssd_scan {name:7s} bh={bh} t={t} p={p} n={n} "
              f"chunk={chunk}: {ms:.3f} ms (plain {plain_ms:.3f} ms, bound "
              f"{max(op_ms, byte_ms):.3f} ms by {out[-1]['bound_by']}), "
              f"max |err| {err:.2e}", flush=True)
        if name == "main":
            per = profile_ssd(torch, (x, dt, a, b, c), chunk)
            out[-1]["kernel_ms"] = per
            print("kernel ssd_scan main, device time per kernel (profiler, "
                  "L2 warm): " + ", ".join(
                      f"{k} {v:.3f} ms" if v is not None
                      else f"{k} not measured" for k, v in per.items()),
                  flush=True)
        del x, dt, a, b, c
        torch.cuda.empty_cache()
    return out


def serve_config(arch, smoke=False):
    """The served config of ``arch``, cut to ``SERVE_LAYERS`` at full
    width."""
    import dataclasses
    from repro_torch.configs import get_config, get_smoke_config
    if smoke:
        return get_smoke_config(arch)
    cfg = get_config(arch)
    if arch in SERVE_LAYERS:
        cfg = dataclasses.replace(cfg, num_layers=SERVE_LAYERS[arch])
    return cfg


def serve_prompts(cfg, batch, positions, patches, rng):
    """Token prompts of a sequence of ``positions`` from ``rng``: (batch,
    positions) ids, (batch, positions, K) for audio; a vlm's ``patches``
    patch embeddings take the first positions."""
    k = (cfg.num_codebooks,) if cfg.family == "audio" else ()
    return rng.integers(0, cfg.vocab_size,
                        (batch, positions - patches) + k).astype(np.int32)


class VlmServe:
    """A vlm's greedy serving loop: ``ServeEngine`` takes token prompts
    only, so the patch embeddings ``patches`` (B, P, D) go ahead of the
    token prompt (B, S0) through ``transformer.prefill``, and decoding
    runs at positions P + S0, P + S0 + 1, ...  It has the engine's
    ``prefill``, ``decode_step`` and ``generate`` (a decode step after
    every new token, the last one's logits unused, as the engine's), so
    ``instrument`` and ``profile_serve`` take it as an engine."""

    def __init__(self, cfg, model, cache_len, patches):
        self.cfg, self.model, self.cache_len = cfg, model, cache_len
        self.patches = patches

    def prefill(self, tokens):
        from repro_torch.models import transformer
        return transformer.prefill(self.model, tokens, self.cache_len,
                                   patch_embeds=self.patches)

    def decode_step(self, caches, tokens, pos):
        from repro_torch.models import transformer
        return transformer.decode_step(self.model, caches, tokens, pos)

    def generate(self, prompts, max_new_tokens):
        import torch
        from repro_torch.serve.engine import GenerationResult
        tokens = torch.as_tensor(prompts, dtype=torch.long,
                                 device=self.model.device)
        b, s0 = tokens.shape[0], self.patches.shape[1] + tokens.shape[1]
        logits, caches = self.prefill(tokens)
        out = []
        for step in range(max_new_tokens):
            tok = torch.argmax(logits, dim=-1)
            out.append(tok)
            pos = torch.full((b,), s0 + step, dtype=torch.int32,
                             device=tokens.device)
            logits = self.decode_step(caches, tok[:, None], pos)
        toks = torch.stack(out, dim=1).cpu().numpy().astype(np.int32)
        return GenerationResult(tokens=toks, steps=len(out), prefill_len=s0)


def serve_launches(cfg, impl, prompt):
    """Kernel launches of one prefill and of one decode step on the card,
    derived from the layers: flash attention once per GQA attention layer
    when ``impl`` picks it (``flash``, or ``auto`` past 2,048 keys; MLA
    takes dense or chunked attention, never flash), the SSD scan once per
    mamba layer (``kernel`` or ``auto``), the radix partition once per MoE
    layer (the dispatch ranks of each batch row) in prefill and in every
    decode step, the segmented sum never."""
    kinds = [cfg.layer_kind(i) for i in range(cfg.num_layers)]
    moe = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    flash = cfg.mla is None and (
        impl == "flash" or (impl == "auto" and prompt > 2048))
    prefill = {"radix_partition": moe, "segmented_sum": 0,
               "flash_attention": kinds.count("a") if flash else 0,
               "ssd_scan": (kinds.count("m") if impl in ("kernel", "auto")
                            else 0)}
    return prefill, dict(prefill, flash_attention=0, ssd_scan=0)


def instrument(torch, engine, rec):
    """Wrap the engine's prefill and decode step: kernel launch counts are
    reset just before each call and read just after it; the prefill is
    timed to its end on the device (time to first token) and its logits
    are checked finite."""
    from repro_torch.kernels import flash_attention_cuda
    prefill, decode = engine.prefill, engine.decode_step

    def counts():
        return launch_counts()

    def counted_prefill(tokens):
        routes = dict(flash_attention_cuda.route_launches)
        reset_counts()
        t = time.perf_counter()
        logits, caches = prefill(tokens)
        torch.cuda.synchronize()
        rec["prefill_s"] = time.perf_counter() - t
        rec["prefill"] = counts()
        rec["flash_routes"] = {
            r: c - routes[r]
            for r, c in flash_attention_cuda.route_launches.items()
            if c > routes[r]}
        check(bool(torch.isfinite(
            logits[..., :engine.cfg.vocab_size]).all()),
            "prefill logits are not finite")
        return logits, caches

    def counted_decode(caches, tokens, pos):
        reset_counts()
        logits = decode(caches, tokens, pos)
        rec["decode"].append(counts())
        rec["last_logits"] = logits
        return logits

    engine.prefill, engine.decode_step = counted_prefill, counted_decode


def serve_phase(torch, smi, seed=0):
    """``SERVE_CASES`` at full width (jamba, qwen3-32b and llava cut to
    ``SERVE_LAYERS``) through ``ServeEngine``, and ``VLM_CASES`` through
    ``VlmServe`` (their patch embeddings standard normals from the seed);
    returns per-arch records of the first and the cached run, with the
    model FLOPs of a prefill (``launch/roofline.py::model_flops``) over
    its time and the card's f32 peak."""
    from repro_torch.kernels.flash_attention.cuda import route_for
    from repro_torch.launch.roofline import device_peaks, model_flops
    from repro_torch.launch.shapes import vlm_patches
    from repro_torch.models import transformer
    from repro_torch.serve import ServeEngine
    dev = torch.device("cuda")
    f32_peak = device_peaks().f32_flops_per_s
    results = {}
    for arch, batch, prompt, new in SERVE_CASES + VLM_CASES:
        cfg = serve_config(arch)
        t = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(seed)
        model = transformer.init_params(cfg, gen, torch.float32, dev)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        print(f"serve {arch}: {cfg.num_layers} layers, {n_params / 1e9:.3f}"
              f" B float32 parameters ({n_params * 4 / 2**30:.2f} GiB) made "
              f"on the card in {time.perf_counter() - t:.1f} s", flush=True)
        patches = 0
        if cfg.family == "vlm":
            patches = vlm_patches(cfg, prompt)
            engine = VlmServe(cfg, model, prompt + new, torch.randn(
                (batch, patches, cfg.d_model), generator=gen, device=dev))
        else:
            engine = ServeEngine(cfg, model, cache_len=prompt + new)
        prompts = serve_prompts(cfg, batch, prompt, patches,
                                np.random.default_rng(seed))
        want_pre, want_dec = serve_launches(cfg, "auto", prompt)
        # f32 weights: the simt route at every head dim
        route = route_for(torch.float32, cfg.resolved_head_dim)
        want_routes = ({route: want_pre["flash_attention"]}
                       if want_pre["flash_attention"] else {})
        runs = {}
        for run in ("first", "cached"):
            rec = {"decode": []}
            instrument(torch, engine, rec)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            res = engine.generate(prompts, max_new_tokens=new)
            total = time.perf_counter() - t
            del engine.prefill, engine.decode_step   # the unwrapped methods
            peak = torch.cuda.max_memory_allocated()
            toks = res.tokens
            check(res.steps == new and res.prefill_len == prompt
                  and toks.shape == (batch, new) + prompts.shape[2:],
                  f"{arch}/{run}: {toks.shape} tokens in {res.steps} steps "
                  f"after {res.prefill_len} positions")
            check(int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
                  f"{arch}/{run}: token ids outside [0, {cfg.vocab_size})")
            check(bool(torch.isfinite(
                rec["last_logits"][..., :cfg.vocab_size]).all()),
                f"{arch}/{run}: decode logits are not finite")
            pre = rec["prefill"]
            check(pre == want_pre, f"{arch}/{run}: prefill launches {pre}, "
                  f"derived {want_pre}")
            check(rec["flash_routes"] == want_routes, f"{arch}/{run}: "
                  f"flash launches by route {rec['flash_routes']}, derived "
                  f"{want_routes}")
            dec = rec["decode"]
            check(len(dec) == new and all(c == want_dec for c in dec),
                  f"{arch}/{run}: decode launches {dec}, derived {want_dec} "
                  f"a step")
            decode_s = total - rec["prefill_s"]
            dec_sum = {k: sum(c[k] for c in dec) for k in want_dec}
            r = dict(ttft_s=rec["prefill_s"], total_s=total,
                     decode_ms_per_step=decode_s / len(dec) * 1e3,
                     tok_per_s=batch * res.steps / total,
                     decode_tok_per_s=batch * len(dec) / decode_s,
                     peak_gib=peak / 2**30, prefill_launches=pre,
                     decode_launches=dec_sum,
                     flash_routes=rec["flash_routes"],
                     launches={k: pre[k] + dec_sum[k] for k in pre})
            runs[run] = r
            shown = {k: (v, dec_sum[k]) for k, v in pre.items()
                     if v or dec_sum[k]}
            print(f"serve {arch} {run:6s} batch={batch} prompt={prompt} "
                  f"new={new}: time to first token {r['ttft_s']:.3f} s, "
                  f"decode {r['decode_ms_per_step']:.2f} ms/step "
                  f"({r['decode_tok_per_s']:.1f} tok/s), overall "
                  f"{r['tok_per_s']:.1f} tok/s, peak device memory "
                  f"{r['peak_gib']:.2f} GiB; launches (prefill, decode over "
                  f"{len(dec)} steps): {shown}, flash by route "
                  f"{rec['flash_routes']} (head dim "
                  f"{cfg.resolved_head_dim}), as derived [{smi}]",
                  flush=True)
            print(f"serve {arch} {run} first sequence: "
                  f"{toks[0, :12].tolist()}...", flush=True)
            r["first_tokens"] = toks[:, :SHARD_SERVE[3]].tolist()
        flops = model_flops(cfg, "prefill", batch, prompt)
        for run, r in runs.items():
            r["model_flops_share"] = flops / r["ttft_s"] / f32_peak
        print(f"serve {arch} model FLOPs a prefill {flops / 1e12:.1f} T "
              f"(2 x {cfg.active_param_count() / 1e9:.3f} B active "
              f"parameters x {batch} x {prompt} positions): first / "
              f"cached {runs['first']['model_flops_share']:.1%} / "
              f"{runs['cached']['model_flops_share']:.1%} of the f32 peak "
              f"{f32_peak / 1e12:.0f} TFLOP/s [{smi}]", flush=True)
        results[arch] = runs
        moe_ms = profile_serve(torch, engine, prompts, arch, offset=patches)
        if cfg.moe:
            runs["first"]["moe_profile_ms"] = moe_ms
        del engine, model
        torch.cuda.empty_cache()
    return results


def serve_bf16_phase(torch, smi, seed=0, arch="qwen3-8b", batch=4,
                     prompt=4096):
    """qwen3-8b prefill at full width with bfloat16 weights (the JAX
    package's ``init_params`` default) through ``ServeEngine``, twice:
    finite logits, first tokens inside the vocab, one flash-attention
    launch per layer, every one on the bf16 tensor-core (wgmma) route;
    returns each run's time to first token."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention_cuda
    from repro_torch.models import transformer
    from repro_torch.serve import ServeEngine
    dev = torch.device("cuda")
    cfg = get_config(arch)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = transformer.init_params(cfg, gen, torch.bfloat16, dev)
    engine = ServeEngine(cfg, model, cache_len=prompt + 1)
    tokens = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, prompt)), dtype=torch.long, device=dev)
    runs = {}
    for run in ("first", "cached"):
        rec = {"decode": []}
        instrument(torch, engine, rec)
        wgmma = flash_attention_cuda.route_launches["wgmma"]
        logits, caches = engine.prefill(tokens)
        wgmma = flash_attention_cuda.route_launches["wgmma"] - wgmma
        del engine.prefill, engine.decode_step   # the unwrapped methods
        first = torch.argmax(logits, dim=-1)
        check(int(first.min()) >= 0 and int(first.max()) < cfg.vocab_size,
              f"{arch} bf16/{run}: first tokens outside the vocab")
        n = rec["prefill"]["flash_attention"]
        check(n == cfg.num_layers and wgmma == n, f"{arch} bf16/{run}: "
              f"{n} flash launches ({wgmma} on the wgmma route), want "
              f"{cfg.num_layers}")
        runs[run] = dict(ttft_s=rec["prefill_s"], flash_launches=n,
                         wgmma_launches=wgmma)
        print(f"serve {arch} bf16 {run:6s} batch={batch} prompt={prompt}: "
              f"time to first token {rec['prefill_s']:.3f} s; flash "
              f"launches {n}, all wgmma; first tokens {first.tolist()} "
              f"[{smi}]", flush=True)
        del logits, caches
    del engine, model
    torch.cuda.empty_cache()
    return runs


def serve_parity_phase(torch, devices=("cuda", "cpu"), new=8):
    """The SMOKE configs with the same weights on ``devices``: the card
    runs the kernels (``PARITY_CASES``: forced, or reached past 2,048
    keys) at a prompt longer than the flash tile (64) and the smoke chunk
    (32), with launches as derived; the CPU runs the plain versions.
    Prefill logits within 1e-3, greedy tokens equal.  A vlm's prompt is
    ``SMOKE_PATCHES`` patch embeddings and the text after them."""
    import copy
    import dataclasses
    from repro_torch.models import transformer
    for arch, _, _, _ in SERVE_CASES + VLM_CASES:
        cfg = dataclasses.replace(serve_config(arch, smoke=True),
                                  **PARITY_WIDEN.get(arch, {}))
        impl, prompt = PARITY_CASES[arch]
        card = serve_launches(cfg, impl, prompt)[0]
        base = transformer.init_params(cfg, torch.Generator().manual_seed(3),
                                       torch.float32, "cpu")
        rng = np.random.default_rng(3)
        n_patch = SMOKE_PATCHES if cfg.family == "vlm" else 0
        prompts = serve_prompts(cfg, 2, prompt, n_patch, rng)
        patches = (torch.from_numpy(rng.standard_normal(
            (2, n_patch, cfg.d_model)).astype(np.float32)) if n_patch
            else None)
        logits, tokens = {}, {}
        for device in devices:
            model = copy.deepcopy(base).to(device)
            reset_counts()
            lg, caches = transformer.prefill(
                model, torch.as_tensor(prompts, dtype=torch.long,
                                       device=device),
                prompt + new, impl,
                None if patches is None else patches.to(device))
            counts = launch_counts()
            want = card if device != "cpu" else dict.fromkeys(card, 0)
            check(counts == want, f"parity {arch} {device}: {counts} "
                  f"launches, derived {want}")
            logits[device] = lg.cpu()
            # greedy decoding after the forced-kernel prefill, as
            # ServeEngine.generate does after its own
            out = []
            for step in range(new):
                tok = torch.argmax(lg, dim=-1)
                out.append(tok)
                pos = torch.full((tok.shape[0],), prompt + step,
                                 dtype=torch.int32, device=device)
                lg = transformer.decode_step(model, caches, tok[:, None],
                                             pos)
            tokens[device] = torch.stack(out, dim=1).cpu().numpy()
        err = float((logits[devices[0]] - logits[devices[-1]]).abs().max())
        check(err <= 1e-3, f"parity {arch}: prefill logits differ by {err}")
        check(np.array_equal(tokens[devices[0]], tokens[devices[-1]]),
              f"parity {arch}: greedy tokens differ")
        print(f"serve parity {arch} smoke (head dim "
              f"{cfg.resolved_head_dim}), prompt {prompt}, impl {impl}: "
              f"card == cpu (prefill logits max |err| {err:.2e}, {new} "
              f"greedy tokens equal; card launches {card})", flush=True)


#: the shuffle-dispatch phase: one olmoe-1b-7b MoE layer at full width on
#: x (batch, seq, d_model) over stacked ranks, at the capacity factor of
#: ``tests/md_scripts/moe_shuffle_parity.py`` (ample: nothing drops)
MOE_SHUFFLE = dict(arch="olmoe-1b-7b", batch=4, seq=4096, ranks=8,
                   capacity_factor=8.0, reps=5)


def moe_shuffle_phase(torch, smi, seed=0):
    """One MoE layer through ``moe_apply_shuffle`` (the dataframe shuffle
    over ``MOE_SHUFFLE["ranks"]`` stacked ranks, ``xla``) and through
    ``moe_apply_grouped``: y within atol 2e-4 / rtol 1e-3 and aux within
    rtol 1e-4 of each other (``moe_shuffle_parity.py``'s tolerances), no
    row dropped (derived from the routing at the reference's capacities),
    radix launches as derived (2 shuffles + 1 local group; 1 grouped),
    both timed (CUDA events, median of ``reps``), peak memory."""
    import dataclasses
    from repro_torch.models import moe
    from repro_torch.models.layers import ShardingRules
    o = MOE_SHUFFLE
    dev = torch.device("cuda")
    base = serve_config(o["arch"])
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=o["capacity_factor"], communicator="xla"))
    m, b, s, ms = cfg.moe, o["batch"], o["seq"], o["ranks"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = moe.moe_init(gen, cfg, torch.float32, dev)
    x = torch.randn(b, s, cfg.d_model, generator=gen, device=dev)
    # the reference's capacities (repro/models/moe.py:242-260): a rank's
    # rows t * k, its send bucket, its receive capacity and each local
    # expert's; the grouped dispatch's per-row expert capacity
    e, k = m.num_experts, m.top_k
    e_loc, tk = e // ms, b * s // ms * m.top_k
    cap_send = max(8, -(-int(m.capacity_factor * tk) // (8 * ms)) * 8)
    rcap = ms * cap_send
    cap2 = min(max(8, -(-int(rcap * 2) // (8 * e_loc)) * 8),
               -(-rcap // 8) * 8)
    cap = moe.expert_capacity(cfg, s)
    # drops derived from the routing: rows each rank sends each rank, rows
    # each rank receives, rows each expert gets (all on its owning rank),
    # rows each batch row sends each expert in the grouped dispatch
    topi = moe._route(params, x, cfg)[1]
    flat = topi.reshape(b, ms, s // ms, k).transpose(0, 1).reshape(ms, tk)
    sent = torch.zeros((ms, ms), dtype=torch.int64, device=dev).scatter_add_(
        1, flat // e_loc, torch.ones_like(flat))
    kept = sent.clamp(max=cap_send)
    per_expert = torch.bincount(flat.reshape(-1), minlength=e)
    per_row = torch.zeros((b, e), dtype=torch.int64, device=dev).scatter_add_(
        1, topi.reshape(b, -1), torch.ones_like(topi.reshape(b, -1)))
    drops = {"send": int((sent - kept).sum()),
             "receive": int((kept.sum(0) - rcap).clamp(min=0).sum()),
             "local_expert": int((per_expert - cap2).clamp(min=0).sum()),
             "grouped": int((per_row - cap).clamp(min=0).sum())}
    check(not any(drops.values()), f"moe shuffle: rows dropped {drops} at "
          f"capacities send {cap_send}, receive {rcap}, local expert "
          f"{cap2}, grouped {cap}")
    del topi, flat
    flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device=dev)
    out, res = {}, {}
    for name, fn, radix in (
            ("grouped", lambda: moe.moe_apply_grouped(params, x, cfg), 1),
            ("shuffle", lambda: moe.moe_apply_shuffle(
                params, x, cfg, ShardingRules(model="model", model_size=ms)),
             3)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        y, aux = fn()
        torch.cuda.synchronize()
        counts = launch_counts()
        want = {"radix_partition": radix, "segmented_sum": 0,
                "flash_attention": 0, "ssd_scan": 0}
        check(counts == want, f"moe {name}: launches {counts}, derived "
              f"{want}")
        check(tuple(y.shape) == (b, s, cfg.d_model)
              and bool(torch.isfinite(y).all()), f"moe {name}: y "
              f"{tuple(y.shape)} not finite or misshapen")
        peak = torch.cuda.max_memory_allocated() / 2**30
        res[name] = (y, float(aux))
        times = time_cuda_samples(torch, fn, o["reps"], flush)
        out[name] = dict(ms=float(np.median(times)), samples_ms=times,
                         peak_gib=peak, radix_launches=counts[
                             "radix_partition"], aux=float(aux))
    (y_g, aux_g), (y_s, aux_s) = res["grouped"], res["shuffle"]
    diff = (y_s - y_g).abs()
    err = float(diff.max())
    check(bool((diff <= 2e-4 + 1e-3 * y_g.abs()).all()), f"moe shuffle != "
          f"grouped: max |err| {err}")
    check(abs(aux_s - aux_g) <= 1e-4 * abs(aux_g), f"moe shuffle aux "
          f"{aux_s} != grouped {aux_g}")
    rec = dict(shape=[b, s, cfg.d_model], experts=e, top_k=k,
               d_ff_expert=m.d_ff_expert, ranks=ms,
               capacity_factor=m.capacity_factor,
               capacities={"send": cap_send, "receive": rcap,
                           "local_expert": cap2, "grouped": cap},
               drops=drops, max_abs_err=err, **out)
    print(f"moe shuffle dispatch: olmoe layer (d {cfg.d_model}, {e} experts "
          f"of {m.d_ff_expert}, top-{k}) on x {rec['shape']} over {ms} "
          f"stacked ranks (xla), capacity factor {m.capacity_factor}: "
          f"shuffle {out['shuffle']['ms']:.2f} ms (peak "
          f"{out['shuffle']['peak_gib']:.2f} GiB, 3 radix launches), "
          f"grouped {out['grouped']['ms']:.2f} ms (peak "
          f"{out['grouped']['peak_gib']:.2f} GiB, 1 radix launch); y max "
          f"|err| {err:.2e}, aux {aux_s:.6f} vs {aux_g:.6f}; 0 rows dropped "
          f"[{smi}]", flush=True)
    del params, x, res, y_g, y_s, flush
    torch.cuda.empty_cache()
    return rec


#: the query-serving phase: rank slots in the pool, gangs, queries a sweep
SERVE_SLOTS, SERVE_GANGS, SERVE_QUERIES = 8, 4, 24
#: the faulted-serving plan of ``tests/md_scripts/serving_stress.py``
SERVE_FAULTS = "stage:launch@0x1=raise;a2a:chunk@1x1=raise"


def serving_oracle(name, ld, rd):
    """What query ``name`` must return, from numpy on the host: the
    groupbys' keys and float64 sums (exact: integer payloads) rounded to
    float32, the filter's rows in key order."""
    if name == "filter":
        m = ld["v0"] > 64
        order = np.lexsort((ld["v0"][m], ld["k"][m]))
        return {"k": ld["k"][m][order], "v0": ld["v0"][m][order]}
    nk = int(max(ld["k"].max(), rd["k"].max())) + 1
    if name == "groupby":
        cnt = np.bincount(ld["k"], minlength=nk)
        sums = np.bincount(ld["k"], weights=ld["v0"].astype(np.float64),
                           minlength=nk)
        keys = np.nonzero(cnt)[0]
        return {"k": keys.astype(np.int32),
                "v0_sum": sums[keys].astype(np.float32),
                "v0_mean": (sums[keys] / cnt[keys]).astype(np.float32)}
    ml, mr = ld["v0"] > 4, rd["w"] < 250
    cnt_l = np.bincount(ld["k"][ml], minlength=nk)
    cnt_r = np.bincount(rd["k"][mr], minlength=nk)
    sum_l = np.bincount(ld["k"][ml], weights=ld["v0"][ml].astype(np.float64),
                        minlength=nk)
    keys = np.nonzero((cnt_l > 0) & (cnt_r > 0))[0]
    # the join keeps the left v0; each left row meets cnt_r partners
    return {"k": keys.astype(np.int32),
            "v0_sum": (sum_l * cnt_r)[keys].astype(np.float32)}


def check_oracle(out, want, label):
    got = dict(out)
    if "v0" in want:        # the sort orders by k only: ties in any order
        order = np.lexsort((got["v0"], got["k"]))
        check(np.array_equal(got["k"], np.sort(got["k"])),
              f"{label}: keys not in order")
        got = {c: a[order] for c, a in got.items()}
    check(sorted(got) == sorted(want), f"{label}: columns {sorted(got)}, "
          f"want {sorted(want)}")
    for c in want:
        check(got[c].dtype == want[c].dtype and np.array_equal(
            got[c], want[c]), f"{label}: column {c} differs from numpy")


def same_dist(torch, got, want):
    """Slot for slot: equal row counts and equal valid rows per rank."""
    if (got.parallelism != want.parallelism
            or sorted(got.columns) != sorted(want.columns)
            or not torch.equal(got.row_counts.cpu(), want.row_counts.cpu())):
        return False
    counts = want.row_counts.tolist()
    return all(torch.equal(got.columns[c][r, :n], want.columns[c][r, :n])
               for c in want.columns for r, n in enumerate(counts))


def serving_launches(pplans, kinds):
    """Radix and segmented-sum launches that queries of ``kinds`` make on
    the card: one radix launch per shuffle of each lowered plan, one
    segmented sum per sum / count / size of every local groupby."""
    return ({"radix_partition": sum(pplans[k].num_shuffles for k in kinds),
             "segmented_sum": sum(segsum_launches_expected(pplans[k], "bsp")
                                  for k in kinds)})


def disjoint_overlaps(handles, label):
    """Queries whose [started, finished] intervals overlap never share a
    rank slot; returns the number of overlapping pairs."""
    spans = [(h.stats["started_monotonic"], h.stats["finished_monotonic"],
              set(h.stats["devices"])) for h in handles]
    pairs = 0
    for i, (a0, a1, da) in enumerate(spans):
        for b0, b1, db in spans[i + 1:]:
            if a0 < b1 and b0 < a1:
                pairs += 1
                check(not da & db, f"{label}: overlapping queries shared "
                      f"slots {sorted(da & db)}")
    return pairs


def stream_overlap(trace_path):
    """From a Chrome trace of ``torch.profiler``: the time (ms) during
    which any kernel ran (the union of kernel intervals), the kernels'
    summed time (ms), the time (ms) during which kernels of two or more
    streams ran at once, and the number of kernels."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    ks = [(e["ts"], e["ts"] + e["dur"], e["args"].get("stream"))
          for e in events if e.get("cat") == "kernel" and "dur" in e]
    edges = sorted([(t0, 1, st) for t0, _, st in ks]
                   + [(t1, -1, st) for _, t1, st in ks])
    active, busy, both, last = {}, 0.0, 0.0, None
    for t, step, st in edges:
        if last is not None:
            streams = sum(1 for n in active.values() if n > 0)
            busy += (t - last) if streams else 0.0
            both += (t - last) if streams >= 2 else 0.0
        active[st] = active.get(st, 0) + step
        last = t
    total = sum(t1 - t0 for t0, t1, _ in ks)
    return busy / 1e3, total / 1e3, both / 1e3, len(ks)


def query_serving_phase(torch, rows=1 << 24, device=None, fig9_rows=None,
                        smi=None, keep=None):
    """Serving of queries (``benchmarks/bench_pipeline.py:383-472``,
    ``run_serving``): ``SERVE_GANGS`` gangs of 2 stacked ranks carved from
    a pool of ``SERVE_SLOTS`` rank slots on the card, the three query kinds
    over two ``rows``-row tables (integer-valued payloads) ingested once
    and pinned to no env, every partition pre-warmed through one shared
    stage cache; a serial sweep (``max_inflight=1``) and a concurrent one
    (``max_inflight=SERVE_GANGS``) of ``SERVE_QUERIES`` queries each, then
    the concurrent sweep once more under ``torch.profiler``; held:
    results bit-identical to the pre-warm runs and equal to numpy, no
    stage built, launches equal to their derivation, overlapping queries
    on disjoint slots.  Then ``tests/md_scripts/serving_stress.py``'s
    checks at this size (16 submissions from 8 threads, ``collect()`` in
    ``session(scheduler=)`` from 8 threads, a mid-queue cancellation, a
    faulted run recovered), and Fig-9 ``bsp`` at ``fig9_rows`` per table
    (default ``2 * rows``: ``FULL_ROWS`` on the card) over ``P`` ranks per
    communicator (``xla``, ``ring``, ``bruck``), bit-identical to ``xla``.
    Returns the numbers for the JSON line and, on the card, the radix and
    segmented-sum inputs of one query of each kind on a gang
    (``serving_kernel_inputs``).  ``keep`` (a dict) gets what the
    process-group phase holds its gangs of processes to: each kind's
    per-rank digests on a gang, its derived launches, the sweeps'
    numbers."""
    import repro_torch.df as rdf
    from repro_torch.core import CylonEnv, DevicePool, DistTable
    from repro_torch.kernels import radix_partition_cuda
    from repro_torch.launch.fig9 import serving_queries
    from repro_torch.planner import compile_plan
    from repro_torch.serve import ProgramCache, QueryScheduler
    t_phase = time.perf_counter()
    gang = SERVE_SLOTS // SERVE_GANGS
    pool = DevicePool(slots=SERVE_SLOTS, device=device)
    on_card = pool.device.type == "cuda"
    card = smi if smi is not None else "not a card"
    ld = make_table_data(rows, 0, exact_values=True)
    rd = make_table_data(rows, 1, exact_values=True)
    rd["w"] = rd.pop("v0")
    left = rdf.from_table(DistTable.from_numpy(ld, gang, device=pool.device),
                          name="l")
    right = rdf.from_table(DistTable.from_numpy(rd, gang,
                                                device=pool.device),
                           name="r")
    queries = serving_queries(left, right)
    kinds = sorted(queries)
    pplans = {k: compile_plan(q().plan, q().sources)
              for k, q in queries.items()}
    shared = ProgramCache(registry=False)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # pre-warm every partition; the first is the sequential reference
    refs, lone = {}, {}
    for g in range(SERVE_GANGS):
        env = CylonEnv(devices=pool.devices[g * gang:(g + 1) * gang],
                       program_cache=shared)
        for k in kinds:
            out = queries[k]().collect(env=env)
            if k not in refs:
                refs[k] = out
            else:
                check(same_dist(torch, out, refs[k]), f"serving pre-warm "
                      f"{k} on slots {env.slot_ids} differs from slots "
                      f"(0, 1)")
            del out
    warm = (len(shared), shared.misses)
    # a lone warm query of each kind on the first gang: wall and the
    # peak memory it adds
    env = CylonEnv(devices=pool.devices[:gang], program_cache=shared)
    for k in kinds:
        sync()
        base = torch.cuda.memory_allocated() if on_card else 0
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = queries[k]().collect(env=env)
        env.synchronize()
        lone[k] = {"wall_s": time.perf_counter() - t, "peak_gib": (
            (torch.cuda.max_memory_allocated() - base) / 2**30
            if on_card else None)}
        check(same_dist(torch, out, refs[k]) and env.cache_misses == 0,
              f"serving lone {k}: differs or built a stage")
        del out
    for k in kinds:
        check_oracle(refs[k].to_numpy(), serving_oracle(k, ld, rd),
                     f"serving {k}")
    if keep is not None:
        keep["serving"] = {
            "rows": rows, "queries": SERVE_QUERIES,
            "digests": {k: result_digests(refs[k]) for k in kinds},
            "launches": {k: serving_launches(pplans, [k]) for k in kinds}}
    print(f"query serving: {SERVE_GANGS} gangs of {gang} stacked ranks from "
          f"{SERVE_SLOTS} slots on {pool.device}, 2 x {rows} rows, "
          f"{warm[0]} stages after the pre-warm ({warm[0] // SERVE_GANGS} "
          f"per partition); each kind bit-identical on every partition and "
          f"equal to numpy; lone warm query "
          + ", ".join(f"{k} {lone[k]['wall_s'] * 1e3:.2f} ms" for k in kinds)
          + f"; set-up {time.perf_counter() - t_phase:.1f} s", flush=True)

    def sweep(inflight, profiled=False):
        sched = QueryScheduler(pool=pool, gang_size=gang,
                               max_inflight=inflight,
                               max_queue=SERVE_QUERIES, program_cache=shared,
                               name=f"serve-x{inflight}")
        sync()
        reset_counts()
        routes0 = dict(radix_partition_cuda.route_launches)
        base = torch.cuda.memory_allocated() if on_card else 0
        if on_card:
            torch.cuda.reset_peak_memory_stats()
            retries0 = torch.cuda.memory_stats()["num_alloc_retries"]
        names = [kinds[i % len(kinds)] for i in range(SERVE_QUERIES)]
        t0 = time.perf_counter()
        handles = [sched.submit(queries[n](), label=f"x{inflight}-{i}")
                   for i, n in enumerate(names)]
        results = [h.result(timeout=600) for h in handles]
        wall = time.perf_counter() - t0
        sched.close()
        sync()
        rec = {"inflight": inflight, "wall_s": wall,
               "queries_per_s": SERVE_QUERIES / wall}
        lat = sorted(h.stats["finished_monotonic"]
                     - h.stats["submitted_monotonic"] for h in handles)
        # with 24 latencies a p99 is the largest: report it as such
        rec["p50_s"], rec["max_s"] = lat[len(lat) // 2], lat[-1]
        rec["wall_s_by_kind"] = {k: float(np.median(
            [h.stats["wall_s"] for h, n in zip(handles, names) if n == k]))
            for k in kinds}
        if on_card:
            rec["peak_allocated_gib"] = torch.cuda.max_memory_allocated() / 2**30
            rec["peak_reserved_gib"] = torch.cuda.max_memory_reserved() / 2**30
            rec["peak_over_base_gib"] = (torch.cuda.max_memory_allocated()
                                         - base) / 2**30
            # allocations that had to free the cached blocks and retry
            rec["alloc_retries"] = (torch.cuda.memory_stats()
                                    ["num_alloc_retries"] - retries0)
        counts = launch_counts()
        routes = {r: radix_partition_cuda.route_launches[r] - routes0[r]
                  for r in routes0}
        label = f"serving sweep x{inflight}" + (" profiled" if profiled
                                                else "")
        check(all(h.stats["cache_misses"] == 0 for h in handles),
              f"{label}: a warm handle built a stage")
        check((len(shared), shared.misses) == warm, f"{label}: the shared "
              f"cache grew")
        for h, n, out in zip(handles, names, results):
            check(same_dist(torch, out, refs[n]), f"{label}: {h.label} "
                  f"({n}) differs from its sequential run")
        want = serving_launches(pplans, names) if on_card else {
            "radix_partition": 0, "segmented_sum": 0}
        for k, n in want.items():
            check(counts[k] == n, f"{label}: {k} launched {counts[k]} "
                  f"times, want {n}")
        if on_card:
            check(routes == {"onepass": want["radix_partition"],
                             "threepass": 0}, f"{label}: radix routes "
                  f"{routes}")
        rec["launches"] = {k: counts[k] for k in want}
        rec["concurrent_pairs"] = disjoint_overlaps(handles, label)
        del results, handles
        return rec

    serial = sweep(1)
    concurrent = sweep(SERVE_GANGS)
    speedup = serial["wall_s"] / concurrent["wall_s"]
    if keep is not None:
        keep["serving"]["stacked"] = {"serial": serial,
                                      "concurrent": concurrent,
                                      "speedup": speedup}
    for tag, r in (("serial", serial), ("concurrent", concurrent)):
        mem = (f"peak allocated {r['peak_allocated_gib']:.2f} GiB "
               f"(+{r['peak_over_base_gib']:.2f} over the tables and "
               f"references), reserved {r['peak_reserved_gib']:.2f} GiB, "
               f"{r['alloc_retries']} allocation retries"
               if on_card else "peak memory not measured")
        print(f"serving {tag:10s} x{r['inflight']}: {SERVE_QUERIES} queries "
              f"in {r['wall_s']:.4f} s, {r['queries_per_s']:.3f} queries/s, "
              f"latency p50 {r['p50_s'] * 1e3:.2f} ms, max (the p99 of "
              f"{SERVE_QUERIES}) {r['max_s'] * 1e3:.2f} ms, gang wall by "
              f"kind "
              + ", ".join(f"{k} {v * 1e3:.2f} ms"
                          for k, v in r["wall_s_by_kind"].items())
              + f"; {mem}; {r['concurrent_pairs']} overlapping pairs, "
              f"launches {r['launches']} (derived, all onepass); {card}",
              flush=True)
    print(f"serving speedup concurrent/serial {speedup:.4f}x; lone warm "
          f"query peak "
          + ", ".join(f"{k} +{v['peak_gib']:.2f} GiB" if on_card else
                      f"{k} not measured" for k, v in lone.items())
          + f"; {card}", flush=True)
    profile = {}
    for tag, inflight in (("serial", 1), ("concurrent", SERVE_GANGS)):
        if not on_card:
            break
        profile[tag] = profiled_sweep(torch, lambda: sweep(inflight, True))
        p = profile[tag]
        print(f"serving {tag} sweep under torch.profiler: wall "
              f"{p['wall_ms']:.1f} ms, device busy {p['busy_ms']:.1f} ms "
              f"({100 * p['busy_share']:.1f}%, idle "
              f"{100 - 100 * p['busy_share']:.1f}%), kernel time "
              f"{p['kernel_ms']:.1f} ms over {p['kernels']} kernels, "
              f"kernels of two or more gangs' streams at once "
              f"{p['two_streams_ms']:.1f} ms, {p['alloc_retries']} "
              f"allocation retries; {card}", flush=True)
    if on_card:
        check(profile["concurrent"]["two_streams_ms"] > 0, "no two gangs' "
              "kernels ran at once in the concurrent sweep")

    stress = serving_stress(torch, pool, shared, queries, refs, gang, kinds,
                            warm)
    comms = communicator_fig9(torch, fig9_rows or 2 * rows, device)
    # recorded last, so that the copies take no memory from the sweeps
    recorded = serving_kernel_inputs(env, queries, kinds, pplans)
    print(f"phase query serving took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {"rows": rows, "slots": SERVE_SLOTS, "gangs": SERVE_GANGS,
            "gang_size": gang, "queries": SERVE_QUERIES,
            "serial": serial, "concurrent": concurrent,
            "speedup": speedup, "lone": lone, "profile": profile,
            "stress": stress, "communicators": comms}, recorded


def serving_kernel_inputs(env, queries, kinds, pplans):
    """The radix and segmented-sum kernels' inputs as one query of each
    kind hands them over on gang ``env``, the first call at each shape:
    ([(case, dest, nb)], [(case, ids, values, S)]) for ``radix_phase``
    and ``segsum_phase``.  Each kind's calls are held to the launches
    derived from its lowered plan."""
    dests, sums = {}, {}
    for k in kinds:
        calls = {"radix_partition": 0, "segmented_sum": 0}

        def note_radix(dest, nb, k=k, calls=calls):
            calls["radix_partition"] += 1
            seen = dests.setdefault((dest.shape[1], nb),
                                    ([], dest.clone(), nb))
            if k not in seen[0]:
                seen[0].append(k)

        def note_sum(ids, vals, s, k=k, calls=calls, sorted_ids=False):
            check(sorted_ids, f"serving {k}: a groupby sum not on the "
                  f"sorted route")
            calls["segmented_sum"] += 1
            seen = sums.setdefault((ids.shape[1], s, vals.dtype),
                                   ([], ids.clone(), vals.clone(), s))
            if k not in seen[0]:
                seen[0].append(k)
        recording(env, lambda k=k: queries[k]().collect(env=env), [
            ("repro_torch.dataframe.shuffle", "radix_partition", note_radix),
            ("repro_torch.dataframe.ops_local", "segmented_sum", note_sum)])
        want = serving_launches(pplans, [k])
        check(calls == want, f"serving {k}: kernel calls {calls}, want "
              f"{want}")
    return ([(f"serve:n={n} ({'/'.join(ks)})", dest, nb)
             for (n, _), (ks, dest, nb) in dests.items()],
            [(f"serve:n={i.shape[1]},S={s},{str(v.dtype).split('.')[-1]} "
              f"({'/'.join(ks)})", i, v, s)
             for ks, i, v, s in sums.values()])


def profiled_sweep(torch, run):
    """``run()`` (a sweep) under ``torch.profiler``: wall, the device's
    busy time and share, summed kernel time, the time kernels of two or
    more streams ran at once."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as d:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            rec = run()
            wall_ms = (time.perf_counter() - t) * 1e3
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        busy, total, both, nk = stream_overlap(path)
    return {"wall_ms": wall_ms, "busy_ms": busy, "busy_share": busy / wall_ms,
            "kernel_ms": total, "two_streams_ms": both, "kernels": nk,
            "queries_per_s": rec["queries_per_s"],
            "alloc_retries": rec.get("alloc_retries")}


def serving_stress(torch, pool, shared, queries, refs, gang, kinds, warm):
    """``tests/md_scripts/serving_stress.py``'s checks on the phase's
    pool, cache and frames."""
    import threading
    import repro_torch.df as rdf
    from repro_torch.core import CylonEnv
    from repro_torch.faults import QueryCancelled, RetryPolicy
    from repro_torch.serve import QueryScheduler
    t0 = time.perf_counter()
    sched = QueryScheduler(pool=pool, gang_size=gang,
                           max_inflight=SERVE_GANGS, max_queue=64,
                           program_cache=shared, name="stress")
    handles, errors = [None] * 16, []
    barrier = threading.Barrier(8)

    def submitter(t):
        try:
            barrier.wait()
            for j in (2 * t, 2 * t + 1):
                n = kinds[j % 3]
                handles[j] = (n, sched.submit(queries[n](),
                                              label=f"storm-{j}",
                                              timeout=300.0))
        except Exception as e:
            errors.append(e)
    threads = [threading.Thread(target=submitter, args=(t,))
               for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    check(not errors, f"stress submitters failed: {errors}")
    for n, h in handles:
        check(same_dist(torch, h.result(timeout=600), refs[n]),
              f"stress {h.label} ({n}) differs from its sequential run")
        check(h.stats["cache_misses"] == 0, f"stress {h.label} built a "
              f"stage")
    pairs = disjoint_overlaps([h for _, h in handles], "stress storm")
    check(pairs > 0, "stress storm never ran two queries at once")
    check((len(shared), shared.misses) == warm, "stress storm built stages")
    del handles

    routed_errors = []

    def routed(t):
        try:
            n = kinds[t % 3]
            with rdf.session(scheduler=sched):
                out = queries[n]().collect()
            check(same_dist(torch, out, refs[n]), f"routed {n} differs")
        except Exception as e:
            routed_errors.append(e)
    threads = [threading.Thread(target=routed, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    check(not routed_errors, f"session routing failed: {routed_errors}")
    check((len(shared), shared.misses) == warm, "session routing built "
          "stages")

    class Gated:
        def __init__(self, inner):
            self.inner = inner
            self.started = threading.Event()
            self.gate = threading.Event()

        def collect(self, **kw):
            self.started.set()
            check(self.gate.wait(300), "gate never opened")
            return self.inner.collect(**kw)

    narrow = QueryScheduler(pool=pool, gang_size=gang, max_inflight=1,
                            max_queue=8, program_cache=shared,
                            name="narrow")
    gated = Gated(queries["groupby"]())
    running = narrow.submit(gated)
    check(gated.started.wait(120), "the narrow scheduler took no query")
    queued = [narrow.submit(queries[kinds[i % 3]]()) for i in range(3)]
    check(queued[1].cancel("mid-queue cancellation"), "cancel refused")
    try:
        queued[1].result(timeout=5)
        check(False, "a cancelled query returned a result")
    except QueryCancelled:
        pass
    gated.gate.set()
    check(same_dist(torch, running.result(timeout=600), refs["groupby"]),
          "the query in flight during a cancellation differs")
    for i in (0, 2):
        check(same_dist(torch, queued[i].result(timeout=600),
                        refs[kinds[i % 3]]), "a survivor differs")
    narrow.close()

    env0 = CylonEnv(devices=pool.devices[:gang], program_cache=shared)
    fault_ref = queries["join"]().collect(env=env0, mode="bsp_staged",
                                          a2a_chunks=2, faults=False)
    check(same_dist(torch, fault_ref, refs["join"]), "bsp_staged join "
          "differs from bsp")
    fkw = dict(mode="bsp_staged", a2a_chunks=2, collect_stats=True,
               faults=SERVE_FAULTS,
               retries=RetryPolicy(retries=6, backoff_s=0.001))
    fh = [sched.submit(queries["join"](), label=f"faulted-{i}", **fkw)
          for i in range(4)]
    fired = 0
    for h in fh:
        out, st = h.result(timeout=600)
        check(same_dist(torch, out, fault_ref) and st.rows_dropped == 0,
              f"{h.label} did not recover bit-identically")
        fired += st.faults_injected
    check(fired > 0, "the fault plan never fired under serving")
    sched.close()
    check(pool.available == pool.size, "leaked slot leases")
    wall = time.perf_counter() - t0
    print(f"serving stress: 16 submissions from 8 threads ({pairs} "
          f"overlapping pairs, disjoint slots, 0 stages built), 8 threads "
          f"through session(scheduler=), a mid-queue cancellation, {fired} "
          f"faults recovered over 4 queries; all bit-identical; "
          f"{wall:.1f} s", flush=True)
    return {"storm_pairs": pairs, "faults_fired": fired, "wall_s": wall}


def communicator_fig9(torch, rows, device):
    """Fig-9 ``bsp`` at ``rows`` per table over ``P`` stacked ranks per
    communicator: bit-identical to ``xla``, stage keys distinct per
    communicator; each run's wall and its data all-to-alls' device time
    (CUDA events around each ``all_to_all_chunked`` call on the stage's
    stream)."""
    from repro_torch.core import (CylonEnv, DistTable, Plan, execute,
                                  resolve_device)
    ld, rd = make_table_data(rows, 0), make_table_data(rows, 1)
    cap = capacity_for(rows, P)
    tables = {"l": DistTable.from_numpy(ld, P, capacity=cap, device=device),
              "r": DistTable.from_numpy(rd, P, capacity=cap, device=device)}
    on_card = resolve_device(device).type == "cuda"
    plan = fig9_plan(Plan, cap)
    ref_np = host_reference(ld, rd)
    out, keys, base = {}, {}, None
    for name in ("xla", "ring", "bruck"):
        env = CylonEnv(P, device=device, communicator=name)
        events = []
        inner = env.comm.all_to_all_chunked

        def timed(x, chunks=1, _inner=inner, _events=events):
            if not on_card:
                return _inner(x, chunks=chunks)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            y = _inner(x, chunks=chunks)
            b.record()
            _events.append((a, b))
            return y
        env.comm.all_to_all_chunked = timed
        walls = {}
        for run in ("first", "cached"):
            events.clear()
            env.synchronize()
            t = time.perf_counter()
            res, st = execute(plan, env, tables, mode="bsp",
                              collect_stats=True)
            env.synchronize()
            walls[run] = time.perf_counter() - t
        a2a_ms = sum(a.elapsed_time(b) for a, b in events) if on_card \
            else None
        check(st.cache_misses == 0, f"fig9 {name}: cached run built stages")
        check_fig9(res, st, ref_np, f"fig9 {name}")
        if base is None:
            base = res
        else:
            check(same_dist(torch, res, base), f"fig9 {name}: differs from "
                  f"xla")
        keys[name] = set(env._cache)
        check(all(name in k for k in keys[name]), f"fig9 {name}: a stage "
              f"key without the communicator's name")
        out[name] = {"first_wall_s": walls["first"],
                     "cached_wall_s": walls["cached"],
                     "a2a_calls": len(events), "a2a_ms": a2a_ms}
        print(f"fig9 bsp communicator {name:5s}: 2 x {rows} rows over {P} "
              f"ranks, wall first {walls['first'] * 1e3:.2f} ms cached "
              f"{walls['cached'] * 1e3:.2f} ms, data all-to-all "
              + (f"{a2a_ms:.3f} ms device time over {len(events)} calls"
                 if on_card else "not measured")
              + ("" if name == "xla" else ", bit-identical to xla"),
              flush=True)
        del res
    check(not (keys["xla"] & keys["ring"] or keys["xla"] & keys["bruck"]
               or keys["ring"] & keys["bruck"]),
          "two communicators share a stage key")
    return out


# ---------------------------------------------------------------------- #
# Fig-9 over a process group: one rank per process (ROADMAP item 12)
# ---------------------------------------------------------------------- #
#: rows per table of the ring and Bruck runs and of the NCCL group of one
PG_SMALL_ROWS = 1 << 22
#: seconds a group may take before the phase fails
PG_TIMEOUT_S = 400
#: the share of the card's memory the processes of a group on one card
#: may hold together (the rest: their CUDA contexts and this process)
PG_CARD_SHARE = 0.85


def same_slots(torch, got, want):
    """Whether two stacked results hold the same row counts and the same
    bits in every slot of every column, padding included (compared on
    their device: hashing a 2 x 2**25-row result on the host takes
    seconds)."""
    def raw(t):
        return t.contiguous().view(torch.uint8)
    return (sorted(got.columns) == sorted(want.columns)
            and torch.equal(got.row_counts, want.row_counts)
            and all(torch.equal(raw(got.columns[n]), raw(want.columns[n]))
                    for n in want.columns))


def result_digests(res):
    """sha1 of each rank's row count and of every slot of each column of
    ``res``: equal digests are equal slots."""
    import hashlib
    counts = res.row_counts.cpu().numpy()
    cols = {n: v.cpu().numpy() for n, v in sorted(res.columns.items())}
    return [dict({"__count": int(counts[r])},
                 **{n: hashlib.sha1(np.ascontiguousarray(v[r]).tobytes())
                    .hexdigest() for n, v in cols.items()})
            for r in range(len(counts))]


def stacked_digests(torch, rows, p, device=None):
    """Fig-9 ``bsp`` over ``p`` ranks stacked on the card: each rank's
    digests, held to the host reference first."""
    from repro_torch.core import CylonEnv, DistTable, Plan, execute
    ld, rd = make_table_data(rows, 0), make_table_data(rows, 1)
    cap = capacity_for(rows, p)
    tables = {n: DistTable.from_numpy(d, p, capacity=cap, device=device)
              for n, d in (("l", ld), ("r", rd))}
    res, st = execute(fig9_plan(Plan, cap), CylonEnv(p, device=device),
                      tables, mode="bsp", collect_stats=True)
    check_fig9(res, st, host_reference(ld, rd), f"stacked p={p}")
    out = result_digests(res)
    del res, tables
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def morsel_for(rows, p):
    """8x oversubscription: a rank's share over 8, rounded up to 8."""
    return -(-(-(-rows // p) // 8) // 8) * 8


def spill_digests(spill):
    """``result_digests`` of a host ``SpillTable``: each held rank's row
    count and a sha1 of each column's rows."""
    import hashlib
    out = []
    for j in range(spill.parallelism):
        cols = spill.rank_concat(j)
        out.append(dict({"__count": int(len(next(iter(cols.values()))))},
                        **{n: hashlib.sha1(np.ascontiguousarray(v)
                                           .tobytes()).hexdigest()
                           for n, v in sorted(cols.items())}))
    return out


def digests_of(res):
    return (spill_digests(res) if hasattr(res, "rank_concat")
            else result_digests(res))


def nccl_ooc_reference(torch, rows):
    """Fig-9 out-of-core over one rank stacked on the card at 2 x
    ``rows``, held to the host reference: its digests and derived
    launches, which NCCL at world size 1 is held to."""
    from repro_torch.core import CylonEnv, DistTable, Plan, execute
    from repro_torch.planner import compile_plan
    ld, rd = make_exact_data(rows, 0, "v0"), make_exact_data(rows, 1, "w")
    cap, morsel = capacity_for(rows, 1), morsel_for(rows, 1)
    tables = {"l": ld, "r": DistTable.from_numpy(rd, 1, capacity=cap)}
    plan = fig9_plan(Plan, cap)
    res, st = execute(plan, CylonEnv(1), tables, mode="bsp",
                      collect_stats=True, morsel_rows=morsel,
                      capacity_factor=4.0)
    ref = host_reference(ld, rd)
    check_fig9(res, st, ref, "stacked out-of-core over one rank")
    want = ooc_launches_expected(compile_plan(plan, tables), ld, ref[1],
                                 res.rank_rows(0), morsel, 1)[0]
    out = (spill_digests(res), want)
    del res, tables
    torch.cuda.empty_cache()
    return out


def _pg_ooc_job(torch, envs, job, device, walls):
    """One out-of-core, from-files or faulted Fig-9 run of a group
    process (``job``: label, rows, morsel, files, faults, a timeout from
    an earlier run's wall); its report."""
    import repro_torch.df as rdf
    from repro_torch.core import CylonEnv, Plan, execute
    from repro_torch.faults import QueryTimeout, random_plan
    import torch.distributed as dist
    rows = job["rows"]
    key = (rows, bool(job.get("files")))
    if key not in envs:
        env = CylonEnv(process_group=dist.group.WORLD, device=device)
        cap = capacity_for(rows, env.parallelism)
        warm_s = 0.0
        if job.get("files") and job["files"][1] == "parquet":
            # pyarrow's to_numpy imports pandas at its first call: paid
            # here, before the timed read, as the stacked read's process
            # paid it before its own
            import pyarrow as pa
            from repro_torch.io.ingest import arrow_batch_columns
            t = time.perf_counter()
            arrow_batch_columns(pa.record_batch({"x": [1]}))
            warm_s = time.perf_counter() - t
        host0 = env.comm.stats["host_s"]
        t = time.perf_counter()
        if job.get("files"):
            paths, lane = job["files"]
            reader = rdf.read_parquet if lane == "parquet" else rdf.read_csv
            frames = {s: reader(paths[s], env=env, dict_cache=None, name=s)
                      for s in "lr"}
            q = fig9_sum_frontend(frames["l"], frames["r"], cap)
            run = q.collect
        else:
            ld = make_exact_data(rows, 0, "v0")
            tables = {"l": ld, "r": env.from_numpy(
                make_exact_data(rows, 1, "w"), capacity=cap)}
            plan = fig9_plan(Plan, cap)

            def run(**kw):
                return execute(plan, env, tables, mode="bsp", **kw)
        envs[key] = (env, run, time.perf_counter() - t,
                     env.comm.stats["host_s"] - host0, warm_s)
    env, run, read_s, read_host_s, warm_s = envs[key]
    on_card = env.device.type == "cuda"
    kw = dict(collect_stats=True)
    if job.get("morsel"):
        kw.update(morsel_rows=job["morsel"], capacity_factor=4.0)
    faults = job.get("faults")
    if isinstance(faults, int):
        faults = random_plan(faults, max_occurrence=2, sites=OOC_SITES)
    if faults is not None:
        kw["faults"] = faults
    if job.get("timeout_s"):
        kw["timeout"] = job["timeout_s"]
    if job.get("timeout_after"):
        # twice the group's slowest clean run, plus a second
        ms = int(env.comm.gather_ints(
            [int(walls[job["timeout_after"]] * 1e3)]).max())
        kw["timeout"] = 2 * ms / 1e3 + 1.0
    stats0 = dict(env.comm.stats)
    env.synchronize()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t = time.perf_counter()
    raised = None
    try:
        res, st = run(**kw)
    except QueryTimeout:
        raised, res, st = "QueryTimeout", None, None
    env.synchronize()
    wall = time.perf_counter() - t
    walls[job["label"]] = wall
    rep = {"wall_s": wall, "read_s": read_s, "read_host_s": read_host_s,
           "warm_s": warm_s,
           "staged_s": env.comm.stats["staged_s"] - stats0["staged_s"],
           "host_s": env.comm.stats["host_s"] - stats0["host_s"],
           "host_calls": env.comm.stats["host_calls"]
           - stats0["host_calls"],
           "peak_bytes": torch.cuda.max_memory_allocated() if on_card
           else None, "launches": launch_counts(), "raised": raised,
           "timeout_s": kw.get("timeout")}
    if res is not None:
        rep.update(digests=digests_of(res)[0], rows_dropped=st.rows_dropped,
                   rows_shuffled=st.rows_shuffled, retries=st.retries,
                   faults_injected=st.faults_injected, morsels=st.morsels,
                   h2d_bytes=st.h2d_bytes, d2h_bytes=st.d2h_bytes,
                   rows_read=st.rows_read)
    return rep


#: what a group process is doing: the job's label and the scheduler it
#: serves with, read by its watchdog (``_pg_watchdog``)
_WATCH = {}


def _pg_watchdog(rank, d):
    """Shortly before ``run_group`` gives up on the group, write this
    process's job, its scheduler's last decision and every thread's
    stack to ``d/hang<rank>.txt``, which the failure prints."""
    import faulthandler
    time.sleep(PG_TIMEOUT_S - 30)
    sched = _WATCH.get("sched")
    with open(os.path.join(d, f"hang{rank}.txt"), "w") as f:
        f.write(f"process {rank}: job {_WATCH.get('job')!r}, last decision "
                f"{sched.stats()['last_decision'] if sched else None}\n")
        f.flush()
        faulthandler.dump_traceback(f, all_threads=True)


def _pg_child(rank, world, d, backend, runs, device):
    """One process of a group: Fig-9 through ``execute`` on the one rank
    it holds, for each ``(communicator, mode, rows, label)`` of ``runs``;
    writes its digests, walls, staged seconds and launch counts to
    ``d/report<rank>.json``.  On the CPU no kernel launches."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from datetime import timedelta
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.comm.process_group import barrier_before_teardown
    from repro_torch.core import CylonEnv, Plan, execute
    from repro_torch.kernels import CUDA_KERNELS
    from repro_torch.kernels.build import BUILD_DIR, library_path
    from repro_torch.planner import compile_plan
    # the kernels come from the builds phase 1 made, never from nvcc here
    libs = {k.name: library_path(k.name) for k in CUDA_KERNELS
            if k.name in ("radix_partition", "segmented_sum")
            and device != "cpu"}
    for name, lib in libs.items():
        check(os.path.exists(lib), f"{name}: no build at {lib}")
    logs = {n: os.path.getmtime(os.path.join(BUILD_DIR, f"{n}.log"))
            for n in libs}
    dist.init_process_group(backend, init_method=f"file://{d}/rendezvous",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    report = {}
    on_card = device != "cpu"
    if on_card and world > 1:
        # the processes share one card, and a caching allocator keeps the
        # blocks its process freed: each is held to its share (its
        # allocator frees its cached blocks when it reaches it), so that
        # one process's cache cannot starve the others (the served
        # queries' concurrent sweep ran out of card memory without this)
        torch.cuda.set_per_process_memory_fraction(PG_CARD_SHARE / world,
                                                   torch.device(device))
    import threading
    threading.Thread(target=_pg_watchdog, args=(rank, d), daemon=True).start()
    try:
        data, envs, walls = {}, {}, {}
        for job in runs:
            _WATCH["job"] = job["label"] if isinstance(job, dict) else job[3]
            if isinstance(job, dict):
                run = {"serve": _pg_serve_job,
                       "handoff": _pg_handoff_job}.get(job.get("kind"))
                report[job["label"]] = (
                    run(torch, job, device) if run is not None else
                    _pg_ooc_job(torch, envs, job, device, walls))
                if on_card:
                    torch.cuda.empty_cache()
                continue
            comm_name, mode, rows, label = job
            if rows not in data:
                data[rows] = (make_table_data(rows, 0),
                              make_table_data(rows, 1))
            env = CylonEnv(communicator=comm_name,
                           process_group=dist.group.WORLD, device=device)
            cap = capacity_for(rows, world)
            tables = {n: env.from_numpy(x, capacity=cap)
                      for n, x in zip("lr", data[rows])}
            plan = fig9_plan(Plan, cap)
            pplan = compile_plan(plan, tables)
            staged0 = env.comm.stats["staged_s"]
            env.synchronize()
            reset_counts()
            t = time.perf_counter()
            res, st = execute(plan, env, tables, mode=mode,
                              collect_stats=True)
            env.synchronize()
            wall = time.perf_counter() - t
            counts = launch_counts()
            report[label] = {
                "wall_s": wall,
                "staged_s": env.comm.stats["staged_s"] - staged0,
                "launches": counts,
                "radix_want": (3 if mode != "amt" else 0) * on_card,
                "segsum_want": segsum_launches_expected(pplan, mode)
                * on_card,
                "rows_dropped": st.rows_dropped,
                "rows_shuffled": st.rows_shuffled,
                "digests": result_digests(res)[0]}
            del res, tables
            if on_card:
                torch.cuda.empty_cache()
        del envs
        for n, t in logs.items():
            check(os.path.getmtime(os.path.join(BUILD_DIR, f"{n}.log")) == t,
                  f"{n} was rebuilt in a group process")
        with open(os.path.join(d, f"report{rank}.json"), "w") as f:
            json.dump(report, f)
        barrier_before_teardown(None if device == "cpu" else device)
    finally:
        dist.destroy_process_group()


def run_group(world, backend, runs, device="cuda:0"):
    """Spawn ``world`` processes of a ``backend`` group that meet through
    a ``file://`` rendezvous in a temporary directory; a child's exception
    or the timeout fails the phase.  Returns each rank's report."""
    import shutil
    import tempfile
    import torch.multiprocessing as mp
    d = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    try:
        ctx = mp.start_processes(_pg_child,
                                 args=(world, d, backend, runs, device),
                                 nprocs=world, start_method="spawn",
                                 join=False)
        deadline = time.perf_counter() + PG_TIMEOUT_S
        while not ctx.join(timeout=2):
            if time.perf_counter() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                hung = [os.path.join(d, f"hang{r}.txt") for r in range(world)]
                raise RuntimeError(
                    f"{backend} group of {world}: no end after {PG_TIMEOUT_S}"
                    f" s; each process's job, last decision and stacks:\n"
                    + "\n".join(open(h).read()[-3000:] for h in hung
                                if os.path.exists(h)))
        reports = []
        for r in range(world):
            with open(os.path.join(d, f"report{r}.json")) as f:
                reports.append(json.load(f))
        return reports
    finally:
        shutil.rmtree(d, ignore_errors=True)


def pg_ooc_runs(kept):
    """The group's out-of-core jobs, (reference label, job) in order, at
    the sizes of the stacked runs ``kept`` holds."""
    rows, fault_rows = kept["ooc_rows"], kept["fault_rows"]
    paths = (kept["paths"], kept["lane"])
    m, mf = morsel_for(rows, P), morsel_for(fault_rows, P)
    fault = dict(rows=fault_rows, morsel=mf)
    return [("ooc", dict(label="gloo ooc first", rows=rows, morsel=m)),
            ("ooc", dict(label="gloo ooc cached", rows=rows, morsel=m)),
            ("files in-core", dict(label="gloo parquet in-core",
                                   rows=kept["files_rows"], files=paths)),
            ("files ooc", dict(label="gloo parquet ooc",
                               rows=kept["files_rows"], files=paths,
                               morsel=morsel_for(kept["files_rows"], P))),
            ("faults", dict(fault, label="gloo faults clean")),
            # a deadline far off arms the per-visit agreement alone
            ("faults", dict(fault, label="gloo faults clean under timeout",
                            timeout_s=60.0)),
            ("faults", dict(fault, label="gloo faults spill:append@0=raise",
                            faults="spill:append@0=raise"))] + [
            ("faults", dict(fault, label=f"gloo faults random_plan({seed})",
                            faults=seed)) for seed in (1, 2, 3)] + [
            (None, dict(fault, label="gloo faults hang",
                        faults="morsel:execute@1=hang",
                        timeout_after="gloo faults clean")),
            ("faults", dict(fault, label="gloo faults after the timeout"))]


def process_group_phase(torch, smi, kept, rows=FULL_ROWS,
                        small=PG_SMALL_ROWS, device=None, corpus=None):
    """Fig-9 over a ``torch.distributed`` process group, one rank per
    process: 8 gloo processes on the card at 2 x ``rows`` (``bsp`` first
    and cached, then ``amt``; ``ring`` and ``bruck`` at 2 x ``small``),
    each process's result equal slot for slot to rank r of the stacked
    ``xla`` run, with 3 radix and 1 segmented-sum launches a ``bsp`` run
    per process; then NCCL at world size 1 (NCCL takes one rank per
    device) at 2 x ``small``, equal to the stacked one-rank run.  Every
    collective of the gloo group is staged through pinned host buffers;
    the share of each run's wall spent there is printed.

    In the same processes, the group's out-of-core paths
    (``pg_ooc_runs``), each held by digest to the same run stacked on the
    card, which the out-of-core, ingest and faults phases made and
    ``kept`` holds (their ``keep=``; the files too): Fig-9 streamed 8x
    oversubscribed (first, cached), from 8 Parquet files a side in-core
    and out-of-core, and at the faults phase's out-of-core size clean,
    under a ``raise`` at ``spill:append``, ``random_plan`` seeds 1-3
    (retries equal on every process), a ``hang`` under ``timeout=``
    (``QueryTimeout`` on every process) and clean again; each process's
    radix and segmented-sum launches equal their derivation (a process
    launches once per morsel for its rank where the stacked run launches
    once for all ranks, so the derivation is the stacked run's).  NCCL
    at world size 1 also streams Fig-9 at 2 x ``small``.

    In the same processes again, the multi-application paths: query
    serving over 4 gangs of 2 processes (``_pg_serve_job``: the query
    serving phase's tables, query kinds and sweeps, which ``kept["serving"]``
    holds with its stacked gang's digests), each member equal by digest
    to rank r of the stacked gang, every process seeing the same
    admissions, gangs and outcomes; and the §IV-C hand-off
    (``_pg_handoff_job``): ``corpus`` (default ``TRAIN_CORPUS``)
    preprocessed on a gang of 4 processes and ``put``, ``get`` at every
    process and onto the other gang of 4, the first ``TRAIN_STEPS``
    batches of each, held to the same pipeline stacked on the card
    (``pipeline_reference``).  NCCL at world size 1 serves the three
    kinds on a gang of one at 2 x ``small``, equal to the stacked
    one-rank run.  ``device="cpu"`` rehearses the gloo group on the CPU
    (no NCCL, no launches)."""
    t_phase = time.perf_counter()
    on_card = device != "cpu"
    if on_card:
        torch.cuda.empty_cache()
    want = {rows: stacked_digests(torch, rows, P, device),
            small: stacked_digests(torch, small, P, device)}
    want_one = stacked_digests(torch, small, 1, device) if on_card else None
    refs = {k: kept[k] for k in ("ooc", "files in-core", "files ooc",
                                 "faults")}
    if on_card:
        refs["nccl ooc"] = nccl_ooc_reference(torch, small)
    ooc_runs = pg_ooc_runs(kept)
    serving = kept["serving"]
    corpus = corpus or TRAIN_CORPUS
    pipe_ref = pipeline_reference(torch, smi, device, corpus)
    multi = [dict(kind="serve", label="serve", rows=serving["rows"],
                  gang=PG_SERVE_GANG, queries=serving["queries"],
                  inflight=(1, P // PG_SERVE_GANG),
                  launches=serving["launches"]),
             dict(kind="handoff", label="handoff", corpus=corpus,
                  gang=PG_HANDOFF_GANG, steps=TRAIN_STEPS)]
    runs = [("xla", "bsp", rows, "gloo xla bsp first"),
            ("xla", "bsp", rows, "gloo xla bsp cached"),
            ("xla", "amt", rows, "gloo xla amt"),
            ("ring", "bsp", small, "gloo ring bsp"),
            ("bruck", "bsp", small, "gloo bruck bsp")]
    if on_card:
        import gc
        gc.collect()
        torch.cuda.empty_cache()
        print(f"process group phase: this process holds "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
              f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved "
              f"before the spawn; the card has "
              f"{torch.cuda.mem_get_info()[0] / 2**30:.2f} GiB free",
              flush=True)
    t = time.perf_counter()
    gloo = run_group(P, "gloo", runs + [job for _, job in ooc_runs]
                     + multi, "cuda:0" if on_card else "cpu")
    gloo_s = time.perf_counter() - t
    nccl_runs = [("xla", "bsp", small, "nccl xla bsp")] if on_card else []
    nccl_ooc = [("nccl ooc", dict(label="nccl ooc", rows=small,
                                  morsel=morsel_for(small, 1)))]
    nccl_serve = dict(kind="serve", label="nccl serve", rows=small, gang=1,
                      queries=6, inflight=(1,),
                      launches=serving["launches"])
    t = time.perf_counter()
    nccl = (run_group(1, "nccl", nccl_runs + [j for _, j in nccl_ooc]
                      + [nccl_serve]) if on_card else None)
    nccl_s = time.perf_counter() - t
    out = {"gloo_group_s": gloo_s, "nccl_group_s": nccl_s, "runs": {}}
    check_pg_ooc(out, gloo, ooc_runs, refs, smi)
    check_pg_serving(out, gloo, "serve", serving["digests"],
                     serving.get("stacked"), smi)
    check_pg_handoff(out, gloo, "handoff", pipe_ref, smi)
    if on_card:
        check_pg_ooc(out, nccl, nccl_ooc, refs, smi)
        check_pg_serving(out, nccl, "nccl serve",
                         serving_one_rank(torch, small, device), None, smi)
    for (comm_name, mode, n, label) in runs + nccl_runs:
        reports = nccl if label.startswith("nccl") else gloo
        stacked = want_one if label.startswith("nccl") else want[n]
        walls, shares = [], []
        for r, rep in enumerate(reports):
            got = rep[label]
            check(got["digests"] == stacked[r], f"{label}: rank {r} differs "
                  f"from rank {r} of the stacked run")
            check(got["rows_dropped"] == 0, f"{label}: rows dropped")
            c = got["launches"]
            check(c["radix_partition"] == got["radix_want"]
                  and c["segmented_sum"] == got["segsum_want"],
                  f"{label}: rank {r} launches {c}, want radix "
                  f"{got['radix_want']}, segmented sum {got['segsum_want']}")
            walls.append(got["wall_s"])
            shares.append(got["staged_s"] / max(got["wall_s"], 1e-9))
        out["runs"][label] = {
            "rows": n, "processes": len(reports), "wall_s": max(walls),
            "staged_share": float(np.mean(shares)),
            "launches_per_process": reports[0][label]["launches"],
            "rows_shuffled": reports[0][label]["rows_shuffled"]}
        print(f"process group {label}: 2 x {n} rows over {len(reports)} "
              f"processes, wall {max(walls):.3f} s (per process "
              f"{min(walls):.3f}-{max(walls):.3f} s), host-staged "
              f"collectives {100 * float(np.mean(shares)):.1f}% of it, "
              f"launches a process {reports[0][label]['launches']}, equal "
              f"to the stacked run slot for slot [{smi}]", flush=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"process group phase: gloo group {gloo_s:.1f} s, NCCL group "
          f"{nccl_s:.1f} s, phase {out['phase_s']:.1f} s [{smi}]",
          flush=True)
    return out


def check_pg_ooc(out, reports, jobs, refs, smi):
    """Hold each out-of-core group job of ``jobs`` to its stacked
    reference and record its numbers in ``out["runs"]``."""
    for ref_label, job in jobs:
        label = job["label"]
        got = [rep[label] for rep in reports]
        if ref_label is None:       # the hang: a timeout everywhere
            check(all(g["raised"] == "QueryTimeout" for g in got),
                  f"{label}: raised {[g['raised'] for g in got]}")
        else:
            digests, want = refs[ref_label]
            for r, g in enumerate(got):
                check(g["raised"] is None and g["rows_dropped"] == 0,
                      f"{label}: rank {r} raised {g['raised']} or dropped")
                check(g["digests"] == digests[r], f"{label}: rank {r} "
                      f"differs from rank {r} of the stacked run")
                if "faults" not in job:
                    check(all(g["launches"][k] == n for k, n in
                              want.items()), f"{label}: rank {r} launches "
                          f"{g['launches']}, want {want}")
            retries = {g["retries"] for g in got}
            check(len(retries) == 1, f"{label}: retries {retries} differ "
                  f"between processes")
            if isinstance(job.get("faults"), str):
                check(retries == {1}, f"{label}: retries {retries}")
        walls = [g["wall_s"] for g in got]
        shares = [(g["staged_s"] + g["host_s"]) / max(g["wall_s"], 1e-9)
                  for g in got]
        peaks = [g["peak_bytes"] or 0 for g in got]
        rec = {"rows": job["rows"], "processes": len(got),
               "wall_s": max(walls), "staged_share": float(np.mean(shares)),
               "launches_per_process": got[0]["launches"],
               "peak_bytes_per_process": max(peaks),
               "read_s": max(g["read_s"] for g in got),
               "read_host_s": max(g["read_host_s"] for g in got),
               "warm_s": max(g["warm_s"] for g in got),
               "host_s": max(g["host_s"] for g in got),
               "host_calls": got[0]["host_calls"]}
        for k in ("retries", "faults_injected", "h2d_bytes", "d2h_bytes",
                  "morsels", "rows_shuffled"):
            if k in got[0]:
                rec[k] = got[0][k]
        out["runs"][label] = rec
        print(f"process group {label}: 2 x {job['rows']} rows over "
              f"{len(got)} processes"
              + (f", morsel_rows {job['morsel']}" if job.get("morsel")
                 else "") + f", wall {max(walls):.3f} s (per process "
              f"{min(walls):.3f}-{max(walls):.3f} s), host-staged "
              f"collectives and host exchanges "
              f"{100 * float(np.mean(shares)):.1f}% of it ("
              f"{rec['host_calls']} host collectives, "
              f"{rec['host_s']:.3f} s at most a process), h2d "
              f"{rec.get('h2d_bytes')} B, d2h {rec.get('d2h_bytes')} B "
              f"(the group's), peak {max(peaks) / 2**30:.2f} GiB a "
              f"process, launches a process {got[0]['launches']}, retries "
              f"{rec.get('retries')}, "
              + ("QueryTimeout on every process after "
                 f"{max(walls):.2f} s (deadline "
                 f"{got[0]['timeout_s']:.2f} s)" if ref_label is None
                 else f"equal to the stacked run by digest, reading "
                 f"{rec['read_s']:.2f} s ({rec['read_host_s']:.2f} s of it "
                 f"in host exchanges; first-call imports before it "
                 f"{rec['warm_s']:.2f} s)") + f" [{smi}]", flush=True)


# ---------------------------------------------------------------------- #
# Serving and the §IV-C hand-off over the process group (one spawn)
# ---------------------------------------------------------------------- #
#: the group's serving runs: gangs of 2 processes (the stacked serving
#: phase's gangs of 2 ranks); the hand-off's preprocessing gang
PG_SERVE_GANG = 2
PG_HANDOFF_GANG = 4
#: seconds the group's served hang waits for its deadline
PG_HANG_S = 1.5


def valid_digests(res):
    """sha1 of each held rank's valid rows, column by column, and its row
    count: equal digests are equal rows in equal order (padding aside)."""
    import hashlib
    counts = res.row_counts.cpu().numpy()
    cols = {n: v.cpu().numpy() for n, v in sorted(res.columns.items())}
    return [dict({"__count": int(c)},
                 **{n: hashlib.sha1(np.ascontiguousarray(v[r, :c])
                                    .tobytes()).hexdigest()
                    for n, v in cols.items()})
            for r, c in enumerate(counts)]


def held_rank(res):
    """The rank of its gang a member's result holds."""
    return int(res.comm.rank()[0]) if res.comm is not None else 0


def batch_digests(table, steps):
    """One sha1 of the first ``steps`` batches ``batches_from_table``
    draws from ``table`` (over a gang of processes: a collective)."""
    import hashlib
    from repro_torch.data import batches_from_table
    it = batches_from_table(table, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    h = hashlib.sha1()
    for _ in range(steps):
        b = next(it)
        h.update(b["tokens"].tobytes())
        h.update(b["labels"].tobytes())
    return h.hexdigest()


def pipeline_reference(torch, smi, device=None, corpus=None,
                       gang=PG_HANDOFF_GANG):
    """The §IV-C pipeline stacked on the card as the group runs it: the
    preprocessing on ``gang`` stacked ranks (held to the numpy oracle,
    its radix launches derived from its operators), ``get`` at ``P``
    ranks, and the first ``TRAIN_STEPS`` batches of that table; each
    rank's valid-row digests, the batches' digest, walls and launches."""
    from types import SimpleNamespace
    from repro_torch.core import CylonExecutor, CylonStore
    from repro_torch.data import (CorpusConfig, preprocess, source_weights,
                                  synth_corpus)
    on_card = device != "cpu"
    dev = torch.device("cuda" if on_card else "cpu")
    cfg = CorpusConfig(**(corpus or TRAIN_CORPUS))
    docs = synth_corpus(cfg, gang, device=dev)
    weights = source_weights(cfg.num_sources, gang, device=dev)
    ex, store = CylonExecutor(gang, device=dev), CylonStore()
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    ops, outs = [], []
    sync()
    reset_counts()
    t = time.perf_counter()
    recording(SimpleNamespace(synchronize=sync),
              lambda: outs.append(preprocess(ex, docs, weights,
                                             store=store)),
              [("repro_torch.data.pipeline", op,
                lambda *a, op=op, **kw: ops.append(op))
               for op in RADIX_PER_OPERATOR])
    wall = time.perf_counter() - t
    out, = outs
    counts = launch_counts()
    derived = sum(RADIX_PER_OPERATOR[op] for op in ops) if on_card else 0
    check(counts["radix_partition"] == derived
          and counts["segmented_sum"] == 0, f"pipeline on {gang} stacked "
          f"ranks: launches {counts}, derived {derived} radix")
    raw, wts = docs.to_numpy(), weights.to_numpy()
    ids, wmap = pipeline_oracle(raw, wts)
    check_pipeline_result(out.to_numpy(), raw, ids, wmap,
                          out.row_counts.cpu().numpy(),
                          f"pipeline on {gang} stacked ranks")
    t = time.perf_counter()
    got = store.get("train_corpus", target_parallelism=P)
    handoff = time.perf_counter() - t
    ref = {"out": valid_digests(out), "get_p": valid_digests(got),
           "batches": batch_digests(got, TRAIN_STEPS), "wall_s": wall,
           "handoff_s": handoff, "rows": int(len(ids)),
           "radix_per_member": derived}
    print(f"pipeline reference: {cfg.num_docs} documents on {gang} stacked "
          f"ranks in {wall:.3f} s ({len(ids)} kept, equal to numpy, "
          f"launches {counts}), get at {P} ranks {handoff:.3f} s [{smi}]",
          flush=True)
    del docs, weights, out, got, raw
    if on_card:
        torch.cuda.empty_cache()
    return ref


def serving_one_rank(torch, rows, device=None):
    """The three served query kinds on one stacked rank at 2 x ``rows``
    (what NCCL at world size 1 is held to): each kind's digests."""
    import repro_torch.df as rdf
    from repro_torch.core import CylonEnv, DistTable
    from repro_torch.launch.fig9 import serving_queries
    ld = make_table_data(rows, 0, exact_values=True)
    rd = make_table_data(rows, 1, exact_values=True)
    rd["w"] = rd.pop("v0")
    env = CylonEnv(1, device=device)
    queries = serving_queries(
        rdf.from_table(DistTable.from_numpy(ld, 1, device=env.device),
                       name="l"),
        rdf.from_table(DistTable.from_numpy(rd, 1, device=env.device),
                       name="r"))
    out = {}
    for k, q in queries.items():
        res = q().collect(env=env)
        check_oracle(res.to_numpy(), serving_oracle(k, ld, rd),
                     f"serving {k} on one rank")
        out[k] = result_digests(res)
    return out


def _pg_serve_job(torch, job, device):
    """Query serving over the group's processes (``job``: rows, gang
    size, queries a sweep, the sweeps' ``max_inflight``s, each kind's
    derived launches): every gang pre-warmed at once, a lone run of each
    kind on each gang outside the scheduler (no agreement), the sweeps,
    then a hang, a deadline in the queue, a cancellation from the last
    process and a rejection on a scheduler of one inflight query and two
    queued; this process's report."""
    import torch.distributed as dist
    import repro_torch.df as rdf
    from repro_torch.core import CylonEnv, DevicePool, DistTable
    from repro_torch.launch.fig9 import prewarm, serving_queries
    from repro_torch.serve import (AdmissionRejected, ProgramCache,
                                   QueryScheduler)
    rows, gang, nq = job["rows"], job["gang"], job["queries"]
    on_card = device != "cpu"
    rank, world = dist.get_rank(), dist.get_world_size()
    pool = DevicePool(process_group=dist.group.WORLD, device=device)

    def sync():
        if on_card:
            torch.cuda.synchronize()
    t = time.perf_counter()
    ld = make_table_data(rows, 0, exact_values=True)
    rd = make_table_data(rows, 1, exact_values=True)
    rd["w"] = rd.pop("v0")
    left = rdf.from_table(DistTable.from_numpy(ld, gang, device=pool.device),
                          name="l")
    right = rdf.from_table(DistTable.from_numpy(rd, gang,
                                                device=pool.device),
                           name="r")
    del ld, rd
    queries = serving_queries(left, right)
    kinds = sorted(queries)
    sync()
    rep = {"upload_s": time.perf_counter() - t,
           "input_bytes": torch.cuda.memory_allocated() if on_card else 0,
           "free_bytes": torch.cuda.mem_get_info()[0] if on_card else 0}
    shared = ProgramCache(registry=False)
    t = time.perf_counter()
    warm = prewarm(pool, gang, queries, shared)
    sync()
    rep["warm_s"] = time.perf_counter() - t
    rep["rank"] = held_rank(next(iter(warm.values())))
    rep["warm"] = {k: result_digests(v)[0] for k, v in warm.items()}
    del warm
    # a lone warm query of each kind on the first gang, outside the
    # scheduler (no agreement at the fault sites), the others idle: what
    # the serial sweep's gang walls are held beside
    leases = [pool.reserve(gang) for _ in range(pool.size // gang)]
    lone, comm = {}, None
    for g, lease in enumerate(leases):
        if lease.is_member:
            env = CylonEnv(devices=lease, program_cache=shared)
            comm = env.comm
            rep["gang"] = list(lease.indices)
            for k in kinds if g == 0 else ():
                env.synchronize()
                t = time.perf_counter()
                res = queries[k]().on_gang(env.comm).collect(env=env)
                env.synchronize()
                lone[k] = time.perf_counter() - t
                check(result_digests(res)[0] == rep["warm"][k] and
                      env.cache_misses == 0, f"group serving lone {k} "
                      f"on rank {rank}: differs or built a stage")
                del res
    for lease in leases:
        lease.release()
    rep["lone_s"] = lone

    def sweep(inflight):
        sched = QueryScheduler(pool=pool, gang_size=gang,
                               max_inflight=inflight, max_queue=nq,
                               program_cache=shared,
                               name=f"pg-serve-x{inflight}")
        _WATCH["sched"] = sched
        names = [kinds[i % len(kinds)] for i in range(nq)]
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        c0 = dict(comm.stats)
        ch0 = sched.stats()["control"]
        t0 = time.monotonic()
        handles = [sched.submit(queries[n](), label=f"x{inflight}-{i}")
                   for i, n in enumerate(names)]
        # each result's digest as it comes, the result then let go: a
        # process's peak is one query's working set, not the sweep's
        # results; the sweep's wall ends at its last query's end
        entries = []
        for i, n in enumerate(names):
            res = handles[i].result(timeout=PG_TIMEOUT_S)
            st = handles[i].stats
            entries.append([
                n, st["devices"], st["state"], st["cache_misses"],
                None if res is None else
                [held_rank(res), result_digests(res)[0]],
                st["submitted_monotonic"], st["started_monotonic"],
                st["finished_monotonic"], st["wall_s"], st["queue_wait_s"]])
            handles[i] = res = None
        wall = max(e[7] for e in entries) - t0
        sched.close()
        ch = sched.stats()["control"]
        counts = launch_counts()
        mine = [e[0] for e in entries if rank in e[1]]
        want = {k: sum(job["launches"][n][k] for n in mine) * on_card
                for k in ("radix_partition", "segmented_sum")}
        rec = {"inflight": inflight, "wall_s": wall, "launches": counts,
               "launches_want": want, "member_of": len(mine),
               "staged_s": sum(comm.stats[k] - c0[k]
                               for k in ("staged_s", "host_s")),
               "control_s": ch["seconds"] - ch0["seconds"],
               "messages": ch["sent"] + ch["received"] - ch0["sent"]
               - ch0["received"],
               "peak_bytes": torch.cuda.max_memory_allocated()
               if on_card else None, "handles": entries}
        return rec
    rep["sweeps"] = [sweep(k) for k in job["inflight"]]

    sched = QueryScheduler(pool=pool, gang_size=gang, max_inflight=1,
                           max_queue=2, program_cache=shared,
                           name="pg-serve-ctl")
    _WATCH["sched"] = sched
    t = time.perf_counter()
    hang = sched.submit(queries["groupby"](), label="hang",
                        faults="stage:launch@0=hang", timeout=PG_HANG_S)
    expires = sched.submit(queries["filter"](), label="expires",
                           timeout=0.2)
    cancelled = sched.submit(queries["join"](), label="cancelled")
    try:
        sched.submit(queries["filter"](), label="rejected")
        rejected = None
    except AdmissionRejected as e:
        rejected = type(e).__name__
    if rank == world - 1:
        cancelled.cancel("from the last process")
    ctl = {"rejected": rejected}
    for name, h in (("hang", hang), ("expires", expires),
                    ("cancelled", cancelled)):
        try:
            h.result(timeout=PG_TIMEOUT_S)
            exc = None
        except Exception as e:      # the outcome under test
            exc = type(e).__name__
        ctl[name] = [h.stats["state"], exc, h.stats.get("devices")]
    ctl["hang_wall_s"] = hang.stats.get("wall_s")
    sched.close()
    ctl["wall_s"] = time.perf_counter() - t
    rep["ctl"] = ctl
    _WATCH.pop("sched", None)
    del left, right, queries
    return rep


def _pg_handoff_job(torch, job, device):
    """The §IV-C hand-off over the group (``job``: the corpus, the
    preprocessing gang's size, the batches): the preprocessing on the
    lowest ranks, ``put``; ``get`` at every process, its batches; ``get``
    onto the next gang of that size, its batches; this process's
    report."""
    import torch.distributed as dist
    from repro_torch.core import CylonExecutor, CylonStore, DevicePool
    from repro_torch.data import (CorpusConfig, preprocess, source_weights,
                                  synth_corpus)
    on_card = device != "cpu"
    world = dist.get_world_size()

    def sync():
        if on_card:
            torch.cuda.synchronize()
    pool = DevicePool(process_group=dist.group.WORLD, device=device)
    store = CylonStore(pool=pool)
    cfg = CorpusConfig(**job["corpus"])
    ex = CylonExecutor(job["gang"], pool=pool)
    rep = {"member": ex.is_member}
    corpus = weights = None
    t = time.perf_counter()
    if ex.is_member:
        corpus = synth_corpus(cfg, ex.parallelism, device=device,
                              comm=ex.env.comm)
        weights = source_weights(cfg.num_sources, ex.parallelism,
                                 device=device, comm=ex.env.comm)
    sync()
    rep["made_s"] = time.perf_counter() - t
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    stats0 = dict(ex.env.comm.stats) if ex.is_member else None
    t = time.perf_counter()
    out = preprocess(ex, corpus, weights, store=store)
    sync()
    rep["preprocess_s"] = time.perf_counter() - t
    rep["launches"] = launch_counts()
    if out is not None:
        rep["staged_s"] = sum(ex.env.comm.stats[k] - stats0[k]
                              for k in ("staged_s", "host_s"))
        rep["out"] = [held_rank(out), valid_digests(out)[0]]
    del corpus, weights, out
    host0 = store.world.stats["host_s"]
    t = time.perf_counter()
    got = store.get("train_corpus", target_parallelism=world)
    sync()
    rep["get_all_s"] = time.perf_counter() - t
    rep["get_all"] = [held_rank(got), valid_digests(got)[0]]
    other = pool.reserve(job["gang"])
    t = time.perf_counter()
    moved = store.get("train_corpus", lease=other)
    sync()
    rep["get_other_s"] = time.perf_counter() - t
    rep["handoff_host_s"] = store.world.stats["host_s"] - host0
    rep["other"] = list(other.indices)
    if moved is not None:
        rep["get_other"] = [held_rank(moved), valid_digests(moved)[0]]
    t = time.perf_counter()
    rep["batches_all"] = batch_digests(got, job["steps"])
    if moved is not None:
        rep["batches_other"] = batch_digests(moved, job["steps"])
    rep["batches_s"] = time.perf_counter() - t
    rep["peak_bytes"] = torch.cuda.max_memory_allocated() if on_card \
        else None
    other.release()
    ex.release()
    del got, moved
    return rep


def _alike(got, label, what):
    first = json.dumps(got[0])
    check(all(json.dumps(g) == first for g in got), f"{label}: {what} "
          f"differs between processes: {got}")


def check_pg_serving(out, reports, label, want, stacked, smi):
    """Hold the group's serving job ``label`` to the stacked gang's
    digests ``want`` ({kind: per-rank digests}), print its numbers beside
    the stacked serving phase's (``stacked``, or None) and record them in
    ``out["runs"]``."""
    got = [rep[label] for rep in reports]
    world = len(got)
    for r, g in enumerate(got):
        for k, d in g["warm"].items():
            check(d == want[k][g["rank"]], f"{label}: pre-warm {k} on "
                  f"process {r} differs from rank {g['rank']} of the "
                  f"stacked gang")
    for i, sw in enumerate(got[0]["sweeps"]):
        tag = f"{label} x{sw['inflight']}"
        sweeps = [g["sweeps"][i] for g in got]
        for j, h in enumerate(sw["handles"]):
            recs = [s["handles"][j] for s in sweeps]
            _alike([x[:4] for x in recs], tag, f"query {j} outcome")
            check(h[2] == "done" and h[3] == 0, f"{tag}: query {j} "
                  f"{h[2]}, {h[3]} stages built")
            for w, x in enumerate(recs):
                check((x[4] is not None) == (w in h[1]), f"{tag}: query "
                      f"{j} result on process {w}, gang {h[1]}")
                if x[4] is not None:
                    check(x[4][1] == want[h[0]][x[4][0]], f"{tag}: query "
                          f"{j} ({h[0]}) on process {w} differs from "
                          f"rank {x[4][0]} of the stacked gang")
        for w, s in enumerate(sweeps):
            check(s["launches"]["radix_partition"]
                  == s["launches_want"]["radix_partition"]
                  and s["launches"]["segmented_sum"]
                  == s["launches_want"]["segmented_sum"],
                  f"{tag}: process {w} launches {s['launches']}, derived "
                  f"{s['launches_want']}")
        pairs = 0
        hs = sw["handles"]
        for a in range(len(hs)):
            for b in range(a + 1, len(hs)):
                if hs[a][6] < hs[b][7] and hs[b][6] < hs[a][7]:
                    pairs += 1
                    check(not set(hs[a][1]) & set(hs[b][1]),
                          f"{tag}: overlapping queries shared processes")
        check(sw["inflight"] == 1 or world == PG_SERVE_GANG or pairs > 0,
              f"{tag}: no two queries ran at once")
        lat = sorted(h[7] - h[5] for h in hs)
        members = [s for s in sweeps if s["member_of"]]
        rec = {"processes": world, "gang": len(hs[0][1]),
               "queries": len(hs), "wall_s": sw["wall_s"],
               "queries_per_s": len(hs) / sw["wall_s"],
               "p50_s": lat[len(lat) // 2], "max_s": lat[-1],
               "gang_wall_s_by_kind": {
                   k: float(np.median([h[8] for h in hs if h[0] == k]))
                   for k in sorted(want)},
               "staged_share": float(np.mean(
                   [s["staged_s"] / sw["wall_s"] for s in members])),
               "control_share": float(np.mean(
                   [s["control_s"] / sw["wall_s"] for s in sweeps])),
               "control_messages": sweeps[0]["messages"],
               "overlapping_pairs": pairs,
               "peak_bytes_per_process": max(s["peak_bytes"] or 0
                                             for s in sweeps),
               "launches_per_process": max(
                   (s["launches"] for s in members),
                   key=lambda c: c["radix_partition"])}
        out["runs"][tag] = rec
        beside = ""
        if stacked is not None:
            st = stacked["serial" if sw["inflight"] == 1 else "concurrent"]
            beside = (f"; stacked gangs of {PG_SERVE_GANG} ranks, same "
                      f"call: {st['queries_per_s']:.3f} queries/s, p50 "
                      f"{st['p50_s'] * 1e3:.1f} ms, largest "
                      f"{st['max_s'] * 1e3:.1f} ms, reserved "
                      f"{st.get('peak_reserved_gib', 0):.2f} GiB")
        print(f"process group serving {tag}: {len(hs)} queries on gangs of "
              f"{rec['gang']} of {world} processes in {sw['wall_s']:.3f} s, "
              f"{rec['queries_per_s']:.3f} queries/s, latency p50 "
              f"{rec['p50_s'] * 1e3:.1f} ms, largest {rec['max_s'] * 1e3:.1f}"
              f" ms, gang wall by kind "
              + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in
                          rec["gang_wall_s_by_kind"].items())
              + f"; host-staged collectives and host exchanges "
              f"{100 * rec['staged_share']:.1f}% of a member's wall, control "
              f"messages {100 * rec['control_share']:.2f}% ("
              f"{rec['control_messages']} on the coordinator), "
              f"{pairs} overlapping pairs on disjoint gangs, peak "
              f"{rec['peak_bytes_per_process'] / 2**30:.2f} GiB a process, "
              f"launches a member {rec['launches_per_process']} (derived), "
              f"every member equal to rank r of the stacked gang, 0 stages "
              f"built{beside} [{smi}]", flush=True)
    sweeps = out["runs"]
    if len(got[0]["sweeps"]) == 2:
        a, b = (sweeps[f"{label} x{s['inflight']}"]["wall_s"]
                for s in got[0]["sweeps"])
        out["runs"][f"{label} x1"]["speedup_concurrent"] = a / b
        print(f"process group serving {label}: concurrent / serial "
              f"{a / b:.4f}x" + (f" (stacked, same call: "
                                 f"{stacked['speedup']:.4f}x)"
                                 if stacked is not None else "")
              + f" [{smi}]", flush=True)
    ctl = [g["ctl"] for g in got]
    _alike([{k: v for k, v in c.items() if not k.endswith("_s")}
            for c in ctl], label, "control outcomes")
    c = ctl[0]
    check(c["rejected"] == "AdmissionRejected"
          and c["hang"][:2] == ["timeout", "QueryTimeout"]
          and c["expires"][:2] == ["timeout", "QueryTimeout"]
          and c["cancelled"][:2] == ["cancelled", "QueryCancelled"],
          f"{label}: control outcomes {c}")
    lone = {k: max(g["lone_s"][k] for g in got if g["lone_s"])
            for k in sorted(want)}
    out["runs"][f"{label} control"] = {
        "outcomes": {k: c[k][:2] for k in ("hang", "expires", "cancelled")},
        "rejected": c["rejected"], "hang_wall_s": c["hang_wall_s"],
        "lone_s": lone, "upload_s": max(g["upload_s"] for g in got),
        "input_bytes": max(g["input_bytes"] for g in got)}
    print(f"process group serving {label}: a hang under a {PG_HANG_S} s "
          f"deadline QueryTimeout on both members after "
          f"{c['hang_wall_s']:.2f} s, a deadline in the queue QueryTimeout, "
          f"a cancellation from process {world - 1} QueryCancelled, "
          f"AdmissionRejected past max_queue, alike on every process; "
          f"lone warm queries on the first gang outside the scheduler (no "
          f"agreement at the fault sites, the other gangs idle) "
          + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in lone.items())
          + f"; whole inputs {max(g['input_bytes'] for g in got) / 2**30:.2f}"
          f" GiB on the card a process, the card's free memory at the job's "
          f"start {min(g['free_bytes'] for g in got) / 2**30:.2f} GiB "
          f"[{smi}]", flush=True)


def check_pg_handoff(out, reports, label, ref, smi):
    """Hold the group's hand-off job to the stacked pipeline ``ref`` and
    record its numbers."""
    got = [rep[label] for rep in reports]
    world = len(got)
    members = [g for g in got if g["member"]]
    gang = len(members)
    for w, g in enumerate(got):
        check(g["member"] == (w < gang), f"{label}: process {w} member "
              f"{g['member']}")
        if g["member"]:
            r, d = g["out"]
            check(r == w and d == ref["out"][r], f"{label}: the "
                  f"preprocessing on process {w} differs from rank {r}")
            check(g["launches"]["radix_partition"]
                  == ref["radix_per_member"], f"{label}: process {w} "
                  f"launches {g['launches']}, derived "
                  f"{ref['radix_per_member']}")
        else:
            check(g["launches"]["radix_partition"] == 0, f"{label}: "
                  f"process {w} launched outside the gang")
        r, d = g["get_all"]
        check(r == w and d == ref["get_p"][r], f"{label}: get at {world} "
              f"on process {w} differs from rank {r}")
        check(g["batches_all"] == ref["batches"], f"{label}: process {w}'s "
              f"batches differ from the stacked run's")
        check(g["other"] == list(range(gang, 2 * gang)), f"{label}: the "
              f"other gang {g['other']}")
        if w >= gang:
            r, d = g["get_other"]
            check(r == w - gang and d == ref["out"][r], f"{label}: get onto "
                  f"the other gang on process {w} differs from rank {r}")
            check(g["batches_other"] == ref["batches"], f"{label}: process "
                  f"{w}'s batches from the other gang differ")
        else:
            check("get_other" not in g, f"{label}: process {w} got rows")
    rec = {"processes": world, "gang": gang,
           "preprocess_s": max(g["preprocess_s"] for g in got),
           "staged_share": float(np.mean([g["staged_s"] / g["preprocess_s"]
                                          for g in members])),
           "get_all_s": max(g["get_all_s"] for g in got),
           "get_other_s": max(g["get_other_s"] for g in got),
           "handoff_host_s": max(g["handoff_host_s"] for g in got),
           "batches_s": max(g["batches_s"] for g in got),
           "made_s": max(g["made_s"] for g in got),
           "peak_bytes_per_process": max(g["peak_bytes"] or 0 for g in got),
           "launches_per_process": members[0]["launches"],
           "stacked_preprocess_s": ref["wall_s"],
           "stacked_handoff_s": ref["handoff_s"]}
    out["runs"][label] = rec
    print(f"process group {label}: {ref['rows']} documents kept by a gang "
          f"of {gang} of {world} processes in {rec['preprocess_s']:.3f} s "
          f"({100 * rec['staged_share']:.1f}% in host-staged collectives "
          f"and host exchanges; corpus made in {rec['made_s']:.2f} s), get "
          f"at {world} {rec['get_all_s']:.3f} s, onto the other gang of "
          f"{gang} {rec['get_other_s']:.3f} s ({rec['handoff_host_s']:.3f} "
          f"s in host exchanges), {TRAIN_STEPS} batches {rec['batches_s']:.3f}"
          f" s; peak {rec['peak_bytes_per_process'] / 2**30:.2f} GiB a "
          f"process; launches a member {rec['launches_per_process']}; every "
          f"process equal to the stacked run by digest (stacked on "
          f"{gang} ranks, same call: {ref['wall_s']:.3f} s, get at {P} "
          f"{ref['handoff_s']:.3f} s) [{smi}]", flush=True)


# ---------------------------------------------------------------------- #
# Training fed by the §IV-C pipeline (mamba2-780m at full width)
# ---------------------------------------------------------------------- #
#: the preprocessing application's corpus: 2**17 documents of 1,024 tokens
TRAIN_CORPUS = dict(num_docs=1 << 17, payload_tokens=1024, vocab_size=50280,
                    dup_rate=0.3, num_sources=8, seed=0)
#: batch, sequence, timed steps (after one warm-up step), CE chunk
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_CE_CHUNK = 8, 1024, 4, 64
#: radix launches of each dataframe operator of the preprocessing
#: application (``data/pipeline.py``): a groupby shuffles its input on the
#: keys, a join both of its sides, a balanced repartition its input once;
#: the store's host-staged re-split launches no kernel
RADIX_PER_OPERATOR = {"groupby": 1, "join": 2, "repartition_balanced": 1}
#: the aggregations that ``groupby_local`` sums with the segmented sum
SEGSUM_AGGS = ("sum", "count", "size", "mean")


def pipeline_oracle(raw, weights):
    """``tests/md_scripts/data_pipeline.py``'s numpy oracle: the kept
    doc ids (the minimum id of each dup group, quality >= 0.2), sorted,
    and each source's weight."""
    _, first = np.unique(raw["dup_group"], return_index=True)
    min_id = np.full(raw["dup_group"].max() + 1, -1, np.int64)
    min_id[raw["dup_group"][first]] = raw["doc_id"][first]
    keep = (min_id[raw["dup_group"]] == raw["doc_id"]) & \
        (raw["quality"] >= 0.2)
    return np.sort(raw["doc_id"][keep]), dict(zip(
        weights["source"].tolist(), weights["weight"].tolist()))


def check_pipeline_result(res, raw, ids, wmap, counts, label):
    """The preprocessed rows against the oracle: ids, payloads, weights,
    balance, no drop."""
    check(np.array_equal(np.sort(res["doc_id"]), ids),
          f"{label}: kept doc ids differ from the numpy oracle")
    check(int(counts.sum()) == len(ids), f"{label}: {int(counts.sum())} "
          f"rows, want {len(ids)} (rows dropped)")
    check(np.array_equal(res["tokens"], raw["tokens"][res["doc_id"]]),
          f"{label}: a document's token payload changed")
    want_w = np.asarray([wmap[s] for s in res["source"].tolist()],
                        np.float32)
    check(np.array_equal(res["weight"], want_w), f"{label}: wrong weights")
    check(counts.max() <= 2.0 * max(counts.mean(), 1),
          f"{label}: ranks unbalanced {counts.tolist()}")


def train_pipeline(torch, smi):
    """The §IV-C preprocessing application on a gang of ``P`` stacked
    ranks on the card, ``put`` into a ``CylonStore`` and ``get`` at 4
    ranks; returns the training table and the phase's record."""
    from types import SimpleNamespace
    from repro_torch.core import CylonExecutor, CylonStore
    from repro_torch.data import (CorpusConfig, preprocess, source_weights,
                                  synth_corpus)
    from repro_torch.dataframe.shuffle import default_bucket_capacity
    dev = torch.device("cuda")
    cfg = CorpusConfig(**TRAIN_CORPUS)
    t = time.perf_counter()
    docs = synth_corpus(cfg, P, device=dev)
    weights = source_weights(cfg.num_sources, P, device=dev)
    made_s = time.perf_counter() - t
    cap = docs.capacity
    slots = P * P * min(default_bucket_capacity(cap, P, 4.0), cap)
    row_bytes = 4 * (cfg.payload_tokens + 7)    # + 7 one-word columns
    print(f"train pipeline: {cfg.num_docs} documents x {cfg.payload_tokens} "
          f"tokens on {P} ranks (capacity {cap}), made in {made_s:.2f} s; "
          f"the balancing shuffle's buffers: {slots} slots x {row_bytes} B "
          f"= {slots * row_bytes / 2**30:.2f} GiB each way", flush=True)
    gang = CylonExecutor(parallelism=P, device=dev)
    store = CylonStore()
    # the operators the application runs, each call with its arguments:
    # the kernels' launches are derived from them
    ops, outs = [], []

    def note(op):
        return lambda *a, **kw: ops.append((op, kw))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t = time.perf_counter()
    recording(SimpleNamespace(synchronize=torch.cuda.synchronize),
              lambda: outs.append(preprocess(gang, docs, weights,
                                             store=store)),
              [("repro_torch.data.pipeline", op, note(op))
               for op in RADIX_PER_OPERATOR])
    wall = time.perf_counter() - t
    out, = outs
    counts = launch_counts()
    want = {"radix_partition": sum(RADIX_PER_OPERATOR[op] for op, _ in ops),
            "sum_aggs": [a for op, kw in ops if op == "groupby"
                         for aggs in kw["aggs"].values() for a in aggs
                         if a in SEGSUM_AGGS]}
    # the derivation of segmented-sum launches covers groupbys without a
    # summed aggregate (the dedup takes a min): none is expected
    check(not want["sum_aggs"], f"train pipeline: groupby aggregates "
          f"{want['sum_aggs']} need a segmented-sum derivation")
    check(counts["radix_partition"] == want["radix_partition"]
          and counts["segmented_sum"] == 0,
          f"train pipeline: launches {counts}, derived "
          f"{want['radix_partition']} radix from {[op for op, _ in ops]} "
          f"and 0 segmented-sum")
    peak = torch.cuda.max_memory_allocated() / 2**30
    raw, wts = docs.to_numpy(), weights.to_numpy()
    ids, wmap = pipeline_oracle(raw, wts)
    check_pipeline_result(out.to_numpy(), raw, ids, wmap,
                          out.row_counts.cpu().numpy(), "train pipeline")
    t = time.perf_counter()
    got = store.get("train_corpus", target_parallelism=4)
    handoff = time.perf_counter() - t
    check_pipeline_result(got.to_numpy(), raw, ids, wmap,
                          got.row_counts.cpu().numpy(),
                          "train pipeline hand-off")
    rec = dict(wall_s=wall, handoff_s=handoff, rows_in=cfg.num_docs,
               rows_out=int(len(ids)), peak_gib=peak, launches=counts,
               operators=[op for op, _ in ops],
               derived_radix=want["radix_partition"],
               rows_per_rank=out.row_counts.cpu().tolist())
    print(f"train pipeline: preprocess {wall:.3f} s ({len(ids)} of "
          f"{cfg.num_docs} documents kept, rows per rank "
          f"{rec['rows_per_rank']}, 0 dropped), CylonStore hand-off to 4 "
          f"ranks {handoff:.3f} s, peak device memory {peak:.2f} GiB, "
          f"launches {counts} (radix derived {want['radix_partition']} "
          f"from {rec['operators']}) [{smi}]", flush=True)
    store.delete("train_corpus")
    del docs, weights, out, raw
    return got, rec


def ssd_train_counts(cfg):
    """SSD kernel forward launches and plain backward passes of one train
    step with remat: one forward per mamba layer and again in each such
    layer's recomputation; one backward per mamba layer."""
    mamba = sum(cfg.layer_kind(i) == "m" for i in range(cfg.num_layers))
    return 2 * mamba, mamba


def radix_train_counts(cfg, shuffle=False):
    """Radix launches of one train step with remat: each MoE layer ranks
    its dispatch in the forward and again in its recomputation (the
    backward launches none): once for the grouped dispatch, three times
    for the shuffle dispatch (the outbound shuffle, the group by local
    expert, the return shuffle)."""
    per = 3 if shuffle else 1
    return 2 * per * sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))


#: layers a trained arch keeps at full width: olmoe-1b-7b's full-width
#: state (16 bytes a parameter, 111 GB) does not fit one card even with
#: the sharding of ROADMAP item 13.6 (a (1, 1) mesh holds all of it), so
#: 4 of 16 layers (1.88 B parameters, ~30 GB of state)
TRAIN_LAYERS = {"olmoe-1b-7b": 4}
#: parameters each trained arch's run checks for a change
TRAIN_PROBES = {"mamba2-780m": ("embed", "blocks.0.mixer.w_in",
                                "blocks.47.mixer.a_log"),
                "olmoe-1b-7b": ("embed", "blocks.0.moe.router",
                                "blocks.3.moe.experts.w_down")}


def train_phase(torch, smi, arch="mamba2-780m", seed=0, keep=None):
    """``arch`` at full width in float32 on the card (mamba2-780m at full
    depth, olmoe-1b-7b cut to ``TRAIN_LAYERS``), fed by
    ``train_pipeline``: one warm-up step and ``TRAIN_STEPS`` timed steps,
    then one profiled step.  ``keep`` (a dict) receives the first batch
    under ``arch``."""
    import dataclasses
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data import batches_from_table
    from repro_torch.kernels import ssd_scan_backward
    from repro_torch.models.layers import NO_SHARDING
    from repro_torch.train import (AdamWConfig, init_train_state,
                                   make_train_step)
    dev = torch.device("cuda")
    batch, seq = TRAIN_BATCH, TRAIN_SEQ
    table, pipe = train_pipeline(torch, smi)
    batches = batches_from_table(table, batch, seq, seed=seed)
    first = next(batches)                 # copies the table to the host
    if keep is not None:
        keep[arch] = first
    del table
    torch.cuda.empty_cache()
    cfg = get_config(arch)
    if arch in TRAIN_LAYERS:
        cfg = dataclasses.replace(cfg, num_layers=TRAIN_LAYERS[arch])
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = init_train_state(cfg, gen, torch.float32, dev)
    n_params = sum(t.numel() for t in state["params"].values())
    steps = TRAIN_STEPS + 1
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=max(steps // 10, 1),
                          total_steps=steps)
    step_fn = make_train_step(cfg, opt_cfg, NO_SHARDING, "auto", True,
                              TRAIN_CE_CHUNK)
    probe = {n: state["params"][n].clone() for n in TRAIN_PROBES[arch]}
    fwd, bwd = ssd_train_counts(cfg)
    radix = radix_train_counts(cfg)
    recs = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        reset_counts()
        b0 = ssd_scan_backward.launches
        t = time.perf_counter()
        state, m = step_fn(state, first if i == 0 else next(batches))
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        wall = time.perf_counter() - t
        counts = launch_counts()
        got = (counts["ssd_scan"], ssd_scan_backward.launches - b0)
        check(got == (fwd, bwd), f"train step {i}: SSD forward launches and "
              f"backward passes {got}, derived {(fwd, bwd)}")
        check(counts["radix_partition"] == radix, f"train step {i}: "
              f"{counts['radix_partition']} radix launches, derived {radix}")
        check(np.isfinite(loss) and np.isfinite(gnorm),
              f"train step {i}: loss {loss}, grad norm {gnorm}")
        recs.append(dict(step_s=wall, loss=loss, grad_norm=gnorm,
                         aux=float(m["aux"]), lr=float(m["lr"]), ssd=got,
                         radix=counts["radix_partition"]))
        print(f"train {cfg.name} step {i}{' (warm-up)' if i == 0 else ''}: "
              f"{wall:.3f} s, loss {loss:.4f} (MoE aux {recs[-1]['aux']:.4f})"
              f", grad norm {gnorm:.3f}, lr {recs[-1]['lr']:.2e}; ssd_scan "
              f"forward launches {got[0]}, backward passes {got[1]}, "
              f"radix_partition launches {counts['radix_partition']} "
              f"[{smi}]", flush=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for n, before in probe.items():
        check(not torch.equal(before, state["params"][n]),
              f"train: parameter {n} did not change")
    timed = [r["step_s"] for r in recs[1:]]
    step_s = float(np.median(timed))
    tokens = batch * seq
    rec = dict(arch=cfg.name, layers=cfg.num_layers, params=n_params,
               batch=batch, seq=seq,
               step_s=step_s, steps_s=timed, tokens_per_s=tokens / step_s,
               peak_gib=peak, warmup_step_s=recs[0]["step_s"],
               losses=[r["loss"] for r in recs],
               aux=[r["aux"] for r in recs],
               grad_norms=[r["grad_norm"] for r in recs],
               radix_launches_per_step={
                   "read": [r["radix"] for r in recs[1:]],
                   "derived": radix},
               # as read in each timed step, beside their derivation
               ssd_launches_per_step={
                   "forward": [r["ssd"][0] for r in recs[1:]],
                   "backward": [r["ssd"][1] for r in recs[1:]],
                   "derived": {"forward": fwd, "backward": bwd}},
               pipeline=pipe)
    # one more step under the profiler: busy share, top operators and the
    # device time under the SSD scan's backward (the recomputation)
    spans = []
    with moe_timed(torch, spans), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        state, m = step_fn(state, next(batches))
        float(m["loss"])
        wall_ms = (time.perf_counter() - t) * 1e3
    busy = report_profile(prof, wall_ms, f"train {arch} step", top=12)
    back = max(((getattr(e, "device_time_total", 0)
                 or getattr(e, "cuda_time_total", 0)) / 1e3
                for e in prof.key_averages()
                if e.key.endswith("SsdScanKernelBackward")), default=0)
    rec.update(profiled_wall_ms=wall_ms, busy_ms=busy,
               busy_share=busy / wall_ms if busy else None,
               ssd_backward_ms=back or None,
               ssd_backward_share=back / busy if busy and back else None)
    share = rec["ssd_backward_share"]
    if cfg.moe:
        rec["moe_profile_ms"] = moe_split(prof, spans)
    print(f"train {cfg.name}: {cfg.num_layers} layers, {n_params / 1e9:.3f}"
          f" B float32 parameters, batch {batch} x {seq}: step "
          f"{step_s:.3f} s (median of {len(timed)}: "
          f"{', '.join(f'{s:.3f}' for s in timed)}), "
          f"{tokens / step_s:.0f} tokens/s, peak device memory "
          f"{peak:.2f} GiB; profiled step: busy "
          + (f"{100 * rec['busy_share']:.1f}%" if rec["busy_share"]
             else "not measured")
          + (", SSD backward recomputation "
             + (f"{rec['ssd_backward_ms']:.1f} ms ({100 * share:.1f}% of "
                f"device time)" if share else "not measured") if fwd else "")
          + (f", {rec['moe_profile_ms']['moe_layer_calls']} MoE layer "
             f"forwards {rec['moe_profile_ms']['moe_layer_ms']:.1f} ms on the"
             f" device, the dispatch ranks of the forwards and "
             f"recomputations {rec['moe_profile_ms']['dispatch_ms']:.3f} ms"
             if cfg.moe else "")
          + f" [{smi}]", flush=True)
    del state, batches
    torch.cuda.empty_cache()
    return rec


def train_parity_phase(torch, steps=3, seed=3):
    """The SMOKE configs from one state on the card and on the CPU: three
    steps with the kernels on the card and the plain versions on the CPU,
    losses and gradient norms within 1e-3 relative; then, on the card, a
    save by ``AsyncCheckpointer`` after step 2, ``restore`` and step 3
    equal to the uninterrupted step 3 bit for bit."""
    import tempfile
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.layers import NO_SHARDING
    from repro_torch.train import (AdamWConfig, AsyncCheckpointer,
                                   init_train_state, make_train_step,
                                   restore)

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        return tree.to(dev, copy=True)

    for arch, _, _, _ in SERVE_CASES + VLM_CASES:
        cfg = get_smoke_config(arch)
        base = init_train_state(cfg, torch.Generator().manual_seed(seed),
                                torch.float32, "cpu")
        rng = np.random.default_rng(seed)
        n_patch = SMOKE_PATCHES if cfg.family == "vlm" else 0
        batches = []
        for _ in range(steps):
            toks = serve_prompts(cfg, 2, 161, n_patch, rng)
            batches.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
            if n_patch:
                batches[-1]["patch_embeds"] = rng.standard_normal(
                    (2, n_patch, cfg.d_model)).astype(np.float32)
        ocfg = AdamWConfig(warmup_steps=1, total_steps=steps)
        metrics, states = {}, {}
        for device in ("cuda", "cpu"):
            impl = "chunked" if device == "cpu" else "auto"
            step = make_train_step(cfg, ocfg, NO_SHARDING, impl, True, 32)
            state, ms = to(base, device), []
            for i, b in enumerate(batches):
                if i == steps - 1:
                    states[device] = (state, step)
                state, m = step(state, b)
                ms.append((float(m["loss"]), float(m["grad_norm"])))
            metrics[device] = np.asarray(ms)
            states[device] += (state,)
        a, b = metrics["cuda"], metrics["cpu"]
        err = float(np.max(np.abs(a - b) / np.abs(b)))
        check(err <= 1e-3, f"train parity {arch}: card {a.tolist()} vs cpu "
              f"{b.tolist()}")
        before, step, after = states["cuda"]
        with tempfile.TemporaryDirectory() as d:
            ck = AsyncCheckpointer()
            ck.save(os.path.join(d, "ckpt_2"), before, 2)
            ck.wait()
            resumed, _ = step(restore(os.path.join(d, "ckpt_2"), before),
                              batches[-1])
        same = all(torch.equal(resumed["params"][n], t)
                   for n, t in after["params"].items()) and all(
            torch.equal(resumed["opt"][k][n], t)
            for k in ("m", "v") for n, t in after["opt"][k].items())
        check(same, f"train parity {arch}: the resumed step 3 differs from "
              f"the uninterrupted one")
        print(f"train parity {arch} smoke, {steps} steps: card == cpu "
              f"(loss and grad norm max rel err {err:.2e}); checkpoint "
              f"after step 2, restore, step 3 == uninterrupted, bit for bit "
              f"on the card", flush=True)


def ssd_grad_phase(torch, flush, bh=TRAIN_BATCH * 48, t=TRAIN_SEQ, p=64,
                   n=128, chunk=128):
    """The SSD scan's autograd path at the training shape: the kernel's
    forward (y and the final state) against ``ssd_scan_chunked`` within
    3e-3; the Function's gradients against autograd through the plain
    version (its backward is that recomputation, so this checks the
    Function's wiring, not the kernel's accuracy); the kernel's forward,
    the plain forward and the backward timed."""
    from repro_torch.kernels import (ssd_scan, ssd_scan_backward,
                                     ssd_scan_chunked)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    args = [torch.randn(bh, t, p, generator=gen, device=dev),
            torch.rand(bh, t, 1, generator=gen, device=dev) * 0.1 + 0.01,
            -torch.rand(bh, 1, generator=gen, device=dev) - 0.05,
            torch.randn(bh, t, n, generator=gen, device=dev),
            torch.randn(bh, t, n, generator=gen, device=dev)]
    gy = torch.randn(bh, t, p, generator=gen, device=dev)
    outs = {}
    for name, fn in (("kernel", ssd_scan), ("plain", ssd_scan_chunked)):
        ins = [v.clone().requires_grad_(True) for v in args]
        y, h = fn(*ins, chunk=chunk)
        grads = torch.autograd.grad(y, ins, gy, retain_graph=True)
        fwd_ms = time_cuda(torch, lambda: fn(*args, chunk=chunk), 5, flush)
        bwd_ms = time_cuda(torch, lambda: torch.autograd.grad(
            y, ins, gy, retain_graph=True), 3, flush)
        outs[name] = (grads, fwd_ms, bwd_ms, (y.detach(), h.detach()))
        del y, h
    fwd_err = max(float((g - w).abs().max()) for g, w in
                  zip(outs["kernel"][3], outs["plain"][3]))
    check(bool(all(torch.isfinite(v).all() for v in outs["kernel"][3])),
          "ssd_scan at the training shape: output not finite")
    check(fwd_err <= 3e-3, f"ssd_scan CUDA != plain at the training shape: "
          f"y / final state differ by {fwd_err} > 3e-3")
    b0 = ssd_scan_backward.launches
    ins = [v.clone().requires_grad_(True) for v in args]
    torch.autograd.grad(ssd_scan(*ins, chunk=chunk)[0], ins, gy)
    check(ssd_scan_backward.launches == b0 + 1,
          "ssd_scan backward passes not counted")
    err = max(float((g - w).abs().max()) for g, w in
              zip(outs["kernel"][0], outs["plain"][0]))
    names = ("x", "dt", "a", "b", "c")
    scale = {k: float(w.abs().max()) for k, w in zip(names,
                                                     outs["plain"][0])}
    for k, g, w in zip(names, outs["kernel"][0], outs["plain"][0]):
        # the kernel's tolerance, as torch.testing.assert_close reads it
        check(bool(((g - w).abs() <= 3e-3 + 3e-3 * w.abs()).all()),
              f"ssd_scan gradient of {k} differs from the plain version's "
              f"by {float((g - w).abs().max())}")
    rec = dict(shape=[bh, t, p, n, chunk], forward_max_abs_err=fwd_err,
               grad_max_abs_err=err,
               kernel_fwd_ms=outs["kernel"][1],
               plain_fwd_ms=outs["plain"][1],
               kernel_bwd_ms=outs["kernel"][2],
               plain_bwd_ms=outs["plain"][2], grad_scale=scale)
    print(f"ssd_scan autograd at the training shape bh={bh} t={t} p={p} "
          f"n={n} chunk={chunk}: kernel forward (y, final state) within "
          f"{fwd_err:.2e} of ssd_scan_chunked; the Function's gradients "
          f"within {err:.2e} of the plain version's (the same "
          f"recomputation: a check of the wiring; largest |grad| "
          f"{max(scale.values()):.3g}); forward: kernel "
          f"{rec['kernel_fwd_ms']:.3f} ms, plain {rec['plain_fwd_ms']:.3f} "
          f"ms; backward (plain recomputation): {rec['kernel_bwd_ms']:.3f} "
          f"ms through the Function, {rec['plain_bwd_ms']:.3f} ms through "
          f"the plain version", flush=True)
    return rec


#: the sharded serving run: arch, batch, prompt, new tokens
SHARD_SERVE = ("qwen3-8b", 4, 4096, 8)
#: the sharded train runs, each held to its unsharded warm-up step of
#: ``train_phase``: (loss rtol, grad-norm rtol); the MoE arch at the
#: reference script's tolerances (the shuffle dispatch drops other rows
#: at capacity factor 1.25 than the grouped one)
SHARD_TRAIN = {"olmoe-1b-7b": (2e-3, 2e-2), "mamba2-780m": (1e-5, 1e-4)}


def sharding_phase(torch, smi, train_recs, batches, serve_rec, seed=0):
    """ROADMAP item 13.6 on the card: a ``("data", "model")`` mesh of one
    rank over NCCL (one process, world size 1).  Each ``SHARD_TRAIN``
    arch takes one train step under ``rules_for_mesh`` from
    ``train_phase``'s seed and first batch, its state placed by
    ``state_specs`` as DTensors: olmoe-1b-7b (``TRAIN_LAYERS``) through
    ``moe_apply_shuffle`` over the mesh's model group, its radix launches
    derived from the layers; mamba2-780m through the SSD kernel and its
    autograd ``Function`` under ``local_map``; loss and gradient norm held
    to ``train_phase``'s warm-up step.  Then ``SHARD_SERVE`` through
    ``ServeEngine(rules=serve_rules_for_mesh)`` (the model placed by
    ``param_specs``, the caches by ``cache_specs``): two timed prefills
    (first and cached), 36 flash launches each as derived, and a greedy
    generation equal to the first tokens of ``serve_phase``'s first run.
    Each train arch also takes a second step for the steady state.  Each
    run's wall time and peak memory beside the unsharded run's."""
    import dataclasses
    import tempfile
    from datetime import timedelta
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan_backward
    from repro_torch.launch.mesh import (make_local_mesh, rules_for_mesh,
                                         serve_rules_for_mesh)
    from repro_torch.models import transformer
    from repro_torch.models.layers import full
    from repro_torch.serve import ServeEngine
    from repro_torch.train import (AdamWConfig, init_train_state,
                                   make_train_step, place_state)
    dev = torch.device("cuda")
    torch.cuda.set_device(0)
    rv = tempfile.mkdtemp()
    dist.init_process_group("nccl", init_method=f"file://{rv}/rendezvous",
                            rank=0, world_size=1,
                            timeout=timedelta(seconds=PG_TIMEOUT_S))
    out = {}
    try:
        mesh = make_local_mesh(model=1)
        rules = rules_for_mesh(mesh)
        for arch, (rtol_l, rtol_g) in SHARD_TRAIN.items():
            cfg = get_config(arch)
            if arch in TRAIN_LAYERS:
                cfg = dataclasses.replace(cfg, num_layers=TRAIN_LAYERS[arch])
            # device memory of whatever else is alive: the step's peak is
            # read above it (the dry-run phase predicts the step's)
            base = torch.cuda.memory_allocated()
            gen = torch.Generator(device=dev).manual_seed(seed)
            state = place_state(init_train_state(cfg, gen, torch.float32,
                                                 dev), cfg, rules, mesh)
            steps = TRAIN_STEPS + 1
            opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=max(steps // 10, 1),
                                  total_steps=steps)
            step_fn = make_train_step(cfg, opt_cfg, rules, "auto", True,
                                      TRAIN_CE_CHUNK)
            fwd, bwd = ssd_train_counts(cfg)
            radix = radix_train_counts(cfg, shuffle=cfg.moe is not None)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            b0 = ssd_scan_backward.launches
            t = time.perf_counter()
            state, m = step_fn(state, batches[arch])
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            wall = time.perf_counter() - t
            step_peak = torch.cuda.max_memory_allocated() - base
            counts = launch_counts()
            peak = torch.cuda.max_memory_allocated() / 2**30
            got = {"radix_partition": counts["radix_partition"],
                   "ssd_scan": counts["ssd_scan"],
                   "ssd_backward": ssd_scan_backward.launches - b0,
                   "flash_attention": counts["flash_attention"],
                   "segmented_sum": counts["segmented_sum"]}
            want = {"radix_partition": radix, "ssd_scan": fwd,
                    "ssd_backward": bwd, "flash_attention": 0,
                    "segmented_sum": 0}
            check(got == want, f"sharded train {arch}: launches {got}, "
                  f"derived {want}")
            ref = train_recs[arch]
            l0, g0 = ref["losses"][0], ref["grad_norms"][0]
            check(abs(loss - l0) <= rtol_l * abs(l0)
                  and abs(gnorm - g0) <= rtol_g * abs(g0),
                  f"sharded train {arch}: loss {loss}, grad norm {gnorm}; "
                  f"unsharded {l0}, {g0} (rtol {rtol_l}, {rtol_g})")
            leaf = next(iter(state["params"].values()))
            check(type(leaf).__name__ == "DTensor",
                  f"sharded train {arch}: the new state is not on the mesh")
            # a second step (the same batch) for the steady state
            reset_counts()
            t = time.perf_counter()
            state, m = step_fn(state, batches[arch])
            check(np.isfinite(float(m["loss"])), f"sharded train {arch}: "
                  f"second step's loss {float(m['loss'])}")
            second = time.perf_counter() - t
            check(launch_counts()["radix_partition"] == radix,
                  f"sharded train {arch}: second step's radix launches")
            peak = torch.cuda.max_memory_allocated() / 2**30
            out[arch] = dict(layers=cfg.num_layers, step_s=wall,
                             second_step_s=second, loss=loss,
                             grad_norm=gnorm, peak_gib=peak,
                             step_peak_bytes=step_peak, base_bytes=base,
                             launches=got,
                             unsharded=dict(
                                 step_s=ref["warmup_step_s"],
                                 steady_step_s=ref["step_s"], loss=l0,
                                 grad_norm=g0, peak_gib=ref["peak_gib"]))
            print(f"sharded train {arch} ({cfg.num_layers} layers) on a "
                  f"(1, 1) mesh over NCCL: first step {wall:.3f} s, second "
                  f"{second:.3f} s (unsharded warm-up step "
                  f"{ref['warmup_step_s']:.3f} s, median step "
                  f"{ref['step_s']:.3f} s), loss {loss:.6f} (unsharded "
                  f"{l0:.6f}), grad norm {gnorm:.4f} (unsharded {g0:.4f}), "
                  f"peak device memory {peak:.2f} GiB (unsharded run "
                  f"{ref['peak_gib']:.2f} GiB); launches {got}, as derived "
                  f"[{smi}]", flush=True)
            del state, step_fn
            torch.cuda.empty_cache()

        srules = serve_rules_for_mesh(mesh)
        arch, batch, prompt, new = SHARD_SERVE
        cfg = serve_config(arch)
        base = torch.cuda.memory_allocated()
        gen = torch.Generator(device=dev).manual_seed(seed)
        model = transformer.shard_model(transformer.init_params(
            cfg, gen, torch.float32, dev), srules, mesh)
        engine = ServeEngine(cfg, model, cache_len=prompt + new,
                             rules=srules)
        prompts = serve_prompts(cfg, batch, prompt, 0,
                                np.random.default_rng(seed))
        pre, dec = serve_launches(cfg, "auto", prompt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ttft = []
        for _ in range(2):                  # first and cached
            reset_counts()
            t = time.perf_counter()
            logits, caches = engine.prefill(torch.as_tensor(
                prompts, dtype=torch.long, device=dev))
            logits = full(logits)
            torch.cuda.synchronize()
            ttft.append(time.perf_counter() - t)
            if len(ttft) == 1:          # the first prefill's own peak
                step_peak = torch.cuda.max_memory_allocated() - base
            counts = launch_counts()
            check(counts == pre, f"sharded serve {arch}: prefill launches "
                  f"{counts}, derived {pre}")
            check(bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()),
                  f"sharded serve {arch}: prefill logits are not finite")
            kv = caches[0]["k"]
            check(type(kv).__name__ == "DTensor",
                  f"sharded serve {arch}: the KV cache is not on the mesh")
            del logits, caches, kv
        reset_counts()
        t = time.perf_counter()
        res = engine.generate(prompts, max_new_tokens=new)
        total = time.perf_counter() - t
        gen_counts = launch_counts()
        want_gen = {k: pre[k] + new * dec[k] for k in pre}
        check(gen_counts == want_gen, f"sharded serve {arch}: generate "
              f"launches {gen_counts}, derived {want_gen}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        want_toks = serve_rec["first"]["first_tokens"]
        check(res.tokens.tolist() == want_toks, f"sharded serve {arch}: "
              f"tokens {res.tokens.tolist()} != serve_phase's {want_toks}")
        un = serve_rec["first"]
        cached = serve_rec["cached"]
        out[arch] = dict(batch=batch, prompt=prompt, new=new,
                         ttft_s=ttft[0], cached_ttft_s=ttft[1],
                         generate_s=total, peak_gib=peak,
                         step_peak_bytes=step_peak, base_bytes=base,
                         prefill_launches=counts,
                         generate_launches=gen_counts,
                         unsharded=dict(ttft_s=un["ttft_s"],
                                        cached_ttft_s=cached["ttft_s"],
                                        peak_gib=un["peak_gib"]))
        print(f"sharded serve {arch} batch={batch} prompt={prompt} "
              f"new={new} under serving rules on a (1, 1) mesh over NCCL: "
              f"time to first token {ttft[0]:.3f} s first, {ttft[1]:.3f} s "
              f"cached (unsharded {un['ttft_s']:.3f} / "
              f"{cached['ttft_s']:.3f} s), generate {total:.3f} s, peak "
              f"device memory {peak:.2f} GiB (unsharded run "
              f"{un['peak_gib']:.2f} GiB); prefill launches {counts}; greedy "
              f"tokens equal to serve_phase's [{smi}]", flush=True)
        del engine, model
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return out


#: the dry run's production cell: one full-width train cell on a fake
#: 256-rank (16, 16) mesh with card stand-ins (the MoE shuffle over the
#: model group at full width); olmoe-1b-7b's 16 layers fit the phase's
#: time, llama3.2-3b's 28 did not on the CPU
DRYRUN_CELL = ("olmoe-1b-7b", "train_4k")
#: the dry run's predicted peak (arguments + temporaries) within this
#: share of the measured step's
DRYRUN_PEAK_RTOL = 0.10
#: seconds each dry-run child may take
DRYRUN_TIMEOUT_S = 300


def _dryrun_child(job, path):
    """Spawned: one dry-run job, its result written as JSON to ``path``.
    ``job`` is a ``SHARD_TRAIN`` arch or ``SHARD_SERVE``'s (the sharding
    phase's configurations on a fake group of one rank) or "production"
    (``DRYRUN_CELL`` on a fake group of 256)."""
    import dataclasses
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import (make_local_mesh, make_production_mesh,
                                         serve_rules_for_mesh)
    from repro_torch.launch.roofline import format_table
    from repro_torch.launch.shapes import Cell, cell
    from repro_torch.configs import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    t = time.perf_counter()
    if job == "production":
        with dryrun.fake_group(256):
            row = dryrun.run_cell(cell(*DRYRUN_CELL), make_production_mesh(),
                                  "single_pod", "")
        row["table"] = format_table([row])
    else:
        with dryrun.fake_group(1):
            mesh = make_local_mesh(model=1)
            if job == SHARD_SERVE[0]:
                arch, batch, prompt, new = SHARD_SERVE
                row = dryrun.run_cell(
                    Cell(arch, "sharded_serve", "prefill", batch, prompt,
                         True), mesh, "local", "",
                    rules_override=serve_rules_for_mesh(mesh),
                    extra={"cache_len": prompt + new},
                    cfg_override=serve_config(arch), dtype=torch.float32)
            else:
                cfg = get_config(job)
                if job in TRAIN_LAYERS:
                    cfg = dataclasses.replace(cfg,
                                              num_layers=TRAIN_LAYERS[job])
                # the sharding phase's step: impl auto, remat, CE chunk
                row = dryrun.run_cell(
                    Cell(job, "sharded_train", "train", TRAIN_BATCH,
                         TRAIN_SEQ, True), mesh, "local", "",
                    ce_chunk=TRAIN_CE_CHUNK, extra={"impl": "auto"},
                    cfg_override=cfg, dtype=torch.float32)
    import torch.distributed as dist
    row["group_left"] = dist.is_initialized()
    row["wall_s"] = time.perf_counter() - t
    with open(path, "w") as f:
        json.dump(row, f)


def dryrun_start():
    """Spawn ``dryrun_phase``'s four processes and return them with their
    output directory and start time.  They work on the host's CPU (fake
    tensors launch nothing; a process holds at most its CUDA context on
    the card), so ``main`` starts them ahead of the device-bound train
    phases and reads them after the sharding phase."""
    import multiprocessing as mp
    import tempfile
    t0 = time.perf_counter()
    jobs = list(SHARD_TRAIN) + [SHARD_SERVE[0], "production"]
    d = tempfile.mkdtemp()
    ctx = mp.get_context("spawn")
    procs = {j: ctx.Process(target=_dryrun_child,
                            args=(j, os.path.join(d, f"{j}.json")))
             for j in jobs}
    for p in procs.values():
        p.start()
    return procs, d, t0


def dryrun_phase(torch, smi, sharded, started):
    """ROADMAP item 13.7 on the card's machine (``launch/dryrun.py``).
    (a) The sharding phase's three configurations (olmoe-1b-7b at
    ``TRAIN_LAYERS`` and mamba2-780m train steps, the qwen3-8b prefill
    under serving rules) dry-run on a fake group of one rank with card
    stand-ins, each in a spawned process: the kernel operators' calls
    equal the launches ``sharding_phase`` read, and the predicted peak
    (arguments + temporaries) is within ``DRYRUN_PEAK_RTOL`` of the
    step's measured peak (``max_memory_allocated`` above what was alive
    before its state, from a reset just before the step).  (b) In a
    fourth process meanwhile, ``DRYRUN_CELL`` at full width on a fake
    256-rank (16, 16) mesh (a backward pass over fake card tensors needs
    a torch built with CUDA: a CPU-only torch runs forward cells alone); its
    roofline row (``format_table``).  No child leaves a process group
    behind.  ``started``: ``dryrun_start``'s processes."""
    import shutil
    procs, d, t0 = started
    t_wait = time.perf_counter()
    deadline = t0 + DRYRUN_TIMEOUT_S
    for p in procs.values():
        p.join(max(0.0, deadline - time.perf_counter()))
    for p in procs.values():
        if p.is_alive():
            p.kill()
            p.join()
    waited = time.perf_counter() - t_wait
    rows = {}
    for j, p in procs.items():
        check(p.exitcode == 0, f"dry run {j}: exit code {p.exitcode}")
        with open(os.path.join(d, f"{j}.json")) as f:
            rows[j] = json.load(f)
        check(not rows[j]["group_left"], f"dry run {j}: a process group "
              f"was left behind")
    shutil.rmtree(d)
    # each configuration's kernel: the launches the sharding phase read
    kernel_of = {"olmoe-1b-7b": ("radix_partition", "launches"),
                 "mamba2-780m": ("ssd_scan", "launches"),
                 SHARD_SERVE[0]: ("flash_attention", "prefill_launches")}
    out = {"predicted": {}, "production": None}
    for j in list(SHARD_TRAIN) + [SHARD_SERVE[0]]:
        r = rows[j]
        ma = r["memory_analysis"]
        predicted = ma["argument_size_in_bytes"] + ma["temp_size_in_bytes"]
        measured = sharded[j]["step_peak_bytes"]
        name, key = kernel_of[j]
        launched = sharded[j][key][name]
        check(r["kernel_calls"].get(name, 0) == launched, f"dry run {j}: "
              f"kernel calls {r['kernel_calls']}, the sharding phase "
              f"launched {name} {launched} times")
        err = predicted / measured - 1.0
        mf = r["roofline"]["model_flops"]
        print(f"dry run {j} ({r['kind']}, {r['layers']} layers, world 1, "
              f"card stand-ins): predicted peak {predicted / 2**30:.3f} GiB "
              f"(arguments {ma['argument_size_in_bytes'] / 2**30:.3f} + "
              f"temporaries {ma['temp_size_in_bytes'] / 2**30:.3f}), "
              f"measured {measured / 2**30:.3f} GiB above "
              f"{sharded[j]['base_bytes'] / 2**30:.3f} GiB alive before "
              f"({100 * err:+.2f}%); kernel calls {r['kernel_calls']}, "
              f"the sharding phase's {name} launches {launched}; FLOPs "
              f"{r['cost_analysis']['flops']:.4e} (model_flops {mf:.4e}), "
              f"bytes {r['cost_analysis']['bytes accessed']:.4e}; "
              f"trace {r['trace_s']} s, counting {r['counting_s']} s, "
              f"process {r['wall_s']:.1f} s [{smi}]", flush=True)
        check(abs(err) <= DRYRUN_PEAK_RTOL, f"dry run {j}: predicted peak "
              f"{predicted} bytes against {measured} measured ({err:+.4f})")
        out["predicted"][j] = dict(
            predicted_bytes=predicted, measured_bytes=measured,
            rel_err=err, kernel_calls=r["kernel_calls"],
            memory_analysis=ma, cost_analysis=r["cost_analysis"],
            model_flops=mf, trace_s=r["trace_s"],
            counting_s=r["counting_s"], process_s=r["wall_s"])
    r = rows["production"]
    calls = r["kernel_calls"]
    # the full-depth cell's calls, held as the world-1 configurations are:
    # the shuffle dispatch over the model group in every MoE layer, and
    # no flash (train takes chunked attention) or SSD call
    from repro_torch.configs import get_config
    want = {"radix_partition": radix_train_counts(get_config(DRYRUN_CELL[0]),
                                                  shuffle=True),
            "flash_attention": 0, "ssd_scan": 0}
    check({k: calls.get(k, 0) for k in want} == want,
          f"dry run {DRYRUN_CELL}: kernel calls {calls}, expected {want}")
    print(f"dry run {DRYRUN_CELL[0]} {DRYRUN_CELL[1]} at full width on a "
          f"fake 256-rank (16, 16) mesh, card stand-ins: trace "
          f"{r['trace_s']} s, counting {r['counting_s']} s, process "
          f"{r['wall_s']:.1f} s; kernel calls {calls}; memory "
          f"{r['memory_analysis']}; collectives "
          f"{ {k: v['count'] for k, v in r['collectives'].items() if k != 'total_wire_bytes'} }, "
          f"wire {r['collectives']['total_wire_bytes']:.4e} B "
          f"[{smi}]\n{r['table']}", flush=True)
    out["production"] = {k: r[k] for k in (
        "arch", "shape", "chips", "trace_s", "counting_s", "wall_s",
        "memory_analysis", "cost_analysis", "collectives", "kernel_calls",
        "roofline")}
    out["phase_s"] = time.perf_counter() - t0
    out["slowest_process_s"] = max(r["wall_s"] for r in rows.values())
    out["waited_s"] = waited
    print(f"dry-run phase: {out['phase_s']:.1f} s from the spawn to its "
          f"last check, alongside the train and sharding phases; slowest "
          f"process {out['slowest_process_s']:.1f} s; waited for them "
          f"{waited:.1f} s after the sharding phase", flush=True)
    return out


# ---------------------------------------------------------------------- #
# The port's examples (examples/torch/), as a user runs them
# ---------------------------------------------------------------------- #
#: every port example, in the order the phase runs them on the card
EXAMPLES = ("pipeline_ops", "legacy_plan_api", "planner_explain",
            "quickstart", "serve_batch", "train_e2e")
#: the dataframe examples: their card results are held to their CPU runs
FRAME_EXAMPLES = EXAMPLES[:4]
#: train_e2e's steps on the card: 30, not its default 300, to keep the
#: script inside its 1,200 s; the loss has fallen by then (its own check)
EXAMPLE_TRAIN_STEPS = 30
#: each example's own check: a line it prints (train_e2e's result line
#: says "OK: improved" when its last 10 steps' mean loss is under its
#: first 10's by more than 0.5)
EXAMPLE_CHECKS = {
    "pipeline_ops": r"bsp == amt results: True",
    "legacy_plan_api": r"frontend == builder \(bit-identical\): True",
    "planner_explain": r"optimized == unoptimized results "
                       r"\(bit-identical\): True",
    "quickstart": r"dropped \(capacity\): 0",
    "serve_batch": r"greedy decode == full-forward argmax replay: True",
    "train_e2e": r"\[result\] loss \S+ -> \S+ \(OK: improved\)",
}
#: float columns held exactly: integer-valued sums (legacy_plan_api's
#: payloads are integers below 256) and the values a join only moves
EXAMPLE_EXACT = {"legacy_plan_api": ("builder/v0_sum", "frontend/v0_sum"),
                 "quickstart": ("joined/x", "joined/y")}
#: the dataframe operators train_e2e's preprocessing runs
#: (``data/pipeline.py::_app``; ``train_pipeline`` records them)
PREPROCESS_OPERATORS = ("groupby", "join", "join", "repartition_balanced")


def example_path(name):
    return os.path.join(ROOT, "examples", "torch", f"{name}.py")


def example_check_line(name, printed):
    """The line of ``printed`` (what example ``name`` printed) that is its
    own check passing (``EXAMPLE_CHECKS``), else None."""
    return next((ln for ln in printed.splitlines()
                 if re.fullmatch(EXAMPLE_CHECKS[name], ln)), None)


def example_launches_expected(name, ns):
    """{kernel: launches} that one card run of dataframe example ``name``
    makes, derived from the namespace ``ns`` of its CPU run as
    ``check_launches`` derives a run's: one radix launch per shuffle of a
    ``bsp`` / ``bsp_staged`` run (none in ``amt``), one segmented-sum
    launch per summed aggregate of every local groupby; quickstart's join
    shuffles each of its two sides once and sums nothing."""
    from repro_torch.planner import compile_plan
    if name == "quickstart":
        return {"radix_partition": 2, "segmented_sum": 0}
    if name == "pipeline_ops":
        pp = compile_plan(ns["out"].plan, ns["out"].sources)
        runs = [(pp, m) for m in ("bsp", "bsp_staged", "amt")
                for _ in ("first", "cached")]
    elif name == "legacy_plan_api":
        runs = [(compile_plan(ns["plan"], ns["tables"]), "bsp"),
                (compile_plan(ns["front"].plan, ns["front"].sources), "bsp")]
    else:                                   # planner_explain
        out = ns["out"]
        runs = [(compile_plan(out.plan, out.sources, optimize_plan=opt),
                 "bsp") for opt in (False, True)
                for _ in ("first", "cached")]
    return {"radix_partition": sum(pp.num_shuffles for pp, m in runs
                                   if m != "amt"),
            "segmented_sum": sum(segsum_launches_expected(pp, m)
                                 for pp, m in runs)}


def _examples_cpu_child(d):
    """The dataframe examples on the CPU in this spawned process (2
    threads), each with ``--out d/<name>.cpu.npz``; ``d/<name>.cpu.json``
    holds what it printed and its derived card launches."""
    import io
    import runpy
    import torch
    torch.set_num_threads(2)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    for name in FRAME_EXAMPLES:
        buf = io.StringIO()
        sys.argv = [example_path(name), "--device", "cpu", "--out",
                    os.path.join(d, f"{name}.cpu.npz")]
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            ns = runpy.run_path(example_path(name), run_name="__main__")
        with open(os.path.join(d, f"{name}.cpu.json"), "w") as f:
            json.dump({"printed": buf.getvalue(),
                       "wall_s": time.perf_counter() - t,
                       "derived": example_launches_expected(name, ns)}, f)


def examples_start():
    """Spawn the dataframe examples' CPU runs (``_examples_cpu_child``) and
    return the process, its output directory and the start time.  They
    use the host's CPU only, so ``main`` starts them with the dry run's
    processes, ahead of the device-bound train phases, and
    ``examples_phase`` reads them."""
    import multiprocessing as mp
    d = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    proc = mp.get_context("spawn").Process(target=_examples_cpu_child,
                                           args=(d,))
    proc.start()
    return proc, d, time.perf_counter()


def same_example_tables(name, got, want, rtol):
    """Result tables ``got`` == ``want`` of dataframe example ``name``
    (``launches/`` entries aside): keys, integer columns and
    ``EXAMPLE_EXACT`` exactly, other float columns within ``rtol``;
    quickstart's joined rows in any order.  The largest relative error."""
    keys = sorted(k for k in want if not k.startswith("launches/"))
    check(sorted(k for k in got if not k.startswith("launches/")) == keys,
          f"example {name}: tables {sorted(got)}, expected {keys}")
    got, want = dict(got), dict(want)
    if name == "quickstart":
        cols = ("joined/k", "joined/x", "joined/y")
        for side in (got, want):
            order = np.lexsort([side[c] for c in reversed(cols)])
            for c in cols:
                side[c] = side[c][order]
    worst = 0.0
    for k in keys:
        g, w = got[k], want[k]
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"example {name} {k}: {g.dtype}{g.shape}, expected "
              f"{w.dtype}{w.shape}")
        if not np.issubdtype(w.dtype, np.floating) or \
                k in EXAMPLE_EXACT.get(name, ()):
            check(np.array_equal(g, w), f"example {name} {k}: differs")
            continue
        rel = (np.abs(g.astype(np.float64) - w)
               / np.maximum(np.abs(w.astype(np.float64)), 1e-30))
        err = float(rel.max()) if rel.size else 0.0
        check(err <= rtol, f"example {name} {k}: off by rtol {err}, over "
              f"{rtol}")
        worst = max(worst, err)
    return worst


def examples_phase(torch, smi, started):
    """Each ``examples/torch/*.py`` on the card as a user runs it
    (``python examples/torch/<name>.py`` in a subprocess, with its
    defaults and ``--out``; train_e2e at ``EXAMPLE_TRAIN_STEPS``): exit
    code 0 and the example's own check line; each dataframe example's
    result tables held to its CPU run (``examples_start``) and its radix /
    segmented-sum launches to the count derived from its frames and
    plans; serve_batch launches no kernel (qwen3-8b's SMOKE prompts of 80
    keys take dense attention); train_e2e launches the radix kernel for
    the shuffles of its preprocessing alone (its 256 keys take dense
    attention), has finite losses and a falling loss (its check).  The
    six run at once: the five short ones spend most of their walls
    starting up (importing, the CUDA context, their first operators), and
    train_e2e's steps come after its own start-up.  Each example's wall
    time (the subprocess's, start-up included) and the timings it prints,
    beside the card."""
    from concurrent.futures import ThreadPoolExecutor
    proc, d, t_cpu = started
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    steps = EXAMPLE_TRAIN_STEPS

    def run(name):
        out = os.path.join(d, f"{name}.card.npz")
        argv = [sys.executable, example_path(name), "--out", out]
        if name == "train_e2e":
            argv += ["--steps", str(steps)]
        t = time.perf_counter()
        done = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=600)
        return done, time.perf_counter() - t, out
    t_phase = time.perf_counter()
    with ThreadPoolExecutor(len(EXAMPLES)) as pool:
        runs = dict(zip(EXAMPLES, pool.map(run, EXAMPLES)))
    rec = {"card_s": time.perf_counter() - t_phase}
    for name in EXAMPLES:
        done, wall, out = runs[name]
        check(done.returncode == 0, f"example {name} exited "
              f"{done.returncode}: {done.stdout[-2000:]}"
              f"{done.stderr[-3000:]}")
        lines = done.stdout.splitlines()
        own = example_check_line(name, done.stdout)
        check(own is not None, f"example {name}: no line matching "
              f"{EXAMPLE_CHECKS[name]!r} in {done.stdout[-2000:]}")
        card = dict(np.load(out))
        launches = {k.split("/", 1)[1]: int(v) for k, v in card.items()
                    if k.startswith("launches/")}
        r = {"wall_s": wall, "launches": launches,
             "timings": [ln.strip() for ln in lines
                         if "first=" in ln or " tokens in " in ln]}
        if name in FRAME_EXAMPLES:
            if "cpu_s" not in rec:
                proc.join(timeout=600)
                check(proc.exitcode == 0, f"the examples' CPU runs exited "
                      f"{proc.exitcode}")
                rec["cpu_s"] = time.perf_counter() - t_cpu
            with open(os.path.join(d, f"{name}.cpu.json")) as f:
                cpu = json.load(f)
            want = dict(cpu["derived"], flash_attention=0, ssd_scan=0)
            r["rtol_vs_cpu"] = same_example_tables(
                name, card, np.load(os.path.join(d, f"{name}.cpu.npz")),
                rtol=1e-3)
            r["cpu_wall_s"] = cpu["wall_s"]
        elif name == "serve_batch":
            want = {k: 0 for k in launches}
            check(bool(card["replay"]), "example serve_batch: replay False")
        else:
            want = {k: 0 for k in launches}
            want["radix_partition"] = sum(RADIX_PER_OPERATOR[op]
                                          for op in PREPROCESS_OPERATORS)
            losses = card["losses"]
            check(len(losses) == steps and bool(np.isfinite(losses).all()),
                  f"example train_e2e: losses {losses}")
            r.update(steps=steps, first_loss=float(losses[0]),
                     last_loss=float(losses[-1]),
                     s_per_step=float(np.median(card["step_s"][1:])),
                     first_step_s=float(card["step_s"][0]), result=own)
        r["derived"] = want
        check(launches == want, f"example {name}: launches {launches}, "
              f"derived {want}")
        rec[name] = r
        extra = "".join(f"; {ln}" for ln in r["timings"])
        if name == "train_e2e":
            extra = (f"; {steps} steps, loss {r['first_loss']:.4f} -> "
                     f"{r['last_loss']:.4f}, {r['s_per_step']:.4f} s a step "
                     f"(median after the first, {r['first_step_s']:.2f} s); "
                     f"{r['result']}")
        elif "rtol_vs_cpu" in r:
            extra += (f"; == the CPU run (float columns within rtol "
                      f"{r['rtol_vs_cpu']:.2e})")
        print(f"example {name}: exit 0 in {wall:.2f} s (the subprocess, "
              f"start-up included; six at once), launches {launches} == "
              f"derived{extra} [{smi}]", flush=True)
    print(f"examples on the card: {rec['card_s']:.2f} s for the six at once "
          f"[{smi}]", flush=True)
    shutil.rmtree(d, ignore_errors=True)
    return rec


def build_all():
    """Build every kernel: one nvcc per source, all started together."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import CUDA_KERNELS
    from repro_torch.kernels.build import build, build_log, ptxas_report
    t = time.perf_counter()
    with ThreadPoolExecutor(len(CUDA_KERNELS)) as pool:
        for done in [pool.submit(build, k.name) for k in CUDA_KERNELS]:
            done.result()
    print(f"built {[k.name for k in CUDA_KERNELS]} in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    for k in CUDA_KERNELS:
        print(build_log(k.name).strip(), flush=True)
    for name in ("flash_attention", "ssd_scan"):
        for fn, regs, st, ld in ptxas_report(name):
            print(f"ptxas {name} {fn}: {regs} registers, spill stores "
                  f"{st} B, spill loads {ld} B", flush=True)


def kernel_record(k, cases, launches, launches_by_run=None,
                  route_launches=None, launches_out_of_core=None,
                  launches_ingest=None, launches_serving=None):
    """The kernels-line entry of wrapper ``k``: the main-shape case's
    numbers, the main path's launch count (and its launches per route,
    and per run of the out-of-core Fig-9, of Fig-9 from files and per
    sweep of served queries) and every case beside them."""
    main = cases[0]
    rec = {"name": k.name, "route": "cuda", "source": k.source,
           "replaces": k.replaces, "launches": launches,
           "max_abs_err": max(c["max_abs_err"] for c in cases),
           "ms": main["ms"], "plain_ms": main["plain_ms"],
           "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
           "library_ms": main["library_ms"]}
    if launches_by_run is not None:
        rec["launches_by_run"] = launches_by_run
    if route_launches is not None:
        rec["route_launches"] = route_launches
    if launches_out_of_core is not None:
        rec["launches_out_of_core"] = launches_out_of_core
    if launches_ingest is not None:
        rec["launches_ingest"] = launches_ingest
    if launches_serving is not None:
        rec["launches_serving"] = launches_serving
    rec["cases"] = cases
    return rec


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import (flash_attention_cuda,
                                     radix_partition_cuda,
                                     segmented_sum_cuda, ssd_scan_cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    t0 = time.perf_counter()
    build_all()

    def phase_done(name):
        torch.cuda.empty_cache()
        print(f"phase {name} done at {time.perf_counter() - t0:.1f} s",
              flush=True)

    flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device="cuda")
    cap = capacity_for(FULL_ROWS, P)
    radix_cases = radix_phase(torch, cap, flush)
    radix_cases += radix_phase(torch, cap, flush, skewed=True)
    radix_cases += radix_phase(torch, cap, flush, moe=True)
    segsum_cases = segsum_phase(torch, cap, flush)
    segsum_cases += segsum_phase(torch, cap, flush, skewed=True)
    flash_cases = flash_phase(torch, flush)
    ssd_cases = ssd_phase(torch, flush)
    del flush
    phase_done("kernels")
    launches, route_launches, segsum_routes, walls, layouts = \
        main_path_phase(torch)
    for k in ("radix_partition", "segmented_sum"):
        check(launches["bsp/first"][k] > 0, f"{k} never launched on the "
              f"Fig-9 path")
    phase_done("fig9")
    flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device="cuda")
    radix_cases += radix_phase(torch, cap, flush, layouts)
    del flush
    phase_done("radix layouts")
    front_launches, front_walls = frontend_phase(torch, smi=smi)
    phase_done("frontend")
    str_launches, str_walls = strings_phase(torch)
    phase_done("strings")
    # the stacked runs the process-group phase holds its processes to
    kept = {"dir": tempfile.mkdtemp(prefix="chip_smoke_files_")}
    ooc, (ooc_layouts, ooc_sums) = out_of_core_phase(torch, keep=kept)
    for k in ("radix_partition", "segmented_sum"):
        check(ooc["launches"]["first"][k] > 0, f"{k} never launched on the "
              f"out-of-core path")
    flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device="cuda")
    radix_cases += radix_phase(torch, cap, flush, ooc_layouts)
    segsum_cases += segsum_phase(torch, cap, flush, ooc_sums)
    # one rank a process (the process-group phase's out-of-core runs hand
    # each process's kernels one rank of these shapes): rank 0's inputs
    radix_cases += radix_phase(
        torch, cap, flush, {k.replace("ooc:", "process:ooc:"): v
                            for k, v in ooc_layouts.items()}, ranks=1)
    segsum_cases += segsum_phase(
        torch, cap, flush, [(k.replace("ooc:", "process:ooc:"),
                             ids[:1].contiguous(), vals[:1].contiguous(), s)
                            for k, ids, vals, s in ooc_sums])
    del flush, ooc_sums
    phase_done("out-of-core")
    ingest = ingest_phase(torch, keep=kept)
    ingest["strings"] = ingest_strings_phase(torch)
    phase_done("ingest and analyze")
    skew = skew_phase(torch)
    phase_done("skew")
    fault_walls = faults_phase(torch, keep=kept)
    phase_done("faults")
    serving, (serve_dests, serve_sums) = query_serving_phase(torch, smi=smi,
                                                             keep=kept)
    for k in ("radix_partition", "segmented_sum"):
        check(serving["concurrent"]["launches"][k] > 0, f"{k} never "
              f"launched by the served queries")
    flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device="cuda")
    radix_cases += radix_phase(torch, cap, flush, recorded=serve_dests)
    segsum_cases += segsum_phase(torch, cap, flush, serve_sums)
    # one rank a process in a gang of 2 processes (the process-group
    # phase's served queries): rank 0's inputs
    radix_cases += radix_phase(torch, cap, flush, recorded=[
        (k.replace("serve:", "process:serve:"), dest[:1].contiguous(), nb)
        for k, dest, nb in serve_dests])
    segsum_cases += segsum_phase(torch, cap, flush, [
        (k.replace("serve:", "process:serve:"), ids[:1].contiguous(),
         vals[:1].contiguous(), s) for k, ids, vals, s in serve_sums])
    del flush, serve_dests, serve_sums
    phase_done("query serving")
    parity_phase()
    degrade_phase()
    unsigned_phase()
    phase_done("fig9 parity, degrade, unsigned")
    served = serve_phase(torch, smi)
    phase_done("serve")
    served_bf16 = serve_bf16_phase(torch, smi)
    phase_done("serve bf16")
    serve_parity_phase(torch)
    phase_done("serve parity")
    moe_shuffle = moe_shuffle_phase(torch, smi)
    phase_done("moe shuffle dispatch")
    # the dry run's processes use the host's CPU only: they run beside
    # the device-bound train phases
    dry_started = dryrun_start()
    # so do the dataframe examples' CPU runs
    examples_started = examples_start()
    first_batches = {}
    train = train_phase(torch, smi, keep=first_batches)
    phase_done("train")
    train_moe = train_phase(torch, smi, arch="olmoe-1b-7b",
                            keep=first_batches)
    phase_done("train olmoe")
    train_parity_phase(torch)
    phase_done("train parity")
    flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device="cuda")
    ssd_autograd = ssd_grad_phase(torch, flush)
    del flush
    phase_done("ssd autograd")
    reset_counts()
    sharded = sharding_phase(
        torch, smi, {"mamba2-780m": train, "olmoe-1b-7b": train_moe},
        first_batches, served[SHARD_SERVE[0]])
    phase_done("sharding")
    dry = dryrun_phase(torch, smi, sharded, dry_started)
    phase_done("dry run")
    # last: its serving and hand-off runs are held to the query serving
    # phase's stacked gangs, and the dry run's host processes are done
    try:
        process_group = process_group_phase(torch, smi, kept=kept)
    finally:
        shutil.rmtree(kept["dir"], ignore_errors=True)
    phase_done("process group")
    examples = examples_phase(torch, smi, examples_started)
    phase_done("examples")

    rp, ss = radix_partition_cuda, segmented_sum_cuda
    kernels = [
        # the Fig-9 path is the first bsp run; every run's count beside it
        kernel_record(rp, radix_cases, launches["bsp/first"][rp.name],
                      {run: c[rp.name] for run, c in launches.items()},
                      route_launches["bsp/first"],
                      {run: c[rp.name]
                       for run, c in ooc["launches"].items()},
                      {run: c[rp.name]
                       for run, c in ingest["launches"].items()},
                      {sw: serving[sw]["launches"][rp.name]
                       for sw in ("serial", "concurrent")}),
        # every segmented-sum launch of every main path took the sorted
        # route (launch_counts checks it at each read)
        kernel_record(ss, segsum_cases, launches["bsp/first"][ss.name],
                      {run: c[ss.name] for run, c in launches.items()},
                      segsum_routes["bsp/first"],
                      launches_out_of_core={
                          run: c[ss.name]
                          for run, c in ooc["launches"].items()},
                      launches_ingest={
                          run: c[ss.name]
                          for run, c in ingest["launches"].items()},
                      launches_serving={
                          sw: serving[sw]["launches"][ss.name]
                          for sw in ("serial", "concurrent")}),
        # the serving paths are the first run of each arch
        kernel_record(flash_attention_cuda, flash_cases,
                      served["qwen3-8b"]["first"]["launches"][
                          flash_attention_cuda.name]),
        kernel_record(ssd_scan_cuda, ssd_cases,
                      served["mamba2-780m"]["first"]["launches"][
                          ssd_scan_cuda.name]),
    ]
    # every served arch's first run (prefill and 32 decode steps), beside
    # the Fig-9 count above: radix on the MoE archs' dispatch, flash on the
    # attention layers, the SSD scan on the mamba layers
    for rec in kernels:
        rec["launches_model_serving"] = {
            arch: runs["first"]["launches"][rec["name"]]
            for arch, runs in served.items()}
    kernels[0]["launches_moe"] = {
        "shuffle_dispatch": moe_shuffle["shuffle"]["radix_launches"],
        "grouped_dispatch": moe_shuffle["grouped"]["radix_launches"],
        "olmoe_train_step": train_moe["radix_launches_per_step"]}
    # the SSD scan also runs in every mamba2-780m train step (forward and
    # remat recomputation; the counts read in each timed step); its
    # gradient is the plain version's
    # one rank per process: each process's launches in each group run
    for rec in kernels[:2]:
        rec["launches_process_group"] = {
            label: r["launches_per_process"][rec["name"]]
            for label, r in process_group["runs"].items()
            if "launches_per_process" in r}
    kernels[-1]["launches_train_step"] = train["ssd_launches_per_step"]
    # the sharded path (a (1, 1) mesh over NCCL): each kernel's launches in
    # each sharded run
    for rec in kernels:
        rec["launches_sharded"] = {
            arch: r.get("launches", r.get("generate_launches"))[rec["name"]]
            for arch, r in sharded.items()}
    kernels[-1]["train_shape"] = ssd_autograd
    # the dry run (fake tensors: the operators' calls, not launches) of
    # each world-1 configuration and of the production cell
    for rec in kernels:
        rec["dryrun_calls"] = {
            **{j: p["kernel_calls"].get(rec["name"], 0)
               for j, p in dry["predicted"].items()},
            "/".join(DRYRUN_CELL): dry["production"]["kernel_calls"].get(
                rec["name"], 0)}
    print(json.dumps({"fig9_wall_s": walls}))
    print(json.dumps({"skew": skew}))
    print(json.dumps({"faults_wall_s": fault_walls}))
    print(json.dumps({"out_of_core": ooc}))
    print(json.dumps({"ingest": ingest}))
    print(json.dumps({"frontend_wall_s": front_walls,
                      "frontend_launches": front_launches,
                      "strings_wall_s": str_walls,
                      "strings_launches": str_launches}))
    print(json.dumps({"serve": {arch: {run: {k: v for k, v in r.items()
                                             if k != "prefill_launches"}
                                       for run, r in runs.items()}
                                for arch, runs in served.items()},
                      "serve_bf16_prefill": {"qwen3-8b": served_bf16}}))
    print(json.dumps({"moe_shuffle": moe_shuffle}))
    print(json.dumps({"train": train, "train_olmoe": train_moe,
                      "ssd_autograd": ssd_autograd}))
    print(json.dumps({"process_group": process_group}))
    print(json.dumps({"sharding": sharded}))
    print(json.dumps({"dryrun": dry}))
    print(json.dumps({"query_serving": serving}))
    print(json.dumps({"examples": examples}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
