#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit, no result line):

1. the card: its name and power limit as ``nvidia-smi`` reports them;
2. build every kernel from the sources in this checkout, one ``nvcc`` per
   source, all started together;
3. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes, with its CUDA-graph device time, its bound and the plain
   time; WKV6 also with w over [0, 1) holding zeros, and at a ragged
   T = 513, and its time at 1-4 heads per SM with the SM clock and power
   draw under that load; the backward kernels of WKV6 and the RG-LRU scan
   against their plain reverse sweeps at the training shapes (2, 4096, 64,
   64) and (1, 4096, 4096) and the serving prefill's, WKV6's also at a
   ragged T = 513, with w holding zeros and with nonzero s0 and ds_fin;
   both WKV6 kernels also at phase 19's share of a pod, (1, 4096, 64, 64);
   the RG-LRU scan forward also at the training shape, both RG-LRU
   kernels at two D that are no multiple of their 32-channel tiles; the
   white-data filter and the CRDT merge also at small odd shapes, the merge
   also at 1 to 3,400 rows (fewer than 32 rows a warp), bit for bit; the
   joins straight into a table's rows, ``crdt_join_rows`` (the store's
   join, the WAN commit's and the views' kernel: (epoch, seq, node)
   compared, versions, lengths and presence written in the same pass) and
   the ranked ``crdt_merge_rows``, at small odd shapes in every payload
   dtype and into a table at an odd offset (triples tied in each
   component, equal, Version.ZERO, LOAD_VERSION, absent rows), then at a
   YCSB commit's 3,400 rows of 250 int32 words and TPC-C's 34,000 rows of
   30 (120 B) into a table of 10,000,000 rows, row 9,999,999 among them,
   whole tables and ``took`` bit for bit; at both commits the device time
   of each, every row taken, against its bound, beside the join it
   replaced (``version_rank``, the ranked kernel, three columns written),
   the library's calls and the plain version; the dense merge's at (3,400,
   250);
4. rwkv6-7b at full width and depth, on its f32 weights: prefill + stepwise
   decode against the full forward, in f32 and bf16 compute, each decode
   position gated against a multiple of the noise floor measured in the same
   run without the cache; a decode fed a zeroed WKV state must fail the gate;
5. rwkv6-7b served through ``repro_torch.launch.serve``: batch 8, prompts of
   512 tokens, 32 generated tokens (one from prefill, 31 decode steps), with
   every kernel's launch count read around it, and the device time of a
   prefill and of a decode step by kernel from ``torch.profiler``;
6. recurrentgemma-9b at full width and all 38 layers, on its f32 weights:
   the check of phase 4 (linear attention cache), failed on purpose by a
   decode fed a zeroed RG-LRU state and by one fed a zeroed KV cache;
7. the local-attention ring cache, which the main path's 544-position cache
   never reaches: batch 2, a prompt of exactly the window (2048), 8 decode
   steps that wrap the ring, against the full forward (banded attention),
   f32, all 38 layers, gated as in phase 6;
8. recurrentgemma-9b served as in phase 5;
9. ``filter_gradient`` (the white-data filter) over one device's share of
   the rwkv6-7b gradient: the embedding, lm_head, final norm and 6 of the 32
   blocks (129 leaves, 1,853,681,664 elements), two rounds of error
   feedback, f32 g and r, then bf16 g and f32 r, each leaf bit-exact
   against the plain version; the tree's device time against its bound;
10. ``crdt_merge_many`` over three replicas of a YCSB table (10,000,000
   records of 10 fields x 100 bytes, held as 250 int32 words, int32
   versions), bit-exact against the plain fold, ACI at full size, and one
   merge's device time against its bound; a commit's 3,400 rows joined into
   the merged table by their int32 versions through ``crdt_merge_rows``'s
   API, counted;
11. minitron-8b (global attention, no kernel of the port on its path):
   ``flash_attention`` against ``dense_attention`` on the card at (2, 2056,
   32 q heads, 8 kv heads, 128), f32 and bf16, with the device time of each
   and of PyTorch's ``scaled_dot_product_attention`` as a yardstick only;
   then at full width and all 32 layers on its f32 weights, the check of
   phase 4 on a linear KV cache in f32 and bf16, and a long prompt (batch 2,
   2048 tokens + 8 decode steps) against the full forward over 2056 tokens,
   which goes through ``flash_attention`` (asserted); a decode fed a zeroed
   KV cache must fail each;
12. minitron-8b served as in phase 5, every kernel's count 0;
13. granite-moe-3b-a800m (top-8 of 40 experts, tied embeddings) at full width
   and all 32 layers: the check of phase 11 on a copy of the config whose
   capacity factor (5.0 = experts / top-k) drops nothing, and the drop
   rate at the published 1.25 at the prefill and decode shapes;
14. granite-moe-3b-a800m served as in phase 5, at the published capacity
   factor, every kernel's count 0;
15. rwkv6-7b training at full width, 8 of its 32 layers (f32 parameters,
   gradients, m and v take 16 B a parameter: 121 GB for the whole model,
   36.7 GB for 8 layers): (a) the gradients of every leaf through the
   kernels against those with both wrappers swapped for the plain
   recurrences (f32, batch 2 x 64), each mixer leaf nonzero on both paths;
   (d) microbatches 1 and 2 on the same step; (b) the main path: 4 steps of
   ``launch.train.train()`` at batch 2 x 4096 in bf16 compute with remat,
   every kernel's count read around it (WKV6 forward 2 x 8 a step: the
   forward and remat's recompute; backward 8); (c) the loss falls over 5
   steps on one repeated batch, the last step profiled (device busy share,
   the kernels' share of its device time);
16. recurrentgemma-9b training, the same checks, full width, 3 of 38 layers
   (one rglru, rglru, attn_local repetition), batch 1 x 4096 through banded
   attention; RG-LRU forward 2 x 2 and backward 2 a step;
17. granite-moe-3b-a800m training, the same checks but (a), at full width
   and 16 of 32 layers (27.0 GB of state; cut for the run's time limit),
   batch 1 x 4096 through the plain
   flash attention and MoE dispatch, every kernel's count 0;
18. demo-100m (``examples/train_100m.py``): 40 steps of ``train()`` at
   batch 8 x 256, the loss must fall; the same run saved at step 20 and
   resumed by a fresh ``train()`` must match it bit for bit;
19. rwkv6-7b across two pods: two ranks spawned on the card, joined over
   gloo (``launch.mesh.run_local_ranks``), each training at full width and
   2 layers on its 1 x 4096 rows of a 2 x 4096 global batch, bf16 compute,
   remat: 2 steps of ``train()`` with geococo (density 0.10, chunk 2048,
   min_leaf_size 4096, relay ring (1, 0)), then 1 with flat, the WKV6
   counts read around each run in each rank (2 x 2 forward, 2 backward a
   step).  Gated: finite losses; every pod's parameters bit-identical after
   every step (``pods_agree``, from per-leaf checksums); the wire values
   counted from the masks and the dense leaves equal to
   ``estimate_sync_bytes`` (the wire model, which counts a (value, index)
   pair a selection) over the grouped tree; after one geococo step
   every filtered leaf's residual nonzero and different between the pods;
   geococo at density 1.0 equal to flat from the same state.  Printed per
   step: compute, the exchange's device and host (staging + gloo) parts,
   AdamW, the bytes handed to gloo (the whole masked tensors: gloo's
   all-reduce sums dense values on the host).  The same two ranks then
   compute phase 21's yardstick on their (2, 1, 1) mesh;
20. geococo's chunked top-k (``topk_select``) over phase 9's gradient share,
   one process, no exchange: its device time by CUDA events against its
   bound (16 B an element), beside the white-data filter's;
21. rwkv6-7b on a (2, 2, 1) mesh: four ranks spawned on the card, joined
   over gloo, each holding its blocks of the parameters, of AdamW's m and v
   and of the residuals (``data`` splits dim 0 of every 2-d leaf), at full
   width and 2 layers on its 1 x 4096 rows of a 4 x 4096 global batch,
   bf16 compute, remat: 1 step of ``train()`` with hier (relay ring
   (1, 0)), then 2 with geococo at phase 19's settings, the WKV6 counts
   read around each run in each rank.  Gated: finite losses, the same on
   every rank; the blocks of every pod group bit-identical after every
   step, and the whole leaves of every pod (the step raises otherwise);
   the wire values counted equal to the per-rank wire model
   (``estimate_sync_bytes`` over the rank's blocks; printed beside the
   reference's ``shard_factor`` form); after one geococo step every
   filtered residual block nonzero and different between the pods;
   geococo at density 1.0 equal to hier from the same state, bit for bit;
   one hier step against one on (2, 1, 1) with 2 microbatches (phase 19's
   two ranks) from the same state and batch, each gradient leaf within 4 x
   its noise floor (the batch's rows reversed) or 1e-3 of its norm.
   Printed per step and rank: compute, the in-pod gathers and
   reduce-scatters and the pod exchange (device and host parts), AdamW,
   the bytes to gloo in-pod and across the pods; peak memory a rank; hier's
   bytes across the pod against phase 19's flat on (2, 1, 1);
22. granite-moe-3b-a800m on a (1, 2, 2) mesh: four ranks spawned on the
   card, at full width and 2 of 32 layers on a 2 x 4096 global batch (1 x
   4096 a data rank, shared along model), the published capacity factor
   1.25, bf16 compute, remat, hier: each rank computes 12 of the 24 q
   heads (4 of the 8 kv heads) and 20 of the 40 experts, summed over
   model, on expert weights gathered over data; 2 steps of ``train()``,
   every kernel's count read around them in each rank.  Gated: finite
   losses, the same on every rank; the whole leaves of the pod
   bit-identical after every step (the step raises otherwise); every
   kernel's count 0; step 1 in f64 compute from the same state and batch
   against one process on (1, 1, 1) with 2 microbatches (one a data
   rank's row, so each routes its 4096 tokens alone, as the reference's
   expert parallelism does): each synced gradient leaf within 4 x its
   noise floor (the yardstick from parameters one f64 ulp off) or 1e-3 of
   its norm, the loss within 1e-4, each rank's MoE drop rate equal to its
   microbatch's (f64, because an f32 reassociation can flip a routing
   near-tie at this size, a different routing rather than a rounding).  Printed per step and
   rank: compute, the in-pod gathers and reduce-scatters (device and host
   parts), the model sums and count prefix (``tp_s``), AdamW, the bytes to
   gloo in-pod and of the model sums (``tp_bytes``), the drops; peak memory
   a rank;
23. the trainer (``train.trainer.Trainer``) on four pods: four ranks
   spawned on the card as a (4, 1, 1) mesh over gloo, rwkv6-7b at full
   width and 1 of 32 layers on 1 x 4096 rows a rank of a 4 x 4096 global
   batch, bf16 compute, remat, hier, under a ``ControlPlane`` over the
   reference test's 4-node square for one round, then the square with its
   (0, 1) and (2, 3) links spiked; 5 steps, an asynchronous checkpoint at
   step 3 (after the ring change) into a temporary directory, a
   ``FaultInjected`` on every rank before step 5, rolled back to step 3 and
   step 4 replayed; the WKV6 counts read around ``run()``.  Gated: the
   ``RelayOrderChanged`` orders (0, 1, 2, 3) then ``relay_ring_order`` of
   the spiked square, (0, 2, 1, 3), and at least 2 step rebuilds; every
   rank the same ring, event list and records before every step; the pods
   agree after every step; the replayed step's loss and gradient norm
   equal its first run's bit for bit, and the run ends at step 5; WKV6 2
   forward and 1 backward a layer, step and rank, the replay included;
   finite losses that fall.  Printed per step and rank: the ring the step
   ran on, compute, the exchange (device and host), AdamW, the bytes to
   gloo; the straggler trips (the reference's threshold 1.5 and sustain 3,
   on the slowest rank's step time), the checkpoint's blocking part and
   its writer thread's time; peak memory a rank;
24. deepseek-v3-671b (MLA, a shared expert and 256 routed experts, top 8)
   at full width and 4 of its 61 layers (the 3 dense-prefix MLA blocks and
   one MLA + MoE block; 60.44 GB of f32 weights): (a) ``mla_apply`` alone
   on one layer's f32 weights at (2, 2056), without a cache (through
   ``flash_attention``, asserted) against the cached prefill of the same
   input (dense over the cache), within 1e-5 of the output's largest
   value; (b) the check of phase 4 at batch 2, prompt 32 and 8 decode steps
   on an MLA cache, f32 and bf16, on a copy of the config whose capacity
   factor (32 = experts / top-k) drops nothing, failed on purpose by a
   decode fed a zeroed MLA cache (ckv, kr); (c) the drop rate at the
   published 1.25 as phase 13 measures it; (d) served as in phase 5 at
   1.25, every kernel's count 0;
25. llama-3.2-vision-90b at full width and 5 of its 100 layers (4
   self-attention blocks and the cross-attention block) with an image
   context of (B, 1601, 8192) drawn from the seed, given to every call: the
   check of phase 4, failed on purpose by a zeroed KV cache and, in f32, by
   decode steps fed another image context than the prefill's (it moves the
   logits by ~3% of the largest, below bf16's limit); served as in phase 5
   with the image context, every kernel's count 0;
26. hubert-xlarge (encoder-only, the frames frontend) at full width and all
   48 layers: ``flash_attention`` against ``dense_attention`` at (1, 4096,
   16, 16, 80), not causal, f32; the prefill step (``launch.serve.encode``)
   over 8 x 512 frames in f32 and bf16 compute, every kernel's count 0,
   with its time, frames/s, device busy share and peak memory; bf16 within
   2e-2 of f32's largest logit over the first 4 layers (over all 48 bf16's
   rounding grows past it, printed); row 0's last frame changed moves row 0's
   first position and leaves rows 1-7 bit for bit; a 1 x 4096 forward
   through the non-causal ``flash_attention`` in every layer (asserted);
27. deepseek-v3-671b training at full width, its 3 dense-prefix layers of
   61 (MLA and the dense FFN of d_ff 18432; 3,603,815,424 parameters, 57.7
   GB of f32 state; from here on the allocator grows its segments),
   batch 1 x 4096 (MLA through flash, chunks of 1024): the checks of
   phase 17 through ``launch.train.train()``, every kernel's count 0;
28. hubert-xlarge training at full width and 16 of its 48 layers (cut for
   the run's time limit), batch 1 x 4096 frames drawn from the seed (non-causal
   flash), 504 codebook targets: the checks of phase 17 through
   ``build_train_step`` (``train()``'s pipeline yields tokens only), every
   kernel's count 0;
29. llama-3.2-vision-90b's cross block alone at full width (one
   ``attn_cross`` + dense block with the embedding and the untied head;
   2,957,008,896 parameters), batch 8 x 512 with an image context of (8,
   1601, 8192) from the seed (dense cross-attention): the checks of phase
   28; then one ``torch.no_grad()`` forward of it at 1 x 4096 over a
   1601-token image, which takes ``flash_attention`` with one key a chunk
   (1601 is prime): its wall and device time, the kv chunk steps counted
   (4 x 1601 = 6,404 expected, gated) and the f32 accumulators a training
   step would keep for them, reckoned (not attempted);
30. serving on a (1, 2, 2) mesh: four ranks of one gloo group on the card,
   each with the whole f32 weights, its rows of the batch and its part of
   the cache (``build_serve_step(mesh=)``): (a) granite-moe-3b-a800m at full
   width and 16 of 32 layers, 8 x 512 + 32 (heads and experts split over model, the
   cache whole along its sequence), then served through ``serve(mesh=)`` at
   the published 1.25 in bf16, and its no-drop copy's bf16 decode (the
   weights as serve() casts them) held against one process' within 4 x a
   floor or 2e-2 of the largest logit; (b) minitron-8b at 4 of 32 layers and (c)
   deepseek-v3-671b at 1 of 61 (an MLA block), 2 prompts of 8192 tokens
   prefilled in chunks and 8 decode steps on a cache of 8200 positions split
   along its sequence over model.  Each part's decode steps in f32 against
   one process on the card fed the same tokens, within 4 x a floor or 1e-4
   of the largest logit, failed on purpose in (b) and (c) by zeroed
   model-rank-1 shards; every kernel's count 0; the cache leaves at
   ``cache_specs``' local shapes; the model ranks of a row bit-identical.
   Printed: each part's prefill and decode times, the bytes to gloo a step
   (the merge's apart), rank 0's device time a step, peak memory a rank;
31. the dry-run (``launch.dryrun``) against the card: (a) phase 15's
   rwkv6-7b training step and phase 14's granite-moe-3b-a800m prefill,
   each run once more under ``launch.cost.CostMode`` in its phase (on its
   weights and state), dry-run on the meta device as one process with the
   same config, shape and dtypes: FLOPs and bytes equal, exactly; the
   dry-run's peak against ``torch.cuda.max_memory_allocated()`` over that
   step, within PEAK_BAND, and a training dry-run given no optimizer state
   outside it; each step's roofline bound beside its measured time; (b)
   rank 0 of phase 22's (1, 2, 2) training step and of phase 30 (a)'s
   prefill and decode steps, dry-run on meta over the fake process group:
   the bytes of the pod exchange, of the in-pod gathers and reduce-scatters
   and of the ``model`` sums and merges equal rank 0's counts there, to the
   byte;
32. the WAN sync plane: ``GeoCluster``'s epoch pipeline (OCC validation,
   the white-data filter, the CRDT commit through ``crdt_join_rows``) on a YCSB
   store of 10,000,000 records of 1000 B on the card, every record loaded
   before epoch 0 (YCSB's load phase), Zipf 0.99, 50/50
   reads and updates, 4 operations a transaction, 10% rewrites; 5 nodes on
   the paper's testbed trace at 120 Mbps, 1000 transactions a node an
   epoch, kcenter, 20 epochs of flat, then of geococo.  Gated: (a) at
   200,000 loaded keys and 5 epochs, flat and geococo under the event and
   barrier engines on the card equal to the same runs on the CPU (every
   ``EpochStats`` and ``RunSummary`` field, ``FilterStats``, the message
   matrix, both digests; modeled filter CPU); (b) at full size flat and
   geococo end in the same state and value digests; (c) ``crdt_join_rows``
   launched once an epoch (one commit each) in each main run, every other
   kernel 0.  Printed: the host's SHA-256 rate; the store's set-up and load
   before the epochs and ``run()``'s two digests (one pass) after them,
   each apart, and the state digest alone; each epoch's wall split
   into host draws, the copy to the card with its gathers, device work and
   host work (planner, schedules, simulator); committed and aborted (read,
   write-write); WAN bytes and the white byte ratio; peak memory; the
   device busy share over the first 5 epochs of a third run (geococo), its
   store loaded before (torch.profiler's device time against that window's
   wall) and the commit kernel's device time, launch by launch, against the
   bound of the rows each took;
33. TPC-C on the card: (a) ``benchmarks/bench_throughput.py``'s regime (the
   paper's testbed trace, 10 Gbps LAN / 15 Mbps WAN, 100 warehouses x 50
   items, remote 0.25, 40 transactions a node, MILP, 10 epochs), the four
   mixes under flat and geococo on the card equal to the same runs on the
   CPU as in 32 (a), flat and geococo one state; (b) 100 warehouses x
   100,000 items (STOCK's rows, TPC-C clause 1.3.1) of 120 B loaded before
   epoch 0, TPCC-A, remote 0.10, phase 32's testbed at 120 Mbps, 1000
   transactions a node an epoch, kcenter, 5 epochs of flat, then of
   geococo, gated and printed as 32 (b), (c), with tpmTotal and the
   NewOrder count; (d) (b)'s settings from an empty store with the
   filter's CPU modeled, flat then geococo, one state: printed in the form
   in which ``tests/tpcc_full_reference.py`` prints the reference's runs
   on the CPU, and set beside (b)'s runs;
34. the streaming engine and per-node views (``streaming=True``,
   ``staleness_feedback=True``: each node's view a table on the card,
   advanced by joining whole committed epochs through ``crdt_join_rows``
   once the stitched simulation has delivered them): (a) Fig 11a's streaming
   arm (33 (a)'s TPCC-A geococo regime, 10 ms) and the abort curve (the same
   regime, kcenter, with feedback, at 10, 80 and 320 ms), 10 epochs each, on
   the card equal to the CPU as in 32 (a) (the view lags and the views'
   joins too); the 80 ms run again with ``stream_mode="resim"``, equal to
   the incremental one; without feedback, the stream's digests those of
   the formula engine's run; (b) phase 32's loaded 10^7-key YCSB store and
   testbed, geococo, 20 epochs at 320 ms, streaming without feedback (its
   digests, commits and WAN bytes those of phase 32's geococo run) and with
   it (five views on the card; its write-write aborts the first run's),
   then phase 33 (b)'s loaded TPC-C database with feedback, 5 epochs;
   (c) ``crdt_join_rows`` launched once a commit and once a view and epoch
   merged, every other kernel 0.  Printed: each epoch's wall split with the
   views' part, the stream's wall and pipeline overlap against the
   formula's, read aborts and view lags, peak memory against the tables'
   reckoning, the device busy share over 5 epochs of a third feedback run
   (its views made before the window), each view's join against the bound
   of the rows it took, and the host's side of those joins, traced;
   (c-ii) of phase 35: the feedback runs serve a million clients a node over
   their views (``ServeConfig``), their serving summary printed;
35. WAN compression, the serving plane and the Raft plane: (a) Fig 16's
   quick regime (``benchmarks/bench_compression.py``: 8 nodes, 40 Mbps WAN,
   YCSB, modeled CPU), baseline, zlib, geococo and geococo+zlib on the card
   equal to the same runs on the CPU as in 32 (a), one state, the
   normalized makespans the reference's; (b) ``geococo-zlib`` on phase 32's
   loaded store and settings, filter and compression CPU measured: its
   digests phase 32's geococo run's; printed the WAN bytes against
   geococo's, each epoch's wall with compression apart (the records'
   streams built on the card, their copies to the host, zlib there), zlib's
   rate and ratio; (c-i) ``benchmarks/bench_serving.py``'s quick regime
   (TPCC-A streamed at 10 ms, 24 epochs, a million clients a node, redirect,
   a 200-key cache) at bounds 0, 50 ms and 1e9 ms and flat at 50 ms: the
   card's ``ServeStats`` equal to the CPU's, serving on = off in digests,
   WAN bytes and times, the reference's served reads/s; (d) Fig 11b's
   ``RaftCluster`` (host numpy) without and with bandwidth, the reference's
   gains; ``crdt_join_rows`` launched once a commit in (a)-(c), every
   other kernel 0;
36. the static-analysis package (``repro_torch.analysis``): (a) the model
   checker's smoke tier, its five theorems one by one, the table theorems
   (CRDT confluence, OCC atomicity, abort monotonicity, eviction and the
   serving prefix) on tables on the card, every join through
   ``crdt_join_rows``: each theorem's instances and info the reference's,
   zero violations, each wall time and join count printed; its four seeded
   mutants rejected with the reference's count of violations each; (b) phase
   32's geococo run on the loaded 10^7-key store again with
   ``verify_schedules=True`` (its digests and every ``EpochStats`` field but
   the measured filter CPU's times phase 32's, one schedule verified an
   epoch), and phase 34 (b)'s five-view run, modeled filter CPU, 8 epochs,
   verified against unverified (every field, both digests, the read
   aborts; two schedules verified an epoch); the verifier's host time an
   epoch against the epoch's wall; (c) every mutator of
   ``repro_torch.analysis.mutate`` on a round of (b) or on the stream its
   rounds stitch into makes ``WANSimulator(verify=True)`` raise
   ``ScheduleVerificationError`` naming its rule.

Each model's weights are released before the next one's are drawn (no two
fit on one 80 GB card together): rwkv6-7b, then recurrentgemma-9b.  Phases 9
and 10 start on an empty card, after recurrentgemma-9b's weights are
released, and phases 11, 13, 15-30 and 32-36 each on an empty card after the
phase before; phase 31 allocates nothing on the card.  Each phase prints its
wall time.

The line before the last lists the kernels as JSON; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
import json
import math
import statistics
import subprocess
import tempfile
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet), for the bound of each kernel
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12          # float32 outside the tensor cores
L2_BYTES = 50 * 2**20

RWKV, RG = "rwkv6-7b", "recurrentgemma-9b"
DENSE, MOE = "minitron-8b", "granite-moe-3b-a800m"
BATCH, PROMPT_LEN, GEN_LEN = 8, 512, 32
CHECK_PROMPT, CHECK_STEPS = 64, 4
# phases 7, 11 and 13: a long prompt, then decode steps
LONG_BATCH, LONG_PROMPT, LONG_STEPS = 2, 2048, 8
# phases 24-26: MLA, cross-attention and the frames frontend at full width.
# deepseek-v3-671b at 4 of 61 layers (the 3 dense-prefix MLA blocks and one
# MLA + MoE block: the least depth that holds every block kind; 15.1e9
# parameters, 60.44 GB in f32); MLA alone at (2, 2056), above 2048 tokens,
# where its uncached path attends blockwise; the decode check at batch 2 x
# (32 + 8): drop-free dispatch (capacity factor 256 / 8 = 32) holds a
# buffer of E x t rows of d_model, 0.59 GB at t = 80 where the served 8 x
# 512 would need 30 GB beside the weights.  llama-3.2-vision-90b at 5 of
# 100 layers (4 self-attention blocks and the cross-attention block: one
# period of its pattern).  hubert-xlarge whole (48 layers); a 1 x 4096
# forward through the non-causal flash attention.
MLA_ARCH, VLM_ARCH, AUDIO_ARCH = "deepseek-v3-671b", "llama-3.2-vision-90b", "hubert-xlarge"
MLA_LAYERS, VLM_LAYERS = 4, 5
MLA_ALONE_BATCH, MLA_ALONE_SEQ, MLA_ALONE_TOL = 2, 2056, 1e-5
MLA_CHECK_BATCH, MLA_CHECK_PROMPT, MLA_CHECK_STEPS = 2, 32, 8
AUDIO_LONG = 4096
# hubert's bf16 step is held against f32 over its first 4 layers (8 x 512
# frames): over all 48 random layers bf16's rounding grows past 2e-2 of the
# largest logit, in the reference as in the port
AUDIO_BF16_LAYERS = 4
# phases 27-29: training the models of phases 24-26 at full width, each cut
# to what 16 B a parameter of f32 state leaves room for on the card:
# deepseek-v3-671b's MLA_TRAIN_LAYERS dense-prefix blocks (one MoE block
# alone holds 11.27e9 expert parameters, 180 GB of state) at 1 x 4096: two
# peaked at 60.97 GB of the card's 85.02 (NVIDIA H100 80GB HBM3, 700 W),
# which leaves room for the third; hubert-xlarge at 1 x 4096 frames and
# AUDIO_TRAIN_LAYERS of its 48 layers (whole, its phase took 46.2 to 51.2 s
# of a run that must end in 1200 s; a step's time goes with the depth);
# llama-3.2-vision-90b's cross block alone (five layers, one period, would
# be 102 GB) at 8 x 512, where 512 x 1601 scores stay dense.  Then that block's forward at 1 x
# HAZARD_SEQ, through flash with kv chunks of 1 (1601 is prime): measured
# without grad; a training step there would keep an f32 accumulator per
# chunk step
MLA_TRAIN_LAYERS, AUDIO_TRAIN_LAYERS = 3, 16
MLA_TRAIN_SHAPE, AUDIO_TRAIN_SHAPE, VLM_TRAIN_SHAPE = (1, 4096), (1, 4096), (8, 512)
HAZARD_SEQ = 4096

# kernel vs plain, f32, relative to the output scale.  WKV6: the plain
# version sums y through a batched matmul in another order.  RG-LRU: the
# same recurrence, one FMA per step in the kernel where the plain version
# rounds the product and the sum; the recurrence is contractive, so the
# difference stays a few ulps of the state.
WKV6_TOL = 2e-5
RGLRU_TOL = 1e-5
# WKV6 backward kernel vs the plain reverse sweep, relative to each
# gradient's scale: the same f32 sweep, with the contractions summed in
# another order and the states recomputed by FMA from checkpoints every 8
# steps where the plain version keeps each state; over T = 4096 steps the
# dS recurrence carries those roundings along.  (The RG-LRU backward is held
# to RGLRU_TOL: the same products and sums, the carry maybe an FMA.)
WKV6_BWD_TOL = 1e-4
# the backward kernels' shapes on the training path (phases 15 and 16)
TRAIN_WKV_SHAPE = (2, 4096, 64, 64)
TRAIN_RG_SHAPE = (1, 4096, 4096)
# the RG-LRU kernels' tiles are 32 channels wide, so a D that is no multiple
# of 32 leaves a masked edge tile: of 4 channels at D = 100, copied 16 bytes
# at a time; at D = 45, no multiple of 4, the copies are of 4 bytes
RAGGED_RG_SHAPES = ((1, 33, 100), (2, 37, 45))
RGLRU_REDESIGN = "redesigned: 32-channel tiles, cp.async ring, one pass"
BACKWARD_NOTE = ("new, no Pallas counterpart: the reference differentiates %s with "
                 "autodiff; 'replaces' names the forward's TPU kernel")
# prefill + stepwise decode vs the full forward, at full depth.  The two
# differ only in the shapes of their GEMMs and reductions (B rows per decode
# step, B x 68 in the full forward), so their sums run in another order,
# and a random model of 32 or 38 layers amplifies that far beyond one
# rounding.  decode_limit measures this noise floor in the same run,
# changing only the row counts and with no cache involved, as the larger
# of: the last prompt position of a prompt-only forward, and the decode
# positions of the full forward run one sequence at a time, each against
# the full forward of the batch.  A decode position passes within
# FLOOR_MULT x that floor, or within DECODE_TOL where the floor is smaller
# (relative to the largest logit: f32 with TF32 off leaves room for
# summation order only; bf16 is the tolerance of tests/test_archs_smoke.py).
# A wrong state, token shift or layer cache is not a reordering of sums:
# each check shows that decode steps fed a zeroed part of the cache fail
# the same limit.
FLOOR_MULT = 4.0
DECODE_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# flash vs dense attention, relative to the output scale: in f32 the online
# softmax only reorders the max and the sums (a few ulps); in bf16 flash
# rounds p before it is normalised, dense after (the bf16 tolerance above)
FLASH_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# injected cache faults: the cache leaves zeroed before every decode step
RWKV_FAULTS = {"a zeroed WKV state": ("s",)}
ATTN_FAULTS = {"a zeroed attention KV cache": ("k", "v")}
MLA_FAULTS = {"a zeroed MLA cache (ckv, kr)": ("ckv", "kr")}
RG_FAULTS = {"a zeroed RG-LRU state (h, conv)": ("h", "conv"), **ATTN_FAULTS}
GEMM_KERNEL_MARKS = ("gemm", "nvjet", "xmma", "cutlass")

# phase 9: the gradient tree one device holds when the rwkv6-7b trainer
# shards it over data x model = 2 x 2 (7.56e9 / 4 = 1.89e9 elements).  Cut to
# 6 of the 32 blocks: the reference's stats["total"] is int32, which holds
# 7 blocks at most, and four f32 trees of the whole model would take 121 GB.
FILTER_BLOCKS = 6
TAU = 1.6449        # keeps 10% of N(0, 1): the reference's SyncConfig.density
# phase 10: YCSB's CoreWorkload record (fieldcount=10 x fieldlength=100 =
# 1,000 bytes, 250 int32 words), 10M records, replication factor 3; ~1% of
# the rows tie on the top version with different payloads
YCSB_ROWS, YCSB_WORDS, REPLICAS = 10_000_000, 250, 3
# phase 3: the join of a WAN commit (phase 32 joins ~3,400 distinct rows an
# epoch) into a table of YCSB_ROWS rows
JOIN_ROWS, JOIN_TABLE_ROWS = 3400, YCSB_ROWS
# and TPC-C's commit (phase 33 joins ~34,000 distinct rows an epoch) of 120-byte
# rows, 30 int32 words
TPCC_JOIN_ROWS, TPCC_WORDS = 34_000, 30
TIE_SHARE = 0.01
MERGE_CHUNK = 1_000_000
# phases 15-17: (a) and (d) at GRAD_BATCH x GRAD_SEQ, f32 with TF32 off;
# (b) TRAIN_STEPS steps of train(); (c) FALL_STEPS steps on one batch.  (a):
# the two paths differ in the recurrences' order of sums (WKV6_TOL,
# RGLRU_TOL in one call); (d): the batch's mean is taken in two halves and
# the GEMMs see half the rows.  Random full-width layers amplify any such
# reordering, and some gradients are rounding noise around an exact 0, so
# each leaf is gated at FLOOR_MULT x its own noise floor, which the same run
# measures (train_grad_checks), or at TRAIN_GRAD_TOL (1e-5 for the loss)
# where that floor is smaller.  A floor above FLOOR_CAP of a leaf's norm
# fails the phase: a gate that wide would pass anything.
GRAD_BATCH, GRAD_SEQ = 2, 64
TRAIN_STEPS, FALL_STEPS, FALL_LR = 4, 5, 1e-5
TRAIN_GRAD_TOL = 1e-3
FLOOR_CAP = 0.1
# phase 18: demo-100m, cut and resumed
DEMO_STEPS, DEMO_CUT = 40, 20


# phase 19: rwkv6-7b at full width across two pods, both ranks on the one
# card over gloo: 2 layers (with 1 the stacking of the scan region would be
# invisible), global batch 2 x 4096 (1 x 4096 a pod), the reference's
# geococo defaults with the relay ring (1, 0)
POD_LAYERS, POD_BATCH, POD_SEQ = 2, 2, 4096
POD_GEO_STEPS, POD_FLAT_STEPS = 2, 1
POD_SYNC = dict(density=0.10, chunk=2048, min_leaf_size=4096, ring_order=(1, 0))
POD_TIMEOUT = 600
# phase 21: rwkv6-7b at full width and 2 layers on a (2, 2, 1) mesh, four
# ranks on the one card, each holding its blocks of the parameters, of m, v
# and of the residuals (data splits dim 0 of every 2-d leaf); global batch
# 4 x 4096 (1 x 4096 a rank): hier on the relay ring (1, 0), then geococo at
# POD_SYNC; one hier step held against one on (2, 1, 1) with 2 microbatches
INPOD_MESH, INPOD_BATCH = (2, 2, 1), 4
INPOD_HIER_STEPS, INPOD_GEO_STEPS = 1, 2
INPOD_TIMEOUT = 900
# phase 22: granite-moe-3b-a800m at full width and 2 of its 32 layers (for
# the run's time limit: at 8 this phase took 127.5 s of a 1086 s run, at 4
# and 3 steps 91.3 s of a 1026 s run, on the NVIDIA H100 80GB HBM3, 700 W)
# on a (1, 2, 2) mesh, four ranks on the one
# card: attention heads and experts split over model, the expert weights gathered over data; global batch 2 x
# 4096 (1 x 4096 a data rank, shared along model), the published capacity
# factor, bf16, remat, hier: TP_STEPS steps of train().  Step 1 is held in
# f64 compute against one process on (1, 1, 1) with 2 microbatches (each a
# data rank's row: the reference's expert-parallel routing) from the same
# state and batch: gradients at FLOOR_MULT x their floor (the yardstick
# from parameters one f64 ulp off) or TRAIN_GRAD_TOL, the loss at
# TP_LOSS_TOL, each rank's drop rate equal to its microbatch's.  Not in
# f32: routing is discrete, and at 8 layers x 8192 tokens an f32
# reassociation (the split sums over model) flips an assignment at a
# near-tie now and then, which moves late layers' gradients by 1e-3 of
# their norm; in f64 such a tie is ~1e9 times rarer
TP_MESH, TP_LAYERS, TP_BATCH, TP_STEPS = (1, 2, 2), 2, 2, 2
TP_CAPACITY, TP_LOSS_TOL, TP_CHECK_DTYPE = 1.25, 1e-4, "float64"
TP_TIMEOUT = 600
# phase 23: the trainer on four pods.  A ring order can change only with
# four pods or more (every 2- and 3-node ring is one canonical ring), so
# four ranks share the card, which sets the depth: rwkv6-7b at full width
# and 1 of its 32 layers (16 B a parameter of state, ~16 GB a rank), 1 x
# TRAINER_SEQ rows a rank of a 4 x TRAINER_SEQ global batch, bf16, remat,
# hier.  The
# control plane sees the reference test's 4-node square for one round (the
# test holds it two; one spares a step of ~12 s of the run's time limit),
# then the square with its (0, 1) and (2, 3) links spiked
# (tests/test_control_plane.py:33-49): the ring is (0, 1, 2, 3) from step 2
# and (0, 2, 1, 3) from step 4.  A checkpoint lands at step 3, after the
# change; a FaultInjected on every rank before step 5 rolls back to it, so
# step 4 replays under the ring of its first run.  AdamW at its defaults,
# as in phases 19 and 21: a warm-up of 100 steps keeps the first steps'
# learning rate small (with 6e-4 after 2 warm-up steps the loss rose from
# 11.79 to 15.04 in 6 steps at this width).
TRAINER_MESH, TRAINER_LAYERS, TRAINER_BATCH = (4, 1, 1), 1, 4
TRAINER_STEPS, TRAINER_CKPT_EVERY, TRAINER_FAULT_AT = 5, 3, 4
# the sequence is not cut: at 4096 a rank peaked at 17.54 to 18.61 GB, 74 GB
# of the card's 80 for the four ranks, and at 2048 at the same: the peak is
# the exchange's (state, gradient, the ring's held messages), not the
# activations'
TRAINER_SEQ = 4096
TRAINER_TIMEOUT = 900
SQUARE_MS = ((0.0, 10.0, 14.0, 10.0), (10.0, 0.0, 10.0, 14.0),
             (14.0, 10.0, 0.0, 10.0), (10.0, 14.0, 10.0, 0.0))
SPIKE_MS, SQUARE_ROUNDS = 100.0, 1
# phase 30: serving on a (1, 2, 2) mesh, four ranks of one gloo group on the
# card, each holding the whole f32 weights (serving writes none; the
# reference's p_shard would spread them over data).  (a) granite-moe-3b-a800m
# at full width and 16 of 32 layers, phase 14's 8 x 512 + 32: a data rank's 4
# rows, a model rank's 12 of 24 q heads, 4 of 8 kv heads and 20 of 40
# experts, the 544-position cache whole along its sequence; its gate in f32
# compute on the no-drop copy (capacity factor 5.0, as phase 13), then
# served through serve(mesh=) at the published 1.25 in bf16, which casts the
# weights; with them, the no-drop copy's bf16 decode from the f32-prefilled
# cache, gated against one process' the same way (DECODE_TOL["bfloat16"]).
# (b)
# minitron-8b at full width and 4 of 32 layers, 2 prompts of 8192 tokens and
# 8 decode steps on a cache of 8200 positions, split over model (4100 a
# model rank, all 8 kv heads); (c) deepseek-v3-671b at full width and 1 of
# 61 layers (a dense-prefix MLA block), as (b) on its latent cache.  The
# prompts of (b) and (c) go through the cached step in chunks: in one piece
# a row's prefill would hold 8.4 GB of logits and 8.6 GB of f32 scores; (c)
# at 512, where a rank's MLA scores over 128 heads are 2.1 GB a chunk of
# 1024.  Each part's MESH_STEPS decode steps, in f32, against one process
# on the card fed the same tokens (run first, its logits kept on the host):
# a rank's rows' logits within FLOOR_MULT x a floor (that one process over
# each data rank's rows alone, against all rows) or DECODE_TOL; (b) and (c)
# must fail it on a decode whose model-rank-1 shard of every layer's cache
# is zeroed.  The depth cuts of (b) and (c) are for the card's 80 GB with
# four ranks on it; (a)'s, to 16 layers, is for the run's time limit (whole,
# the script took 977 to 1026 s of its 1200 on the NVIDIA H100 80GB HBM3,
# 700 W).
MESH_SERVE = (1, 2, 2)
MESH_SERVE_TIMEOUT = 900
MESH_STEPS = 8
MESH_NO_DROP = 5.0
SPLIT_BATCH, SPLIT_PROMPT, SPLIT_STEPS = 2, 8192, 8
MESH_PARTS = (
    {"tag": "(a)", "arch": MOE, "layers": 16, "batch": BATCH, "prompt": PROMPT_LEN,
     "max_len": PROMPT_LEN + GEN_LEN, "chunk": None, "capacity": MESH_NO_DROP, "zero": False,
     "serve": True},
    {"tag": "(b)", "arch": DENSE, "layers": 4, "batch": SPLIT_BATCH, "prompt": SPLIT_PROMPT,
     "max_len": SPLIT_PROMPT + SPLIT_STEPS, "chunk": 1024, "capacity": None, "zero": True,
     "serve": False},
    {"tag": "(c)", "arch": MLA_ARCH, "layers": 1, "batch": SPLIT_BATCH, "prompt": SPLIT_PROMPT,
     "max_len": SPLIT_PROMPT + SPLIT_STEPS, "chunk": 512, "capacity": None, "zero": True,
     "serve": False},
)
# phase 32: the WAN sync plane (GeoCluster's epoch pipeline).  A YCSB store of
# WAN_KEYS records of YCSB CoreWorkload's default record, 10 fields x 100
# bytes (phase 10's), on the card, every record loaded before epoch 0 (YCSB's
# load phase, CoreWorkload's recordcount): 10.0 GB of values, 0.33 GB of
# versions, lengths and flags.  Zipf theta 0.99 (YCSB's zipfian constant), workload A's 50/50
# read/update mix, 4 operations a transaction, 10% of writes rewriting the
# key's current value (the null rule's white data), no hot set; 5 nodes on
# the paper's testbed (examples/geo_database_sim.py: 2 Kalgan, 2 Hohhot,
# 1 Hong Kong) at 120 Mbps, WAN_TXNS transactions a node an epoch, kcenter,
# WAN_EPOCHS epochs of flat, then of geococo (cut from the 60 of the
# example for the phase's 60 s); gate (a) at WAN_CHECK_KEYS keys and
# WAN_CHECK_EPOCHS epochs, card against CPU; the device busy share over
# WAN_PROFILE_EPOCHS epochs of a second geococo run
WAN_KEYS, WAN_VALUE_BYTES, WAN_TXNS, WAN_EPOCHS = 10_000_000, 1000, 1000, 20
# (gate (a)'s keys cut from 10^6 to 2 x 10^5 for the whole script's time,
# 1108 s at 10^6 with phase 34 on an H100 host: its CPU runs hash and
# gather the whole loaded store)
WAN_CHECK_KEYS, WAN_CHECK_EPOCHS, WAN_PROFILE_EPOCHS = 200_000, 5, 5
# the phase's limit: 60 s on a store that started empty; a loaded store adds
# its load and each run's two digests over ~10.2 GB a stream, hashed on the
# host at its SHA-256 rate (~10 s a run), and the gate's CPU runs' digests
WAN_BANDWIDTH_MBPS, WAN_PHASE_LIMIT_S = 120.0, 150.0
WAN_TESTBED = ((0.0, 1.5, 8.0, 8.5, 42.0), (1.5, 0.0, 8.2, 8.0, 43.0),
               (8.0, 8.2, 0.0, 1.8, 38.0), (8.5, 8.0, 1.8, 0.0, 39.0),
               (42.0, 43.0, 38.0, 39.0, 0.0))
WAN_REGIONS = (0, 0, 1, 1, 2)
# phases 32 and 33: the seed of the values loaded before epoch 0
LOAD_SEED = 7
# phase 33: TPC-C on the card.  (a) benchmarks/bench_throughput.py's regime
# (the paper's 5-node testbed trace with Kalgan and Hohhot one region and
# Hong Kong the other, 10 Gbps LAN / 15 Mbps WAN, 100 warehouses x 50 items,
# remote 0.25, TPCC_CHECK_TXNS transactions a node, MILP), TPCC_CHECK_EPOCHS
# epochs of each mix, card against CPU; (b) the database at full size:
# TPCC_WAREHOUSES (examples/geo_database_sim.py:52) x TPCC_ITEMS (TPC-C
# v5.11 clause 1.3.1: STOCK holds W x 100,000 rows) rows of 120 B
# (NewOrder's width), every row loaded before epoch 0, TPCC-A (the paper's
# write-intensive mix), remote 0.10 (TPCCConfig's default), phase 32's
# testbed at 120 Mbps, TPCC_TXNS transactions a node an epoch, kcenter,
# TPCC_EPOCHS epochs of flat, then of geococo; (d) the same from an empty
# store with the filter's CPU modeled, as tests/tpcc_full_reference.py runs
# the reference.  TPCC_EPOCHS cut from 10 to 5 for the whole script's time
# (1140 s with phase 35 on a slow H100 host, whose SHA-256 ran at 2.08 GB/s
# in two threads): an epoch at this size is ~0.7 s of host draws
TPCC_WAREHOUSES, TPCC_ITEMS, TPCC_VALUE_BYTES = 100, 100_000, 120
TPCC_TXNS, TPCC_EPOCHS = 1000, 5
TPCC_CHECK_TXNS, TPCC_CHECK_EPOCHS = 40, 10
TPCC_BENCH_REGIONS = (0, 0, 0, 0, 1)
TPCC_MIXES_ORDER = ("TPCC-A", "TPCC-B", "TPCC-C", "TPCC-D")
# phase 34: the streaming engine and per-node views.  (a) Fig 11a's streaming
# arm (benchmarks/bench_throughput.py:85-91: phase 33 (a)'s TPCC-A geococo
# regime, MILP, 10 ms, streaming) and the abort curve
# (benchmarks/bench_abort_curve.py:46-60: the same regime, kcenter, streaming
# with feedback) at STREAM_CURVE_MS, TPCC_CHECK_EPOCHS epochs each, card
# against CPU; (b) phase 32's loaded YCSB store and phase 33 (b)'s loaded
# TPC-C database at full size, geococo, at STREAM_EPOCH_MS: the abort
# curve's top cadence, near the full-size stores' sync makespan (~0.3-0.6 s),
# so that the views join epochs within the run (at the default 10 ms no
# epoch commits anywhere before the last one arrives, and no view would
# ever advance); the busy share over STREAM_PROFILE_EPOCHS epochs of a third
# YCSB feedback run
STREAM_CURVE_MS = (10.0, 80.0, 320.0)
STREAM_EPOCH_MS, STREAM_PROFILE_EPOCHS, STREAM_PHASE_LIMIT_S = 320.0, 5, 90.0
# phase 35: WAN compression, the serving plane and the Raft plane.  (a) Fig
# 16's quick regime (benchmarks/bench_compression.py:16-31, its cluster from
# benchmarks/common.py:60-65: FIG16_NODES nodes, seed FIG16_SEED,
# FIG16_EPOCHS trace steps; 40 Mbps WAN under a 10 Gbps LAN; YCSB over
# 20,000 keys, theta 0.7, hot writes 0.35, rewrites 0.10, 100 B values;
# FIG16_TXNS transactions a node; MILP; modeled CPU), card against CPU, and
# the normalized makespans the reference gives on the CPU; (b) geococo-zlib
# on phase 32's loaded store; (c-i) benchmarks/bench_serving.py's quick
# regime (phase 33 (a)'s TPCC-A regime streamed at 10 ms, SERVE_EPOCHS epochs
# of SERVE_TXNS transactions a node, modeled CPU, SERVE_CLIENTS clients a
# node reading 95% of the time, redirect, a SERVE_CACHE_KEYS-key cache) at
# the bounds of SERVE_RPS, flat against geococo at SERVE_BOUND_MS, with the
# reference's served reads/s on the CPU (SERVE_RPS); (c-ii) phase 34 (b)'s feedback runs serve
# SERVE_CLIENTS clients a node at SERVE_BOUND_MS over their views; (d) Fig
# 11b (benchmarks/bench_throughput.py:102-115) on wan_cluster(RAFT_NODES,
# RAFT_STEPS, seed=RAFT_SEED), without bandwidth as the benchmark runs it
# and with the bandwidth matrix wan_cluster returns, with the reference's
# gains on the CPU
FIG16_NODES, FIG16_SEED, FIG16_EPOCHS, FIG16_TXNS = 8, 41, 20, 15
FIG16_NORM = {"baseline": 1.0, "zlib": 0.99005, "geococo": 0.47124, "geococo+zlib": 0.46476}
SERVE_EPOCHS, SERVE_TXNS, SERVE_CLIENTS, SERVE_CACHE_KEYS = 24, 20, 1_000_000.0, 200
SERVE_BOUND_MS = 50.0
SERVE_RPS = {("geococo", 0.0): 30_711, ("geococo", 50.0): 214_980,
             ("geococo", 1e9): 737_075, ("flat", 50.0): 132_449}
RAFT_NODES, RAFT_STEPS, RAFT_SEED = 9, 30, 11
RAFT_PAYLOADS = {"YCSB-A": 64_000.0, "YCSB-B": 24_000.0, "YCSB-C": 12_000.0,
                 "YCSB-D": 24_000.0}
# the reference's gains (%, to 0.1): one figure without bandwidth (the
# benchmark passes none), YCSB-A's and YCSB-C's with it
RAFT_GAINS = {False: {"YCSB-A": 12.0, "YCSB-B": 12.0, "YCSB-C": 12.0, "YCSB-D": 12.0},
              True: {"YCSB-A": 25.1, "YCSB-C": 14.8}}
PLANES_PHASE_AIM_S = 45.0
# phase 36: the static-analysis package on the card.  (a) the model checker
# (repro_torch.analysis.modelcheck) at its smoke tier, all five theorems and
# the self-test, its table theorems on the card's tables: each theorem's
# instances and info the reference's (python -m repro.analysis.modelcheck
# --tier smoke on the CPU), each seeded mutant's violations the reference's
# (the quick tier's table theorems take ~1.5 min on an H100, PERF.md: over
# the phase's aim, so not run here); (b) phase 32's geococo run on the loaded
# 10^7-key YCSB store again with verify_schedules=True (its digests and every
# EpochStats field but the measured filter CPU's times as phase 32's), and
# phase 34 (b)'s five-view YCSB streaming run with verify_schedules=True,
# modeled filter CPU, cut to VERIFY_VIEW_EPOCHS epochs, against an
# unverified run of the same cut (every field, both digests, the read
# aborts); (c) every mutator of repro_torch.analysis.mutate on a schedule of
# (b) rejected by WANSimulator(verify=True)
MODELCHECK_SMOKE = {
    "admission": (1840, {"valid_accepted": 1840, "mutants": "840/840", "corpus_size": 38,
                         "corpus_max_loss": 0.4257907542579076}),
    "confluence": (14, {"universe": 4}),
    "occ_atomicity": (7992, {"write_skew_instances": 48}),
    "abort_monotonicity": (1024, {"views": 3}),
    "eviction_prefix": (196, {"grids": [(2, 3)]}),
}
MODELCHECK_MUTANTS = {"broken-admission-ranking": 38, "non-commutative-merge": 6,
                      "occ-reinstatement": 378, "frontier-under-read": 196}
VERIFY_VIEW_EPOCHS = 8
ANALYSIS_PHASE_AIM_S = 60.0
# phase 31: the band that the card's peak memory over a step (after a reset)
# must hold against the dry-run's peak of live storage: the caching
# allocator rounds each block up to 512 bytes and keeps cuBLAS' workspaces,
# which the dry-run does not see; a step without AdamW's m and v (8 B a
# parameter) must fall outside it
PEAK_BAND = (0.97, 1.05)
# the records every rank holds alike (not its host times, nor its counts of
# its own nonzero values)
SHARED_RECORD = ("step", "loss", "grad_norm", "lr", "pods_agree", "dense_values",
                 "sparse_values", "bytes_sent")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def device_ms(calls: list, reps: int = 5) -> float:
    """Device time of one call: the ``calls`` captured in one CUDA graph and
    replayed between two CUDA events, so host dispatch is left out.  Median
    over ``reps`` replays, divided by the number of calls."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls[0]()                              # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(calls))
    del graph
    return statistics.median(times)


def dispatch_ms(fn, reps: int = 50) -> float:
    """Median time of one eager call of ``fn`` between two CUDA events, host
    dispatch included: what the main path pays where the device waits on
    the host."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bound(nbytes: int, flops: int) -> tuple[float, str]:
    """Least time on the card (ms): bytes over the memory rate or f32
    operations over the f32 rate, whichever is larger."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / F32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def wkv6_input_bytes(b: int, t: int, h: int, n: int) -> int:
    """r/k/v/w, u and the initial state, float32."""
    return 4 * (4 * b * t * h * n + h * n + b * h * n * n)


def work_bound(w) -> tuple[float, str]:
    """``_bound`` of one call's work (``repro_torch.kernels.work``)."""
    return _bound(w.nbytes, w.flops)


def wkv6_bound(b: int, t: int, h: int, n: int) -> tuple[float, str]:
    """Least time for one WKV6 call (``kernels.work.wkv6``)."""
    from repro_torch.kernels import work

    return work_bound(work.wkv6(b, t, h, n))


def rglru_input_bytes(b: int, t: int, d: int) -> int:
    """a, b and h0, float32."""
    return 4 * (2 * b * t * d + b * d)


def rglru_bound(b: int, t: int, d: int) -> tuple[float, str]:
    """Least time for one RG-LRU scan (``kernels.work.rglru``)."""
    from repro_torch.kernels import work

    return work_bound(work.rglru(b, t, d))


def wkv6_inputs(gen, b, t, h, n, *, zero_state: bool, w_zeros: bool = False):
    """r, k, v ~ N(0, 1), w over [0.6, 0.999); with ``w_zeros`` w over
    [0, 1) with every 7th element 0 and every 11th 1e-35."""
    import torch

    def mk():
        return torch.randn((b, t, h, n), generator=gen, device="cuda")

    r, k, v = mk(), mk(), mk()
    w = torch.rand((b, t, h, n), generator=gen, device="cuda")
    if w_zeros:
        w.view(-1)[::7] = 0.0
        w.view(-1)[3::11] = 1e-35
    else:
        w = w * 0.399 + 0.6
    u = torch.randn((h, n), generator=gen, device="cuda") * 0.5
    s0 = torch.randn((b, h, n, n), generator=gen, device="cuda") * 0.1
    if zero_state:
        s0.zero_()
    return r, k, v, w, u, s0


def rglru_inputs(gen, b, t, d):
    import torch

    a = torch.rand((b, t, d), generator=gen, device="cuda") * 0.499 + 0.5
    bterm = torch.randn((b, t, d), generator=gen, device="cuda") * 0.5
    h0 = torch.randn((b, d), generator=gen, device="cuda")
    return a, bterm, h0


def check_close(name: str, got, want, tol: float) -> float:
    import torch

    err = (got - want).abs().max().item()
    scale = max(1.0, want.abs().max().item())
    if not bool(torch.isfinite(got).all()) or err > tol * scale:
        fail(f"{name}: max abs err {err:.3e} > {tol:g} x {scale:.3e}")
    print(f"  {name}: max abs err {err:.3e}, rel {err / scale:.2e} "
          f"(scale {scale:.3e}, tol {tol:g} x scale)")
    return err


def time_kernel(name, kernel, plain, make_inputs, shape, input_bytes, bound,
                n_sets: int | None = None) -> dict:
    """Device time of ``kernel`` at ``shape`` from a CUDA-graph replay that
    cycles enough input sets (at least 12, and at least twice the 50 MB L2)
    that the L2 cannot hold them from one call to the next, as on the main
    path, whose layers each bring their own inputs; the plain version's
    device time and one eager call's time beside it.  ``n_sets`` overrides
    the count where one set is far beyond the L2 and twelve would not fit."""
    if n_sets is None:
        n_sets = max(12, -(-2 * L2_BYTES // input_bytes(*shape)))
    sets = [make_inputs(*shape) for _ in range(n_sets)]
    ms = device_ms([functools.partial(kernel, *s) for s in sets])
    plain_ms = device_ms([functools.partial(plain, *sets[0])], reps=3)
    eager_ms = dispatch_ms(lambda: kernel(*sets[0]))
    bound_ms, bound_by = bound(*shape)
    print(f"  {name} {shape}: kernel {ms:.4f} ms on the device over {n_sets} input sets "
          f"({eager_ms:.4f} ms per eager call), plain {plain_ms:.3f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of bound")
    return {"shape": list(shape), "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "eager_call_ms": eager_ms}


def kernel_entry(name: str, source: str, replaces: str, errs: list, main: dict,
                 library_ms: float | None = None, **extra) -> dict:
    """The kernel's line of the JSON summary: ``main`` is its timing at the
    main path's shape; ``extra`` carries its timings at other shapes."""
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": None,          # filled in by the main path's run
        "max_abs_err": max(errs),
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": library_ms,
        "shape": main["shape"],
        **extra,
    }


def phase_wkv6(ops, wkv6_ref) -> dict:
    """WKV6 vs plain at the rwkv6 path's shapes and phase 19's share of a
    pod (library_ms: no single PyTorch call computes WKV6)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    errs, timings = [], {}
    cases = [
        ("prefill", (BATCH, PROMPT_LEN, 64, 64), True, False),
        ("decode", (BATCH, 1, 64, 64), False, False),
        ("w in [0, 1) with zeros", (BATCH, PROMPT_LEN, 64, 64), False, True),
        ("ragged T", (BATCH, PROMPT_LEN + 1, 64, 64), False, False),
        ("smoke head dim 16", (2, 64, 4, 16), False, False),
        ("pod share", (POD_BATCH // 2, POD_SEQ, 64, 64), True, False),
    ]
    for label, shape, zero, w_zeros in cases:
        args = wkv6_inputs(gen, *shape, zero_state=zero, w_zeros=w_zeros)
        y, s = ops.wkv6(*args)
        torch.cuda.synchronize()
        y_ref, s_ref = wkv6_ref(*args)
        errs.append(check_close(f"wkv6 {label} {shape} y", y, y_ref, WKV6_TOL))
        errs.append(check_close(f"wkv6 {label} {shape} state", s, s_ref, WKV6_TOL))
        if label in ("prefill", "decode"):
            timings[label] = time_kernel(
                "wkv6 " + label, ops.wkv6, wkv6_ref,
                lambda *sh, z=zero: wkv6_inputs(gen, *sh, zero_state=z),
                shape, wkv6_input_bytes, wkv6_bound)

    timings["heads_per_sm"] = wkv6_limiter(ops, gen)

    # state continuation: [0, t1) then [t1, T) with the carried state == one pass
    r, k, v, w, u, s0 = wkv6_inputs(gen, BATCH, PROMPT_LEN, 64, 64, zero_state=False)
    t1 = 200
    halves = [tuple(x[:, sl].contiguous() for x in (r, k, v, w))
              for sl in (slice(0, t1), slice(t1, None))]
    y1, s1 = ops.wkv6(*halves[0], u, s0)
    y2, s2 = ops.wkv6(*halves[1], u, s1)
    torch.cuda.synchronize()
    y_ref, s_ref = wkv6_ref(r, k, v, w, u, s0)
    errs.append(check_close("wkv6 continuation y", torch.cat([y1, y2], 1), y_ref, WKV6_TOL))
    errs.append(check_close("wkv6 continuation state", s2, s_ref, WKV6_TOL))
    return kernel_entry("wkv6", "src/repro_torch/csrc/wkv6.cu",
                        "src/repro/kernels/rwkv6_wkv/rwkv6_wkv.py:28", errs, timings["prefill"],
                        decode=timings["decode"], heads_per_sm_ms=timings["heads_per_sm"])


def wkv6_limiter(ops, gen) -> list:
    """What holds WKV6: its device time at T = 512 with 1, 2, 3, 4 heads per
    SM (B = 1, H = 132 n; the prefill has 512 heads, 3.9 per SM), and the
    card's SM clock and power draw, sampled by nvidia-smi every 100 ms while
    the 4-per-SM graph replays for a second.  Time that grows in proportion
    to the heads per SM is bound by throughput (instructions or memory), not by the
    latency of one head's chain."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    times = []
    for per_sm in (1, 2, 3, 4):
        shape = (1, PROMPT_LEN, sms * per_sm, 64)
        n_sets = max(12, -(-2 * L2_BYTES // wkv6_input_bytes(*shape)))
        sets = [wkv6_inputs(gen, *shape, zero_state=True) for _ in range(n_sets)]
        times.append(device_ms([functools.partial(ops.wkv6, *x) for x in sets]))
    print("  wkv6 heads per SM 1, 2, 3, 4 at T = 512: "
          + ", ".join(f"{ms:.4f} ms ({ms / PROMPT_LEN * 1e6:.1f} ns per step)" for ms in times))

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for x in sets:
            ops.wkv6(*x)
    with subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
             "-lms", "100"], stdout=subprocess.PIPE, text=True) as sampler:
        try:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 1.0:
                graph.replay()
                torch.cuda.synchronize()
        finally:
            sampler.terminate()
        out = sampler.communicate(timeout=60)[0]
    samples = []
    for line in out.splitlines():
        try:
            clock, power = (float(f) for f in line.split(","))
        except ValueError:
            continue
        samples.append((clock, power))
    del graph
    if samples:
        print(f"  under that load ({len(samples)} samples): SM clock "
              f"{min(c for c, _ in samples):.0f}-{max(c for c, _ in samples):.0f} MHz, "
              f"power draw up to {max(p for _, p in samples):.2f} W")
    return times


def phase_rglru(ops, rglru_scan_ref) -> dict:
    """RG-LRU scan vs plain at the recurrentgemma path's shapes (serving's
    prefill and decode, training's), an odd shape and two whose D is no
    multiple of the kernel's 32-channel tile, with a nonzero h0; its time
    at the three path shapes (library_ms: no single PyTorch call computes a
    stable linear recurrence)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    errs, timings = [], {}
    cases = [("prefill", (BATCH, PROMPT_LEN, 4096)), ("decode", (BATCH, 1, 4096)),
             ("training", TRAIN_RG_SHAPE), ("odd shape", (2, 37, 96)),
             *(("ragged tile", shape) for shape in RAGGED_RG_SHAPES)]
    for label, shape in cases:
        args = rglru_inputs(gen, *shape)
        h, h_last = ops.rglru_scan(*args)
        torch.cuda.synchronize()
        h_ref, last_ref = rglru_scan_ref(*args)
        errs.append(check_close(f"rglru_scan {label} {shape} h", h, h_ref, RGLRU_TOL))
        errs.append(check_close(f"rglru_scan {label} {shape} h_T", h_last, last_ref, RGLRU_TOL))
        if label in ("prefill", "decode", "training"):
            timings[label] = time_kernel(
                "rglru_scan " + label, ops.rglru_scan, rglru_scan_ref,
                lambda *sh: rglru_inputs(gen, *sh), shape, rglru_input_bytes, rglru_bound)

    a, b, h0 = rglru_inputs(gen, BATCH, PROMPT_LEN, 4096)
    t1 = 200
    h1, last1 = ops.rglru_scan(a[:, :t1].contiguous(), b[:, :t1].contiguous(), h0)
    h2, last2 = ops.rglru_scan(a[:, t1:].contiguous(), b[:, t1:].contiguous(), last1)
    torch.cuda.synchronize()
    h_ref, last_ref = rglru_scan_ref(a, b, h0)
    errs.append(check_close("rglru_scan continuation h", torch.cat([h1, h2], 1), h_ref,
                            RGLRU_TOL))
    errs.append(check_close("rglru_scan continuation h_T", last2, last_ref, RGLRU_TOL))
    return kernel_entry("rglru_scan", "src/repro_torch/csrc/rglru_scan.cu",
                        "src/repro/kernels/rglru_scan/rglru_scan.py:27", errs, timings["prefill"],
                        decode=timings["decode"], training=timings["training"],
                        note=RGLRU_REDESIGN)


def wkv6_backward_bound(b: int, t: int, h: int, n: int) -> tuple[float, str]:
    """Least time for one WKV6 backward (``kernels.work.wkv6_backward``)."""
    from repro_torch.kernels import work

    return work_bound(work.wkv6_backward(b, t, h, n))


def rglru_backward_bound(b: int, t: int, d: int) -> tuple[float, str]:
    """Least time for one RG-LRU backward (``kernels.work.rglru_backward``)."""
    from repro_torch.kernels import work

    return work_bound(work.rglru_backward(b, t, d))


def time_backward(name, kernel, plain, sets, shape, bound) -> dict:
    """Device time of ``kernel`` from a CUDA-graph replay over the input
    ``sets`` (each far beyond the 50 MB L2), and of the plain reverse sweep
    from CUDA events around one eager call (its T steps are thousands of
    small launches, too many to capture)."""
    import torch

    ms = device_ms([functools.partial(kernel, *s) for s in sets], reps=3)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    plain(*sets[0])
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    bound_ms, bound_by = bound(*shape)
    print(f"  {name} {shape}: kernel {ms:.4f} ms on the device over {len(sets)} input sets, "
          f"{ms / shape[1] * 1e3:.4f} us per step, plain {plain_ms:.3f} ms (one eager call), "
          f"bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of bound")
    return {"shape": list(shape), "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def check_grads(label: str, got, want, names, tol: float) -> list:
    return [check_close(f"{label} {n}", g, w, tol) for n, g, w in zip(names, got, want)]


def phase_wkv6_backward(ops, wkv6_backward_ref) -> dict:
    """The WKV6 backward kernel vs the plain reverse sweep at the training
    shape and phase 19's share of a pod (s0 and ds_fin zero, as training
    gives them), the serving prefill,
    a ragged T, w holding zeros, and head dim 16, each but the first with
    nonzero s0 and ds_fin; its time at the training and prefill shapes."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(5)
    names = ("dr", "dk", "dv", "dw", "du", "ds0")

    def inputs(b, t, h, n, zero=False, w_zeros=False):
        args = wkv6_inputs(gen, b, t, h, n, zero_state=zero, w_zeros=w_zeros)
        dy = torch.randn((b, t, h, n), generator=gen, device="cuda")
        ds_fin = torch.randn((b, h, n, n), generator=gen, device="cuda")
        return (*args, dy, ds_fin.zero_() if zero else ds_fin)

    errs, timings = [], {}
    cases = [("training", TRAIN_WKV_SHAPE, True, False),
             ("prefill", (BATCH, PROMPT_LEN, 64, 64), False, False),
             ("ragged T", (BATCH, PROMPT_LEN + 1, 64, 64), False, False),
             ("w in [0, 1) with zeros", (BATCH, PROMPT_LEN, 64, 64), False, True),
             ("smoke head dim 16", (3, 37, 5, 16), False, False),
             ("pod share", (POD_BATCH // 2, POD_SEQ, 64, 64), True, False)]
    for label, shape, zero, w_zeros in cases:
        args = inputs(*shape, zero=zero, w_zeros=w_zeros)
        got = ops.wkv6_backward(*args)
        torch.cuda.synchronize()
        errs += check_grads(f"wkv6_backward {label} {shape}", got, wkv6_backward_ref(*args),
                            names, WKV6_BWD_TOL)
        del got
        if label in ("training", "prefill"):
            sets = [args] + [inputs(*shape, zero=zero) for _ in range(2)]
            timings[label] = time_backward(f"wkv6_backward {label}", ops.wkv6_backward,
                                           wkv6_backward_ref, sets, shape, wkv6_backward_bound)
            del sets
        del args
        torch.cuda.empty_cache()
    return kernel_entry("wkv6_backward", "src/repro_torch/csrc/wkv6_backward.cu",
                        "src/repro/kernels/rwkv6_wkv/rwkv6_wkv.py:28", errs, timings["training"],
                        prefill=timings["prefill"], backward_of="wkv6",
                        note=BACKWARD_NOTE % "src/repro/models/rwkv6.py:96 (wkv6_chunked)"
                        + "; redesigned: row sums by warp shuffles, one barrier per chunk")


def phase_rglru_backward(ops, rglru_scan_ref, rglru_scan_backward_ref) -> dict:
    """The RG-LRU backward kernel vs the plain reverse scan at the training
    shape, the serving prefill, an odd shape and two whose D is no multiple
    of the kernel's 32-channel tile, with nonzero h0 and dh_last; its time
    at the training and prefill shapes."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(6)

    def inputs(b, t, d):
        a, bterm, h0 = rglru_inputs(gen, b, t, d)
        h, _ = rglru_scan_ref(a, bterm, h0)
        return (a, h, h0, torch.randn((b, t, d), generator=gen, device="cuda"),
                torch.randn((b, d), generator=gen, device="cuda"))

    errs, timings = [], {}
    for label, shape in (("training", TRAIN_RG_SHAPE), ("prefill", (BATCH, PROMPT_LEN, 4096)),
                         ("odd shape", (2, 37, 96)),
                         *(("ragged tile", shape) for shape in RAGGED_RG_SHAPES)):
        args = inputs(*shape)
        got = ops.rglru_scan_backward(*args)
        torch.cuda.synchronize()
        errs += check_grads(f"rglru_scan_backward {label} {shape}", got,
                            rglru_scan_backward_ref(*args), ("da", "db", "dh0"), RGLRU_TOL)
        if label in ("training", "prefill"):
            sets = [args] + [inputs(*shape) for _ in range(2)]
            timings[label] = time_backward(f"rglru_scan_backward {label}",
                                           ops.rglru_scan_backward, rglru_scan_backward_ref,
                                           sets, shape, rglru_backward_bound)
            del sets
        del args, got
        torch.cuda.empty_cache()
    return kernel_entry("rglru_scan_backward", "src/repro_torch/csrc/rglru_scan_backward.cu",
                        "src/repro/kernels/rglru_scan/rglru_scan.py:27", errs, timings["training"],
                        prefill=timings["prefill"], backward_of="rglru_scan",
                        note=BACKWARD_NOTE % "src/repro/models/rglru.py:66 (associative_scan)"
                        + "; " + RGLRU_REDESIGN)


def same_bits(name: str, got, want) -> float:
    """Fail unless ``got`` and ``want`` hold the same dtype, shape and bits
    (a NaN equals a NaN of the same bits); 0.0, the error of a bit-exact
    result."""
    import torch

    def bits(x):
        return x.reshape(-1).view(torch.int16 if x.element_size() == 2 else torch.int32)

    if got.dtype != want.dtype or got.shape != want.shape:
        fail(f"{name}: {got.dtype} {tuple(got.shape)} vs plain {want.dtype} {tuple(want.shape)}")
    if not torch.equal(bits(got), bits(want)):
        n = int((bits(got) != bits(want)).sum())
        fail(f"{name}: {n} of {got.numel()} elements differ from the plain version in their bits")
    return 0.0


def filter_bound(n: int, g_size: int, r_size: int) -> tuple[float, str]:
    """Least time for the filter over n elements
    (``kernels.work.whitedata_filter``)."""
    from repro_torch.kernels import work

    return work_bound(work.whitedata_filter(n, g_size, r_size))


def merge_bound(m: int, n: int, size: int) -> tuple[float, str]:
    """Least time for one merge of (m, n) payloads
    (``kernels.work.crdt_merge``)."""
    from repro_torch.kernels import work

    return work_bound(work.crdt_merge(m, n, size))


def phase_filter_small(ops, ref, dev) -> list:
    """The white-data filter vs plain at small odd shapes, every tau of
    note (0 and -1 keep all, inf keeps none) and a NaN input, bit for bit."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(2)
    dtypes = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
              (torch.bfloat16, torch.float32)]
    errs, cases = [], 0
    for shape in [(1000,), (3, 5, 7), (129,)]:
        for g_dt, r_dt in dtypes:
            g = torch.randn(shape, generator=gen, device=dev)
            g.view(-1)[::97] = float("nan")
            g, r = g.to(g_dt), (torch.randn(shape, generator=gen, device=dev) * 0.5).to(r_dt)
            for tau in (0.0, -1.0, TAU, float("inf")):
                got, want = ops.whitedata_filter(g, r, tau), ref(g, r, tau)
                for part, a, b in zip(("send", "new_r", "kept"), got, want):
                    errs.append(same_bits(f"whitedata_filter {shape} {g_dt}/{r_dt} tau {tau} "
                                          f"{part}", a, b))
                cases += 1
    print(f"  whitedata_filter: {cases} cases at (1000,), (3, 5, 7), (129,), f32/bf16 g and r, "
          "tau in {0, -1, 1.6449, inf}, NaN inputs: bit-exact")
    return errs


def merge_payload(gen, m: int, n: int, dtype):
    import torch

    if dtype == torch.int32:
        return torch.randint(-2**31, 2**31 - 1, (m, n), generator=gen, device=gen.device,
                             dtype=torch.int32)
    return torch.randn((m, n), generator=gen, device=gen.device).to(dtype)


def merge_batch(gen, m: int, n: int):
    """An (m, n) int32 payload and its (m,) int32 versions in [0, 8)."""
    import torch

    return (merge_payload(gen, m, n, torch.int32),
            torch.randint(0, 8, (m,), generator=gen, device=gen.device, dtype=torch.int32))


def phase_merge_small(ops, ref, dev) -> list:
    """The CRDT merge vs plain at small shapes, at 1 to 3,400 rows (where
    the launcher gives a warp fewer than 32 rows) and at 65536 rows, in
    every payload dtype, bit for bit."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(3)
    errs = []
    shapes = [(7, 250), (64, 100), (65536, 256), (1, 250), (31, 7), (33, 100), (JOIN_ROWS, 250)]
    for m, n in shapes:
        for dt in (torch.float32, torch.bfloat16, torch.int32):
            va, vb = (merge_payload(gen, m, n, dt) for _ in range(2))
            ra, rb = (torch.randint(0, 8, (m,), generator=gen, device=dev, dtype=torch.int32)
                      for _ in range(2))
            (ov, orr), (wv, wr) = ops.crdt_merge(va, ra, vb, rb), ref(va, ra, vb, rb)
            errs.append(same_bits(f"crdt_merge ({m}, {n}) {dt} values", ov, wv))
            errs.append(same_bits(f"crdt_merge ({m}, {n}) {dt} versions", orr, wr))
    print(f"  crdt_merge: {', '.join(map(str, shapes))} in f32, bf16 and int32: bit-exact")
    return errs


def join_bound(k: int, n: int, size: int, taken: int) -> tuple[float, str]:
    """Least time for one join of k rows of n elements into a table's
    columns, of which ``taken`` rows are taken
    (``kernels.work.crdt_join_rows``)."""
    from repro_torch.kernels import work

    return work_bound(work.crdt_join_rows(k, n, size, taken))


def ranked_bound(k: int, n: int, size: int, taken: int) -> tuple[float, str]:
    """Least time for one ranked join (``kernels.work.crdt_merge_rows``)."""
    from repro_torch.kernels import work

    return work_bound(work.crdt_merge_rows(k, n, size, taken))


def join_inputs(gen, r: int, k: int, n: int, dtype, *, top: int = 8, taken: bool = False):
    """k distinct rows of a table of r rows (row r - 1 among them), their
    ranks and a batch of k rows of n elements; with ``taken`` every row's
    new rank above its current one."""
    import torch

    dev = gen.device
    rest = torch.randperm(r - 1, generator=gen, device=dev)[:k - 1]
    rows = torch.cat([torch.full((1,), r - 1, device=dev), rest])
    cur = torch.randint(0, top, (k,), generator=gen, device=dev, dtype=torch.int32)
    new = (cur + torch.randint(1, top, (k,), generator=gen, device=dev, dtype=torch.int32)
           if taken else torch.randint(0, top, (k,), generator=gen, device=dev, dtype=torch.int32))
    return rows, cur, merge_payload(gen, k, n, dtype), new


# the values a check's (epoch, seq, node) components are drawn from: a few
# each, so that every component ties, with Version.ZERO's -1 and values
# past 2^31
TRIPLE_PARTS = ((-1, 0, 1, 2**33), (-1, 0, 5, 2**31 + 3), (-1, 0, 1, 4))


def few_triples(gen, m: int):
    """(m, 3) int64 versions, each component drawn from TRIPLE_PARTS, a
    sixteenth of the rows LOAD_VERSION (-1, 0, 0)."""
    import torch

    dev = gen.device
    cols = [torch.tensor(p, device=dev)[torch.randint(0, len(p), (m,), generator=gen, device=dev)]
            for p in TRIPLE_PARTS]
    ver = torch.stack(cols, 1)
    ver[torch.rand(m, generator=gen, device=dev) < 1 / 16] = torch.tensor([-1, 0, 0], device=dev)
    return ver


def join_table(gen, r: int, n: int, dtype, payload=None):
    """A table's four columns: r rows of n elements (``payload`` where
    given), versions from ``few_triples``, lengths in [0, 4n], and a tenth
    of the rows absent (Version.ZERO, length 0), as ``CRDTTable`` keeps
    them."""
    import torch

    dev = gen.device
    val = merge_payload(gen, r, n, dtype) if payload is None else payload
    ver = few_triples(gen, r)
    length = torch.randint(0, 4 * n + 1, (r,), generator=gen, device=dev)
    present = torch.rand(r, generator=gen, device=dev) >= 0.1
    ver[~present] = -1
    length[~present] = 0
    return val, ver, length, present


def join_batch(gen, table, k: int, dtype):
    """k distinct rows of ``table`` (row R - 1 among them) and a batch for
    them: versions from ``few_triples``, a quarter set equal to the row's
    own (all three components tie), a sixteenth ``Version.ZERO``; lengths
    in [0, 4n]."""
    import torch

    val, ver = table[0], table[1]
    r, n = val.shape
    dev = gen.device
    rest = torch.randperm(r - 1, generator=gen, device=dev)[:k - 1]
    rows = torch.cat([torch.full((1,), r - 1, device=dev), rest])
    new_ver = few_triples(gen, k)
    same = torch.rand(k, generator=gen, device=dev) < 0.25
    new_ver[same] = ver[rows[same]]
    new_ver[torch.rand(k, generator=gen, device=dev) < 1 / 16] = -1
    new_len = torch.randint(0, 4 * n + 1, (k,), generator=gen, device=dev)
    return rows, merge_payload(gen, k, n, dtype), new_ver, new_len


def same_values(name: str, got, want) -> None:
    """Fail unless two int64 or bool tensors are equal in dtype, shape and
    values."""
    import torch

    if got.dtype != want.dtype or got.shape != want.shape or not torch.equal(got, want):
        n = int((got != want).sum()) if got.shape == want.shape else got.numel()
        fail(f"{name}: {got.dtype} {tuple(got.shape)} differs from the plain version's "
             f"{want.dtype} {tuple(want.shape)} ({n} elements)")


def check_join(ops, join_ref, errs: list, label: str, table, batch) -> int:
    """``crdt_join_rows`` on ``table`` against the plain version on a copy:
    the values bit for bit, the versions, lengths, presence and ``took``
    equal; returns the rows taken."""
    import torch

    want = [c.clone() for c in table]
    want_took = join_ref(*want, *batch)
    took = ops.crdt_join_rows(*table, *batch)
    torch.cuda.synchronize()
    errs.append(same_bits(f"crdt_join_rows {label} values", table[0], want[0]))
    for part, got, ref in zip(("versions", "lengths", "presence"), table[1:], want[1:]):
        same_values(f"crdt_join_rows {label} {part}", got, ref)
    same_values(f"crdt_join_rows {label} took", took, want_took)
    return int(took.sum())


def join_library(table, rows, cur, new_val, new):
    """The ranked join in four PyTorch calls: a yardstick, used nowhere in
    the port."""
    import torch

    out = torch.where((new > cur)[:, None], new_val, table.index_select(0, rows))
    table.index_copy_(0, rows, out)
    return torch.maximum(cur, new)


def join_rows_library(val, ver, length, present, rows, new_val, new_ver, new_len):
    """``crdt_join_rows`` in PyTorch's calls (``index_select``, the
    lexicographic compare, ``where``, ``index_copy_`` for each column): a
    yardstick, used nowhere in the port."""
    import torch

    cur = ver.index_select(0, rows)
    e, s = new_ver[:, 0] == cur[:, 0], new_ver[:, 1] == cur[:, 1]
    took = (~present.index_select(0, rows) | (new_ver[:, 0] > cur[:, 0])
            | (e & (new_ver[:, 1] > cur[:, 1])) | (e & s & (new_ver[:, 2] > cur[:, 2])))
    val.index_copy_(0, rows, torch.where(took[:, None], new_val, val.index_select(0, rows)))
    ver.index_copy_(0, rows, torch.where(took[:, None], new_ver, cur))
    length.index_copy_(0, rows, torch.where(took, new_len, length.index_select(0, rows)))
    present.index_copy_(0, rows, present.index_select(0, rows) | took)
    return took


def ranked_join(merge_rows, val, ver, length, present, rows, new_val, new_ver, new_len):
    """The store's join as ``CRDTTable.join_rows`` ran it before
    ``crdt_join_rows`` (the join it replaced): both sides' triples ranked
    densely (``version_rank``), the ranked kernel, then the versions,
    lengths and presence of the rows taken written."""
    import torch

    from repro_torch.core.crdt import version_rank

    k = rows.numel()
    cur_ver = ver[rows]
    rank = version_rank(torch.cat([cur_ver, new_ver])).to(torch.int32)
    cur_rank, new_rank = rank[:k].contiguous(), rank[k:].contiguous()
    took = merge_rows(val, rows, cur_rank, new_val, new_rank) != cur_rank
    ver[rows] = torch.where(took[:, None], new_ver, cur_ver)
    length[rows] = torch.where(took, new_len, length[rows])
    present[rows] = present[rows] | took
    return took


def gather_merge_scatter(merge, table, rows, cur, new_val, new):
    """The commit's join before the indexed kernel: the table's rows
    gathered, merged with the batch by the dense kernel, scattered back."""
    out_val, out_rank = merge(table[rows], cur, new_val, new)
    table[rows] = out_val
    return out_rank


def rising_ms(fn, table, sets: list, reps: int = 5) -> dict:
    """Device and eager time of one ``fn(*table, rows, new_val, new_ver,
    new_len)`` over ``sets`` of (rows, values, lengths), every row taken in
    every call: each call gets versions made before, their epoch above every
    earlier call's (seq and node random), so that a join into the table's
    columns takes its rows again in each replay.  ``reps + 1`` CUDA graphs
    over the sets, the first replayed as a warm-up, each other once between
    two CUDA events (the median over them, a call's share); the eager time
    the median of 50 calls on the first set, host dispatch included."""
    import torch

    dev, k = sets[0][0].device, sets[0][0].numel()
    epoch = [int(table[1][:, 0].max()) + 1]

    def versions():
        ver = torch.randint(0, 2**40, (k, 3), device=dev)
        ver[:, 0] = epoch[0]
        epoch[0] += 1
        return ver

    def calls():
        return [functools.partial(fn, *table, rows, val, versions(), length)
                for rows, val, length in sets]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()[0]()                              # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graphs = []
    for _ in range(reps + 1):
        graph, made = torch.cuda.CUDAGraph(), calls()
        with torch.cuda.graph(graph):
            for call in made:
                call()
        graphs.append((graph, made))
    graphs[0][0].replay()
    torch.cuda.synchronize()
    times = []
    for graph, _ in graphs[1:]:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(sets))
    del graphs
    eager = iter([functools.partial(fn, *table, sets[0][0], sets[0][1], versions(), sets[0][2])
                  for _ in range(51)])
    eager_ms = dispatch_ms(lambda: next(eager)())
    return {"ms": statistics.median(times), "eager_call_ms": eager_ms}


def join_sets(gen, r: int, k: int, n: int) -> list:
    """Input sets past the L2 for a join of k rows of n int32 words into r
    rows: (rows, values, lengths), rows drawn anew for each set."""
    import torch

    set_bytes = 2 * (4 * k * n + 8 * k) + 48 * k
    out = []
    for _ in range(max(12, -(-2 * L2_BYTES // set_bytes))):
        rows = torch.randperm(r, generator=gen, device=gen.device)[:k]
        out.append((rows, merge_payload(gen, k, n, torch.int32),
                    torch.randint(0, 4 * n + 1, (k,), generator=gen, device=gen.device)))
    return out


def time_joins(ops, rows_ref, join_ref, gen, r: int, k: int, n: int, label: str) -> dict:
    """Both joins at one commit's shape (k rows of n int32 words into an
    r-row table, row r - 1 among them): first the whole table bit for bit
    (``crdt_join_rows``, then the ranked kernel), then, every row taken,
    over input sets past the L2, the device time of ``crdt_join_rows``
    against its bound, of the join it replaced (``ranked_join``), of the
    library's calls and of the plain version; then the ranked kernel's
    against its bound, the library's four calls and its plain version."""
    import torch

    errs = []
    dev = gen.device
    table = join_table(gen, r, n, torch.int32,
                       payload=torch.randint(-2**31, 2**31 - 1, (r, n), generator=gen,
                                             device=dev, dtype=torch.int32))
    taken = check_join(ops, join_ref, errs, f"({r}, {k}, {n}) int32", table,
                       join_batch(gen, table, k, torch.int32))
    torch.cuda.empty_cache()
    want = table[0].clone()
    rows, cur, new_val, new = join_inputs(gen, r, k, n, torch.int32)
    want_rank = rows_ref(want, rows, cur, new_val, new)
    got_rank = ops.crdt_merge_rows(table[0], rows, cur, new_val, new)
    errs.append(same_bits(f"crdt_merge_rows ({r}, {k}, {n}) int32 table", table[0], want))
    errs.append(same_bits(f"crdt_merge_rows ({r}, {k}, {n}) int32 out_rank", got_rank,
                          want_rank))
    del want
    torch.cuda.empty_cache()
    print(f"  {label}: {k:,} rows of {n} int32 words into a table of {r:,} rows "
          f"({table[0].numel() * 4 / 1e9:.2f} GB), row {r - 1:,} among them: crdt_join_rows "
          f"({taken:,} taken) and crdt_merge_rows, whole tables bit-exact")

    # ---- device times, every row taken (a commit into a store that holds
    # few of its keys, or holds them at older versions)
    sets = join_sets(gen, r, k, n)
    bound_ms, bound_by = join_bound(k, n, 4, k)
    new_kernel = rising_ms(ops.crdt_join_rows, table, sets)
    replaced = rising_ms(functools.partial(ranked_join, ops.crdt_merge_rows), table, sets)
    library = rising_ms(join_rows_library, table, sets)
    versions = table[1][sets[0][0]]
    versions[:, 0] += 1
    plain_ms = device_ms([functools.partial(join_ref, *table, sets[0][0], sets[0][1], versions,
                                            sets[0][2])], reps=3)
    print(f"  crdt_join_rows at {label} ({k:,} of {r:,} rows, {n} int32 words, every row "
          f"taken): {new_kernel['ms'] * 1e3:.2f} us on the device over {len(sets)} input sets "
          f"({new_kernel['eager_call_ms'] * 1e3:.2f} us per eager call), bound "
          f"{bound_ms * 1e3:.3f} us ({bound_by}), {bound_ms / new_kernel['ms']:.1%} of bound; "
          f"the join it replaced (version_rank, crdt_merge_rows, the three columns written) "
          f"{replaced['ms'] * 1e3:.2f} us ({replaced['eager_call_ms'] * 1e3:.2f} us per eager "
          f"call); the library's index_select + compare + where + index_copy_ of each column "
          f"{library['ms'] * 1e3:.2f} us; plain {plain_ms * 1e3:.2f} us")
    join = {"shape": [r, k, n], "ms": new_kernel["ms"], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "eager_call_ms": new_kernel["eager_call_ms"], "library_ms": library["ms"],
            "replaced_ms": replaced["ms"], "replaced_eager_call_ms": replaced["eager_call_ms"]}
    del sets
    torch.cuda.empty_cache()

    # ---- the ranked kernel, its ranks given: every row taken in every replay
    set_bytes = 2 * (4 * k * n + 4 * k)
    n_sets = max(12, -(-2 * L2_BYTES // set_bytes))
    sets = [join_inputs(gen, r, k, n, torch.int32, top=2**20, taken=True) for _ in range(n_sets)]
    bound_ms, bound_by = ranked_bound(k, n, 4, k)
    ms = device_ms([functools.partial(ops.crdt_merge_rows, table[0], *s) for s in sets])
    library_ms = device_ms([functools.partial(join_library, table[0], *s) for s in sets])
    plain_ms = device_ms([functools.partial(rows_ref, table[0], *sets[0])], reps=3)
    eager_ms = dispatch_ms(lambda: ops.crdt_merge_rows(table[0], *sets[0]))
    print(f"  crdt_merge_rows at {label}, every row taken: {ms * 1e3:.2f} us on the device over "
          f"{n_sets} input sets ({eager_ms * 1e3:.2f} us per eager call), bound "
          f"{bound_ms * 1e3:.3f} us ({bound_by}), {bound_ms / ms:.1%} of bound; the library's "
          f"index_select + where + maximum + index_copy_ {library_ms * 1e3:.2f} us; plain "
          f"{plain_ms * 1e3:.2f} us")
    ranked = {"shape": [r, k, n], "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "eager_call_ms": eager_ms, "library_ms": library_ms}
    if n == YCSB_WORDS:
        ranked["gather_merge_scatter_ms"] = device_ms(
            [functools.partial(gather_merge_scatter, ops.crdt_merge, table[0], *s) for s in sets])
        print(f"  the gather, dense merge and scatter the ranked kernel replaced: "
              f"{ranked['gather_merge_scatter_ms'] * 1e3:.2f} us")
    del sets, table
    torch.cuda.empty_cache()
    return {"errs": errs, "join": join, "ranked": ranked}


def phase_join(ops, merge_ref, rows_ref, join_ref, dev) -> dict:
    """The joins straight into a table's rows vs plain: ``crdt_join_rows``
    (the store's join: versions, lengths and presence written in the same
    pass) and the ranked ``crdt_merge_rows`` at small odd shapes in every
    payload dtype, and into a table at an odd offset, whole tables bit for
    bit; the join's triples tie in every component, match the row's own,
    hold Version.ZERO and LOAD_VERSION and meet absent rows.  Then
    ``time_joins`` at a YCSB commit (JOIN_ROWS rows of YCSB_WORDS words) and
    at TPC-C's (TPCC_JOIN_ROWS of TPCC_WORDS) into a JOIN_TABLE_ROWS-row
    table, and the dense merge at the YCSB commit's size."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(4)
    errs = []

    def check_ranked(label, table, rows, cur, new_val, new):
        want = table.clone()
        want_rank = rows_ref(want, rows, cur, new_val, new)
        got_rank = ops.crdt_merge_rows(table, rows, cur, new_val, new)
        errs.append(same_bits(f"crdt_merge_rows {label} table", table, want))
        errs.append(same_bits(f"crdt_merge_rows {label} out_rank", got_rank, want_rank))

    shapes = [(64, 7, 250), (1000, 1000, 100), (300, 1, 7), (5000, 33, 3)]
    taken = 0
    for r, k, n in shapes:
        for dt in (torch.float32, torch.bfloat16, torch.int32):
            table = join_table(gen, r, n, dt)
            taken += check_join(ops, join_ref, errs, f"({r}, {k}, {n}) {dt}", table,
                                join_batch(gen, table, k, dt))
            check_ranked(f"({r}, {k}, {n}) {dt}", merge_payload(gen, r, n, dt),
                         *join_inputs(gen, r, k, n, dt))
    buf = merge_payload(gen, 1, 300 * 250 + 8, torch.bfloat16).view(-1)
    before = buf.clone()
    table = join_table(gen, 300, 250, torch.bfloat16, payload=buf[3:3 + 300 * 250].view(300, 250))
    taken += check_join(ops, join_ref, errs, "(300, 40, 250) bf16 at offset 3", table,
                        join_batch(gen, table, 40, torch.bfloat16))
    end = 3 + 300 * 250
    errs.append(same_bits("crdt_join_rows: the buffer around a table at offset 3",
                          torch.cat([buf[:3], buf[end:]]), torch.cat([before[:3], before[end:]])))
    check_ranked("(300, 40, 250) bf16 at offset 3", buf[3:3 + 300 * 250].view(300, 250),
                 *join_inputs(gen, 300, 40, 250, torch.bfloat16))
    print(f"  crdt_join_rows and crdt_merge_rows: (R, K, N) {', '.join(map(str, shapes))} in "
          f"f32, bf16 and int32, and a bf16 table at an odd offset: whole tables (values, "
          f"versions, lengths, presence) and took bit-exact ({taken:,} rows taken; ties in each "
          f"component, equal triples, Version.ZERO, LOAD_VERSION, absent rows)")

    ycsb = time_joins(ops, rows_ref, join_ref, gen, JOIN_TABLE_ROWS, JOIN_ROWS, YCSB_WORDS,
                      "a YCSB commit")
    tpcc = time_joins(ops, rows_ref, join_ref, gen, JOIN_TABLE_ROWS, TPCC_JOIN_ROWS, TPCC_WORDS,
                      "TPC-C's commit")
    dense = time_kernel("crdt_merge", ops.crdt_merge, merge_ref,
                        lambda m, n: (*merge_batch(gen, m, n), *merge_batch(gen, m, n)),
                        (JOIN_ROWS, YCSB_WORDS), lambda m, n: 2 * (4 * m * n + 4 * m),
                        lambda m, n: merge_bound(m, n, 4))
    return {"errs": errs + ycsb["errs"] + tpcc["errs"], "join": ycsb["join"],
            "tpcc_join": tpcc["join"], "ranked": ycsb["ranked"], "tpcc_ranked": tpcc["ranked"],
            "dense": dense}


def profile_device(label: str, run, n_runs: int,
                   matmul_flops: float | None = None) -> float | None:
    """Device time per call of ``run()``, from torch.profiler over ``n_runs``
    calls, with the kernels that take most of it; None when the profiler saw
    no device activity.  With ``matmul_flops`` it also prints the rate of
    the GEMM kernels over their own device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_runs):
            run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_us = [(getattr(e, "self_device_time_total", 0.0), e.count, e.key) for e in kernels]
    total_ms = sum(t for t, _, _ in dev_us) / n_runs / 1e3
    if total_ms <= 0:
        print(f"  {label}: device time not measured (the profiler saw no device activity)")
        return None
    print(f"  {label}: {total_ms:.2f} ms of device time per call (torch.profiler, {n_runs} "
          f"calls), {sum(c for _, c, _ in dev_us) / n_runs:.0f} kernels per call")
    for t, c, name in sorted(dev_us, reverse=True)[:8]:
        print(f"    {t / n_runs / 1e3:8.3f} ms/call  {c / n_runs:5.0f} launches/call  {name[:90]}")
    if matmul_flops is not None:
        gemm_ms = sum(t for t, _, name in dev_us
                      if any(m in name.lower() for m in GEMM_KERNEL_MARKS)) / n_runs / 1e3
        if gemm_ms > 0:
            print(f"    GEMM kernels: {gemm_ms:.2f} ms of device time, "
                  f"{matmul_flops / gemm_ms / 1e9:.1f} TFLOP/s over their own time "
                  f"(f32 peak {F32_FLOPS / 1e12:g})")
        else:
            print("    GEMM kernels: not identified by name")
    return total_ms


def print_busy(label: str, device_ms: float | None, wall_ms: float) -> None:
    if device_ms is not None:
        print(f"  {label}: {device_ms:.2f} ms of device time vs {wall_ms:.2f} ms wall on the "
              f"main path: device busy {device_ms / wall_ms:.1%}")


def _logits(cfg, params, tokens, cdt, cache=None, extra=None):
    """The forward's f32 logits over ``tokens``, with the inputs ``extra``
    (a VLM's image context) beside them, and its new cache."""
    import torch

    from repro_torch.models.model import forward

    with torch.inference_mode():
        out, cache = forward(cfg, params, {"tokens": tokens, **(extra or {})}, cache=cache,
                             compute_dtype=cdt)
    if not bool(torch.isfinite(out).all()):
        fail(f"forward over {tuple(tokens.shape)} ({cdt}) produced non-finite logits")
    return out.float(), cache


def _rel(got, want) -> float:
    """Max abs difference relative to the largest logit (at least 1)."""
    return (got - want).abs().max().item() / max(1.0, want.abs().max().item())


def _rows(extra, i: int):
    return {k: v[i:i + 1] for k, v in (extra or {}).items()}


def decode_limit(cfg, params, seq, cdt, full, prompt: int = CHECK_PROMPT, extra=None) -> float:
    """FLOOR_MULT x the noise floor of the stepwise-vs-full comparison, or
    DECODE_TOL where that is larger.  ``full`` is the forward over ``seq``
    (with ``extra``)."""
    import torch

    prefix = _rel(_logits(cfg, params, seq[:, :prompt], cdt, extra=extra)[0][:, -1],
                  full[:, prompt - 1])
    split = torch.cat([_logits(cfg, params, seq[i:i + 1], cdt, extra=_rows(extra, i))[0][:, prompt:]
                       for i in range(seq.shape[0])])
    one_by_one = _rel(split, full[:, prompt:])
    limit = max(DECODE_TOL[str(cdt).removeprefix("torch.")],
                FLOOR_MULT * max(prefix, one_by_one))
    print(f"  noise floor, no cache: position {prompt - 1} of a {prompt}-token "
          f"forward {prefix:.3e}; one sequence at a time {one_by_one:.3e}; "
          f"limit {limit:.3e} x the largest logit")
    return limit


def _tensors(tree):
    """The tensors of a nested dict/list of parameters or cache."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        return [t for sub in tree for t in _tensors(sub)]
    return [tree]


def _zeroed(tree, names: tuple[str, ...]):
    """The cache with every tensor stored under one of ``names`` zeroed."""
    import torch

    if isinstance(tree, dict):
        return {k: torch.zeros_like(v) if k in names else _zeroed(v, names)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeroed(v, names) for v in tree]
    return tree


def decode_vs_full(cfg, params, seq, cdt, full, *, prompt: int = CHECK_PROMPT,
                   zero: tuple[str, ...] = (), extra=None,
                   decode_extra=None) -> list[tuple[str, float]]:
    """``(label, error relative to the largest logit)`` per position: prefill
    of ``prompt`` tokens on a cache of ``seq``'s length, then the decode
    steps, against ``full``, the forward over all of ``seq`` in ``cdt``
    compute, each call with the inputs ``extra``.  Each decode step is fed
    a cache whose leaves named in ``zero`` are zeroed, and ``decode_extra``
    in place of ``extra`` where given (faults the check must catch)."""
    from repro_torch.models.model import init_cache

    cache = init_cache(cfg, seq.shape[0], seq.shape[1], dtype=cdt, device=seq.device)
    pre, cache = _logits(cfg, params, seq[:, :prompt], cdt, cache, extra)
    out = [(f"position {prompt - 1} (prefill)", _rel(pre[:, -1], full[:, prompt - 1]))]
    for t in range(prompt, seq.shape[1]):
        step, cache = _logits(cfg, params, seq[:, t:t + 1], cdt, _zeroed(cache, zero),
                              extra if decode_extra is None else decode_extra)
        out.append((f"position {t} (decode)", _rel(step[:, 0], full[:, t])))
    return out


def check_decode(cfg, params, seq, cdt, prompt: int, faults: dict, extra=None,
                 input_faults: dict | None = None) -> None:
    """Phases 4, 6, 7, 11, 13, 24 and 25: every decode position within the
    limit, every injected fault beyond it: a cache whose leaves named in a
    ``faults`` value are zeroed, or decode steps fed an ``input_faults``
    value in place of ``extra``."""
    full = _logits(cfg, params, seq, cdt, extra=extra)[0]
    limit = decode_limit(cfg, params, seq, cdt, full, prompt, extra)
    for label, err in decode_vs_full(cfg, params, seq, cdt, full, prompt=prompt, extra=extra):
        print(f"  {label}: {err:.3e} x the largest logit ({err / limit:.2f} of the limit)")
        if err > limit:
            fail(f"{cfg.name} {cdt} {label}: stepwise vs full {err:.3e} > {limit:.3e}")
    cases = [(fault, {"zero": names}) for fault, names in faults.items()]
    cases += [(fault, {"decode_extra": wrong}) for fault, wrong in (input_faults or {}).items()]
    for fault, how in cases:
        faulty = [err for label, err in decode_vs_full(cfg, params, seq, cdt, full,
                                                       prompt=prompt, extra=extra, **how)
                  if "decode" in label]
        print(f"  decode fed {fault}: {', '.join(f'{e:.3e}' for e in faulty)} "
              f"({max(faulty) / limit:.1f} x the limit at most)")
        if max(faulty) <= limit:
            fail(f"{cfg.name} {cdt}: the check does not catch a decode fed {fault}")


def prefill_matmuls(cfg, tokens: int) -> tuple[int, float, str]:
    """The matmul work of a forward over ``tokens`` tokens at once: the
    parameters every token multiplies (all but the embedding, which is a
    gather, and the experts; a tied table once more, as the unembedding),
    the operations (2 per multiply-add) with each MoE layer's experts over
    their E x capacity rows, the capacity padding included, and how the
    experts were counted."""
    from repro_torch.models.model import param_count

    d = cfg.d_model
    params = param_count(cfg) - (0 if cfg.tie_embeddings else cfg.vocab_size * d)
    if cfg.moe is None:
        return params, 2.0 * params * tokens, ""
    m = cfg.moe
    n_moe = sum(blk.ffn == "moe" for blk in cfg.block_list())
    capacity = max(1, int(m.capacity_factor * m.top_k * tokens / m.n_experts))
    params -= n_moe * m.n_experts * 3 * d * m.d_expert
    experts = 2.0 * n_moe * m.n_experts * capacity * 3 * d * m.d_expert
    return params, 2.0 * params * tokens + experts, (
        f" + 2 x {n_moe} MoE layers x {m.n_experts} experts x {capacity} slots x "
        f"3 x {d} x {m.d_expert}")


def phase_serve(tag: str, cfg, params, tcfg, dev, counters: dict, expected: dict) -> dict:
    """Serve ``cfg`` at BATCH x PROMPT_LEN, GEN_LEN tokens, through
    ``launch.serve``, with every kernel's launch count set to 0 just before
    and read just after; the device time of a prefill (before serving casts
    the weights) and of a decode step by kernel.  A VLM gets the image
    context ``launch.serve.make_image`` draws from the prompts' seed, with
    the prefill and every decode step.  Returns the counts."""
    import torch

    from repro_torch.launch.serve import make_image, make_prompts, serve
    from repro_torch.models.model import forward, init_cache
    from repro_torch.train.train_step import build_serve_step

    prompts = make_prompts(cfg, BATCH, PROMPT_LEN, seed=0)
    img = make_image(cfg, BATCH, PROMPT_LEN, seed=0)
    extra = {} if img is None else {"img": torch.from_numpy(img).to(dev)}
    max_len = PROMPT_LEN + GEN_LEN
    matmul_params, matmul_flops, expert_text = prefill_matmuls(cfg, BATCH * PROMPT_LEN)

    def prefill():       # as serve() prefills: f32 compute on the f32 weights
        with torch.inference_mode():
            forward(cfg, params, {"tokens": torch.from_numpy(prompts).to(dev), **extra},
                    cache=init_cache(cfg, BATCH, max_len, dtype=torch.float32, device=dev),
                    compute_dtype=torch.float32)

    # profiled before serve() casts the weights; also the first-call set-up
    # of cuBLAS at these shapes, outside the counted run
    print(f"{tag} {cfg.name}: device time by kernel, outside the counted run")
    prefill_dev_ms = profile_device(f"prefill {BATCH}x{PROMPT_LEN}", prefill, 1, matmul_flops)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    res = serve(cfg, params, prompts, GEN_LEN, tcfg, dev, img)
    launches = {name: fn.launches for name, fn in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches != expected:
        fail(f"{cfg.name}: kernel launches on the main path {launches}, expected {expected}")
    gen = res.tokens
    if gen.shape != (BATCH, GEN_LEN) or not ((gen >= 0) & (gen < cfg.vocab_size)).all():
        fail(f"{cfg.name}: decoded tokens malformed: shape {gen.shape}")
    decode_steps = GEN_LEN - 1
    print(f"{tag} served {cfg.name}: prefill {BATCH}x{PROMPT_LEN} (f32 compute): "
          f"{res.prefill_s * 1e3:.1f} ms, {BATCH * PROMPT_LEN / res.prefill_s:.0f} prompt tokens/s")
    print(f"  decode {decode_steps} steps ({tcfg.compute_dtype}): "
          f"{res.decode_s / decode_steps * 1e3:.2f} ms/step, "
          f"{BATCH * decode_steps / res.decode_s:.1f} tokens/s")
    print(f"  peak device memory {peak_gb:.2f} GB; kernel launches {launches} "
          f"(1 prefill + {decode_steps} decode steps)")
    print(f"  sample row: {gen[0].tolist()}")
    print(f"  prefill matmuls: {matmul_flops / res.prefill_s / 1e12:.1f} TFLOP/s over the "
          f"prefill's wall time, a lower bound on their rate (2 x {matmul_params:,} x "
          f"{BATCH * PROMPT_LEN} tokens{expert_text})")
    print_busy("prefill", prefill_dev_ms, res.prefill_s * 1e3)
    by_dtype: dict = {}
    for leaf in _tensors(params):
        by_dtype[leaf.dtype] = by_dtype.get(leaf.dtype, 0) + leaf.numel()
    print("  the serving copy after the cast: " + ", ".join(
        f"{n:,} {dt} parameters ({n * dt.itemsize / 1e9:.2f} GB)" for dt, n in by_dtype.items()))

    # decode device time, outside the counted run, on the weights serve() cast
    step = build_serve_step(cfg, tcfg, kind="decode", device=dev)
    state = {"cache": init_cache(cfg, BATCH, max_len, dtype=torch.float32, device=dev),
             "tok": torch.zeros((BATCH, 1), dtype=torch.int32, device=dev)}

    def decode():
        tok, state["cache"] = step(params, state["cache"], {"tokens": state["tok"], **extra})
        state["tok"] = tok[:, None]

    decode()
    decode_dev_ms = profile_device("decode step", decode, 3)
    print_busy("decode step", decode_dev_ms, res.decode_s / decode_steps * 1e3)
    return launches


def count_card_step(run, dev, wall_ms: float, **step) -> dict:
    """Phase 31 (a)'s record of a phase's step: ``run()`` once more under
    ``launch.cost.CostMode`` on ``dev``, the peak memory reset just before
    it; ``wall_ms`` the same step's time measured outside the count,
    ``step`` the arguments of ``launch.dryrun.dry_step`` that repeat it
    (``cfg``, ``shape``, ``tcfg`` and, for a cached step, ``cache_len`` and
    ``cache_dtype``)."""
    import torch

    from repro_torch.launch.cost import CostMode

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    mode = CostMode(dev)
    t0 = time.perf_counter()
    with mode:
        run()
    torch.cuda.synchronize()
    return dict(step=step, counts=mode.summary(), wall_ms=wall_ms,
                peak_bytes=torch.cuda.max_memory_allocated(), held_bytes=before,
                counted_s=time.perf_counter() - t0)


def count_prefill(tag: str, cfg, params, dev) -> dict:
    """Phase 14's prefill as ``serve()`` prefills it: the cached step
    (``build_serve_step(kind="decode")``'s ``logits``) in f32 compute on
    the f32 weights, BATCH x PROMPT_LEN into an empty f32 cache of
    PROMPT_LEN + GEN_LEN positions; timed after a warm-up, each call on a
    new cache, then counted for phase 31."""
    import torch

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.serve import make_prompts
    from repro_torch.train.train_step import TrainConfig, build_serve_step, init_local_cache

    tcfg = TrainConfig(compute_dtype=torch.float32)
    step = build_serve_step(cfg, tcfg, kind="decode", device=dev)
    batch = {"tokens": torch.from_numpy(make_prompts(cfg, BATCH, PROMPT_LEN, seed=0)).to(dev)}
    max_len = PROMPT_LEN + GEN_LEN

    def new_cache():
        return init_local_cache(cfg, BATCH, max_len, {}, torch.float32, dev)

    step.logits(params, new_cache(), batch)
    cache = new_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step.logits(params, cache, batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    cache = new_cache()
    rec = count_card_step(lambda: step.logits(params, cache, batch), dev, wall_ms, cfg=cfg,
                          shape=ShapeSpec("phase 14", PROMPT_LEN, BATCH, "prefill"), tcfg=tcfg,
                          cache_len=max_len, cache_dtype=torch.float32)
    print(f"{tag} serve()'s prefill ({BATCH} x {PROMPT_LEN} into a {max_len}-position f32 cache, "
          f"f32) once more for phase 31: {wall_ms:.1f} ms; counted under CostMode in "
          f"{rec['counted_s']:.1f} s")
    return rec


def draw(tag: str, arch: str, tcfg, dev, n_layers: int | None = None):
    """The config of ``arch`` (cut to its first ``n_layers`` layers where
    given) and its f32 weights, drawn on the card."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import init_model
    from repro_torch.models.model import param_count

    cfg = get_config(arch)
    if n_layers is not None:
        print(f"{tag} {cfg.name}: {n_layers} of its {cfg.n_layers} layers, "
              f"{[f'{b.mixer}/{b.ffn}' for b in cfg.block_list()[:n_layers]]}")
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    t0 = time.perf_counter()
    params = init_model(cfg, tcfg, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"{tag} {cfg.name}: {param_count(cfg):,} parameters in f32 on the card "
          f"({time.perf_counter() - t0:.1f} s to draw)")
    return cfg, params


def run_rwkv6(dev, tcfg, counters) -> dict:
    """Phases 4 and 5; the weights are freed on return."""
    import torch

    from repro_torch.launch.serve import make_prompts

    cfg, params = draw("[4]", RWKV, tcfg, dev)
    seq = torch.from_numpy(make_prompts(cfg, BATCH, CHECK_PROMPT + CHECK_STEPS, seed=1)).to(dev)
    for cdt in (torch.float32, tcfg.compute_dtype):
        print(f"[4] prefill {CHECK_PROMPT} + {CHECK_STEPS} decode steps vs full forward, all "
              f"{cfg.n_layers} layers, {cdt} compute ({tcfg.param_dtype} weights)")
        check_decode(cfg, params, seq, cdt, CHECK_PROMPT, RWKV_FAULTS)
    return phase_serve("[5]", cfg, params, tcfg, dev, counters,
                       {name: 0 for name in counters} | {"wkv6": cfg.n_layers * GEN_LEN})


def run_recurrentgemma(dev, tcfg, counters) -> dict:
    """Phases 6, 7 and 8; the weights are freed on return."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import init_model, make_prompts
    from repro_torch.models.model import param_count

    cfg = get_config(RG)
    t0 = time.perf_counter()
    params = init_model(cfg, tcfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_rglru = sum(blk.mixer == "rglru" for blk in cfg.block_list())
    print(f"[6] {cfg.name}: {param_count(cfg):,} parameters in f32 on the card "
          f"({time.perf_counter() - t0:.1f} s to draw); {n_rglru} RG-LRU and "
          f"{cfg.n_layers - n_rglru} local-attention blocks")

    # ---- 6. prefill + stepwise decode vs the full forward, linear KV cache
    seq = torch.from_numpy(make_prompts(cfg, BATCH, CHECK_PROMPT + CHECK_STEPS, seed=1)).to(dev)
    for cdt in (torch.float32, tcfg.compute_dtype):
        print(f"[6] prefill {CHECK_PROMPT} + {CHECK_STEPS} decode steps vs full forward, all "
              f"{cfg.n_layers} layers, {cdt} compute ({tcfg.param_dtype} weights), "
              f"a linear cache of {CHECK_PROMPT + CHECK_STEPS} positions")
        check_decode(cfg, params, seq, cdt, CHECK_PROMPT, RG_FAULTS)
    del seq

    # ---- 7. the ring cache: a prompt of exactly the window, decode wraps it
    window = cfg.local_window
    seq = torch.from_numpy(make_prompts(cfg, LONG_BATCH, window + LONG_STEPS, seed=2)).to(dev)
    print(f"[7] ring cache: batch {LONG_BATCH}, prefill {window} + {LONG_STEPS} decode steps "
          f"(cache of {window + LONG_STEPS} positions -> a ring of {window}) vs the full "
          f"forward (banded attention), all {cfg.n_layers} layers, float32 compute")
    check_decode(cfg, params, seq, torch.float32, window, ATTN_FAULTS)
    del seq
    torch.cuda.empty_cache()

    # ---- 8. main path
    return phase_serve("[8]", cfg, params, tcfg, dev, counters,
                       {name: 0 for name in counters} | {"rglru_scan": n_rglru * GEN_LEN})


@contextlib.contextmanager
def spying(module, name: str, record):
    """Within the block, every call of ``module.name`` passes its arguments
    to ``record`` first."""
    real = getattr(module, name)

    def spy(*args, **kwargs):
        record(*args, **kwargs)
        return real(*args, **kwargs)

    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, real)


def phase_flash_vs_dense(tag: str, arch: str = DENSE, b: int = LONG_BATCH,
                         s: int = LONG_PROMPT + LONG_STEPS, causal: bool = True,
                         dtypes: tuple[str, ...] = ("float32", "bfloat16")) -> None:
    """flash_attention against dense_attention on the card at the shape a
    long forward gives it (``arch``'s heads, b x s tokens, the chunks
    attention_any picks; phase 11: minitron-8b at 2 x 2056, causal; phase
    26: hubert-xlarge at 1 x 4096, not causal), in ``dtypes``; the device
    time of each and, as a yardstick only, of PyTorch's
    scaled_dot_product_attention on the same inputs (its error printed, not
    gated)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs.registry import get_config
    from repro_torch.models.layers import _largest_chunk, dense_attention, flash_attention

    cfg = get_config(arch)
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    chunk = _largest_chunk(s, 1024)
    gen = torch.Generator(device="cuda").manual_seed(4)
    for dt in (getattr(torch, name) for name in dtypes):
        q = torch.randn((b, s, hq, d), generator=gen, device="cuda").to(dt)
        k, v = (torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(dt)
                for _ in range(2))
        flash = functools.partial(flash_attention, q, k, v, causal=causal, q_chunk=chunk,
                                  kv_chunk=chunk)
        dense = functools.partial(dense_attention, q, k, v, causal=causal)
        # the yardstick in its own layout, kv heads repeated for the q heads
        qs, ks, vs = (x.transpose(1, 2).contiguous()
                      for x in (q, k.repeat_interleave(hq // hkv, 2),
                                v.repeat_interleave(hq // hkv, 2)))
        sdpa = functools.partial(F.scaled_dot_product_attention, qs, ks, vs, is_causal=causal)
        want = dense().float()
        label = str(dt).removeprefix("torch.")
        check_close(f"flash_attention vs dense_attention {(b, s, hq, hkv, d)} {label}, "
                    f"{'causal' if causal else 'not causal'}, chunks {chunk}", flash().float(),
                    want, FLASH_TOL[label])
        sdpa_err = (sdpa().transpose(1, 2).float() - want).abs().max().item()
        times = {name: device_ms([fn], reps=3) for name, fn in
                 (("flash_attention", flash), ("dense_attention", dense), ("sdpa", sdpa))}
        print(f"{tag} {label}: device time flash_attention {times['flash_attention']:.4f} ms, "
              f"dense_attention {times['dense_attention']:.4f} ms; yardstick (not on the path) "
              f"scaled_dot_product_attention {times['sdpa']:.4f} ms, max abs err against "
              f"dense {sdpa_err:.3e}")
    torch.cuda.empty_cache()


def check_long_prompt(tag: str, cfg, params, dev) -> None:
    """Prefill of LONG_PROMPT tokens + LONG_STEPS decode steps on a linear
    cache, against the full forward, f32, gated as in phase 4 and failed on
    purpose by a zeroed KV cache.  The forwards over all positions go
    through flash_attention (S^2 is above attention_any's dense threshold):
    asserted from its calls."""
    import torch

    from repro_torch.launch.serve import make_prompts
    from repro_torch.models import layers

    n = LONG_PROMPT + LONG_STEPS
    chunk = layers._largest_chunk(n, 1024)
    seq = torch.from_numpy(make_prompts(cfg, LONG_BATCH, n, seed=2)).to(dev)
    print(f"{tag} long prompt: batch {LONG_BATCH}, prefill {LONG_PROMPT} + {LONG_STEPS} decode "
          f"steps on a linear cache of {n} positions vs the full forward over {n} tokens "
          f"(flash attention, chunks of {chunk}), all {cfg.n_layers} layers, float32 compute")
    calls = []
    with spying(layers, "flash_attention",
                lambda q, k, v, **kw: calls.append((q.shape[1], kw["q_chunk"], kw["kv_chunk"]))):
        check_decode(cfg, params, seq, torch.float32, LONG_PROMPT, ATTN_FAULTS)
    seen = collections.Counter(calls)
    print(f"  flash_attention calls by (length, q chunk, kv chunk): {dict(seen)}")
    # the full forward and the noise floor's one-sequence-at-a-time forwards
    want = (1 + LONG_BATCH) * sum(blk.mixer == "attn" for blk in cfg.block_list())
    if seen[(n, chunk, chunk)] != want:
        fail(f"{cfg.name}: {seen[(n, chunk, chunk)]} flash_attention calls over {n} tokens, "
             f"expected {want}")


def check_attention_model(tag: str, cfg, params, tcfg, dev) -> None:
    """The checks of phases 11 and 13: the short prompt in f32 and in the
    decode dtype, then the long prompt; a zeroed KV cache must fail each."""
    import torch

    from repro_torch.launch.serve import make_prompts

    seq = torch.from_numpy(make_prompts(cfg, BATCH, CHECK_PROMPT + CHECK_STEPS, seed=1)).to(dev)
    for cdt in (torch.float32, tcfg.compute_dtype):
        print(f"{tag} prefill {CHECK_PROMPT} + {CHECK_STEPS} decode steps vs full forward, all "
              f"{cfg.n_layers} layers, {cdt} compute ({tcfg.param_dtype} weights), a linear "
              f"cache of {CHECK_PROMPT + CHECK_STEPS} positions")
        check_decode(cfg, params, seq, cdt, CHECK_PROMPT, ATTN_FAULTS)
    del seq
    check_long_prompt(tag, cfg, params, dev)
    torch.cuda.empty_cache()


def run_minitron(dev, tcfg, counters) -> dict:
    """Phases 11 and 12 on an emptied card; the weights are freed on return."""
    memory_line("[11]", "start")
    phase_flash_vs_dense("[11]")
    cfg, params = draw("[11]", DENSE, tcfg, dev)
    check_attention_model("[11]", cfg, params, tcfg, dev)
    memory_line("[11]", "end")
    return phase_serve("[12]", cfg, params, tcfg, dev, counters,
                       {name: 0 for name in counters})


def moe_drop_rates(tag: str, cfg, params, tcfg, dev, no_drop_rows=None) -> None:
    """The drop rate at the published capacity factor, from moe_apply's aux
    on the first MoE layer's input at the served shapes: the prefill of the
    served prompts (f32) and the first decode step after it (in the decode
    dtype).  The decode check's copy of the config must drop nothing on the
    prefill's input, or on its first ``no_drop_rows`` = (rows, tokens)
    where the decode check runs at that shape."""
    import torch

    from repro_torch.launch.serve import make_prompts
    from repro_torch.models import moe
    from repro_torch.models.model import init_cache

    first = next(layer["ffn"] for layer, blk in zip(params["layers"], cfg.block_list())
                 if blk.ffn == "moe")
    inputs = []
    prompts = torch.from_numpy(make_prompts(cfg, BATCH, PROMPT_LEN, seed=0)).to(dev)
    with spying(moe, "moe_apply", lambda p, x, **kw: p is first and inputs.append(x)):
        cache = init_cache(cfg, BATCH, PROMPT_LEN + 1, dtype=torch.float32, device=dev)
        logits, cache = _logits(cfg, params, prompts, torch.float32, cache)
        tok = logits[:, -1].argmax(dim=-1)[:, None]
        del logits
        _logits(cfg, params, tok, tcfg.compute_dtype, cache)
    m = cfg.moe
    with torch.inference_mode():
        for label, x in zip(("prefill", "decode"), inputs):
            t = x.shape[0] * x.shape[1]
            capacity = max(1, int(m.capacity_factor * m.top_k * t / m.n_experts))
            _, aux = moe.moe_apply(first, x, top_k=m.top_k, capacity_factor=m.capacity_factor,
                                   return_aux=True)
            print(f"{tag} drop rate at capacity factor {m.capacity_factor}, first MoE layer, "
                  f"{label} ({x.dtype}, t = {t}, capacity {capacity}): "
                  f"{float(aux['drop_rate']):.6f} of {t * m.top_k} assignments; aux loss "
                  f"{float(aux['aux_loss']):.6f}")
        no_drop = m.n_experts / m.top_k
        x = inputs[0] if no_drop_rows is None else inputs[0][:no_drop_rows[0], :no_drop_rows[1]]
        _, aux = moe.moe_apply(first, x, top_k=m.top_k, capacity_factor=no_drop,
                               return_aux=True)
    if float(aux["drop_rate"]) != 0.0:
        fail(f"{cfg.name}: capacity factor {no_drop} drops {float(aux['drop_rate'])}")


def run_granite(dev, tcfg, counters) -> dict:
    """Phases 13 and 14 on an emptied card; the weights are freed on return.
    The decode check runs on a copy of the config whose capacity factor is
    n_experts / top_k, so capacity = t and no assignment drops: capacity is
    per call (t = B x S tokens), and at the published 1.25 a decode step of
    8 tokens has 2 slots per expert and drops assignments that the full
    forward over 8 x 68 tokens keeps, the reference's semantics, which a
    cached decode cannot match position by position."""
    memory_line("[13]", "start")
    cfg, params = draw("[13]", MOE, tcfg, dev)
    no_drop = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    print(f"[13] decode checks at capacity factor {no_drop.moe.capacity_factor} "
          f"(capacity = t, nothing drops); served at the published {cfg.moe.capacity_factor}")
    check_attention_model("[13]", no_drop, params, tcfg, dev)
    moe_drop_rates("[13]", cfg, params, tcfg, dev)
    memory_line("[13]", "end")
    card_step = count_prefill("[14]", cfg, params, dev)
    return {"launches": phase_serve("[14]", cfg, params, tcfg, dev, counters,
                                    {name: 0 for name in counters}),
            "counted": card_step}


def phase_mla_alone(tag: str, cfg, dev) -> None:
    """Phase 24 (a): one layer's MLA at full width on its f32 weights, at
    MLA_ALONE_BATCH x MLA_ALONE_SEQ: the uncached path, which attends
    through flash_attention above 2048 tokens (asserted from its calls),
    against the cached prefill of the same input, which attends densely
    over the cache, within MLA_ALONE_TOL of the output's largest value."""
    import torch

    from repro_torch.models import layers, mla

    b, s = MLA_ALONE_BATCH, MLA_ALONE_SEQ
    gen = torch.Generator(device=dev).manual_seed(5)
    p = mla.mla_init(gen, cfg.d_model, cfg.n_heads, cfg.mla, dev)
    x = torch.randn((b, s, cfg.d_model), generator=gen, device=dev)
    chunk = layers._largest_chunk(s, 1024)
    calls = []
    with torch.inference_mode(), spying(mla, "flash_attention",
                                        lambda q, k, v, **kw: calls.append(
                                            (q.shape[1], kw["q_chunk"], kw["causal"]))):
        t0 = time.perf_counter()
        flash, _ = mla.mla_apply(p, x, n_heads=cfg.n_heads, mla=cfg.mla,
                                 rope_theta=cfg.rope_theta)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cache = mla.mla_init_cache(b, s, cfg.mla, torch.float32, dev)
        dense, cache = mla.mla_apply(p, x, n_heads=cfg.n_heads, mla=cfg.mla,
                                     rope_theta=cfg.rope_theta, cache=cache)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    if calls != [(s, chunk, True)]:
        fail(f"mla_apply at {(b, s)} without a cache: flash_attention calls {calls}, "
             f"expected one over {s} tokens in chunks of {chunk}")
    scale = dense.abs().max().item()
    err = (flash - dense).abs().max().item()
    print(f"{tag} (a) mla_apply, one layer's weights ({sum(t.numel() for t in _tensors(p)):,} "
          f"f32 parameters), x {(b, s, cfg.d_model)}: uncached (flash_attention, chunks "
          f"{chunk}) {(t1 - t0) * 1e3:.1f} ms, cached prefill (dense over the cache) "
          f"{(t2 - t1) * 1e3:.1f} ms; max abs err {err:.3e}, {err / scale:.2e} of the output's "
          f"largest value {scale:.3e} (tol {MLA_ALONE_TOL:g})")
    if not bool(torch.isfinite(flash).all()) or err > MLA_ALONE_TOL * scale:
        fail(f"mla_apply flash vs dense over the cache: {err:.3e} > {MLA_ALONE_TOL:g} x {scale:.3e}")
    del p, x, flash, dense, cache
    torch.cuda.empty_cache()


def run_deepseek(dev, tcfg, counters) -> dict:
    """Phase 24 on an emptied card; the weights are freed on return.  The
    decode check runs on a copy of the config whose capacity factor (256 /
    8 = 32) drops nothing, as phase 13's does; the drop rates and serving
    at the published 1.25."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import make_prompts

    memory_line("[24]", "start")
    phase_mla_alone("[24]", get_config(MLA_ARCH), dev)
    cfg, params = draw("[24]", MLA_ARCH, tcfg, dev, n_layers=MLA_LAYERS)
    no_drop = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    n = MLA_CHECK_PROMPT + MLA_CHECK_STEPS
    seq = torch.from_numpy(make_prompts(cfg, MLA_CHECK_BATCH, n, seed=1)).to(dev)
    for cdt in (torch.float32, tcfg.compute_dtype):
        print(f"[24] (b) prefill {MLA_CHECK_PROMPT} + {MLA_CHECK_STEPS} decode steps vs full "
              f"forward, batch {MLA_CHECK_BATCH}, all {cfg.n_layers} layers, {cdt} compute "
              f"({tcfg.param_dtype} weights), an MLA cache of {n} positions, capacity factor "
              f"{no_drop.moe.capacity_factor} (nothing drops)")
        check_decode(no_drop, params, seq, cdt, MLA_CHECK_PROMPT, MLA_FAULTS)
    del seq
    torch.cuda.empty_cache()
    memory_line("[24]", "end")
    moe_drop_rates("[24] (c)", cfg, params, tcfg, dev, no_drop_rows=(MLA_CHECK_BATCH, n))
    torch.cuda.empty_cache()
    return phase_serve("[24] (d)", cfg, params, tcfg, dev, counters,
                       {name: 0 for name in counters})


def run_vision(dev, tcfg, counters) -> dict:
    """Phase 25 on an emptied card; the weights are freed on return: the
    check of phase 4 with the image context given to every call, failed on
    purpose by a zeroed KV cache and, in f32, by decode steps fed another
    image context than the prefill's; then served with the image context.
    The cross block's whole contribution moves the logits of this random
    5-layer model by ~3% of the largest, which the f32 limit (1e-4) sees
    and bf16's (4 x a floor of ~1.7e-2) cannot: a check of the image in
    bf16 would pass a decode that ignored it."""
    import torch

    from repro_torch.launch.serve import make_image, make_prompts

    memory_line("[25]", "start")
    cfg, params = draw("[25]", VLM_ARCH, tcfg, dev, n_layers=VLM_LAYERS)
    n = CHECK_PROMPT + CHECK_STEPS
    seq = torch.from_numpy(make_prompts(cfg, BATCH, n, seed=1)).to(dev)
    img, other = ({"img": torch.from_numpy(make_image(cfg, BATCH, n, seed=k)).to(dev)}
                  for k in (1, 2))
    for cdt in (torch.float32, tcfg.compute_dtype):
        print(f"[25] prefill {CHECK_PROMPT} + {CHECK_STEPS} decode steps vs full forward, all "
              f"{cfg.n_layers} layers, {cdt} compute ({tcfg.param_dtype} weights), a linear "
              f"cache of {n} positions, an image context of {tuple(img['img'].shape)}")
        check_decode(cfg, params, seq, cdt, CHECK_PROMPT, ATTN_FAULTS, extra=img,
                     input_faults={"another image context": other}
                     if cdt == torch.float32 else None)
    del seq, img, other
    torch.cuda.empty_cache()
    memory_line("[25]", "end")
    return phase_serve("[25]", cfg, params, tcfg, dev, counters,
                       {name: 0 for name in counters})


def run_hubert(dev, tcfg, counters) -> None:
    """Phase 26 on an emptied card; the weights are freed on return: the
    prefill step (``launch.serve.encode``) over BATCH x PROMPT_LEN frames in
    f32 and in the compute dtype, every kernel's count 0; bf16 against f32
    at DECODE_TOL over the first AUDIO_BF16_LAYERS layers; the non-causal
    check; a 1 x AUDIO_LONG forward through
    the non-causal flash_attention; flash against dense at that shape."""
    import torch

    from repro_torch.launch.serve import encode, make_frames
    from repro_torch.models import layers
    from repro_torch.models.model import forward

    memory_line("[26]", "start")
    phase_flash_vs_dense("[26]", AUDIO_ARCH, 1, AUDIO_LONG, causal=False, dtypes=("float32",))
    cfg, params = draw("[26]", AUDIO_ARCH, tcfg, dev)
    frames = make_frames(cfg, BATCH, PROMPT_LEN, seed=0)
    logits = {}
    for cdt in (torch.float32, tcfg.compute_dtype):
        run_cfg = dataclasses.replace(tcfg, compute_dtype=cdt)
        encode(cfg, params, frames, run_cfg, dev)           # cuBLAS set-up, outside the timing
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        res = encode(cfg, params, frames, run_cfg, dev)
        launches = {name: fn.launches for name, fn in counters.items()}
        if any(launches.values()):
            fail(f"{cfg.name}: kernel launches on the prefill step {launches}, expected none")
        logits[cdt] = res.logits.float()
        print(f"[26] {cfg.name} prefill step {BATCH}x{PROMPT_LEN} frames ({cdt} compute): "
              f"{res.prefill_s * 1e3:.1f} ms, {BATCH * PROMPT_LEN / res.prefill_s:.0f} frames/s; "
              f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; kernel "
              f"launches {launches}")
        dev_ms = profile_device(f"prefill step {BATCH}x{PROMPT_LEN} ({cdt})",
                                lambda c=run_cfg: encode(cfg, params, frames, c, dev), 1)
        print_busy(f"prefill step ({cdt})", dev_ms, res.prefill_s * 1e3)
    # bf16 against f32 within DECODE_TOL, on the first AUDIO_BF16_LAYERS
    # layers: every block is the same kind, so a fault of the bf16 path shows
    # there, while bf16's rounding, which grows with depth over random
    # layers (in the reference as in the port, PERF.md §6), stays below the
    # tolerance.  The whole model's difference is printed beside it.
    want, half = logits[torch.float32], logits[tcfg.compute_dtype]
    cut = dataclasses.replace(cfg, n_layers=AUDIO_BF16_LAYERS)
    cut_logits = [encode(cut, params, frames, dataclasses.replace(tcfg, compute_dtype=cdt),
                         dev).logits.float() for cdt in (torch.float32, tcfg.compute_dtype)]
    rel = _rel(cut_logits[1], cut_logits[0])
    print(f"[26] {tcfg.compute_dtype} vs float32 logits: {rel:.3e} x the largest logit over the "
          f"first {AUDIO_BF16_LAYERS} layers (tol {DECODE_TOL['bfloat16']:g}); "
          f"{_rel(half, want):.3e} over all {cfg.n_layers}")
    if rel > DECODE_TOL["bfloat16"]:
        fail(f"{cfg.name}: bf16 prefill vs f32 over {AUDIO_BF16_LAYERS} layers "
             f"{rel:.3e} > {DECODE_TOL['bfloat16']:g}")

    # not causal: row 0's last frame reaches row 0's first position, and only row 0
    moved = frames.copy()
    moved[0, -1] = make_frames(cfg, 1, 1, seed=1)[0, 0]
    got = encode(cfg, params, moved, dataclasses.replace(tcfg, compute_dtype=torch.float32),
                 dev).logits
    first = (got[0, 0] - want[0, 0]).abs().max().item()
    same = torch.equal(got[1:], want[1:])
    print(f"[26] row 0's last frame changed: row 0's first position moved by {first:.3e}; "
          f"rows 1-{BATCH - 1} bit for bit the same: {same}")
    if first == 0.0 or not same:
        fail(f"{cfg.name}: the non-causal check failed (first position moved {first}, "
             f"other rows the same {same})")

    # a long input: attention_any takes the non-causal flash_attention
    calls = []
    long = torch.from_numpy(make_frames(cfg, 1, AUDIO_LONG, seed=2)).to(dev)
    with torch.inference_mode(), spying(layers, "flash_attention",
                                        lambda q, k, v, **kw: calls.append(
                                            (q.shape[1], kw["q_chunk"], kw["causal"]))):
        t0 = time.perf_counter()
        out, _ = forward(cfg, params, {"embeds": long}, compute_dtype=torch.float32)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    chunk = layers._largest_chunk(AUDIO_LONG, 1024)
    print(f"[26] forward over 1 x {AUDIO_LONG} frames, f32: {(t1 - t0) * 1e3:.1f} ms; "
          f"flash_attention calls by (length, chunk, causal): "
          f"{dict(collections.Counter(calls))}")
    if calls != [(AUDIO_LONG, chunk, False)] * cfg.n_layers or not bool(torch.isfinite(out).all()):
        fail(f"{cfg.name}: the 1 x {AUDIO_LONG} forward did not go through the non-causal "
             f"flash_attention in every layer, or is not finite")
    memory_line("[26]", "end")


@contextlib.contextmanager
def plain_mixers(f64: bool = False):
    """Within the block the models call the plain recurrences (autograd
    through them on the card) in place of the kernel wrappers; with
    ``f64`` the recurrences run in float64 between casts of their inputs
    and outputs (the rest of the model stays as it is)."""
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    from repro_torch.kernels.rwkv6_wkv.ref import wkv6_ref
    from repro_torch.models import rglru, rwkv6

    def wide(fn):
        return lambda *xs: tuple(o.float() for o in fn(*(x.double() for x in xs)))

    real = rwkv6.wkv6, rglru.rglru_scan
    rwkv6.wkv6, rglru.rglru_scan = ((wide(wkv6_ref), wide(rglru_scan_ref)) if f64
                                    else (wkv6_ref, rglru_scan_ref))
    try:
        yield
    finally:
        rwkv6.wkv6, rglru.rglru_scan = real


def data_batch(cfg, batch: int, seq: int, dev, step: int = 0) -> dict:
    from repro_torch.data.pipeline import DataConfig, make_batch

    return make_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
                                 seed=1), step, dev)


def train_batch(cfg, batch: int, seq: int, dev, step: int = 0) -> dict:
    """Batch ``step`` of a training run: ``data_batch``'s labels, and its
    tokens, or for a frames frontend ``embeds`` (B, S, d) in their place;
    for a model with an image context also ``img`` (B, N_img, d); both
    drawn from the step's seed (``launch.serve.make_frames``,
    ``make_image``)."""
    import torch

    from repro_torch.launch.serve import make_frames, make_image

    out = data_batch(cfg, batch, seq, dev, step)
    if cfg.frontend != "token":
        del out["tokens"]
        out["embeds"] = torch.from_numpy(make_frames(cfg, batch, seq, seed=step)).to(dev)
    if cfg.n_img_tokens:
        out["img"] = torch.from_numpy(make_image(cfg, batch, seq, seed=step)).to(dev)
    return out


def counted(counters: dict, run):
    """``run()`` with every kernel count set to 0 just before; returns its
    result and the counts just after."""
    for fn in counters.values():
        fn.launches = 0
    out = run()
    return out, {name: fn.launches for name, fn in counters.items()}


def grad_errors(params, got, want) -> dict[str, float]:
    """|got - want| / |want| for every leaf, by key."""
    from repro_torch.tree import leaf_paths

    return {key: ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
            for (key, _), a, b in zip(leaf_paths(params), got, want)}


def worst_text(errs: dict[str, float], n: int = 3) -> str:
    return ", ".join(f"{key} {e:.3e}" for key, e in sorted(errs.items(), key=lambda kv: -kv[1])[:n])


def compare_grads(label: str, cfg, params, got, want, limits: dict[str, float],
                  kernel_mixer: str) -> None:
    """Every leaf's gradient finite and within its own limit (a share of its
    norm of ``want``'s); with ``kernel_mixer``, every leaf of such a block's
    mixer nonzero in both."""
    import torch

    from repro_torch.tree import leaf_paths

    errs = grad_errors(params, got, want)
    blocks = cfg.block_list()
    mixer_leaves = 0
    for (key, _), a, b in zip(leaf_paths(params), got, want):
        if not bool(torch.isfinite(a).all()):
            fail(f"{label} {key}: a non-finite gradient")
        parts = key.split("/")
        if (kernel_mixer and parts[0] == "layers" and parts[2] == "mixer"
                and blocks[int(parts[1])].mixer == kernel_mixer):
            if a.abs().max().item() == 0 or b.abs().max().item() == 0:
                fail(f"{label} {key}: zero gradient through a {kernel_mixer} mixer")
            mixer_leaves += 1
    share = {key: e / limits[key] for key, e in errs.items()}
    nearest = sorted(share, key=share.get, reverse=True)[:3]
    print(f"  {label}: {len(errs)} leaves, the worst {worst_text(errs)}; nearest their limits "
          + ", ".join(f"{key} {errs[key]:.3e} of {limits[key]:.3e}" for key in nearest)
          + (f"; {mixer_leaves} {kernel_mixer}-mixer leaves nonzero on both paths"
             if kernel_mixer else ""))
    over = [key for key in nearest if share[key] > 1]
    if over:
        fail(f"{label} {over[0]}: gradient {errs[over[0]]:.3e} of its norm from the other "
             f"path's (> {limits[over[0]]:.3e})")


def train_grad_checks(tag, cfg, dev, counters, kernels) -> None:
    """(a) the gradients through the kernels against the plain recurrences
    and (d) microbatches 1 against 2, f32 compute, GRAD_BATCH x GRAD_SEQ, on
    weights drawn for the check and released after it.  Both are gated by a
    noise floor measured first, with no kernel and no microbatching, as the
    larger of two differences from the plain f32 path's gradients: the same
    path with the batch's sequences swapped (each weight's gradient sums
    its rows in another order), and the same path with the recurrences in
    f64 (their own f32 rounding; it is large where the exact value is 0:
    the group norm's backward leaves dy orthogonal to y in each head, and y
    is parallel to v at t = 0, so v . dy, and with it dr, dk and du there,
    are rounding noise in f32).  Each leaf has its own floor and passes
    within FLOOR_MULT x it, or within TRAIN_GRAD_TOL where that is larger;
    a floor above FLOOR_CAP fails the phase.  ``kernels``
    names the forward and backward counters of the model's mixer kernel, or
    is None for a model that runs none (then (a) has nothing to compare).
    An MoE model is checked at capacity factor n_experts / top_k (capacity
    = t, nothing drops): capacity is per call, so at the published factor
    the order of the tokens and the split into microbatches decide which
    assignments drop, a different result rather than a rounding."""
    import torch

    from repro_torch.models.model import init_params
    from repro_torch.train.train_step import TrainConfig, grads_and_loss

    if any(blk.ffn == "moe" for blk in cfg.block_list()):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
        print(f"{tag} gradient checks at capacity factor {cfg.moe.capacity_factor} (nothing "
              "drops); (b) and (c) train at the published one")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    f32 = TrainConfig(compute_dtype=torch.float32)
    batch = train_batch(cfg, GRAD_BATCH, GRAD_SEQ, dev)
    mixer = "" if kernels is None else ("rwkv" if kernels[0] == "wkv6" else "rglru")
    n_kernel = sum(blk.mixer == mixer for blk in cfg.block_list())

    def loss_rel(a, b) -> float:
        return abs(a.item() - b.item()) / abs(b.item())

    with plain_mixers():
        (gp, lp), counts = counted(counters, lambda: grads_and_loss(cfg, f32, params, batch))
        if any(counts.values()):
            fail(f"{cfg.name}: the plain path launched {counts}")
        gs, ls = grads_and_loss(cfg, f32, params, {k: v.flip(0) for k, v in batch.items()})
    swap = grad_errors(params, gs, gp)
    del gs
    loss_floor = loss_rel(ls, lp)
    wide = {}
    if n_kernel:
        with plain_mixers(f64=True):
            g64, l64 = grads_and_loss(cfg, f32, params, batch)
        wide = grad_errors(params, gp, g64)
        loss_floor = max(loss_floor, loss_rel(lp, l64))
        del g64
    floors = {key: max(e, wide.get(key, 0.0)) for key, e in swap.items()}
    limits = {key: max(TRAIN_GRAD_TOL, FLOOR_MULT * f) for key, f in floors.items()}
    loss_limit = max(1e-5, FLOOR_MULT * loss_floor)
    wider = sorted((key for key in limits if limits[key] > TRAIN_GRAD_TOL),
                   key=limits.get, reverse=True)
    print(f"{tag} noise floor of the plain f32 path, batch {GRAD_BATCH} x {GRAD_SEQ}: sequences "
          f"swapped, the worst {worst_text(swap)}; recurrences in f64, the worst "
          + (worst_text(wide) if wide else "(no recurrence)")
          + f"; loss {loss_floor:.3e}; limits: loss {loss_limit:.3e}, gradients per leaf "
          f"{TRAIN_GRAD_TOL:g} of its norm, or {FLOOR_MULT:g} x its floor for {len(wider)} of "
          f"{len(limits)} leaves" + (f" (the widest {', '.join(f'{k} {limits[k]:.3e}' for k in wider[:3])})"
                                     if wider else ""))
    worst_floor = max(floors, key=floors.get)
    if max(floors[worst_floor], loss_floor) > FLOOR_CAP:
        fail(f"{cfg.name}: noise floor {floors[worst_floor]:.3e} at {worst_floor}, loss "
             f"{loss_floor:.3e} (> {FLOOR_CAP:g}): no gate that wide tells a fault from noise")

    if kernels is not None:
        (gk, lk), counts = counted(counters, lambda: grads_and_loss(cfg, f32, params, batch))
        want = {name: 0 for name in counters} | {kernels[0]: 2 * n_kernel, kernels[1]: n_kernel}
        if counts != want:
            fail(f"{cfg.name} (a): kernel launches {counts}, expected {want}")
        err = loss_rel(lk, lp)
        print(f"{tag} (a) gradients through the kernels vs the plain recurrences: loss "
              f"{lk.item():.6f} vs {lp.item():.6f} ({err:.3e}); launches {counts_text(counts)}")
        if err > loss_limit:
            fail(f"{cfg.name} (a): loss {err:.3e} from the plain path's (> {loss_limit:.3e})")
        compare_grads(f"{tag} (a)", cfg, params, gk, gp, limits, mixer)
        del gp
        torch.cuda.empty_cache()
    else:
        gk, lk = gp, lp
    g2, l2 = grads_and_loss(cfg, dataclasses.replace(f32, microbatches=2), params, batch)
    err = loss_rel(l2, lk)
    print(f"{tag} (d) microbatches 1 vs 2: loss {lk.item():.6f} vs {l2.item():.6f} ({err:.3e})")
    if err > loss_limit:
        fail(f"{cfg.name} (d): loss {err:.3e} apart (> {loss_limit:.3e})")
    compare_grads(f"{tag} (d)", cfg, params, g2, gk, limits, mixer)
    del g2, gk, params
    torch.cuda.empty_cache()


def counts_text(counts: dict) -> str:
    return ", ".join(f"{k} {v}" for k, v in counts.items() if v) or "none"


def profile_launches(run, name: str) -> tuple[float | None, dict, list]:
    """Device time of ``run()`` and its device time by kernel name (ms) from
    torch.profiler, which records the device's activity only: the host's
    events of a step of ~10^5 launches took longer to gather than the step.
    Also the device time (ms) of each launch of the kernels whose names hold
    ``name``, in order."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    by_name = {e.key: getattr(e, "self_device_time_total", 0.0) / 1e3 for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA}
    each = [getattr(e, "self_device_time_total", 0.0) / 1e3 for e in prof.events()
            if e.device_type == DeviceType.CUDA and name and name in e.name]
    total = sum(by_name.values())
    return (total if total > 0 else None), by_name, each


def profile_step(run) -> tuple[float | None, dict]:
    """``profile_launches`` without the launches."""
    return profile_launches(run, "")[:2]


def drive_steps(cfg, tcfg, batch: int, seq: int, dev) -> list[dict]:
    """TRAIN_STEPS steps of ``build_train_step`` on ``train_batch``'s batches
    0, 1, ... from parameters drawn from seed 0, for a model whose inputs
    ``train()``'s pipeline cannot feed; one record a step as ``train()``
    keeps them: the loss and ``dt``, the host time of the step ending in a
    synchronise, its batch drawn outside it."""
    import torch

    from repro_torch.models.model import init_params
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.train_step import build_train_step

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    opt = adamw_init(params, tcfg.optim)
    step = build_train_step(cfg, tcfg, dev)
    hist = []
    for i in range(TRAIN_STEPS):
        b = train_batch(cfg, batch, seq, dev, step=i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(params, opt, b)["loss"]
        torch.cuda.synchronize()
        hist.append({"loss": float(loss), "dt": time.perf_counter() - t0})
    return hist


def cut_config(arch: str, n_layers: int | None, **changes):
    """``arch``'s published config and the one trained: its first
    ``n_layers`` layers (all with None), with ``changes``."""
    from repro_torch.configs.registry import get_config

    full = get_config(arch)
    if n_layers is not None:
        changes["n_layers"] = n_layers
    return dataclasses.replace(full, **changes), full


def run_training(tag, cfg, full, batch, seq, dev, counters, kernels,
                 count: bool = False) -> dict:
    """Phases 15-17 and 27-29: ``cfg`` (``full`` cut in depth) at full
    width, each check on an emptied card: (a) and (d), then (b)
    TRAIN_STEPS steps at batch x seq (the counted main path) through
    ``launch.train.train()``, or through ``build_train_step``
    (``drive_steps``) for a model that reads frames or an image context,
    which ``train()``'s pipeline does not yield, then (c) FALL_STEPS steps
    on one repeated batch, the last one profiled; with ``count`` one more
    step under ``CostMode``, phase 31's record (``counted``)."""
    import torch

    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import train
    from repro_torch.models.model import init_params, param_count
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.train_step import TrainConfig, build_train_step

    memory_line(tag, "start")
    n = param_count(cfg)
    print(f"{tag} {full.name} training at full width, {cfg.n_layers} of {full.n_layers} layers "
          f"({', '.join(b.mixer + '+' + b.ffn for b in cfg.block_list()[:3])}"
          f"{', ...' if cfg.n_layers > 3 else ''}): {n:,} parameters; f32 params + grads + m + v "
          f"= 16 B each = {16 * n / 1e9:.1f} GB (the whole model: {16 * param_count(full) / 1e9:.1f} GB)")
    train_grad_checks(tag, cfg, dev, counters, kernels)

    # ---- (b) the main path at the full shape, every count read
    tcfg = TrainConfig()            # the reference's defaults: bf16 compute, lr 3e-4 after 100 steps
    tokens_only = cfg.frontend == "token" and not cfg.n_img_tokens
    torch.cuda.reset_peak_memory_stats()
    if tokens_only:
        data = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, seed=0)
        hist, counts = counted(counters, lambda: train(cfg, tcfg, data, TRAIN_STEPS, seed=0,
                                                       device=dev))
    else:
        hist, counts = counted(counters, lambda: drive_steps(cfg, tcfg, batch, seq, dev))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    card_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9
    n_mixer = 0
    want = {name: 0 for name in counters}
    if kernels is not None:
        mixer = "rwkv" if kernels[0] == "wkv6" else "rglru"
        n_mixer = sum(blk.mixer == mixer for blk in cfg.block_list())
        want |= {kernels[0]: 2 * n_mixer * TRAIN_STEPS, kernels[1]: n_mixer * TRAIN_STEPS}
    if counts != want:
        fail(f"{cfg.name} (b): kernel launches over {TRAIN_STEPS} steps {counts}, expected {want}")
    losses = [r["loss"] for r in hist]
    if len(hist) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        fail(f"{cfg.name} (b): losses {losses}")
    steady = statistics.median(r["dt"] for r in hist[1:])
    tokens = batch * seq
    unit = "tokens" if cfg.frontend == "token" else "frames"
    print(f"{tag} (b) {'train()' if tokens_only else 'build_train_step'}: {TRAIN_STEPS} steps at "
          f"batch {batch} x {seq}"
          f"{' with an image context of ' + str(cfg.n_img_tokens) if cfg.n_img_tokens else ''}, "
          f"{tcfg.compute_dtype} compute, remat: losses {', '.join(f'{x:.4f}' for x in losses)}; "
          f"step times {', '.join('%.1f' % (r['dt'] * 1e3) for r in hist)} ms (the first warms "
          f"up); steady {steady * 1e3:.1f} ms/step, {tokens / steady:.0f} {unit}/s; peak device "
          f"memory {peak_gb:.2f} GB of the card's {card_gb:.2f} GB; launches "
          f"{counts_text(counts)} (per step: forward + remat recompute {2 * n_mixer}, "
          f"backward {n_mixer})")
    torch.cuda.empty_cache()

    # ---- (c) the loss falls on one repeated batch; the last step profiled.
    # Adam's first steps move each weight by about lr * sign(g), coherently
    # along a 4096-wide input: a layer's output moves by ~lr * |x|_1, ~3e3 lr
    # here, so the rate must stay far below the reference's 3e-4 peak
    ctcfg = TrainConfig(optim=AdamWConfig(lr=FALL_LR, warmup_steps=0, total_steps=100))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    opt = adamw_init(params, ctcfg.optim)
    step = build_train_step(cfg, ctcfg, dev)
    one = train_batch(cfg, batch, seq, dev)
    fall, walls = [], []
    for _ in range(FALL_STEPS - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fall.append(float(step(params, opt, one)["loss"]))
        walls.append(time.perf_counter() - t0)
    dev_ms, by_name = profile_step(lambda: fall.append(float(step(params, opt, one)["loss"])))
    if not (all(map(math.isfinite, fall)) and fall[-1] < fall[0]):
        fail(f"{cfg.name} (c): the loss does not fall on a repeated batch: {fall}")
    wall_ms = statistics.median(walls[1:]) * 1e3
    print(f"{tag} (c) {FALL_STEPS} steps on one batch, lr {FALL_LR:g}: losses "
          f"{', '.join(f'{x:.4f}' for x in fall)}")
    kernel_ms = {}
    if dev_ms is None:
        print("  device time not measured (the profiler saw no device activity)")
    else:
        print(f"  one step: {dev_ms:.2f} ms of device time (torch.profiler) vs {wall_ms:.2f} ms "
              f"wall unprofiled: device busy {dev_ms / wall_ms:.1%}")
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            print(f"    {ms:9.3f} ms  {name[:100]}")
        marks = {"wkv6_forward_kernel": "wkv6", "wkv6_backward_kernel": "wkv6_backward",
                 "rglru_scan_kernel": "rglru_scan", "rglru_scan_backward_kernel": "rglru_scan_backward"}
        for name, ms in by_name.items():
            for mark, kernel in marks.items():
                if mark in name:
                    kernel_ms[kernel] = kernel_ms.get(kernel, 0.0) + ms
        if kernel_ms:
            print("  the port's kernels in that step: " + ", ".join(
                f"{k} {ms:.2f} ms ({ms / dev_ms:.2%})" for k, ms in kernel_ms.items()))
    card_step = None
    if count:
        from repro_torch.configs.base import ShapeSpec

        card_step = count_card_step(lambda: step(params, opt, one), dev, wall_ms, cfg=cfg,
                                    shape=ShapeSpec(f"phase {tag}", seq, batch, "train"),
                                    tcfg=ctcfg)
        print(f"{tag} one more step for phase 31, counted under CostMode in "
              f"{card_step['counted_s']:.1f} s")
    del params, opt, step, one
    torch.cuda.empty_cache()
    memory_line(tag, "end")
    return {"launches": counts, "step_ms": steady * 1e3, "tokens_per_s": tokens / steady,
            "peak_gb": peak_gb, "device_ms": dev_ms, "wall_ms": wall_ms, "kernel_ms": kernel_ms,
            "counted": card_step}


def run_cross_hazard(tag: str, cfg, dev) -> dict:
    """Phase 29's last part: ``cfg`` (the cross block alone) forward at 1 x
    HAZARD_SEQ tokens over an image context of ``cfg.n_img_tokens`` from
    the seed, bf16 compute on f32 weights, under ``torch.no_grad()``.
    ``attention_any`` takes ``flash_attention`` there with kv chunks of
    ``_largest_chunk(n_img, 1024)``, 1 for a prime n_img (asserted).  Its
    wall time, its device time (torch.profiler), the kv chunk steps
    counted (one PV product of ``flash_attention`` a step, seen in the
    warm-up run through a ``TorchFunctionMode``; gated against the steps the
    chunks give), and what a training step would keep for them, reckoned:
    autograd holds each step's f32 accumulator (B, Hkv, G, q_chunk, Dv)
    for ``acc * corr``."""
    import torch
    from torch.overrides import TorchFunctionMode

    from repro_torch.launch.serve import make_image, make_prompts
    from repro_torch.models import layers
    from repro_torch.models.model import forward, init_params

    class PVSteps(TorchFunctionMode):
        """Counts flash_attention's PV products, one a kv chunk step."""

        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is torch.einsum and args and args[0] == "bhgqk,bkhd->bhgqd":
                self.n += 1
            return func(*args, **(kwargs or {}))

    s, n_img = HAZARD_SEQ, cfg.n_img_tokens
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    batch = {"tokens": torch.from_numpy(make_prompts(cfg, 1, s, seed=3)).to(dev),
             "img": torch.from_numpy(make_image(cfg, 1, s, seed=3)).to(dev)}

    def run():
        return forward(cfg, params, batch, compute_dtype=torch.bfloat16)[0]

    q_chunk, kv_chunk = layers._largest_chunk(s, 1024), layers._largest_chunk(n_img, 1024)
    calls, steps = [], PVSteps()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        with spying(layers, "flash_attention", lambda q, k, v, **kw: calls.append(
                (q.shape[1], k.shape[1], kw["q_chunk"], kw["kv_chunk"], kw["causal"]))), steps:
            run()                                           # warm-up, its steps counted
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        dev_ms, by_name = profile_step(run)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want_steps = (s // q_chunk) * (n_img // kv_chunk)
    heads, n_kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    acc_bytes = n_kv * (heads // n_kv) * q_chunk * hd * 4
    print(f"{tag} the cross block's forward at 1 x {s} over a {n_img}-token image, bf16, no grad: "
          f"flash_attention calls by (Sq, Sk, q_chunk, kv_chunk, causal) {calls}; {steps.n:,} kv "
          f"chunk steps counted ({s // q_chunk} x {n_img // kv_chunk} = {want_steps:,} expected); "
          f"{wall_ms:.1f} ms wall, "
          + (f"{dev_ms:.2f} ms of device time (busy {dev_ms / wall_ms:.1%})" if dev_ms
             else "device time not measured")
          + f"; peak device memory {peak_gb:.2f} GB")
    if dev_ms:
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:5]:
            print(f"    {ms:9.3f} ms  {name[:100]}")
    print(f"{tag} a training step at that length would keep one f32 accumulator of "
          f"(1, {n_kv}, {heads // n_kv}, {q_chunk}, {hd}) = {acc_bytes / 1e6:.1f} MB for each of "
          f"its {want_steps:,} steps in the block's recompute: {want_steps * acc_bytes / 1e9:.1f} GB "
          f"(reckoned, not attempted)")
    if (calls != [(s, n_img, q_chunk, kv_chunk, False)] or steps.n != want_steps
            or not bool(torch.isfinite(out).all()) or out.shape != (1, s, cfg.vocab_size)):
        fail(f"{cfg.name} at 1 x {s}: flash_attention calls {calls}, {steps.n} kv steps "
             f"(expected {want_steps}), logits {tuple(out.shape)} finite "
             f"{bool(torch.isfinite(out).all())}")
    del params, batch, out
    torch.cuda.empty_cache()
    return {"wall_ms": wall_ms, "device_ms": dev_ms, "steps": steps.n,
            "acc_gb": want_steps * acc_bytes / 1e9, "peak_gb": peak_gb}


def run_new_training(dev, counters) -> None:
    """Phases 27-29, each on the emptied card: training deepseek-v3-671b's
    dense prefix, hubert-xlarge and llama-3.2-vision-90b's cross block at
    full width (``run_training``), then the cross block's long forward
    (``run_cross_hazard``)."""
    import torch

    from repro_torch.configs.base import Block

    # deepseek-v3's three dense blocks peak at ~70 GB allocated, which fixed
    # segments left by the earlier phases fragment past the card's 85 GB:
    # from here on the allocator grows segments
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    for tag, (cfg, full), (b, s_len) in (
            ("[27]", cut_config(MLA_ARCH, MLA_TRAIN_LAYERS), MLA_TRAIN_SHAPE),
            ("[28]", cut_config(AUDIO_ARCH, AUDIO_TRAIN_LAYERS), AUDIO_TRAIN_SHAPE),
            ("[29]", cut_config(VLM_ARCH, 1, blocks_pattern=(Block("attn_cross", "dense"),)),
             VLM_TRAIN_SHAPE)):
        torch.cuda.empty_cache()
        t_phase = time.perf_counter()
        run_training(tag, cfg, full, b, s_len, dev, counters, None)
        if cfg.n_img_tokens:
            run_cross_hazard(tag, cfg, dev)
        torch.cuda.empty_cache()
        print(f"  {tag} took {time.perf_counter() - t_phase:.1f} s; "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated")


def run_demo(dev, counters) -> None:
    """Phase 18: demo-100m, the model of examples/train_100m.py, trained
    DEMO_STEPS steps through train(); the loss must fall.  The same run cut
    at DEMO_CUT (a checkpoint), resumed by a fresh train(), must end bit for
    bit where the uninterrupted one does: its losses and its last
    checkpoint's files, under torch.use_deterministic_algorithms."""
    import tempfile
    import warnings

    import numpy as np
    import torch

    from repro_torch.configs.base import Block, ModelConfig
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import train
    from repro_torch.models.model import param_count
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import TrainConfig

    # examples/train_100m.py:49-53
    cfg = ModelConfig(name="demo-100m", family="dense", n_layers=8, d_model=640, n_heads=10,
                      n_kv_heads=5, d_ff=2560, vocab_size=32_000,
                      blocks_pattern=(Block("attn", "dense"),))
    tcfg = TrainConfig(optim=AdamWConfig(lr=6e-4, total_steps=DEMO_STEPS, warmup_steps=20))
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=256, global_batch=8, seed=0)
    print(f"[18] {cfg.name}: {param_count(cfg):,} parameters, batch 8 x 256, "
          f"{tcfg.compute_dtype} compute, lr 6e-4 with 20 warm-up steps")
    with tempfile.TemporaryDirectory() as tmp, warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            def run(name, steps):
                return train(cfg, tcfg, data, steps, ckpt_dir=f"{tmp}/{name}",
                             ckpt_every=DEMO_CUT, seed=0, device=dev)

            whole, counts = counted(counters, lambda: run("whole", DEMO_STEPS))
            first = run("cut", DEMO_CUT)
            second = run("cut", DEMO_STEPS)
        finally:
            torch.use_deterministic_algorithms(False)
        files = {}
        for name in ("whole", "cut"):
            with open(f"{tmp}/{name}/step_{DEMO_STEPS}/meta.json") as f:
                meta = json.load(f)
            files[name] = [np.load(f"{tmp}/{name}/step_{DEMO_STEPS}/{leaf['file']}").tobytes()
                           for leaf in meta["leaves"]]
    if any(counts.values()):
        fail(f"{cfg.name}: kernel launches {counts}, expected none")
    losses = [r["loss"] for r in whole]
    head, tail = statistics.mean(losses[:10]), statistics.mean(losses[-10:])
    steady = statistics.median(r["dt"] for r in whole[1:])
    print(f"[18] {DEMO_STEPS} steps: loss {losses[0]:.4f} -> {losses[-1]:.4f} (mean of the "
          f"first 10 {head:.4f}, of the last 10 {tail:.4f}); {steady * 1e3:.2f} ms/step, "
          f"{8 * 256 / steady:.0f} tokens/s")
    if not (all(map(math.isfinite, losses)) and tail < head - 0.5):
        fail(f"{cfg.name}: the loss does not fall: {head:.4f} -> {tail:.4f}")
    resumed = first + second
    same = [(a["loss"], a["grad_norm"], a["lr"]) == (b["loss"], b["grad_norm"], b["lr"])
            for a, b in zip(whole, resumed)]
    if [r["step"] for r in resumed] != list(range(1, DEMO_STEPS + 1)) or not all(same):
        fail(f"{cfg.name}: the run resumed at step {DEMO_CUT} differs from the uninterrupted one "
             f"at steps {[i + 1 for i, ok in enumerate(same) if not ok][:10]}")
    if files["whole"] != files["cut"]:
        fail(f"{cfg.name}: the step-{DEMO_STEPS} checkpoints differ")
    notes = sorted({str(w.message)[:120] for w in caught})
    print(f"[18] saved at step {DEMO_CUT}, resumed by a fresh train(): steps "
          f"{DEMO_CUT + 1}-{DEMO_STEPS} bit for bit (loss, grad norm, lr) and the step-"
          f"{DEMO_STEPS} checkpoint's {len(files['whole'])} files byte for byte, under "
          f"torch.use_deterministic_algorithms(True, warn_only=True); its warnings: "
          f"{notes or 'none'}")


def memory_line(tag: str, when: str) -> None:
    import torch

    if when == "start":
        torch.cuda.reset_peak_memory_stats()
        print(f"{tag} device memory at the start: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
              "allocated")
    else:
        print(f"{tag} peak device memory: {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")


def card_state(tag: str) -> None:
    """The card's clocks, power draw and temperature, beside a timing."""
    state = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{tag} card before the timings (SM clock, memory clock, power draw, "
          f"temperature): {state}")


def gradient_shapes():
    """The shapes of one device's share of the rwkv6-7b gradient (meta
    tensors): embedding, lm_head, final norm and the first FILTER_BLOCKS
    blocks, in the order of the port's parameter tree."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import init_params

    tree = init_params(get_config(RWKV), None, "meta")
    tree["layers"] = tree["layers"][:FILTER_BLOCKS]
    return tree


def map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(v, fn) for v in tree]
    return fn(tree)


def check_filter_round(label: str, ref, g, r, send, new_r, stats, exact_sum: bool) -> float:
    """Each leaf of a filter_gradient call bit-exact against the plain
    version, one leaf at a time so the plain version never doubles the
    memory; the stats against the sum of the plain counts; with
    ``exact_sum`` (f32 g and r) send + new_r == g + r.  Returns the density."""
    import torch

    leaves = [_tensors(t) for t in (g, r, send, new_r)]
    kept = total = 0
    for i, (gl, rl, sl, nl) in enumerate(zip(*leaves)):
        ws, wr, wk = ref(gl, rl, TAU)
        same_bits(f"{label} leaf {i} send", sl, ws)
        same_bits(f"{label} leaf {i} new_r", nl, wr)
        if exact_sum and not torch.equal(sl + nl, gl + rl):
            fail(f"{label} leaf {i}: send + new_r != g + r")
        kept += int(wk)
        total += gl.numel()
        del ws, wr, wk
    density = torch.tensor(kept, dtype=torch.float32) / torch.tensor(total, dtype=torch.float32)
    got = {k: v.cpu() for k, v in stats.items()}
    want = {"kept": torch.tensor(kept, dtype=torch.int32),
            "total": torch.tensor(total, dtype=torch.int32), "density": density}
    for key in want:
        if got[key].dtype != want[key].dtype or not torch.equal(got[key], want[key]):
            fail(f"{label}: stats[{key!r}] {got[key]} vs the plain counts' {want[key]}")
    return float(density)


def run_filter(ops, ref, counters: dict, shapes, dev) -> dict:
    """Phase 9: filter_gradient over the tree of ``shapes``, two rounds of
    error feedback, f32 g and r, then bf16 g and f32 r.  Each dtype's two
    calls are the main path, with every kernel's count set to 0 just before
    and read just after; then the whole call's device time from a CUDA graph
    of its launches, one eager call's wall time, the plain version's device
    time over the tree, and the kernel at a block's largest leaf."""
    import torch

    memory_line("[9]", "start")
    leaves = _tensors(shapes)
    n = sum(x.numel() for x in leaves)
    print(f"[9] filter_gradient over {len(leaves)} leaves, {n:,} elements (reduced: the "
          f"embedding, lm_head, final norm and {FILTER_BLOCKS} of the 32 blocks of {RWKV}, "
          f"about one device's share at data x model = 2 x 2; stats['total'] is int32), "
          f"tau {TAU}")
    gen = torch.Generator(device=dev).manual_seed(0)
    launches = {name: 0 for name in counters}
    timings = {}
    for label, g_dt in (("f32", torch.float32), ("bf16 g", torch.bfloat16)):
        r = map_tree(shapes, lambda x: torch.zeros(x.shape, device=dev))
        for fn in counters.values():
            fn.launches = 0
        for rnd in (1, 2):
            g = map_tree(shapes, lambda x, dt=g_dt: torch.randn(
                x.shape, generator=gen, device=dev, dtype=dt))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            send, new_r, stats = ops.filter_gradient(g, r, TAU)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            density = check_filter_round(f"filter {label} round {rnd}", ref, g, r, send, new_r,
                                         stats, exact_sum=g_dt == torch.float32)
            print(f"  {label} round {rnd}: density {density:.6f} ({int(stats['kept']):,} kept), "
                  f"{wall:.2f} ms wall, bit-exact leaf by leaf"
                  + (", send + new_r == g + r" if g_dt == torch.float32 else ""))
            if rnd == 1:
                del g, send, r, stats
                r = new_r
            del new_r
        counts = {name: fn.launches for name, fn in counters.items()}
        expected = {name: 0 for name in counters} | {"whitedata_filter": 2 * len(leaves)}
        if counts != expected:
            fail(f"filter {label}: kernel launches {counts}, expected {expected}")
        print(f"  {label}: kernel launches over the two calls {counts}")
        for name in counters:
            launches[name] += counts[name]

        # ---- timings, outside the counted run, on round 2's inputs
        del send
        torch.cuda.empty_cache()
        card_state("  ")
        bound_ms, bound_by = filter_bound(n, g_dt.itemsize, 4)
        ms = device_ms([lambda: ops.filter_gradient(g, r, TAU)])
        torch.cuda.empty_cache()

        def plain_tree():
            for gl, rl in zip(_tensors(g), _tensors(r)):
                ref(gl, rl, TAU)

        plain_ms = device_ms([plain_tree], reps=3)
        torch.cuda.empty_cache()
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ops.filter_gradient(g, r, TAU)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        eager_ms = statistics.median(walls)
        print(f"  {label} tree: {ms:.4f} ms on the device ({len(leaves)} launches in one CUDA "
              f"graph), {eager_ms:.3f} ms per eager call (wall), plain {plain_ms:.3f} ms; bound "
              f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of bound")
        del g, r
        torch.cuda.empty_cache()

        def leaf_inputs(*shape, dt=g_dt):
            return (torch.randn(shape, generator=gen, device=dev, dtype=dt),
                    torch.randn(shape, generator=gen, device=dev) * 0.5)

        block = time_kernel(
            f"whitedata_filter {label} leaf", lambda a, b: ops.whitedata_filter(a, b, TAU),
            lambda a, b: ref(a, b, TAU), leaf_inputs, (4096, 14336),
            lambda *sh, dt=g_dt: (dt.itemsize + 4) * sh[0] * sh[1],
            lambda *sh, dt=g_dt: filter_bound(sh[0] * sh[1], dt.itemsize, 4))
        a, b = leaf_inputs(4096, 14336)
        for part, x, y in zip(("send", "new_r", "kept"), ops.whitedata_filter(a, b, TAU),
                              ref(a, b, TAU)):
            same_bits(f"whitedata_filter {label} leaf {part}", x, y)
        del a, b
        torch.cuda.empty_cache()
        timings[label] = {"shape": f"{RWKV} gradient tree, {FILTER_BLOCKS} of 32 blocks: "
                                   f"{len(leaves)} leaves, {n:,} elements, {label}",
                          "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                          "bound_by": bound_by, "eager_call_ms": eager_ms, "block_leaf": block}
    memory_line("[9]", "end")
    return {"launches": launches, "timings": timings}


def ycsb_replicas(dev, rows: int, words: int):
    """REPLICAS batches of (rows, words) int32 payloads with int32 versions,
    from seed 0 on ``dev``: each row's top version lies on a replica drawn
    uniformly, the others below it, and on ~TIE_SHARE of the rows the next
    replica ties on the top with a different payload.  Returns the batches
    and the versions (REPLICAS, rows)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(0)
    vals = [merge_payload(gen, rows, words, torch.int32) for _ in range(REPLICAS)]
    kw = dict(generator=gen, device=dev)
    winner = torch.randint(0, REPLICAS, (1, rows), **kw)
    top = torch.randint(1000, 2**30, (1, rows), **kw, dtype=torch.int32)
    vers = top - torch.randint(1, 1000, (REPLICAS, rows), **kw, dtype=torch.int32)
    vers.scatter_(0, winner, top)
    tie = torch.rand((1, rows), **kw) < TIE_SHARE
    second = (winner + 1) % REPLICAS
    vers.scatter_(0, second, torch.where(tie, top, vers.gather(0, second)))
    return [(vals[i], vers[i]) for i in range(REPLICAS)], vers


def run_merge(ops, ref, counters: dict, dev, rows: int = YCSB_ROWS,
              words: int = YCSB_WORDS, chunk: int = MERGE_CHUNK) -> dict:
    """Phase 10: crdt_merge_many over REPLICAS replicas of a YCSB table, with
    every kernel's count set to 0 just before and read just after; bit-exact
    against the plain fold one chunk of rows at a time; ACI at full size;
    one merge's device time against its bound."""
    import torch

    memory_line("[10]", "start")
    batches, vers = ycsb_replicas(dev, rows, words)
    top = vers.max(dim=0).values
    at_top = vers == top
    unique = at_top.sum(dim=0) == 1
    print(f"[10] crdt_merge_many over {REPLICAS} replicas of {rows:,} YCSB records "
          f"({words} int32 words = {4 * words} bytes each, int32 versions; "
          f"{REPLICAS * rows * (4 * words + 4) / 1e9:.2f} GB); rows on top per replica "
          + ", ".join(f"{int(x):,}" for x in at_top.sum(dim=1))
          + f"; {rows - int(unique.sum()):,} rows tie on the top version")
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_val, out_ver = ops.crdt_merge_many(batches)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = {name: fn.launches for name, fn in counters.items()}
    expected = {name: 0 for name in counters} | {"crdt_merge": REPLICAS - 1}
    if launches != expected:
        fail(f"crdt_merge_many: kernel launches {launches}, expected {expected}")
    print(f"  main call: {wall:.2f} ms wall, kernel launches {launches}")

    for lo in range(0, rows, chunk):
        sl = slice(lo, lo + chunk)
        want_val, want_ver = batches[0][0][sl], batches[0][1][sl]
        for vb, rb in batches[1:]:
            want_val, want_ver = ref(want_val, want_ver, vb[sl], rb[sl])
        same_bits(f"crdt_merge_many rows {lo}+ values", out_val[sl], want_val)
        same_bits(f"crdt_merge_many rows {lo}+ versions", out_ver[sl], want_ver)
    del want_val, want_ver
    print(f"  bit-exact against the plain fold, {chunk:,} rows at a time")

    # ---- ACI at full size
    rev_val, rev_ver = ops.crdt_merge_many(batches[::-1])
    if not torch.equal(rev_ver, out_ver):
        fail("crdt_merge_many: the reversed order gives other versions")
    differ = 0
    for lo in range(0, rows, chunk):
        sl = slice(lo, lo + chunk)
        rows_differ = (rev_val[sl] != out_val[sl]).any(dim=1)
        if (rows_differ & unique[sl]).any():
            fail(f"crdt_merge_many: the reversed order differs on a row with a unique top "
                 f"version (rows {lo}+)")
        differ += int(rows_differ.sum())
    del rev_val, rev_ver
    if not 0 < differ <= rows - int(unique.sum()):
        fail(f"crdt_merge_many: {differ} rows differ in reversed order, expected the tied rows")
    same_val, same_ver = ops.crdt_merge(out_val, out_ver, out_val, out_ver)
    if not (torch.equal(same_val, out_val) and torch.equal(same_ver, out_ver)):
        fail("crdt_merge(x, x) != x")
    del same_val, same_ver
    dup_val, dup_ver = ops.crdt_merge_many(batches + [batches[0]])
    if not (torch.equal(dup_val, out_val) and torch.equal(dup_ver, out_ver)):
        fail("crdt_merge_many: a duplicated batch changed the result")
    del dup_val, dup_ver
    print(f"  ACI: reversed order equal versions, equal payloads on every row with a unique "
          f"top ({differ:,} tied rows keep their first batch's payload); merge(x, x) == x; a "
          f"duplicated batch changes nothing")
    ranked = ranked_join_api(ops, counters, out_val, out_ver, dev)
    del out_val, out_ver

    # ---- one merge's device time, outside the counted run
    torch.cuda.empty_cache()
    card_state("  ")
    (va, ra), (vb, rb) = batches[0], batches[1]
    main = time_kernel("crdt_merge", ops.crdt_merge, ref, lambda *shape: (va, ra, vb, rb),
                       (rows, words), lambda m, n: 2 * (4 * m * n + 4 * m),
                       lambda m, n: merge_bound(m, n, 4), n_sets=1)
    both_sides = (2 * rows * words * 4 + 12 * rows) / (3 * rows * words * 4 + 12 * rows)
    print(f"  one input set ({2 * (4 * rows * words + 4 * rows) / 1e9:.2f} GB, "
          f"{2 * (4 * rows * words + 4 * rows) / L2_BYTES:.0f}x the L2); the bound counts the "
          f"winner's payload only: a kernel that reads both sides is held to "
          f"{both_sides:.1%} of it; library_ms = plain_ms (torch.where + torch.maximum)")
    dst = torch.empty_like(va)
    copy_ms = device_ms([lambda: dst.copy_(va)])
    nbytes = 2 * va.numel() * va.element_size()
    print(f"  the card's copy rate on the same bytes (torch copy_ of one replica's payload, "
          f"{nbytes / 1e9:.2f} GB read + written): {copy_ms:.4f} ms, "
          f"{nbytes / copy_ms / 1e9:.3f} TB/s, {nbytes / HBM_BYTES_PER_S * 1e3 / copy_ms:.1%} of "
          f"{HBM_BYTES_PER_S / 1e12:g} TB/s; the merge moves its "
          f"{main['bound_ms'] * HBM_BYTES_PER_S / 1e12:.2f} GB at "
          f"{main['bound_ms'] * HBM_BYTES_PER_S / main['ms'] / 1e12:.3f} TB/s")
    main["copy_ms"] = copy_ms
    del batches, vers, va, vb, ra, rb, dst
    torch.cuda.empty_cache()
    memory_line("[10]", "end")
    return {"launches": launches, "wall_ms": wall, "main": main, "ranked_launches": ranked}


def ranked_join_api(ops, counters: dict, table, versions, dev) -> int:
    """The ranked join through its ops-level API on the merged table: a
    commit's JOIN_ROWS distinct rows joined by their int32 versions
    (``crdt_merge_rows``, each new version one below, equal to or one above
    the row's), with every kernel count 0 just before and read just after;
    the rows and out_rank against the function.  Returns its launches."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(10)
    rows = torch.randperm(table.shape[0], generator=gen, device=dev)[:JOIN_ROWS]
    cur = versions[rows]
    new = cur + torch.randint(-1, 2, cur.shape, generator=gen, device=dev, dtype=torch.int32)
    new_val = merge_payload(gen, JOIN_ROWS, table.shape[1], table.dtype)
    want = torch.where((new > cur)[:, None], new_val, table[rows])
    out_rank, counts = counted(counters, lambda: ops.crdt_merge_rows(table, rows, cur, new_val,
                                                                     new))
    torch.cuda.synchronize()
    if counts != {name: 0 for name in counters} | {"crdt_merge_rows": 1}:
        fail(f"crdt_merge_rows through its API: kernel launches {counts}")
    same_bits("crdt_merge_rows through its API: the rows", table[rows], want)
    same_bits("crdt_merge_rows through its API: out_rank", out_rank, torch.maximum(cur, new))
    print(f"  crdt_merge_rows through its API: {JOIN_ROWS:,} rows joined into the merged table "
          f"by their int32 versions ({int((new > cur).sum()):,} taken), one launch, every "
          f"other kernel 0; the rows and out_rank as the function gives them")
    return counts["crdt_merge_rows"]


def pod_rank(rank: int, ref_dir: str) -> dict:
    """Phase 19, in one of two spawned processes, both on cuda:0: the main
    path (train() with geococo, then with flat) with the WKV6 counts read
    around each run, then the step-level checks (residuals after one step;
    geococo at density 1.0 against flat from the same state); last, on the
    same (2, 1, 1) mesh, phase 21's yardstick (``inpod_reference_rank``,
    its gradient written to ``ref_dir``), which spares phase 21 a spawn of
    its own.  Returns what the parent gates across the ranks."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.dist.collectives import SyncConfig
    from repro_torch.dist.grouping import zero_residuals
    from repro_torch.kernels.rwkv6_wkv import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import train
    from repro_torch.models.model import init_params
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.train_step import TrainConfig, build_train_step
    from repro_torch.tree import leaves

    dev = torch.device("cuda", 0)
    mesh, _ = make_mesh((2, 1, 1), device=dev)
    cfg = dataclasses.replace(get_config(RWKV), n_layers=POD_LAYERS)
    geo = TrainConfig(sync=SyncConfig("geococo", **POD_SYNC))
    flat = TrainConfig(sync=SyncConfig("flat"))
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=POD_SEQ, global_batch=POD_BATCH, seed=0)
    counters = {"wkv6": ops.wkv6, "wkv6_backward": ops.wkv6_backward}
    out = {}
    for name, tcfg, steps in (("geococo", geo, POD_GEO_STEPS), ("flat", flat, POD_FLAT_STEPS)):
        torch.cuda.reset_peak_memory_stats()
        hist, counts = counted(counters, lambda: train(cfg, tcfg, data, steps, seed=0, device=dev,
                                                       mesh=mesh))
        out[name] = {"history": hist, "launches": counts,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        torch.cuda.empty_cache()

    def fresh(tcfg):
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        return params, adamw_init(params, tcfg.optim), build_train_step(cfg, tcfg, dev, mesh)

    batch = make_batch(data, 0)
    # one geococo step from the start: the residuals each pod keeps
    params, opt, step = fresh(geo)
    res = zero_residuals(cfg, dev)
    step(params, opt, batch, res)
    out["residuals"] = {k: (int(r.view(torch.int32).sum(dtype=torch.int64)), float(r.abs().max()),
                            r.numel()) for k, r in res.items()}
    del params, opt, step, res
    torch.cuda.empty_cache()
    # geococo at density 1.0 and flat, each one step from the same state
    dense = TrainConfig(sync=SyncConfig("geococo", **dict(POD_SYNC, density=1.0)))
    params, opt, step = fresh(dense)
    step(params, opt, batch, zero_residuals(cfg, dev))
    after_dense = [p.detach().cpu() for p in leaves(params)]
    del params, opt, step
    torch.cuda.empty_cache()
    params, opt, step = fresh(flat)
    step(params, opt, batch)
    out["dense_vs_flat"] = max(float((p.detach().cpu() - q).abs().max())
                               for p, q in zip(leaves(params), after_dense))
    del params, opt, step, after_dense
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["inpod_ref"] = inpod_reference_rank(rank, ref_dir)
    out["inpod_ref"]["seconds"] = time.perf_counter() - t0
    return out


@contextlib.contextmanager
def shared_card():
    """The ranks spawned inside share the card's 80 GB: their allocators
    grow segments rather than reserve fixed blocks."""
    import os

    before = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        yield
    finally:
        if before is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = before


def run_pods(ref_dir: str) -> tuple[float, list]:
    """Phase 19: rwkv6-7b across two pods on the card (two ranks of one gloo
    group, spawned by ``launch.mesh.run_local_ranks``), gated here across
    the ranks.  Returns the bytes flat handed to gloo a rank in its last
    step, and phase 21's yardstick by rank (its gradient in ``ref_dir``)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.dist.collectives import SyncConfig, estimate_sync_bytes
    from repro_torch.dist.grouping import group_like_reference
    from repro_torch.dist.sharding import param_specs
    from repro_torch.launch.mesh import run_local_ranks
    from repro_torch.models.model import init_params, param_count
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(get_config(RWKV), n_layers=POD_LAYERS)
    grouped = group_like_reference(cfg, leaves(init_params(cfg, None, "meta")))
    specs = param_specs(grouped, {"pod": 2, "data": 1, "model": 1}, "geococo")
    if any(axis is not None for spec in specs.values() for axis in spec):
        fail(f"[19] a leaf is split on the (2, 1, 1) mesh: {specs}")
    n = param_count(cfg)
    print(f"[19] {cfg.name} across 2 pods on one card (2 ranks over gloo, each a CUDA context on "
          f"cuda:0): full width, {POD_LAYERS} of 32 layers, {n:,} parameters a pod, global batch "
          f"{POD_BATCH} x {POD_SEQ} ({POD_BATCH // 2} x {POD_SEQ} a pod), bf16 compute, remat; "
          f"{len(grouped)} leaves in the reference's layout; geococo {POD_SYNC}")
    try:
        with shared_card():
            ranks = run_local_ranks(pod_rank, 2, (ref_dir,), timeout=POD_TIMEOUT)
    except (RuntimeError, TimeoutError) as err:
        fail(f"[19] {err}")
    for name, strategy in (("geococo", SyncConfig("geococo", **POD_SYNC)),
                           ("flat", SyncConfig("flat"))):
        estimate = estimate_sync_bytes(grouped, strategy, 2)
        steps = len(ranks[0][name]["history"])
        want_launches = {"wkv6": 2 * POD_LAYERS * steps, "wkv6_backward": POD_LAYERS * steps}
        for rank, got in enumerate(ranks):
            hist = got[name]["history"]
            if got[name]["launches"] != want_launches:
                fail(f"[19] {name}, rank {rank}: launches {got[name]['launches']}, "
                     f"expected {want_launches}")
            for rec in hist:
                if not math.isfinite(rec["loss"]):
                    fail(f"[19] {name}, rank {rank}, step {rec['step']}: loss {rec['loss']}")
                if rec["pods_agree"] != 1.0:
                    fail(f"[19] {name}, step {rec['step']}: the pods' parameters differ")
                counted_bytes = 2.0 * (2 - 1) / 2 * (4 * rec["dense_values"]
                                                      + 8 * rec["sparse_values"])
                if counted_bytes != estimate:
                    fail(f"[19] {name}, rank {rank}, step {rec['step']}: the wire values counted "
                         f"({rec['dense_values']:.0f} dense, {rec['sparse_values']:.0f} top-k) "
                         f"give {counted_bytes:.0f} B, estimate_sync_bytes {estimate:.0f} B")
        if [r["loss"] for r in ranks[0][name]["history"]] != [r["loss"] for r in
                                                               ranks[1][name]["history"]]:
            fail(f"[19] {name}: the ranks report different pod-mean losses")
        losses = ", ".join(f"{r['loss']:.4f}" for r in ranks[0][name]["history"])
        print(f"[19] {name}: {steps} step{'s' * (steps > 1)} of train(), pod-mean losses "
              f"{losses}; "
              f"parameters bit-identical across the pods after every step; launches a rank "
              f"{counts_text(ranks[0][name]['launches'])} ({2 * POD_LAYERS} forward, "
              f"{POD_LAYERS} backward a step); wire values counted = the wire model "
              f"(estimate_sync_bytes, a (value, index) pair a selection) {estimate / 1e9:.4f} GB "
              f"a rank a step, handed to gloo {ranks[0][name]['history'][-1]['bytes_sent'] / 1e9:.4f}"
              f" GB (dense, masked); peak device memory "
              f"{ranks[0][name]['peak_gb']:.2f} / {ranks[1][name]['peak_gb']:.2f} GB")
        for rank, got in enumerate(ranks):
            for rec in got[name]["history"]:
                device_s = rec["exchange_s"] - rec["exchange_host_s"]
                print(f"  rank {rank} step {rec['step']}: {rec['dt'] * 1e3:.1f} ms = forward + "
                      f"backward {rec['compute_s'] * 1e3:.1f}, exchange {rec['exchange_s'] * 1e3:.1f} "
                      f"(device {device_s * 1e3:.1f}, host staging + gloo "
                      f"{rec['exchange_host_s'] * 1e3:.1f}), AdamW {rec['adamw_s'] * 1e3:.1f}; "
                      f"{rec['bytes_sent'] / 1e9:.3f} GB to gloo; top-k selections "
                      f"{rec['sparse_values']:.0f}, nonzero {rec['nonzero_sent']:.0f}")
    res = [got["residuals"] for got in ranks]
    for key, (sum0, max0, size) in res[0].items():
        sum1, max1, _ = res[1][key]
        filtered = size >= POD_SYNC["min_leaf_size"]
        if filtered and not (max0 > 0 and max1 > 0 and sum0 != sum1):
            fail(f"[19] residual {key} after one step: max |r| {max0:g} / {max1:g}, "
                 f"checksums {sum0} / {sum1}: expected nonzero and different per pod")
        if not filtered and (max0 or max1):
            fail(f"[19] residual {key} of a densely exchanged leaf is nonzero")
    diff = max(got["dense_vs_flat"] for got in ranks)
    print(f"[19] after one geococo step: every filtered leaf's residual nonzero and different "
          f"between the pods ({sum(v[2] >= POD_SYNC['min_leaf_size'] for v in res[0].values())} "
          f"leaves), the dense ones 0; geococo at density 1.0 vs flat from the same state: "
          f"max |difference| of the parameters {diff:g} (two pods: each sum adds the same two "
          f"operands, so the gate is 0)")
    if diff != 0.0:
        fail(f"[19] geococo at density 1.0 differs from flat by {diff:g}")
    return ranks[0]["flat"]["history"][-1]["bytes_sent"], [got["inpod_ref"] for got in ranks]


def inpod_config():
    from repro_torch.configs.registry import get_config

    return dataclasses.replace(get_config(RWKV), n_layers=POD_LAYERS)


def inpod_data(cfg):
    from repro_torch.data.pipeline import DataConfig

    return DataConfig(vocab_size=cfg.vocab_size, seq_len=POD_SEQ, global_batch=INPOD_BATCH, seed=0)


def inpod_reference_rank(rank: int, out_dir: str) -> dict:
    """Phase 21's yardstick, in one of phase 19's two ranks on cuda:0: the
    synced gradient of one hier step on (2, 1, 1) with 2 microbatches (the
    rows each (2, 2, 1) rank computes on, one microbatch each), from the
    seed-0 parameters and the first global batch, and the same with the
    batch's rows reversed, its noise floor.  Pod 0 writes the gradient to
    ``out_dir``."""
    import os

    import torch
    import torch.distributed as dist

    from repro_torch.data.pipeline import make_batch
    from repro_torch.dist.collectives import SyncConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import init_params
    from repro_torch.train.train_step import SyncGrads, TrainConfig
    from repro_torch.tree import leaf_paths

    dev = torch.device("cuda", 0)
    mesh, _ = make_mesh((2, 1, 1), device=dev)
    cfg = inpod_config()
    tcfg = TrainConfig(sync=SyncConfig("hier", ring_order=(1, 0)), microbatches=2)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    sync = SyncGrads(cfg, tcfg, dev, mesh)
    batch = make_batch(inpod_data(cfg), 0)
    grads, loss, _ = sync(params, batch)
    flipped, loss_flipped, _ = sync(params, {k: v.flip(0) for k, v in batch.items()})
    keys = [key for key, _ in leaf_paths(params)]
    floors = {key: float((a - b).norm() / b.norm().clamp_min(1e-30))
              for key, a, b in zip(keys, flipped, grads)}
    del flipped
    losses = torch.stack([loss, loss_flipped]).float().cpu()
    dist.all_reduce(losses)
    if mesh.coords["pod"] == 0:
        torch.save({key: g.detach().cpu() for key, g in zip(keys, grads)},
                   os.path.join(out_dir, "grads.pt"))
    dist.barrier()
    return {"floors": floors, "loss": float(losses[0] / 2), "loss_flipped": float(losses[1] / 2)}


def inpod_rank(rank: int, ref_dir: str) -> dict:
    """Phase 21, in one of four spawned processes, all on cuda:0, on the
    (2, 2, 1) mesh: the main path (train() with hier, then geococo) with the
    WKV6 counts read around each run, then the step-level checks from the
    seed-0 state (the residual blocks after one geococo step; hier against
    geococo at density 1.0; hier against the (2, 1, 1) gradient in
    ``ref_dir``)."""
    import math
    import os

    import torch
    import torch.distributed as dist

    from repro_torch.data.pipeline import make_batch
    from repro_torch.dist.collectives import SyncConfig
    from repro_torch.dist.grouping import leaf_specs, zero_residuals
    from repro_torch.dist.inpod import InPodGroup
    from repro_torch.dist.sharding import local_shard
    from repro_torch.kernels.rwkv6_wkv import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import StatePlacement, train
    from repro_torch.models.model import init_params
    from repro_torch.train.train_step import SyncGrads, TrainConfig

    dev = torch.device("cuda", 0)
    mesh, _ = make_mesh(INPOD_MESH, device=dev)
    cfg = inpod_config()
    hier = TrainConfig(sync=SyncConfig("hier", ring_order=POD_SYNC["ring_order"]))
    geo = TrainConfig(sync=SyncConfig("geococo", **POD_SYNC))
    data = inpod_data(cfg)
    counters = {"wkv6": ops.wkv6, "wkv6_backward": ops.wkv6_backward}
    out = {"coords": dict(mesh.coords)}
    for name, tcfg, steps in (("hier", hier, INPOD_HIER_STEPS), ("geococo", geo, INPOD_GEO_STEPS)):
        torch.cuda.reset_peak_memory_stats()
        hist, counts = counted(counters, lambda: train(cfg, tcfg, data, steps, seed=0, device=dev,
                                                       mesh=mesh))
        out[name] = {"history": hist, "launches": counts,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        torch.cuda.empty_cache()

    def blocks(tcfg):
        full = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        return StatePlacement(cfg, tcfg, dev, mesh).place(full, "params")

    batch = make_batch(data, 0)
    # one geococo step from the start: the residual blocks each pod keeps
    params, res = blocks(geo), zero_residuals(cfg, dev, mesh.shape, "geococo")
    SyncGrads(cfg, geo, dev, mesh)(params, batch, res)
    out["residuals"] = {k: (int(r.view(torch.int32).sum(dtype=torch.int64)), float(r.abs().max()),
                            r.numel()) for k, r in res.items()}
    del params, res
    torch.cuda.empty_cache()
    # hier and geococo at density 1.0 from the same state: the synced blocks
    params = blocks(hier)
    g_hier, loss, _ = SyncGrads(cfg, hier, dev, mesh)(params, batch)
    dense = TrainConfig(sync=SyncConfig("geococo", **dict(POD_SYNC, density=1.0)))
    g_dense, _, _ = SyncGrads(cfg, dense, dev, mesh)(
        params, batch, zero_residuals(cfg, dev, mesh.shape, "geococo"))
    out["dense_vs_hier"] = max(float((a - b).abs().max()) for a, b in zip(g_dense, g_hier))
    del g_dense
    # hier against (2, 1, 1) with 2 microbatches: per leaf the norm of the
    # difference over the norm of the (2, 1, 1) gradient, each block counted once
    want = torch.load(os.path.join(ref_dir, "grads.pt"), mmap=True)
    inpod = InPodGroup(mesh)
    specs = leaf_specs(cfg, mesh.shape, "hier")
    sums = []
    for (key, spec), got in zip(specs.items(), g_hier):
        w = local_shard(want[key], spec, mesh.coords, mesh.shape).to(dev)
        part = torch.stack([(got.float() - w.float()).square().sum(), w.float().square().sum()])
        sums.append(part if inpod.counts_once(spec) else torch.zeros_like(part))
    total = inpod.all_reduce_sum(torch.stack(sums)).cpu()
    out["vs_211"] = {key: math.sqrt(d) / max(math.sqrt(n), 1e-30)
                     for key, (d, n) in zip(specs, total.tolist())}
    mean = loss.detach().float().reshape(1).cpu()
    dist.all_reduce(mean)
    out["loss"] = float(mean[0]) / mesh.size
    return out


def run_inpod(flat_bytes: float, ref: list, ref_dir: str) -> None:
    """Phase 21: rwkv6-7b on a (2, 2, 1) mesh on the card (four ranks of one
    gloo group), gated here across the ranks.  ``flat_bytes``: what flat
    handed to gloo a rank a step in phase 19, on (2, 1, 1); ``ref``: the
    yardstick on (2, 1, 1) by rank, which phase 19's ranks computed, its
    gradient in ``ref_dir``."""
    import torch

    from repro_torch.dist.collectives import SyncConfig, estimate_sync_bytes
    from repro_torch.dist.grouping import group_like_reference, grouped_specs
    from repro_torch.dist.sharding import local_shape
    from repro_torch.launch.mesh import run_local_ranks
    from repro_torch.models.model import init_params
    from repro_torch.tree import leaves

    cfg = inpod_config()
    sizes = dict(zip(("pod", "data", "model"), INPOD_MESH))
    n_ranks = math.prod(INPOD_MESH)
    grouped = group_like_reference(cfg, leaves(init_params(cfg, None, "meta")))
    specs = grouped_specs(cfg, sizes, "hier")
    mine = {k: torch.empty(local_shape(v.shape, specs[k], sizes), device="meta")
            for k, v in grouped.items()}
    replicated = {k: v.numel() for k, v in grouped.items() if not any(specs[k])}
    n_full, n_rank = sum(v.numel() for v in grouped.values()), sum(v.numel() for v in mine.values())
    print(f"[21] {cfg.name} on a {INPOD_MESH} mesh on one card (4 ranks over gloo, each a CUDA "
          f"context on cuda:0): full width, {POD_LAYERS} of 32 layers, {n_full:,} parameters, "
          f"{n_rank:,} a rank ({len(mine) - len(replicated)} leaves split over data, "
          f"{len(replicated)} whole: {sum(replicated.values()):,} values); global batch "
          f"{INPOD_BATCH} x {POD_SEQ} (1 x {POD_SEQ} a rank), bf16 compute, remat; hier on the "
          f"ring {POD_SYNC['ring_order']}, geococo {POD_SYNC}")
    print(f"[21] the (2, 1, 1) yardstick (hier, 2 microbatches of 1 x {POD_SEQ}), computed by "
          f"phase 19's two ranks in {max(r['seconds'] for r in ref):.1f} s")
    with shared_card():
        try:
            ranks = run_local_ranks(inpod_rank, n_ranks, (ref_dir,), timeout=INPOD_TIMEOUT)
        except (RuntimeError, TimeoutError) as err:
            fail(f"[21] {err}")
    per_pod = n_ranks // INPOD_MESH[0]
    for name, strategy in (("hier", SyncConfig("hier", ring_order=POD_SYNC["ring_order"])),
                           ("geococo", SyncConfig("geococo", **POD_SYNC))):
        model = estimate_sync_bytes(mine, strategy, INPOD_MESH[0])
        reference = estimate_sync_bytes(grouped, strategy, INPOD_MESH[0],
                                        shard_factor=per_pod) / per_pod
        steps = len(ranks[0][name]["history"])
        want_launches = {"wkv6": 2 * POD_LAYERS * steps, "wkv6_backward": POD_LAYERS * steps}
        for rank, got in enumerate(ranks):
            if got[name]["launches"] != want_launches:
                fail(f"[21] {name}, rank {rank}: launches {got[name]['launches']}, "
                     f"expected {want_launches}")
            for rec in got[name]["history"]:
                if not math.isfinite(rec["loss"]):
                    fail(f"[21] {name}, rank {rank}, step {rec['step']}: loss {rec['loss']}")
                if rec["pods_agree"] != 1.0:
                    fail(f"[21] {name}, step {rec['step']}: the pods' blocks differ")
                counted_bytes = 2.0 * (2 - 1) / 2 * (4 * rec["dense_values"]
                                                      + 8 * rec["sparse_values"])
                if counted_bytes != model:
                    fail(f"[21] {name}, rank {rank}, step {rec['step']}: the wire values counted "
                         f"({rec['dense_values']:.0f} dense, {rec['sparse_values']:.0f} top-k) "
                         f"give {counted_bytes:.0f} B, the per-rank wire model {model:.0f} B")
        losses = [[r["loss"] for r in got[name]["history"]] for got in ranks]
        peaks = ", ".join(f"{got[name]['peak_gb']:.2f}" for got in ranks)
        if any(one != losses[0] for one in losses):
            fail(f"[21] {name}: the ranks report different mean losses")
        print(f"[21] {name}: {steps} step{'s' * (steps > 1)} of train(), mean losses "
              f"{', '.join(f'{v:.4f}' for v in losses[0])}; within every pod group the blocks "
              f"bit-identical after every step, and within every pod the whole leaves; launches a "
              f"rank {counts_text(ranks[0][name]['launches'])}; wire values counted = the "
              f"per-rank wire model {model / 1e9:.4f} GB a rank a step; the reference's "
              f"estimate_sync_bytes(shard_factor={per_pod}) / {per_pod} = "
              f"{reference / 1e9:.4f} GB, the difference {model - reference:+.0f} B (it counts "
              f"a whole leaf once a pod, every in-pod rank sends it); peak device memory a "
              f"rank {peaks} GB")
        for rank, got in enumerate(ranks):
            for rec in got[name]["history"]:
                compute = rec["compute_s"] - rec["inpod_s"]
                print(f"  rank {rank} step {rec['step']}: {rec['dt'] * 1e3:.1f} ms = forward + "
                      f"backward {compute * 1e3:.1f} + in-pod gathers and reduce-scatters "
                      f"{rec['inpod_s'] * 1e3:.1f} (device {(rec['inpod_s'] - rec['inpod_host_s']) * 1e3:.1f}"
                      f", host staging + gloo {rec['inpod_host_s'] * 1e3:.1f}), pod exchange "
                      f"{rec['exchange_s'] * 1e3:.1f} (device "
                      f"{(rec['exchange_s'] - rec['exchange_host_s']) * 1e3:.1f}, host "
                      f"{rec['exchange_host_s'] * 1e3:.1f}), AdamW {rec['adamw_s'] * 1e3:.1f}; "
                      f"to gloo {rec['inpod_bytes'] / 1e9:.3f} GB in-pod, "
                      f"{rec['bytes_sent'] / 1e9:.3f} GB across pods")
    hier_bytes = ranks[0]["hier"]["history"][-1]["bytes_sent"]
    print(f"[21] across the pod a rank a step: hier on (2, 2, 1) {hier_bytes / 1e9:.4f} GB, flat "
          f"on (2, 1, 1) (phase 19) {flat_bytes / 1e9:.4f} GB: {hier_bytes / flat_bytes:.4f} of it "
          f"(the wire model: {estimate_sync_bytes(mine, SyncConfig('hier'), 2) / 1e9:.4f} against "
          f"{estimate_sync_bytes(grouped, SyncConfig('flat'), 2) / 1e9:.4f} GB)")
    res = [got["residuals"] for got in ranks]
    for rank in range(n_ranks):
        other = (rank + per_pod) % n_ranks
        for key, (sum0, max0, size) in res[rank].items():
            sum1, max1, _ = res[other][key]
            if size >= POD_SYNC["min_leaf_size"] and not (max0 > 0 and sum0 != sum1):
                fail(f"[21] residual block {key} of rank {rank} after one step: max |r| {max0:g}, "
                     f"checksums {sum0} / {sum1} (rank {other}): expected nonzero and different "
                     f"per pod")
            if size < POD_SYNC["min_leaf_size"] and max0:
                fail(f"[21] residual block {key} of a densely exchanged leaf is nonzero")
    diff = max(got["dense_vs_hier"] for got in ranks)
    print(f"[21] after one geococo step every filtered residual block nonzero and different "
          f"between the pods ({sum(v[2] >= POD_SYNC['min_leaf_size'] for v in res[0].values())} "
          f"leaves a rank), the dense ones 0; geococo at density 1.0 vs hier from the same state: "
          f"max |difference| of the synced blocks {diff:g} (gate 0)")
    if diff != 0.0:
        fail(f"[21] geococo at density 1.0 differs from hier by {diff:g}")
    floors = ref[0]["floors"]
    loss_floor = abs(ref[0]["loss_flipped"] - ref[0]["loss"]) / abs(ref[0]["loss"])
    limits = {key: max(TRAIN_GRAD_TOL, FLOOR_MULT * f) for key, f in floors.items()}
    loss_limit = max(1e-5, FLOOR_MULT * loss_floor)
    errs = ranks[0]["vs_211"]
    loss_err = abs(ranks[0]["loss"] - ref[0]["loss"]) / abs(ref[0]["loss"])
    print(f"[21] one hier step on (2, 2, 1) vs (2, 1, 1) with 2 microbatches, the same state and "
          f"global batch: loss {ranks[0]['loss']:.6f} vs {ref[0]['loss']:.6f} ({loss_err:.3e}, "
          f"limit {loss_limit:.3e}); synced gradients, the worst {worst_text(errs)}; noise floor "
          f"(the batch's rows reversed) the worst {worst_text(floors)}, loss {loss_floor:.3e}")
    if loss_err > loss_limit:
        fail(f"[21] loss {loss_err:.3e} from the (2, 1, 1) step's (> {loss_limit:.3e})")
    over = [key for key, e in errs.items() if not e <= limits[key]]
    if over:
        fail(f"[21] {over[0]}: the synced gradient {errs[over[0]]:.3e} of its norm from the "
             f"(2, 1, 1) step's (> {limits[over[0]]:.3e})")


def tp_config():
    from repro_torch.configs.registry import get_config

    cfg = get_config(MOE)
    if cfg.moe.capacity_factor != TP_CAPACITY:
        fail(f"[22] {MOE}'s capacity factor is {cfg.moe.capacity_factor}, not {TP_CAPACITY}")
    return dataclasses.replace(cfg, n_layers=TP_LAYERS)


def tp_data(cfg):
    from repro_torch.data.pipeline import DataConfig

    return DataConfig(vocab_size=cfg.vocab_size, seq_len=POD_SEQ, global_batch=TP_BATCH, seed=0)


def kernel_counters() -> dict:
    """Every kernel wrapper of the port, by name, for ``counted``."""
    from repro_torch.kernels.crdt_merge import ops as merge_ops
    from repro_torch.kernels.rglru_scan import ops as rglru_ops
    from repro_torch.kernels.rwkv6_wkv import ops as wkv6_ops
    from repro_torch.kernels.whitedata_filter import ops as filter_ops

    return {"wkv6": wkv6_ops.wkv6, "wkv6_backward": wkv6_ops.wkv6_backward,
            "rglru_scan": rglru_ops.rglru_scan, "rglru_scan_backward": rglru_ops.rglru_scan_backward,
            "whitedata_filter": filter_ops.whitedata_filter, "crdt_merge": merge_ops.crdt_merge,
            "crdt_merge_rows": merge_ops.crdt_merge_rows,
            "crdt_join_rows": merge_ops.crdt_join_rows}


def tp_yardstick(out_dir: str) -> dict:
    """Phase 22's yardstick, in this process on cuda:0 (the mesh (1, 1,
    1); a process of its own would add its start and CUDA set-up): the gradient of step 1 from the seed-0 parameters and the
    first global batch with 2 microbatches, one a ``data`` rank's row, in
    ``TP_CHECK_DTYPE`` compute (each microbatch routes its 4096 tokens
    alone, as the reference's expert parallelism routes a ``data``
    shard's); its noise floor, the same from the parameters in f64, each
    moved by one unit in the last place, up or down at random (the rows
    reversed would be no floor: the two microbatches' gradients add in
    either order to the same bits); each microbatch's MoE drop counts (a
    forward under a context of one rank, which counts them).  The
    gradient is written to ``out_dir``."""
    import os

    import torch

    from repro_torch.data.pipeline import make_batch
    from repro_torch.dist.context import DistContext, distribution
    from repro_torch.models.model import forward, init_params
    from repro_torch.train.train_step import TrainConfig, grads_and_loss
    from repro_torch.tree import leaf_paths

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.reset_peak_memory_stats()
    cfg = tp_config()
    cdt = getattr(torch, TP_CHECK_DTYPE)
    tcfg = TrainConfig(compute_dtype=cdt, microbatches=TP_BATCH)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    batch = make_batch(tp_data(cfg), 0, dev)
    grads, loss = grads_and_loss(cfg, tcfg, params, batch)
    gen = torch.Generator(device=dev).manual_seed(1)

    def nudged(p):
        up = torch.randint(0, 2, p.shape, generator=gen, device=dev, dtype=torch.bool)
        return torch.nextafter(p.detach().double(), torch.where(up, math.inf, -math.inf))

    nudged_grads, loss_nudged = grads_and_loss(cfg, tcfg, map_tree(params, nudged), batch)
    keys = [key for key, _ in leaf_paths(params)]
    floors = {key: float((a - b.double()).norm() / b.double().norm().clamp_min(1e-30))
              for key, a, b in zip(keys, nudged_grads, grads)}
    del nudged_grads
    torch.save({key: g.detach().cpu() for key, g in zip(keys, grads)},
               os.path.join(out_dir, "grads.pt"))
    del grads
    drops = []
    for row in range(TP_BATCH):
        ctx = DistContext({}, {})
        with distribution(ctx), torch.no_grad():
            forward(cfg, params, {k: v[row:row + 1] for k, v in batch.items()},
                    compute_dtype=cdt)
        drops.append((float(ctx.moe_dropped), ctx.moe_assigned))
    return {"floors": floors, "loss": float(loss), "loss_nudged": float(loss_nudged),
            "drops": drops, "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def tp_rank(rank: int, ref_dir: str) -> dict:
    """Phase 22, in one of four spawned processes, all on cuda:0, on the
    (1, 2, 2) mesh: the main path (train() with hier, bf16) with every
    kernel's count read around it, then one step's synced gradient in
    ``TP_CHECK_DTYPE`` compute from the seed-0 state against the
    yardstick's in ``ref_dir``, and the MoE's drop counts of that step."""
    import math
    import os

    import torch
    import torch.distributed as dist

    from repro_torch.data.pipeline import make_batch
    from repro_torch.dist.collectives import SyncConfig
    from repro_torch.dist.grouping import leaf_specs
    from repro_torch.dist.sharding import local_shard
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import StatePlacement, train
    from repro_torch.models.model import init_params
    from repro_torch.train.train_step import SyncGrads, TrainConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    mesh, _ = make_mesh(TP_MESH, device=dev)
    cfg = tp_config()
    data = tp_data(cfg)
    torch.cuda.reset_peak_memory_stats()
    hist, counts = counted(kernel_counters(), lambda: train(
        cfg, TrainConfig(sync=SyncConfig("hier")), data, TP_STEPS, seed=0, device=dev, mesh=mesh))
    out = {"coords": dict(mesh.coords), "history": hist, "launches": counts,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    torch.cuda.empty_cache()

    check = TrainConfig(sync=SyncConfig("hier"), compute_dtype=getattr(torch, TP_CHECK_DTYPE))
    full = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    params = StatePlacement(cfg, check, dev, mesh).place(full, "params")
    del full
    sync = SyncGrads(cfg, check, dev, mesh)
    grads, loss, _ = sync(params, make_batch(data, 0))
    out["drops"] = (float(sync.ctx.moe_dropped), sync.ctx.moe_assigned)
    want = torch.load(os.path.join(ref_dir, "grads.pt"), mmap=True)
    specs = leaf_specs(cfg, mesh.shape, "hier")
    sums = []
    for (key, spec), got in zip(specs.items(), grads):
        w = local_shard(want[key], spec, mesh.coords, mesh.shape).to(dev)
        part = torch.stack([(got.float() - w.float()).square().sum(), w.float().square().sum()])
        sums.append(part if sync.inpod.counts_once(spec) else torch.zeros_like(part))
    total = sync.inpod.all_reduce_sum(torch.stack(sums)).cpu()
    out["vs_yardstick"] = {key: math.sqrt(d) / max(math.sqrt(n), 1e-30)
                           for key, (d, n) in zip(specs, total.tolist())}
    losses = loss.detach().float().reshape(1).cpu()
    dist.all_reduce(losses)
    out["loss"] = float(losses[0]) / mesh.size
    return out


def run_tp() -> list[dict]:
    """Phase 22: granite-moe-3b-a800m on a (1, 2, 2) mesh on the card (four
    ranks of one gloo group), after its yardstick on (1, 1, 1) (this
    process), gated here across the ranks.  Returns rank 0's step records
    (its bytes to gloo, for phase 31)."""
    import torch

    from repro_torch.dist.context import DistContext
    from repro_torch.launch.mesh import run_local_ranks
    from repro_torch.models.layers import tp_heads
    from repro_torch.models.model import param_count

    cfg = tp_config()
    sizes = dict(zip(("pod", "data", "model"), TP_MESH))
    n_ranks = math.prod(TP_MESH)
    q_heads, kv_heads = tp_heads(cfg.n_heads, cfg.n_kv_heads, sizes["model"], 0)
    _, e_local, _ = DistContext(sizes, {}).experts(cfg.moe.n_experts)
    print(f"[22] {cfg.name} on a {TP_MESH} mesh on one card (4 ranks over gloo, each a CUDA "
          f"context on cuda:0): full width, {TP_LAYERS} of 32 layers, {param_count(cfg):,} "
          f"parameters; global batch {TP_BATCH} x {POD_SEQ} (1 x {POD_SEQ} a data rank, shared "
          f"along model), capacity factor {cfg.moe.capacity_factor}, bf16 compute, remat, hier; "
          f"a rank computes {sum(h >= 0 for h in q_heads)} of {cfg.n_heads} q heads and "
          f"{len(set(kv_heads))} of {cfg.n_kv_heads} kv heads, {e_local} of "
          f"{cfg.moe.n_experts} experts, on expert weights gathered over data")
    with shared_card(), tempfile.TemporaryDirectory(prefix="tp-") as ref_dir:
        try:
            t0 = time.perf_counter()
            ref = tp_yardstick(ref_dir)
            torch.cuda.empty_cache()
            print(f"[22] the (1, 1, 1) yardstick (this process, {TP_CHECK_DTYPE}, {TP_BATCH} "
                  f"microbatches of "
                  f"1 x {POD_SEQ}) in {time.perf_counter() - t0:.1f} s, peak device memory "
                  f"{ref['peak_gb']:.2f} GB")
            ranks = run_local_ranks(tp_rank, n_ranks, (ref_dir,), timeout=TP_TIMEOUT)
        except (RuntimeError, TimeoutError) as err:
            fail(f"[22] {err}")
    want_launches = {name: 0 for name in ranks[0]["launches"]}
    for rank, got in enumerate(ranks):
        if got["launches"] != want_launches:
            fail(f"[22] rank {rank}: the port's kernels launched {got['launches']}, expected none")
        for rec in got["history"]:
            if not math.isfinite(rec["loss"]):
                fail(f"[22] rank {rank}, step {rec['step']}: loss {rec['loss']}")
    losses = [[r["loss"] for r in got["history"]] for got in ranks]
    if any(one != losses[0] for one in losses):
        fail("[22] the ranks report different mean losses")
    peaks = ", ".join(f"{got['peak_gb']:.2f}" for got in ranks)
    print(f"[22] hier: {TP_STEPS} steps of train(), mean losses "
          f"{', '.join(f'{v:.4f}' for v in losses[0])}; within the pod the whole leaves "
          f"bit-identical after every step; every kernel's count 0 in every rank; peak device "
          f"memory a rank {peaks} GB")
    for rank, got in enumerate(ranks):
        for rec in got["history"]:
            compute = rec["compute_s"] - rec["inpod_s"] - rec["tp_s"]
            print(f"  rank {rank} step {rec['step']}: {rec['dt'] * 1e3:.1f} ms = forward + "
                  f"backward {compute * 1e3:.1f} + in-pod gathers and reduce-scatters "
                  f"{rec['inpod_s'] * 1e3:.1f} (device {(rec['inpod_s'] - rec['inpod_host_s']) * 1e3:.1f}"
                  f", host staging + gloo {rec['inpod_host_s'] * 1e3:.1f}) + model sums and "
                  f"count prefix {rec['tp_s'] * 1e3:.1f}, AdamW {rec['adamw_s'] * 1e3:.1f}; to "
                  f"gloo {rec['inpod_bytes'] / 1e9:.3f} GB in-pod, {rec['tp_bytes'] / 1e9:.3f} GB "
                  f"model sums; MoE assignments dropped {rec['moe_dropped']:.0f} of "
                  f"{rec['moe_assigned']:.0f}")
    drops_differ = []
    for rank, got in enumerate(ranks):
        row = got["coords"]["data"]
        dropped, assigned = got["drops"]
        want_dropped, want_assigned = ref["drops"][row]
        print(f"  rank {rank} {got['coords']}: MoE drop rate {dropped / assigned:.6f} "
              f"({dropped:.0f} of {assigned}, forward and remat's recompute), the yardstick's "
              f"microbatch {row} {want_dropped / want_assigned:.6f} ({want_dropped:.0f} of "
              f"{want_assigned})")
        if dropped / assigned != want_dropped / want_assigned:
            drops_differ.append(rank)
    floors = ref["floors"]
    loss_floor = abs(ref["loss_nudged"] - ref["loss"]) / abs(ref["loss"])
    capped = [key for key, f in floors.items() if f > FLOOR_CAP]
    if capped or loss_floor > FLOOR_CAP:
        fail(f"[22] noise floor above {FLOOR_CAP}: {capped or 'the loss'}")
    limits = {key: max(TRAIN_GRAD_TOL, FLOOR_MULT * f) for key, f in floors.items()}
    loss_limit = TP_LOSS_TOL
    errs = ranks[0]["vs_yardstick"]
    loss_err = abs(ranks[0]["loss"] - ref["loss"]) / abs(ref["loss"])
    share = {key: e / limits[key] for key, e in errs.items()}
    nearest = sorted(share, key=share.get, reverse=True)[:3]
    print(f"[22] step 1 in {TP_CHECK_DTYPE} compute on {TP_MESH} vs (1, 1, 1) with {TP_BATCH} "
          f"microbatches, the same state and global batch: loss {ranks[0]['loss']:.6f} vs {ref['loss']:.6f} "
          f"({loss_err:.3e}, limit {loss_limit:.3e}); synced gradients, the worst "
          f"{worst_text(errs)}; noise floor (parameters one f64 ulp off) the worst "
          f"{worst_text(floors)}, loss {loss_floor:.3e}; nearest their limits "
          + ", ".join(f"{key} {errs[key]:.3e} of {limits[key]:.3e}" for key in nearest))
    if drops_differ:
        fail(f"[22] ranks {drops_differ}: MoE drop rates differ from the yardstick's")
    if loss_err > loss_limit:
        fail(f"[22] loss {loss_err:.3e} from the yardstick's (> {loss_limit:.3e})")
    over = [key for key in nearest if share[key] > 1]
    if over:
        fail(f"[22] {over[0]}: the synced gradient {errs[over[0]]:.3e} of its norm from the "
             f"yardstick's (> {limits[over[0]]:.3e})")
    return ranks[0]["history"]

def square_frames(rounds: int):
    """The reference test's square for SQUARE_ROUNDS rounds, then spiked."""
    import numpy as np

    square = np.array(SQUARE_MS)
    spiked = square.copy()
    spiked[0, 1] = spiked[1, 0] = spiked[2, 3] = spiked[3, 2] = SPIKE_MS
    return [square] * SQUARE_ROUNDS + [spiked] * (rounds - SQUARE_ROUNDS)


def event_text(event) -> tuple:
    """An event's type, round, reason and payload, comparable across ranks."""
    plan = getattr(event, "plan", None)
    return (type(event).__name__, event.round, event.reason, getattr(event, "order", None),
            None if plan is None else (plan.groups, plan.aggregators))


def trainer_rank(rank: int, cfg, device: str, seq: int, ckpt_dir: str) -> dict:
    """Phase 23, in one of four spawned processes on the (4, 1, 1) mesh: a
    ``Trainer`` of ``cfg`` (hier) under a ``ControlPlane`` over
    ``square_frames``, a fault injected before step TRAINER_FAULT_AT + 1,
    the WKV6 counts read around ``run()``.  Before every step (from the
    fault injector) it notes the ring the step runs on, the events applied
    so far and the straggler monitor.  Under deterministic algorithms, so
    that a replayed step is its first run bit for bit."""
    import torch

    from repro_torch.control import ControlPlane, TraceView
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.dist.collectives import SyncConfig
    from repro_torch.kernels.rwkv6_wkv import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.train_step import TrainConfig
    from repro_torch.train.trainer import FaultInjected, Trainer, TrainerConfig

    torch.use_deterministic_algorithms(True, warn_only=True)
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    mesh, _ = make_mesh(TRAINER_MESH, device=dev)
    plane = ControlPlane(TraceView(square_frames(TRAINER_STEPS + 2), loop=False),
                         replan_sustain=2, degrade_sustain=2)
    tcfg = TrainConfig(sync=SyncConfig("hier"))
    run_cfg = TrainerConfig(steps=TRAINER_STEPS, ckpt_dir=ckpt_dir,
                            ckpt_every=TRAINER_CKPT_EVERY, log_every=0)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=TRAINER_BATCH, seed=0)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, mesh, tcfg, run_cfg, data, control=plane, device=dev)
    seen, fired = [], []

    def before_step(step: int) -> None:
        seen.append({"step": step + 1, "ring": trainer.tcfg.sync.ring_order,
                     "events": [event_text(e) for e in trainer.network_events],
                     "rebuilds": trainer.sync_rebuilds, "trips": trainer.monitor.trips})
        if step == TRAINER_FAULT_AT and not fired:
            fired.append(step)
            raise FaultInjected(f"injected before step {step + 1}")

    hist, counts = counted({"wkv6": ops.wkv6, "wkv6_backward": ops.wkv6_backward},
                           lambda: trainer.run(fault_injector=before_step))
    out = {"history": hist, "launches": counts, "seen": seen, "fired": fired,
           "step_idx": trainer.step_idx, "sync_rebuilds": trainer.sync_rebuilds,
           "events": [event_text(e) for e in trainer.network_events],
           "ring": trainer.tcfg.sync.ring_order, "saves": trainer.saves,
           "trips": trainer.monitor.trips,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else None}
    if rank == 0:
        out["plane"] = (f"control plane: {plane.round} rounds, {plane.replan_count} replans, "
                        f"relay order {plane.relay_order}, events {plane.event_counts()}, probe "
                        f"traffic {plane.probe_bytes} B; step rebuilds {trainer.sync_rebuilds}")
    return out


def check_trainer(ranks: list, cfg, kernels: bool) -> None:
    """Phase 23's gates across the ranks (``kernels``: the WKV6 wrappers
    launch their kernels, so their counts are 2 and 1 a layer and step)."""
    from repro_torch.control import relay_ring_order

    import numpy as np

    first = ranks[0]
    hist = first["history"]
    spiked = np.array(square_frames(SQUARE_ROUNDS + 1)[-1])
    orders = [e[3] for e in first["events"] if e[0] == "RelayOrderChanged"]
    want_orders = [(0, 1, 2, 3), relay_ring_order(spiked)]
    if orders != want_orders or want_orders[1] != (0, 2, 1, 3):
        fail(f"[23] relay orders {orders}, expected {want_orders} with the second (0, 2, 1, 3)")
    if first["sync_rebuilds"] < 2:
        fail(f"[23] {first['sync_rebuilds']} step rebuilds, expected at least 2")
    for rank, got in enumerate(ranks):
        if (got["seen"], got["events"], got["ring"]) != (first["seen"], first["events"],
                                                          first["ring"]):
            fail(f"[23] rank {rank} holds another ring or event list than rank 0")
        mine = [tuple(r[k] for k in SHARED_RECORD) for r in got["history"]]
        if mine != [tuple(r[k] for k in SHARED_RECORD) for r in hist]:
            fail(f"[23] rank {rank}'s records differ from rank 0's")
        for rec in got["history"]:
            if not math.isfinite(rec["loss"]) or rec["pods_agree"] != 1.0:
                fail(f"[23] rank {rank}, step {rec['step']}: loss {rec['loss']}, pods_agree "
                     f"{rec['pods_agree']}")
        n = len(got["history"])
        want = ({"wkv6": 2 * cfg.n_layers * n, "wkv6_backward": cfg.n_layers * n} if kernels
                else {"wkv6": 0, "wkv6_backward": 0})
        if got["launches"] != want:
            fail(f"[23] rank {rank}: launches {got['launches']} over {n} steps run, expected "
                 f"{want}")
    steps = [r["step"] for r in hist]
    replay = TRAINER_FAULT_AT
    want_steps = list(range(1, replay + 1)) + list(range(TRAINER_CKPT_EVERY + 1,
                                                         TRAINER_STEPS + 1))
    if first["fired"] != [replay] or steps != want_steps or first["step_idx"] != TRAINER_STEPS:
        fail(f"[23] steps run {steps} (fault {first['fired']}), expected {want_steps}, ending "
             f"at {TRAINER_STEPS}")
    again = hist[TRAINER_CKPT_EVERY:replay], hist[replay:2 * replay - TRAINER_CKPT_EVERY]
    if [(r["loss"], r["grad_norm"]) for r in again[0]] != [(r["loss"], r["grad_norm"])
                                                           for r in again[1]]:
        fail(f"[23] the replayed steps differ from their first run: {again}")
    by_step = {s["step"]: s["ring"] for s in first["seen"]}
    if by_step[replay] != want_orders[1]:
        fail(f"[23] step {replay} ran on {by_step[replay]}, not on {want_orders[1]}")
    if not hist[-1]["loss"] < hist[0]["loss"]:
        fail(f"[23] the loss does not fall: {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")
    print(f"[23] gates hold: relay orders {orders}, {first['sync_rebuilds']} step rebuilds; "
          f"every rank the same ring, events and records before every step; pods agree after "
          f"every step; step {replay} replayed bit for bit in loss and gradient norm on ring "
          f"{by_step[replay]}; the run ends at step {first['step_idx']}; WKV6 launches exact; "
          f"the loss falls")


def run_trainer() -> None:
    """Phase 23: the trainer on four pods of the card (four ranks of one gloo
    group), gated here across the ranks."""
    import tempfile

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import run_local_ranks
    from repro_torch.models.model import param_count

    cfg = dataclasses.replace(get_config(RWKV), n_layers=TRAINER_LAYERS)
    n = param_count(cfg)
    print(f"[23] the trainer: {cfg.name} on a {TRAINER_MESH} mesh on one card (4 ranks over "
          f"gloo, each a CUDA context on cuda:0): full width, {TRAINER_LAYERS} of 32 layers, "
          f"{n:,} parameters a pod ({16 * n / 1e9:.2f} GB of f32 state), global batch "
          f"{TRAINER_BATCH} x {TRAINER_SEQ} (1 x {TRAINER_SEQ} a pod), bf16 compute, remat, hier, "
          f"AdamW at its defaults; a ControlPlane over the square "
          f"{SQUARE_MS} for {SQUARE_ROUNDS} rounds, then (0, 1) and (2, 3) at {SPIKE_MS} ms "
          f"(replan and degrade sustain 2); a checkpoint every {TRAINER_CKPT_EVERY} steps, a "
          f"FaultInjected on every rank before step {TRAINER_FAULT_AT + 1}")
    with shared_card(), tempfile.TemporaryDirectory(prefix="trainer-") as ckpt_dir:
        try:
            ranks = run_local_ranks(trainer_rank, math.prod(TRAINER_MESH),
                                    (cfg, "cuda", TRAINER_SEQ, ckpt_dir),
                                    timeout=TRAINER_TIMEOUT)
        except (RuntimeError, TimeoutError) as err:
            fail(f"[23] {err}")
    first = ranks[0]
    print(f"[23] {first['plane']}")
    print(f"[23] events on every rank: {first['events']}")
    hist = first["history"]
    losses = ", ".join(f"{r['loss']:.4f}" for r in hist)
    peaks = ", ".join(f"{got['peak_gb']:.2f}" for got in ranks)
    print(f"[23] {len(hist)} steps run (steps {[r['step'] for r in hist]}: step "
          f"{TRAINER_FAULT_AT} replayed after the rollback to step {TRAINER_CKPT_EVERY}), losses "
          f"{losses}; launches a rank {counts_text(first['launches'])} ({2 * TRAINER_LAYERS} "
          f"forward, {TRAINER_LAYERS} backward a step expected, the replay included); straggler "
          f"trips (threshold 1.5, sustain 3, on the slowest rank's step) {first['trips']}; peak "
          f"device memory a rank {peaks} GB")
    for rank, got in enumerate(ranks):
        ring = {s["step"]: s["ring"] for s in got["seen"]}
        for rec in got["history"]:
            device_s = rec["exchange_s"] - rec["exchange_host_s"]
            print(f"  rank {rank} step {rec['step']} on ring {ring.get(rec['step'])}: "
                  f"{rec['dt'] * 1e3:.1f} ms = forward + backward {rec['compute_s'] * 1e3:.1f}, "
                  f"exchange {rec['exchange_s'] * 1e3:.1f} (device {device_s * 1e3:.1f}, host "
                  f"staging + gloo {rec['exchange_host_s'] * 1e3:.1f}), AdamW "
                  f"{rec['adamw_s'] * 1e3:.1f}; {rec['bytes_sent'] / 1e9:.3f} GB to gloo")
        for save in got["saves"]:
            write = "none" if save["write_s"] is None else f"{save['write_s']:.2f} s"
            print(f"  rank {rank} checkpoint at step {save['step']}: gathers and host copy "
                  f"{save['copy_s']:.2f} s, the writer thread's files {write}")
    check_trainer(ranks, cfg, kernels=True)


def mesh_part_config(part: dict):
    """Phase 30's config of ``part``: its arch at full width (at the smoke
    size where ``part["smoke"]``, to rehearse on the CPU), cut to its
    layers, at its capacity factor."""
    from repro_torch.configs.registry import get_config, get_smoke_config

    cfg = (get_smoke_config if part.get("smoke") else get_config)(part["arch"])
    if part["layers"] is not None:
        cfg = dataclasses.replace(cfg, n_layers=part["layers"])
    if part["capacity"] is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                                capacity_factor=part["capacity"]))
    return cfg


def mesh_prefill(step, params, cache, prompts, chunk: int | None, rows: int | None = None):
    """``prompts`` (host; on a mesh this rank's rows of ``rows``) through
    the cached step in chunks; the last position's f32 logits and the
    cache."""
    chunk = chunk or prompts.shape[1]
    for start in range(0, prompts.shape[1], chunk):
        logits, cache = step.logits(params, cache, {"tokens": prompts[:, start:start + chunk]},
                                    rows=rows)
        last = logits[:, -1].float()
        del logits
    return last, cache


def zero_split_shards(cache, coord: int, model_rank: int = 1):
    """``cache`` with its layers' leaves split along the sequence zeroed on
    ``model`` rank ``model_rank`` (this rank is at ``coord``)."""
    import torch

    if coord != model_rank:
        return cache
    return {"layers": [{k: torch.zeros_like(v) if isinstance(v, torch.Tensor) else v
                        for k, v in layer.items()} if layer.get("seq_shards", 1) > 1 else layer
                       for layer in cache["layers"]]}


def mesh_decode(step, params, cache, tokens, zero_coord: int | None = None,
                rows: int | None = None):
    """Decode steps fed ``tokens[:, t]`` (host; on a mesh this rank's rows
    of ``rows``), each step's last-position f32 logits of the rows on the
    host, (rows, steps, vocab); with ``zero_coord`` (this rank's ``model``
    coordinate) each step is fed a cache whose model-rank-1 shards are
    zeroed."""
    import torch

    outs = []
    for t in range(tokens.shape[1]):
        if zero_coord is not None:
            cache = zero_split_shards(cache, zero_coord)
        logits, cache = step.logits(params, cache, {"tokens": tokens[:, t:t + 1]}, rows=rows)
        outs.append(logits[:, -1].float().cpu())
        del logits
    return torch.stack(outs, 1), cache


def mesh_reference(part: dict, dev) -> dict:
    """Phase 30's yardstick of ``part``, one process on the card over the
    whole cache: greedy from the prompts' prefill, MESH_STEPS decode steps
    in f32; the tokens fed (rows, steps), the logits (host), and the noise
    floor: the same over each data rank's rows alone against all rows.
    With ``part["serve"]`` also the same steps in bf16 from the same
    prefilled caches, the weights cast in place as ``serve()`` casts them
    (``bf16_logits``, ``bf16_floor``)."""
    import torch

    from repro_torch.dist.sharding import batch_rows
    from repro_torch.launch.serve import init_model, make_prompts
    from repro_torch.models.model import cast_params_, init_cache
    from repro_torch.train.train_step import TrainConfig, build_serve_step

    cfg = mesh_part_config(part)
    f32 = TrainConfig(compute_dtype=torch.float32)
    params = init_model(cfg, f32, 0, dev)
    prompts = torch.from_numpy(make_prompts(cfg, part["batch"], part["prompt"], seed=0))
    step = build_serve_step(cfg, f32, kind="decode", device=dev)

    def prefill(rows):
        cache = init_cache(cfg, rows.stop - rows.start, part["max_len"], torch.float32, dev)
        return mesh_prefill(step, params, cache, prompts[rows], part["chunk"])

    t0 = time.perf_counter()
    last, prefilled = prefill(slice(0, part["batch"]))
    cache = prefilled           # a step writes a new cache: the prefilled one stays
    tokens, logits = [last.argmax(-1).cpu()], []
    for _ in range(MESH_STEPS):
        got, cache = mesh_decode(step, params, cache, tokens[-1][:, None])
        logits.append(got[:, 0])
        tokens.append(got[:, 0].argmax(-1))
    seconds = time.perf_counter() - t0
    del cache
    fed = torch.stack(tokens[:MESH_STEPS], 1).to(torch.int32)
    want = torch.stack(logits, 1)
    sizes = dict(zip(("pod", "data", "model"), MESH_SERVE))
    floor, alone = 0.0, {}
    for d in range(sizes["data"]):
        rows = batch_rows(sizes, {"pod": 0, "data": d, "model": 0}, part["batch"])
        alone[rows] = prefill(rows)[1]
        got, _ = mesh_decode(step, params, alone[rows], fed[rows])
        floor = max(floor, max(_rel(got[:, t], want[rows, t]) for t in range(MESH_STEPS)))
    out = {"tokens": fed, "logits": want, "floor": floor, "seconds": seconds}
    if part["serve"]:
        cast_params_(params, torch.bfloat16)
        bf16 = build_serve_step(cfg, TrainConfig(compute_dtype=torch.bfloat16), kind="decode",
                                device=dev)
        want16, _ = mesh_decode(bf16, params, prefilled, fed)
        floor16 = 0.0
        for rows, cache in alone.items():
            got, _ = mesh_decode(bf16, params, cache, fed[rows])
            floor16 = max(floor16, max(_rel(got[:, t], want16[rows, t])
                                       for t in range(MESH_STEPS)))
        out.update(bf16_logits=want16, bf16_floor=floor16)
    del params, prefilled, alone
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def mesh_part_rank(part: dict, mesh, dev, tokens) -> dict:
    """Phase 30's ``part`` on this rank: its rows of the prompts prefilled
    and ``tokens`` decoded in f32 on its part of the cache, the logits
    (host); the counts of the steps' distribution context; whether its cache
    leaves have ``cache_specs``' local shapes; with ``part["zero"]`` the
    decode again from the prefilled cache with model rank 1's shards zeroed;
    with ``part["serve"]`` then ``serve(mesh=)`` at the published capacity
    factor in bf16 (which casts the weights), and with the weights so cast
    the decode again in bf16 from the prefilled cache (``bf16_logits``)."""
    import torch
    import torch.distributed as dist

    from repro_torch.device import synchronize
    from repro_torch.dist.sharding import batch_rows, local_shape
    from repro_torch.launch.serve import init_model, make_prompts, mesh_counts, serve
    from repro_torch.models.model import init_cache
    from repro_torch.train.train_step import (TrainConfig, build_serve_step, cache_specs,
                                              init_local_cache)
    cfg = mesh_part_config(part)
    f32 = TrainConfig(compute_dtype=torch.float32)
    params = init_model(cfg, f32, 0, dev)
    prompts_np = make_prompts(cfg, part["batch"], part["prompt"], seed=0)
    b = part["batch"]
    own = batch_rows(mesh.shape, mesh.coords, b)
    tokens = tokens[own]
    step = build_serve_step(cfg, f32, kind="decode", device=dev, mesh=mesh)
    cache = init_local_cache(cfg, part["batch"], part["max_len"], mesh.shape, torch.float32, dev)
    whole = init_cache(cfg, part["batch"], part["max_len"], torch.float32, "meta")
    specs = cache_specs(whole, mesh.shape)
    shapes_ok = all(
        tuple(layer[k].shape) == local_shape(w[k].shape, sp[k], mesh.shape)
        for layer, w, sp in zip(cache["layers"], whole["layers"], specs["layers"])
        for k in w if isinstance(w[k], torch.Tensor))
    split = sorted({key for layer in cache["layers"] if layer.get("seq_shards", 1) > 1
                    for key, v in layer.items() if isinstance(v, torch.Tensor)})
    synchronize(dev)
    dist.barrier()              # the ranks start the timed part together
    t0 = time.perf_counter()
    _, cache = mesh_prefill(step, params, cache, torch.from_numpy(prompts_np[own]),
                            part["chunk"], b)
    synchronize(dev)
    t1 = time.perf_counter()
    prefill_counts = mesh_counts(step.ctx)
    step.ctx.reset()
    logits, _ = mesh_decode(step, params, cache, tokens, rows=b)
    synchronize(dev)
    out = {"logits": logits, "prefill_s": t1 - t0, "decode_s": time.perf_counter() - t1,
           "prefill_counts": prefill_counts, "decode_counts": mesh_counts(step.ctx),
           "shapes_ok": shapes_ok, "split": split,
           "cache_shapes": [tuple(v.shape) for v in cache["layers"][0].values()
                            if isinstance(v, torch.Tensor)]}
    # two decode steps again, profiled on rank 0 (its device time a step);
    # every rank runs them, so the collectives stay matched
    def two_steps():
        mesh_decode(step, params, cache, tokens[:, :2], rows=b)

    if dev.type == "cuda" and not any(mesh.coords.values()):
        dev_ms = profile_device(f"[30] {part['tag']} rank 0, two decode steps", two_steps, 1)
        out["step_device_ms"] = None if dev_ms is None else dev_ms / 2
    else:
        two_steps()
    if part["zero"]:
        out["zeroed"], _ = mesh_decode(step, params, cache, tokens, mesh.coords["model"], b)
    if part["serve"]:
        published = mesh_part_config(dict(part, capacity=None))
        dist.barrier()          # rank 0's profiler above delays it
        res = serve(published, params, prompts_np, GEN_LEN, TrainConfig(), dev, None, mesh)
        out["serve"] = {"prefill_s": res.prefill_s, "decode_s": res.decode_s,
                        "counts": res.counts, "tokens": res.tokens,
                        "capacity": published.moe.capacity_factor}
        bf16 = build_serve_step(cfg, TrainConfig(compute_dtype=torch.bfloat16),
                                kind="decode", device=dev, mesh=mesh)
        out["bf16_logits"], _ = mesh_decode(bf16, params, cache, tokens, rows=b)
    del cache
    return out


def serve_mesh_rank(rank: int, parts: tuple, fed: dict, device: str = "cuda") -> dict:
    """Phase 30, in one of four spawned processes, all on the one card (or
    the CPU, to rehearse), on the (1, 2, 2) mesh: every part in turn, every
    kernel's count read around each and its peak memory."""
    import torch

    from repro_torch.launch.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    mesh, _ = make_mesh(MESH_SERVE, device=dev)
    counters = kernel_counters()
    out = {"coords": dict(mesh.coords), "parts": {}}
    for part in parts:
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        res, launches = counted(counters, lambda part=part: mesh_part_rank(
            part, mesh, dev, fed[part["tag"]]))
        res["launches"] = launches
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else 0.0
        out["parts"][part["tag"]] = res
    return out


def mesh_serve_text(part: dict, cfg) -> str:
    """What a rank holds and computes in ``part``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.dist.context import DistContext
    from repro_torch.dist.grouping import leaf_specs
    from repro_torch.dist.sharding import batch_rows, local_shape
    from repro_torch.models.layers import tp_heads
    from repro_torch.models.model import init_params, param_count
    from repro_torch.tree import leaf_paths

    sizes = dict(zip(("pod", "data", "model"), MESH_SERVE))
    rows = batch_rows(sizes, {"pod": 0, "data": 0, "model": 0}, part["batch"])
    specs = leaf_specs(cfg, sizes, "hier")
    block = sum(math.prod(local_shape(leaf.shape, specs[key], sizes))
                for key, leaf in leaf_paths(init_params(cfg, None, "meta")))
    text = (f"{cfg.name}, {cfg.n_layers} of {get_config(part['arch']).n_layers} "
            f"layers, {param_count(cfg):,} parameters ({4 * param_count(cfg) / 1e9:.2f} GB of "
            f"f32 a rank, where the reference's p_shard (hier) would keep "
            f"{4 * block / 1e9:.2f} GB a device); {part['batch']} prompts x {part['prompt']} "
            f"tokens, a cache of {part['max_len']} positions; a rank takes "
            f"{rows.stop - rows.start} rows")
    if part["max_len"] >= 8192 and part["max_len"] % sizes["model"] == 0:
        return text + (f" and {part['max_len'] // sizes['model']} positions of every head "
                       f"(the sequence split over model)")
    q_heads, kv_heads = tp_heads(cfg.n_heads, cfg.n_kv_heads, sizes["model"], 0)
    text += (f", {sum(h >= 0 for h in q_heads)} of {cfg.n_heads} q heads against "
             f"{len(set(kv_heads))} of {cfg.n_kv_heads} kv heads (every kv head cached)")
    if cfg.moe is not None:
        _, e_local, _ = DistContext(sizes, {}).experts(cfg.moe.n_experts)
        text += f", {e_local} of {cfg.moe.n_experts} experts"
    return text


def run_serve_mesh(dev, parts=MESH_PARTS, device: str = "cuda") -> dict:
    """Phase 30: each part's yardstick in this process, then the four ranks
    on the card (or the CPU, to rehearse), gated here across them.  Returns
    rank 0's counts of each part's prefill and decode steps by its tag (for
    phase 31)."""
    import torch

    from repro_torch.dist.sharding import batch_rows
    from repro_torch.launch.mesh import run_local_ranks

    sizes = dict(zip(("pod", "data", "model"), MESH_SERVE))
    refs = {}
    for part in parts:
        cfg = mesh_part_config(part)
        print(f"[30] {part['tag']} {mesh_serve_text(part, cfg)}")
        refs[part["tag"]] = mesh_reference(part, dev)
        print(f"[30] {part['tag']} one process over the whole cache (the yardstick, f32): "
              f"prefill and {MESH_STEPS} greedy steps in {refs[part['tag']]['seconds']:.1f} s; "
              f"noise floor (each data rank's rows alone) {refs[part['tag']]['floor']:.3e}; "
              f"row 0's greedy tokens {refs[part['tag']]['tokens'][0].tolist()}")
        if part["serve"]:
            print(f"[30] {part['tag']} the same steps in bf16 (the weights cast as serve() casts "
                  f"them), one process: noise floor {refs[part['tag']]['bf16_floor']:.3e}")
    fed = {tag: ref["tokens"] for tag, ref in refs.items()}
    t0 = time.perf_counter()
    with shared_card():
        try:
            ranks = run_local_ranks(serve_mesh_rank, math.prod(MESH_SERVE), (parts, fed, device),
                                    timeout=MESH_SERVE_TIMEOUT)
        except (RuntimeError, TimeoutError) as err:
            fail(f"[30] {err}")
    print(f"[30] the four ranks ran in {time.perf_counter() - t0:.1f} s (spawn and CUDA set-up "
          f"included)")
    for part in parts:
        tag, ref = part["tag"], refs[part["tag"]]
        limit = max(DECODE_TOL["float32"], FLOOR_MULT * ref["floor"])
        worst, zeroed, by_rows = 0.0, 0.0, {}
        for rank, got in enumerate(ranks):
            res = got["parts"][tag]
            if any(res["launches"].values()):
                fail(f"[30] {tag} rank {rank}: the port's kernels launched {res['launches']}")
            if not res["shapes_ok"]:
                fail(f"[30] {tag} rank {rank}: cache leaves {res['cache_shapes']} are not "
                     f"cache_specs' local shapes")
            rows = batch_rows(sizes, got["coords"], part["batch"])
            errs = [_rel(res["logits"][:, t], ref["logits"][rows, t]) for t in range(MESH_STEPS)]
            worst = max(worst, max(errs))
            if max(errs) > limit:
                fail(f"[30] {tag} rank {rank}: decode logits {max(errs):.3e} x the largest from "
                     f"one process' (> {limit:.3e}); by step {[f'{e:.2e}' for e in errs]}")
            same = by_rows.setdefault((rows.start, rows.stop), res["logits"])
            if not torch.equal(same, res["logits"]):
                fail(f"[30] {tag} rank {rank}: the model ranks of rows {rows} hold other logits")
            if part["zero"]:
                zeroed = max(zeroed, max(_rel(res["zeroed"][:, t], ref["logits"][rows, t])
                                         for t in range(MESH_STEPS)))
        r0 = ranks[0]["parts"][tag]
        split = f" (split along the sequence: {', '.join(r0['split'])})" if r0["split"] else ""
        print(f"[30] {tag} decode vs one process: {worst:.3e} x the largest logit at worst "
              f"({worst / limit:.2f} of the limit {limit:.3e}); the model ranks of each row "
              f"bit-identical; every kernel's count 0; cache leaves at cache_specs' local "
              f"shapes{split}")
        if part["zero"]:
            print(f"[30] {tag} decode fed model rank 1's shards zeroed: {zeroed:.3e} "
                  f"({zeroed / limit:.1f} x the limit)")
            if zeroed <= limit:
                fail(f"[30] {tag}: the gate does not catch a zeroed model-rank-1 shard")
        prefill_s = max(got["parts"][tag]["prefill_s"] for got in ranks)
        step_ms = max(got["parts"][tag]["decode_s"] for got in ranks) / MESH_STEPS * 1e3
        pre, dec = r0["prefill_counts"], r0["decode_counts"]
        peaks = ", ".join(f"{got['parts'][tag]['peak_gb']:.2f}" for got in ranks)
        print(f"[30] {tag} f32 on the mesh: prefill {prefill_s * 1e3:.1f} ms (slowest rank; "
              f"model sums and merges {pre['tp_s'] * 1e3:.1f} ms, {pre['tp_bytes'] / 1e9:.4f} GB "
              f"to gloo a rank, of which merges {pre['merge_bytes'] / 1e9:.4f}); decode "
              f"{step_ms:.2f} ms a step (logits to the host each step), "
              f"{dec['tp_bytes'] / MESH_STEPS / 1e6:.3f} MB to gloo a rank a step, of which "
              f"merges {dec['merge_bytes'] / MESH_STEPS / 1e6:.3f} MB, "
              f"{dec['tp_s'] / MESH_STEPS * 1e3:.2f} ms of sums and merges a step; peak device "
              f"memory a rank {peaks} GB")
        print_busy(f"[30] {tag} rank 0's decode step", r0.get("step_device_ms"),
                   r0["decode_s"] / MESH_STEPS * 1e3)
        if part["serve"]:
            served = [got["parts"][tag]["serve"] for got in ranks]
            if any(not (s["tokens"] == served[0]["tokens"]).all() for s in served):
                fail(f"[30] {tag}: the ranks gathered different tokens")
            gen = served[0]["tokens"]
            vocab = mesh_part_config(part).vocab_size
            if gen.shape != (part["batch"], GEN_LEN) or not ((gen >= 0) & (gen < vocab)).all():
                fail(f"[30] {tag}: served tokens malformed: {gen.shape}")
            one_a_row = served[::sizes["model"]]        # model coordinate 0 of each data rank

            def drop_rate(when: str) -> float:
                return (sum(s["counts"][when]["moe_dropped"] for s in one_a_row)
                        / sum(s["counts"][when]["moe_assigned"] for s in one_a_row))

            serve_step = max(s["decode_s"] for s in served) / (GEN_LEN - 1) * 1e3
            print(f"[30] {tag} served through serve(mesh=) at capacity factor "
                  f"{served[0]['capacity']}, bf16 decode: prefill "
                  f"{max(s['prefill_s'] for s in served) * 1e3:.1f} ms (f32), decode "
                  f"{serve_step:.2f} ms a step ({GEN_LEN - 1} steps, "
                  f"{part['batch'] / serve_step * 1e3:.1f} tokens/s); "
                  f"{served[0]['counts']['decode']['tp_bytes'] / (GEN_LEN - 1) / 1e6:.3f} MB to "
                  f"gloo a rank a step, rank 0's sums "
                  f"{served[0]['counts']['decode']['tp_s'] / (GEN_LEN - 1) * 1e3:.2f} ms a step; "
                  f"MoE drop rate {drop_rate('prefill'):.4f} in the prefill, "
                  f"{drop_rate('decode'):.4f} over the decode steps (each data rank routes its "
                  f"rows alone); sample row {gen[0].tolist()}")
            limit16 = max(DECODE_TOL["bfloat16"], FLOOR_MULT * ref["bf16_floor"])
            worst16 = 0.0
            for rank, got in enumerate(ranks):
                res = got["parts"][tag]
                rows = batch_rows(sizes, got["coords"], part["batch"])
                errs = [_rel(res["bf16_logits"][:, t], ref["bf16_logits"][rows, t])
                        for t in range(MESH_STEPS)]
                worst16 = max(worst16, max(errs))
                if max(errs) > limit16:
                    fail(f"[30] {tag} rank {rank}: bf16 decode logits {max(errs):.3e} x the "
                         f"largest from one process' (> {limit16:.3e}); by step "
                         f"{[f'{e:.2e}' for e in errs]}")
            print(f"[30] {tag} bf16 decode with serve()'s cast weights vs one process: "
                  f"{worst16:.3e} x the largest logit at worst ({worst16 / limit16:.2f} of the "
                  f"limit {limit16:.3e})")
    return {part["tag"]: {"prefill": ranks[0]["parts"][part["tag"]]["prefill_counts"],
                          "decode": ranks[0]["parts"][part["tag"]]["decode_counts"]}
            for part in parts}


def step_bound_ms(cost: dict, compute_dtype) -> tuple[float, str]:
    """A whole step's roofline bound on one card (``launch.roofline``'s
    peaks): its FLOPs over the peak of its compute dtype or its bytes over
    HBM's rate, whichever is larger (ms)."""
    from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS

    by_ops = cost["flops"] / PEAK_FLOPS[str(compute_dtype).removeprefix("torch.")] * 1e3
    by_bytes = cost["bytes"] / HBM_BW * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def check_card_step(name: str, rec: dict) -> None:
    """Phase 31 (a) for one of ``count_card_step``'s records: the dry-run of
    the same step on meta against what the card counted and allocated."""
    from repro_torch.launch.dryrun import dry_step

    card, step = rec["counts"], rec["step"]
    dry = dry_step(**step)
    cost = dry["cost"]
    print(f"[31] (a) {name}: {step['cfg'].name}, {step['cfg'].n_layers} layers, "
          f"{step['shape'].global_batch} x {step['shape'].seq_len}, {step['tcfg'].compute_dtype}; "
          f"dry-run in {dry['trace_s']:.1f} s: {cost['flops']:,} FLOPs and {cost['bytes']:,} bytes "
          f"(the kernels' {cost['kernel_flops']:,} and {cost['kernel_bytes']:,} over "
          f"{cost['kernel_calls']} calls); on the card {card['flops']:,} and {card['bytes']:,} "
          f"({card['kernel_calls']} kernel calls)")
    for key in ("flops", "bytes", "kernel_calls"):
        if cost[key] != card[key]:
            fail(f"[31] (a) {name}: {key} {cost[key]:,} on meta, {card[key]:,} on the card: the "
                 f"step took another branch on one of them")
    dry_peak = dry["memory"]["peak_gb"] * 1e9
    ratio = rec["peak_bytes"] / dry_peak
    print(f"[31] (a) {name}: peak {rec['peak_bytes'] / 1e9:.3f} GB on the card "
          f"(max_memory_allocated, {rec['held_bytes'] / 1e9:.3f} GB held at the reset), "
          f"{dry_peak / 1e9:.3f} GB dry-run ({dry['memory']['argument_gb']:.3f} GB of arguments): "
          f"{ratio:.4f}, band {PEAK_BAND}")
    if not PEAK_BAND[0] <= ratio <= PEAK_BAND[1]:
        fail(f"[31] (a) {name}: the card's peak is {ratio:.4f} x the dry-run's, outside {PEAK_BAND}")
    if step["shape"].kind == "train":
        bare = dry_step(**step, optimizer=False)
        bare_ratio = rec["peak_bytes"] / (bare["memory"]["peak_gb"] * 1e9)
        print(f"[31] (a) {name}: the negative control, a dry-run with no optimizer state: peak "
              f"{bare['memory']['peak_gb']:.3f} GB, {bare_ratio:.4f} (must fall outside the band)")
        if PEAK_BAND[0] <= bare_ratio <= PEAK_BAND[1]:
            fail(f"[31] (a) {name}: the band {PEAK_BAND} does not catch a dry-run without AdamW's "
                 f"state ({bare_ratio:.4f})")
    bound_ms, by = step_bound_ms(cost, step["tcfg"].compute_dtype)
    print(f"[31] (a) {name}: roofline bound {bound_ms:.2f} ms ({by}), measured "
          f"{rec['wall_ms']:.2f} ms a step: {bound_ms / rec['wall_ms']:.1%} of the bound")


def check_wire(tag: str, what: str, got: dict, dry: dict) -> None:
    """Phase 31 (b): rank 0's counts on the card against the dry-run's, to
    the byte."""
    print(f"[31] (b) {tag} {what}: to gloo on the card {got}, dry-run {dry}")
    if got != dry:
        fail(f"[31] (b) {tag} {what}: rank 0 handed gloo {got} bytes on the card, the dry-run "
             f"counts {dry}")


def run_dryrun_check(card_steps: dict, tp_history: list, mesh_counts: dict) -> None:
    """Phase 31: (a) the counted steps of phases 15 and 14 (``card_steps``,
    ``train`` and ``prefill``) against their dry-runs; (b) rank 0's bytes to gloo in phases 22 and 30
    (a) against the dry-run of rank 0 of the same (1, 2, 2) mesh."""
    import torch

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.dist.collectives import SyncConfig
    from repro_torch.launch.dryrun import dry_step
    from repro_torch.train.train_step import TrainConfig

    for name in ("train", "prefill"):
        check_card_step(name, card_steps[name])

    dry = dry_step(tp_config(), ShapeSpec("phase 22", POD_SEQ, TP_BATCH, "train"),
                   TrainConfig(sync=SyncConfig("hier")), TP_MESH)
    wire = dry["wire"]
    for rec in tp_history:
        check_wire("[22]", f"step {rec['step']} (pod, in-pod, model)",
                   {"pod": rec["bytes_sent"], "inpod": rec["inpod_bytes"], "model": rec["tp_bytes"]},
                   {"pod": wire["pod"], "inpod": wire["inpod"], "model": wire["model"] + wire["merge"]})
    print(f"[31] (b) [22] left out of the dry-run: " + "; ".join(
        f"{x['name']} ({x['group']}) {x['bytes']:.0f} B" for x in dry["left_out"]))

    part = MESH_PARTS[0]
    cfg, f32 = mesh_part_config(part), TrainConfig(compute_dtype=torch.float32)
    got = mesh_counts[part["tag"]]
    pre = dry_step(cfg, ShapeSpec("phase 30 (a) prefill", part["prompt"], part["batch"], "prefill"),
                   f32, MESH_SERVE, cache_len=part["max_len"], cache_dtype=torch.float32)["wire"]
    check_wire("[30] (a)", "prefill (model sums and merges, merges)",
               {"model": got["prefill"]["tp_bytes"], "merge": got["prefill"]["merge_bytes"]},
               {"model": pre["model"] + pre["merge"], "merge": pre["merge"]})
    dec = dry_step(cfg, ShapeSpec("phase 30 (a) decode", part["max_len"], part["batch"], "decode"),
                   f32, MESH_SERVE, cache_dtype=torch.float32)["wire"]
    check_wire("[30] (a)", f"{MESH_STEPS} decode steps (model sums and merges, merges)",
               {"model": got["decode"]["tp_bytes"], "merge": got["decode"]["merge_bytes"]},
               {"model": MESH_STEPS * (dec["model"] + dec["merge"]), "merge": MESH_STEPS * dec["merge"]})


def wan_cluster(strategy: str, barrier: bool, keys: int, device, *, modeled: bool, **engine):
    """Phase 32's engine, generator and trace (the seeds of
    ``examples/geo_database_sim_torch.py``); ``engine``: more of the
    engine's settings (phase 34's streaming ones)."""
    import numpy as np

    from repro_torch.core.latency import jitter_trace
    from repro_torch.core.replication import EngineConfig, GeoCluster
    from repro_torch.core.workload import YCSBConfig, YCSBGenerator

    eng = GeoCluster(EngineConfig(n_nodes=len(WAN_REGIONS), sync_strategy=strategy,
                                  planner="kcenter", barrier=barrier, modeled_cpu=modeled,
                                  **engine),
                     bandwidth_mbps=WAN_BANDWIDTH_MBPS, seed=3, device=device)
    gen = YCSBGenerator(YCSBConfig(n_keys=keys, theta=0.99, read_ratio=0.5, ops_per_txn=4,
                                   value_bytes=WAN_VALUE_BYTES, rewrite_frac=0.1),
                        len(WAN_REGIONS), seed=5, node_region=WAN_REGIONS)
    trace = jitter_trace(np.array(WAN_TESTBED), max(WAN_EPOCHS, 2), np.random.default_rng(0))
    return eng, gen, trace


def lan_wan_bandwidth(regions, n: int, wan_mbps: float, lan_mbps: float = 10_000.0):
    """Bandwidth matrix with the paper's LAN >> WAN asymmetry (Sec 2.2): a
    copy of ``benchmarks/common.py:69-76``."""
    import numpy as np

    regions = np.asarray(regions)
    same = regions[:, None] == regions[None, :]
    bw = np.where(same, lan_mbps, wan_mbps).astype(float)
    np.fill_diagonal(bw, np.inf)
    return bw


def tpcc_cluster(strategy: str, device, *, full: bool, mix: str = "TPCC-A",
                 modeled: bool, planner: str = "milp", rounds: int = TPCC_CHECK_EPOCHS,
                 **engine):
    """Phase 33's engine, generator and trace.  Not ``full``:
    ``benchmarks/bench_throughput.py``'s regime (``_run_tpcc``, ``:25-62``:
    the paper's testbed trace of ``benchmarks/common.py:30-55``, 10 Gbps LAN
    and 15 Mbps WAN, 100 warehouses x 50 items, remote 0.25, MILP unless
    ``planner`` says otherwise, seed 3; a trace of ``rounds`` steps);
    ``full``: TPCC_WAREHOUSES x TPCC_ITEMS on phase 32's testbed at
    WAN_BANDWIDTH_MBPS, kcenter.  ``engine``: more of the engine's settings
    (phase 34's streaming ones, phase 35's serving plane)."""
    import numpy as np

    from repro_torch.core.latency import jitter_trace
    from repro_torch.core.replication import EngineConfig, GeoCluster
    from repro_torch.core.workload import TPCCConfig, TPCCGenerator

    n = len(WAN_REGIONS)
    if full:
        eng = GeoCluster(EngineConfig(n_nodes=n, sync_strategy=strategy, planner="kcenter",
                                      modeled_cpu=modeled, **engine),
                         bandwidth_mbps=WAN_BANDWIDTH_MBPS, seed=3, device=device)
        cfg = TPCCConfig(n_warehouses=TPCC_WAREHOUSES, mix=mix, remote_prob=0.10,
                         items_per_warehouse=TPCC_ITEMS)
        trace = jitter_trace(np.array(WAN_TESTBED), TPCC_EPOCHS, np.random.default_rng(0))
    else:
        geo = strategy == "geococo"
        wan = np.array(TPCC_BENCH_REGIONS)[:, None] != np.array(TPCC_BENCH_REGIONS)[None, :]
        engine.setdefault("epoch_ms", 10.0)
        eng = GeoCluster(EngineConfig(n_nodes=n, grouping=geo, filtering=geo, tiv=geo,
                                      planner=planner, modeled_cpu=modeled, **engine),
                         bandwidth_mbps=lan_wan_bandwidth(TPCC_BENCH_REGIONS, n, 15.0),
                         wan_mask=wan, seed=3, device=device)
        cfg = TPCCConfig(n_warehouses=100, mix=mix, remote_prob=0.25, items_per_warehouse=50)
        trace = jitter_trace(np.array(WAN_TESTBED), rounds,
                             np.random.default_rng(0), rel_sigma=0.04, spike_prob=0.002,
                             spike_mult=(1.3, 1.8))
    return eng, TPCCGenerator(cfg, n, seed=3), trace


def wan_fields(rs) -> dict:
    """Every field of a run's report but ``plan_time_s`` (a wall clock)."""
    import numpy as np

    return {"epochs": [dataclasses.asdict(e) for e in rs.epochs],
            "summary": dataclasses.asdict(rs.summary),
            "state_digest": rs.state_digest, "value_digest": rs.value_digest,
            "msg_matrix": np.asarray(rs.msg_matrix).tolist(), "serve": rs.serve}


def loaded_store(eng, gen) -> tuple[float, float]:
    """The engine's store made on its device and every row loaded before its
    epochs (YCSB's load phase; a TPC-C database populated); returns the
    seconds each took."""
    import torch

    def sync():
        if eng.device.type == "cuda":
            torch.cuda.synchronize()

    sync()
    t0 = time.perf_counter()
    eng.store = gen.table(eng.device)
    sync()
    t1 = time.perf_counter()
    gen.load(eng.store, seed=LOAD_SEED)
    sync()
    return t1 - t0, time.perf_counter() - t1


def card_equals_cpu(tag: str, runs: list, dev) -> dict:
    """Each ``(label, build)`` run on the card and on the CPU (``build(device)``
    gives the engine, generator, trace, epochs and transactions a node, the
    store already set): every report field and both digests equal (and the
    views' joins, on the streaming engine with per-node views), one commit
    an epoch and one join a view and epoch merged through the join kernel on
    the card.  Returns the card's reports by label."""
    import torch

    from repro_torch.kernels.crdt_merge import ops as merge_ops

    reports = {}
    for label, build in runs:
        out = {}
        for device in (dev, "cpu"):
            eng, gen, trace, epochs, txns = build(device)
            before = merge_ops.crdt_join_rows.launches
            rs = eng.run(gen, trace, txns_per_node=txns, n_epochs=epochs)
            out[str(device)] = (dict(wan_fields(rs), view_merges=eng.view_merges),
                                merge_ops.crdt_join_rows.launches - before)
            reports.setdefault(label, rs)
            del eng, gen
        (card, launches), (cpu, _) = out[str(dev)], out["cpu"]
        differ = sorted(k for k in card if card[k] != cpu[k])
        if differ:
            fail(f"{tag} (a) {label}: the card's run differs from the CPU's in {differ}")
        views = card["view_merges"]
        if launches != epochs + views:
            fail(f"{tag} (a) {label}: {launches} join launches in {epochs} epochs and {views} "
                 f"views' joins (one commit an epoch)")
        print(f"{tag} (a) {label}, {epochs} epochs: the card's run equals the CPU's (every "
              f"EpochStats and RunSummary field, FilterStats, msg_matrix, digest "
              f"{card['state_digest'][:12]}...); {launches} join launches"
              + (f" ({views} of them the views')" if views else ""))
        torch.cuda.empty_cache()
    return reports


def wan_check(dev) -> None:
    """Phase 32 (a): flat and geococo under both engines on the card and on
    the CPU at WAN_CHECK_KEYS keys, every key loaded before epoch 0, and
    WAN_CHECK_EPOCHS epochs, modeled filter CPU."""
    def build(strategy, barrier):
        def make(device):
            eng, gen, trace = wan_cluster(strategy, barrier, WAN_CHECK_KEYS, device,
                                          modeled=True)
            loaded_store(eng, gen)
            return eng, gen, trace, WAN_CHECK_EPOCHS, WAN_TXNS
        return make

    card_equals_cpu("[32]", [(f"{s}, barrier={b}, {WAN_CHECK_KEYS:,} loaded keys", build(s, b))
                             for s in ("flat", "geococo") for b in (False, True)], dev)


def wan_times_text(times: list[dict]) -> str:
    keys = ("draw_s", "copy_s", "device_s", "host_s")
    tot = {k: sum(t[k] for t in times) * 1e3 for k in keys}
    return (f"host draws {tot['draw_s']:.1f} ms, host-to-device copy and gathers "
            f"{tot['copy_s']:.1f}, device work (validation, filters, commit) "
            f"{tot['device_s']:.1f}, host (planner, schedules, simulator) {tot['host_s']:.1f}")


@contextlib.contextmanager
def join_calls(tables: list | None = None):
    """``(rows, rows taken)`` of each ``crdt_join_rows`` call the store
    makes inside the block, filled in when it ends: the name the store
    calls is bound to a wrapper that keeps each call's ``took`` for the
    block's length (the launches are the kernel's own), and the rows taken
    are counted after it, so the main path makes no launch or sync more.
    ``tables``, where given, gets the address of the table each call
    joined into (the store's or a view's)."""
    from repro_torch.core import crdt

    calls, kept, inner = [], [], crdt.crdt_join_rows

    def noting(table, *args):
        took = inner(table, *args)
        kept.append(took)
        if tables is not None:
            tables.append(table.data_ptr())
        return took

    crdt.crdt_join_rows = noting
    try:
        yield calls
    finally:
        crdt.crdt_join_rows = inner
        calls.extend((took.numel(), int(took.sum())) for took in kept)


def tpcc_summary_line(strategy: str, rs, gen) -> str:
    """One TPC-C run's numbers unrounded and its digests, in the form in
    which ``tests/tpcc_full_reference.py`` prints the reference's run."""
    w = rs.white_stats
    return (f"{strategy}: committed {rs.committed}, aborted {rs.aborted} (read "
            f"{rs.read_aborts}, write-write {rs.ww_aborts}); WAN {rs.wan_bytes} B; white bytes "
            f"{w.white_byte_ratio!r} (aborted {w.aborted_updates}, null {w.null_updates}, stale "
            f"{w.stale_updates}, duplicate {w.duplicate_updates}); tpmTotal "
            f"{rs.throughput_tps * 60!r}; NewOrder {gen.neworder_count}; the epochs' sync "
            f"{sum(e.sync_ms for e in rs.epochs)!r} ms, filter CPU "
            f"{sum(e.filter_cpu_ms for e in rs.epochs)!r} ms, wall "
            f"{sum(e.wall_ms for e in rs.epochs)!r} ms; state {rs.state_digest[:16]} value "
            f"{rs.value_digest[:16]}")


def host_sha_rate() -> tuple[float, float]:
    """This host's SHA-256 rate (GB/s) over 256 MiB of pinned memory: one
    thread, and two threads at once (the digests' pair)."""
    import hashlib

    import torch

    buf = torch.randint(0, 256, (1 << 28,), dtype=torch.uint8).pin_memory().numpy()
    t0 = time.perf_counter()
    hashlib.sha256(buf).hexdigest()
    one = buf.size / (time.perf_counter() - t0) / 1e9
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        t0 = time.perf_counter()
        list(pool.map(lambda _: hashlib.sha256(buf).hexdigest(), range(2)))
        two = 2 * buf.size / (time.perf_counter() - t0) / 1e9
    return one, two


def wan_main_runs(tag: str, build, epochs: int, txns: int, counters: dict) -> dict:
    """Flat, then geococo, each from a store loaded before its epochs (its
    set-up timed apart) through ``run()`` (its two digests, one pass,
    timed apart from the epochs): gated (b) one state and (c) one join
    launch an epoch, every other kernel 0."""
    import torch

    runs = {}
    for strategy in ("flat", "geococo"):
        torch.cuda.reset_peak_memory_stats()
        eng, gen, trace = build(strategy)
        make_s, load_s = loaded_store(eng, gen)

        def main_path():
            t0 = time.perf_counter()
            rs = eng.run(gen, trace, txns_per_node=txns, n_epochs=epochs)
            torch.cuda.synchronize()
            return rs, time.perf_counter() - t0

        with join_calls() as calls:
            (rs, wall), counts = counted(counters, main_path)
        peak = torch.cuda.max_memory_allocated()
        others = {k: v for k, v in counts.items() if k != "crdt_join_rows" and v}
        if others or counts["crdt_join_rows"] != epochs:
            fail(f"{tag} (c) {strategy}: kernel counts {counts} in {epochs} epochs (one "
                 f"commit an epoch)")
        epochs_s = sum(sum(t.values()) for t in eng.epoch_times)
        digests_s = wall - epochs_s
        state_b, value_b = eng.store.digest_bytes
        bound_ms = sum(join_bound(k, eng.store.words, 4, taken)[0] for k, taken in calls)
        w = rs.white_stats
        print(f"{tag} {strategy}: store made in {make_s * 1e3:.1f} ms and loaded "
              f"({eng.store.n_rows:,} rows) in {load_s * 1e3:.1f} ms before the epochs; "
              f"{epochs} epochs {epochs_s * 1e3:.1f} ms ({epochs_s / epochs * 1e3:.2f} ms an "
              f"epoch): {wan_times_text(eng.epoch_times)}; then run()'s two digests in one "
              f"pass {digests_s * 1e3:.1f} ms (its wall {wall * 1e3:.1f} ms less the epochs) "
              f"over {state_b / 1e9:.3f} + {value_b / 1e9:.3f} GB: "
              f"{(state_b + value_b) / digests_s / 1e9:.3f} GB/s")
        for e, (st, t) in enumerate(zip(rs.epochs, eng.epoch_times)):
            print(f"    epoch {e:2d}: draws {t['draw_s'] * 1e3:6.1f} ms, copy "
                  f"{t['copy_s'] * 1e3:6.1f}, device {t['device_s'] * 1e3:6.1f}, host "
                  f"{t['host_s'] * 1e3:6.1f}; committed {st.committed}, aborted {st.aborted}, "
                  f"sync {st.sync_ms:.2f} ms, WAN {st.wan_bytes / 1e6:.3f} MB")
        print(f"{tag} {strategy}: committed {rs.committed:,}, aborted {rs.aborted:,} (read "
              f"{rs.read_aborts}, write-write {rs.ww_aborts:,}); modeled {rs.throughput_tps:,.0f} "
              f"txn/s; WAN {rs.wan_bytes / 1e6:.3f} MB; white bytes {w.white_byte_ratio:.4f} "
              f"(aborted {w.aborted_updates:,}, null {w.null_updates:,}, stale "
              f"{w.stale_updates}, duplicate {w.duplicate_updates}); {len(eng.store):,} keys "
              f"present; peak {peak / 1e9:.2f} GB")
        if hasattr(gen, "neworder_count"):
            print(f"{tag} {strategy}: tpmTotal {rs.throughput_tps * 60:,.0f} (modeled); "
                  f"{gen.neworder_count:,} NewOrder transactions of {rs.total_txns:,}")
        print(f"{tag} (c) {strategy}: crdt_join_rows {counts['crdt_join_rows']} launches in "
              f"{epochs} epochs (one commit an epoch), every other kernel 0; "
              f"{min(k for k, _ in calls):,}-{max(k for k, _ in calls):,} rows a join, "
              f"{min(t for _, t in calls):,}-{max(t for _, t in calls):,} taken; bound "
              f"{bound_ms:.4f} ms in all (bytes of the rows taken, kernels.work.crdt_join_rows)")
        runs[strategy] = {"rs": rs, "epochs_s": epochs_s, "load_s": load_s,
                          "digests_s": digests_s, "times": list(eng.epoch_times),
                          "launches": counts["crdt_join_rows"], "bound_ms": bound_ms,
                          "peak": peak}
        if strategy == "flat":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.store.digest()
            one_s = time.perf_counter() - t0
            runs["flat"]["state_digest_s"] = one_s
            print(f"{tag} flat: the state digest alone {one_s * 1e3:.1f} ms over "
                  f"{state_b / 1e9:.3f} GB: {state_b / one_s / 1e9:.3f} GB/s")
        del eng, gen
        torch.cuda.empty_cache()
    flat, geo = runs["flat"]["rs"], runs["geococo"]["rs"]
    if (flat.state_digest, flat.value_digest) != (geo.state_digest, geo.value_digest):
        fail(f"{tag} (b) flat and geococo end in different states")
    print(f"{tag} (b) flat and geococo: the same state digest {geo.state_digest[:16]}... and "
          f"value digest {geo.value_digest[:16]}...; WAN bytes {flat.wan_bytes / 1e6:.3f} -> "
          f"{geo.wan_bytes / 1e6:.3f} MB ({geo.wan_bytes / flat.wan_bytes - 1:+.1%})")
    return runs


def wan_profile(tag: str, build, txns: int, runs: dict) -> dict:
    """The device busy share: the profiler's device time over the first
    WAN_PROFILE_EPOCHS epochs of another geococo run (the same seeds: the
    same work), its store loaded before and no digests, against the wall
    of that window; and the join kernel's device time, launch by launch,
    against the bound of the rows each took."""
    import torch

    eng, gen, trace = build("geococo")
    loaded_store(eng, gen)
    window = {}

    def epochs():
        t0 = time.perf_counter()
        for e in range(WAN_PROFILE_EPOCHS):
            batch = gen.to_batch(gen.draw(e, txns), eng.store)
            eng.run_epoch(e, batch, trace[e % len(trace)])
        torch.cuda.synchronize()
        window["wall_ms"] = (time.perf_counter() - t0) * 1e3

    with join_calls() as calls:
        dev_ms, by_name, each_ms = profile_launches(epochs, "crdt_join_rows_kernel")
    wall_ms = window["wall_ms"]
    unprofiled_ms = sum(sum(t.values())
                        for t in runs["geococo"]["times"][:WAN_PROFILE_EPOCHS]) * 1e3
    kernel_ms = sum(each_ms)
    bounds = [join_bound(k, eng.store.words, 4, taken)[0] for k, taken in calls]
    bound_ms = sum(bounds)
    if len(calls) != WAN_PROFILE_EPOCHS:
        fail(f"{tag} the profiled window made {len(calls)} joins in {WAN_PROFILE_EPOCHS} "
             f"epochs")
    if dev_ms is not None:
        print(f"{tag} geococo's first {WAN_PROFILE_EPOCHS} epochs, profiled: {dev_ms:.2f} ms of "
              f"device time (torch.profiler) in {wall_ms:.1f} ms of that window's wall: busy "
              f"{dev_ms / wall_ms:.1%} (the same epochs unprofiled in the main run: "
              f"{unprofiled_ms:.1f} ms); the largest:")
        for name, kms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
            print(f"    {kms:9.3f} ms  {name[:100]}")
        print(f"{tag} the commit's kernel in those epochs: {len(each_ms)} launches of "
              f"crdt_join_rows_kernel, {kernel_ms:.4f} ms of device time (torch.profiler), "
              f"against a bound of {bound_ms:.4f} ms (bytes of the rows taken): "
              f"{bound_ms / kernel_ms:.1%}; each:")
        for (k, taken), ms, bound in zip(calls, each_ms, bounds):
            print(f"    {k:,} rows, {taken:,} taken: {ms * 1e3:.2f} us against "
                  f"{bound * 1e3:.3f} us, {bound / ms:.1%}")
    del eng, gen
    torch.cuda.empty_cache()
    return {"busy": None if dev_ms is None else dev_ms / wall_ms, "kernel_ms": kernel_ms,
            "kernel_bound_ms": bound_ms}


def run_wan(dev, counters: dict) -> dict:
    """Phase 32: the WAN sync plane at full size on a loaded YCSB store,
    flat then geococo, and a profiled window of epochs."""
    t_phase = time.perf_counter()
    memory_line("[32]", "start")
    one, two = host_sha_rate()
    print(f"[32] this host's SHA-256 over 256 MiB of pinned memory: {one:.3f} GB/s in one thread, "
          f"{two:.3f} GB/s in two at once")
    wan_check(dev)
    print(f"[32] YCSB store of {WAN_KEYS:,} records x {WAN_VALUE_BYTES} B on the card, every "
          f"record loaded before epoch 0 (YCSB's load phase), Zipf 0.99, 50/50, 4 ops, rewrite "
          f"0.1; 5 nodes on the paper's testbed at {WAN_BANDWIDTH_MBPS:g} Mbps, {WAN_TXNS} "
          f"transactions a node an epoch, {WAN_EPOCHS} epochs, kcenter, filter CPU measured on "
          f"the card")

    def build(strategy):
        return wan_cluster(strategy, False, WAN_KEYS, dev, modeled=False)

    runs = wan_main_runs("[32]", build, WAN_EPOCHS, WAN_TXNS, counters)
    prof = wan_profile("[32]", build, WAN_TXNS, runs)
    memory_line("[32]", "end")
    took = time.perf_counter() - t_phase
    print(f"[32] took {took:.1f} s (limit {WAN_PHASE_LIMIT_S:g} s)")
    return {"launches": sum(r["launches"] for r in runs.values()), "runs": runs,
            "seconds": took, "sha_rate": (one, two), **prof}


def tpcc_reference_pair(dev, runs: dict) -> None:
    """Phase 33 (d): (b)'s settings from an empty store, the filter's CPU
    modeled from its bytes, flat then geococo: the runs that
    ``tests/tpcc_full_reference.py`` makes with the reference on the CPU,
    printed in the same form, and set beside (b)'s loaded runs."""
    import torch

    out = {}
    for strategy in ("flat", "geococo"):
        eng, gen, trace = tpcc_cluster(strategy, dev, full=True, modeled=True)
        rs = eng.run(gen, trace, txns_per_node=TPCC_TXNS, n_epochs=TPCC_EPOCHS)
        loaded = runs[strategy]["rs"]
        print(f"[33] (d) empty store, modeled filter CPU, {tpcc_summary_line(strategy, rs, gen)}")
        print(f"[33] (d) {strategy}: committed, aborted and WAN bytes equal (b)'s run from the "
              f"loaded store: {(rs.committed, rs.aborted, rs.wan_bytes) == (loaded.committed, loaded.aborted, loaded.wan_bytes)}; "
              f"tpmTotal {rs.throughput_tps * 60:,.0f} modeled against "
              f"{loaded.throughput_tps * 60:,.0f} with the filter's CPU measured on the card")
        out[strategy] = rs
        del eng, gen
        torch.cuda.empty_cache()
    if out["flat"].state_digest != out["geococo"].state_digest:
        fail("[33] (d) flat and geococo end in different states")


def run_tpcc(dev, counters: dict) -> dict:
    """Phase 33: TPC-C on the card.  (a) ``bench_throughput.py``'s regime,
    the four mixes under flat and geococo, card against CPU; (b) the full
    database, TPCC_WAREHOUSES x TPCC_ITEMS rows loaded before epoch 0,
    TPCC-A, flat then geococo, a profiled window of epochs, and (d) the
    pair that the reference's run on the CPU is compared with."""
    t_phase = time.perf_counter()
    memory_line("[33]", "start")

    def check(mix, strategy):
        def make(device):
            eng, gen, trace = tpcc_cluster(strategy, device, full=False, mix=mix, modeled=True)
            return eng, gen, trace, TPCC_CHECK_EPOCHS, TPCC_CHECK_TXNS
        return make

    card = card_equals_cpu("[33]", [(f"{mix} {s}", check(mix, s)) for mix in TPCC_MIXES_ORDER
                                    for s in ("flat", "geococo")], dev)
    for mix in TPCC_MIXES_ORDER:
        a, b = card[f"{mix} flat"], card[f"{mix} geococo"]
        if (a.state_digest, a.value_digest) != (b.state_digest, b.value_digest):
            fail(f"[33] (a) {mix}: flat and geococo end in different states")
        print(f"[33] (a) {mix}: tpmTotal {a.throughput_tps * 60:,.0f} -> "
              f"{b.throughput_tps * 60:,.0f} ({b.throughput_tps / a.throughput_tps - 1:+.1%}, "
              f"modeled filter CPU); WAN {a.wan_bytes / 1e6:.3f} -> {b.wan_bytes / 1e6:.3f} MB "
              f"({1 - b.wan_bytes / a.wan_bytes:.1%} saved); one state digest")
    print(f"[33] TPC-C {TPCC_WAREHOUSES} warehouses x {TPCC_ITEMS:,} items (STOCK's rows), "
          f"{TPCC_VALUE_BYTES} B values, every row loaded before epoch 0; TPCC-A, remote 0.10; "
          f"5 nodes on the paper's testbed at {WAN_BANDWIDTH_MBPS:g} Mbps, {TPCC_TXNS} "
          f"transactions a node an epoch, {TPCC_EPOCHS} epochs, kcenter, filter CPU measured on "
          f"the card")

    def build(strategy):
        return tpcc_cluster(strategy, dev, full=True, modeled=False)

    runs = wan_main_runs("[33]", build, TPCC_EPOCHS, TPCC_TXNS, counters)
    prof = wan_profile("[33]", build, TPCC_TXNS, runs)
    tpcc_reference_pair(dev, runs)
    memory_line("[33]", "end")
    took = time.perf_counter() - t_phase
    print(f"[33] took {took:.1f} s")
    return {"launches": sum(r["launches"] for r in runs.values()), "runs": runs,
            "seconds": took, **prof}


def stream_check(dev) -> None:
    """Phase 34 (a): Fig 11a's streaming arm and the abort curve, each on
    the card and on the CPU (modeled filter CPU), equal; incremental against
    resim; the stream's digests against the formula engine's."""
    def bench(epoch_ms: float, *, streaming: bool = True, feedback: bool = False,
              planner: str = "milp", mode: str = "incremental"):
        def make(device):
            eng, gen, trace = tpcc_cluster("geococo", device, full=False, modeled=True,
                                           planner=planner, epoch_ms=epoch_ms,
                                           streaming=streaming, staleness_feedback=feedback,
                                           stream_mode=mode)
            return eng, gen, trace, TPCC_CHECK_EPOCHS, TPCC_CHECK_TXNS
        return make

    arm, formula = "Fig 11a's streaming arm (TPCC-A geococo, MILP, 10 ms)", "its formula engine"
    curve = {ms: f"abort curve (TPCC-A geococo, kcenter, feedback) at {ms:g} ms"
             for ms in STREAM_CURVE_MS}
    mid = STREAM_CURVE_MS[1]
    resim = f"{curve[mid]}, resim"
    card = card_equals_cpu("[34]", [
        (arm, bench(10.0)), (formula, bench(10.0, streaming=False)),
        *[(curve[ms], bench(ms, feedback=True, planner="kcenter")) for ms in STREAM_CURVE_MS],
        (resim, bench(mid, feedback=True, planner="kcenter", mode="resim"))], dev)
    if wan_fields(card[resim]) != wan_fields(card[curve[mid]]):
        fail(f"[34] (a) {mid:g} ms: stream_mode='resim' differs from 'incremental'")
    a, f = card[arm], card[formula]
    if (a.state_digest, a.value_digest, a.committed) != (f.state_digest, f.value_digest,
                                                          f.committed):
        fail("[34] (a) the streaming arm's digests differ from the formula engine's")
    print(f"[34] (a) {mid:g} ms: stream_mode='resim' equals 'incremental' (every field, both "
          f"digests); the streaming arm's digests {a.state_digest[:12]}... and commits "
          f"({a.committed:,}) are the formula engine's; wall {a.wall_s * 1e3:.2f} ms streamed "
          f"against the formula's {f.wall_s * 1e3:.2f} ms (pipeline overlap "
          f"{a.pipeline_overlap_ms:.2f} ms), tpmTotal {a.throughput_tps * 60:,.0f} against "
          f"{f.throughput_tps * 60:,.0f} (modeled)")
    for ms in STREAM_CURVE_MS:
        rs = card[curve[ms]]
        print(f"[34] (a) abort curve at {ms:g} ms: read-abort rate {rs.read_abort_rate:.4f} "
              f"({rs.read_aborts:,} of {rs.total_txns:,}), write-write aborts {rs.ww_aborts:,}, "
              f"view lag mean {rs.summary.view_lag_mean:.3f} max {rs.summary.view_lag_max}; "
              f"wall {rs.wall_s * 1e3:.2f} ms")


def table_bytes(table) -> int:
    """The device bytes of a table: values, lengths, versions, flags."""
    return sum(x.numel() * x.element_size()
               for x in (table.values, table.lengths, table.versions, table.present))


def view_joins(eng, calls: list, tables: list) -> list:
    """The ``(rows, taken)`` of the joins into the views (not the store)."""
    store = eng.store.values.data_ptr()
    return [c for c, ptr in zip(calls, tables) if ptr != store]


def stream_main_run(tag: str, build, epochs: int, txns: int, counters: dict) -> dict:
    """One streaming run at full size from a store loaded before its epochs
    (its set-up timed apart), through ``run()``: gated (c) one join a
    commit and one a view and epoch merged, every other kernel 0; printed
    each epoch's wall split and stream, the run's wall against the
    formula's, aborts, view lags and peak memory against the tables'
    reckoning."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    eng, gen, trace = build()
    make_s, load_s = loaded_store(eng, gen)
    cfg = eng.cfg

    def main_path():
        t0 = time.perf_counter()
        rs = eng.run(gen, trace, txns_per_node=txns, n_epochs=epochs)
        torch.cuda.synchronize()
        return rs, time.perf_counter() - t0

    tables = []
    with join_calls(tables) as calls:
        (rs, wall), counts = counted(counters, main_path)
    peak = torch.cuda.max_memory_allocated()
    commits, views = eng.store.merges, eng.view_merges
    others = {k: v for k, v in counts.items() if k != "crdt_join_rows" and v}
    joins = view_joins(eng, calls, tables)
    if others or commits != epochs or counts["crdt_join_rows"] != commits + views \
            or len(joins) != views:
        fail(f"{tag} (c): kernel counts {counts} in {epochs} epochs: {commits} commits, "
             f"{views} views' joins ({len(joins)} seen)")
    times = list(eng.epoch_times)
    epochs_s = sum(sum(t.values()) for t in times)
    n_views = cfg.n_nodes if cfg.staleness_feedback else 0
    one = table_bytes(eng.store)
    formula = [max(cfg.epoch_ms, e.exec_ms, e.sync_ms) for e in rs.epochs]
    print(f"{tag}: store made in {make_s * 1e3:.1f} ms and loaded ({eng.store.n_rows:,} rows) "
          f"in {load_s * 1e3:.1f} ms; {epochs} epochs at {cfg.epoch_ms:g} ms, "
          f"{epochs_s * 1e3:.1f} ms ({epochs_s / epochs * 1e3:.2f} ms an epoch): "
          f"{wan_times_text(times)}, the views' advances "
          f"{sum(t['views_s'] for t in times) * 1e3:.1f}; the rest of run() (the views' "
          f"copies, the two digests) {(wall - epochs_s) * 1e3:.1f} ms")
    for e, (st, t) in enumerate(zip(rs.epochs, times)):
        print(f"    epoch {e:2d}: draws {t['draw_s'] * 1e3:6.1f} ms, copy {t['copy_s'] * 1e3:5.1f}, "
              f"device {t['device_s'] * 1e3:6.1f}, host {t['host_s'] * 1e3:6.1f}, views "
              f"{t['views_s'] * 1e3:5.1f}; committed {st.committed}, read aborts "
              f"{st.read_aborts}, write-write {st.ww_aborts}, view lag {st.view_lag_mean:.1f} "
              f"(max {st.view_lag_max}); sync {st.sync_ms:.2f} ms, stream commit "
              f"{st.stream_commit_ms:.2f} ms, wall {st.wall_ms:.2f} against the formula's "
              f"{formula[e]:.2f}")
    print(f"{tag}: committed {rs.committed:,}, aborted {rs.aborted:,} (read {rs.read_aborts:,}, "
          f"write-write {rs.ww_aborts:,}); read-abort rate {rs.read_abort_rate:.4f}; view lag "
          f"mean {rs.summary.view_lag_mean:.3f}, max {rs.summary.view_lag_max}; streamed wall "
          f"{rs.wall_s * 1e3:.2f} ms against the formula's {sum(formula):.2f} ms (pipeline "
          f"overlap {rs.pipeline_overlap_ms:.2f} ms); WAN {rs.wan_bytes / 1e6:.3f} MB; "
          f"{commits} commits and {views} views' joins through crdt_join_rows, every other "
          f"kernel 0; peak {peak / 1e9:.2f} GB against {1 + n_views} tables of "
          f"{one / 1e9:.3f} GB = {(1 + n_views) * one / 1e9:.2f} GB reckoned")
    if rs.serve is not None:
        print(f"{tag} [35] (c-ii) serving over the views: {serve_text(rs.serve)}")
    out = {"rs": rs, "launches": counts["crdt_join_rows"], "views": views, "peak": peak,
           "times": times}
    del eng, gen
    torch.cuda.empty_cache()
    return out


def stream_profile(tag: str, build, txns: int) -> dict:
    """The device busy share: the profiler's device time over
    STREAM_PROFILE_EPOCHS epochs of a third feedback run (the streaming
    engine's epochs alone: its store loaded and its five views copied
    before the window opens, no digests) against the wall of that window;
    each view's join, launch by launch, against the bound of the rows it
    took; then the host's side of those joins (``view_join_trace``)."""
    import torch

    from repro_torch.core.sinks import RunAggregator

    eng, gen, trace = build()
    loaded_store(eng, gen)
    # the views that the run copies from the store at its start, made here:
    # the window holds no copy of the store
    views, view_next = eng._start_views()
    torch.cuda.synchronize()
    eng._start_views = lambda: (views, view_next)
    # each epoch's committed rows, as the views join them
    deltas, commit = [], eng._commit

    def keeping(batch):
        out = commit(batch)
        deltas.append(out[3])
        return out

    eng._commit = keeping
    window = {}

    def epochs():
        t0 = time.perf_counter()
        eng._run_streaming(gen, trace, txns, STREAM_PROFILE_EPOCHS, RunAggregator())
        torch.cuda.synchronize()
        window["wall_ms"] = (time.perf_counter() - t0) * 1e3

    tables = []
    with join_calls(tables) as calls:
        dev_ms, by_name, each_ms = profile_launches(epochs, "crdt_join_rows_kernel")
    store = eng.store.values.data_ptr()
    joined = [(c, ms) for c, ptr, ms in zip(calls, tables, each_ms) if ptr != store]
    bounds = [join_bound(k, eng.store.words, 4, taken)[0] for (k, taken), _ in joined]
    view_ms = sum(ms for _, ms in joined)
    if len(each_ms) != len(calls) or len(joined) != eng.view_merges:
        fail(f"{tag} the profiled window: {len(each_ms)} kernels, {len(calls)} joins, "
             f"{len(joined)} into views of {eng.view_merges}")
    copies = sum(ms for name, ms in by_name.items() if "Memcpy DtoD" in name)
    views_s = sum(t["views_s"] for t in eng.epoch_times)
    wall_ms = window["wall_ms"]
    if dev_ms is not None:
        print(f"{tag} {STREAM_PROFILE_EPOCHS} epochs of a third feedback run (its views made "
              f"before), profiled: {dev_ms:.2f} ms of device time (torch.profiler) in "
              f"{wall_ms:.1f} ms of that window's wall: busy {dev_ms / wall_ms:.1%}; device "
              f"copies {copies:.3f} ms; the largest:")
        for name, kms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
            print(f"    {kms:9.3f} ms  {name[:100]}")
    print(f"{tag} the views' joins in those epochs: {len(joined)} launches of "
          f"crdt_join_rows_kernel, {view_ms:.4f} ms of device time against a bound of "
          f"{sum(bounds):.4f} ms (bytes of the rows taken)"
          + (f": {sum(bounds) / view_ms:.1%}; the views' advances {views_s * 1e3:.3f} ms "
             f"between synchronises, {views_s * 1e3 / len(joined):.3f} ms a join; each:"
             if joined else ""))
    for ((k, taken), ms), bound in zip(joined, bounds):
        print(f"    {k:,} rows, {taken:,} taken: {ms * 1e3:.2f} us against {bound * 1e3:.3f} us, "
              f"{bound / ms:.1%}")
    host = view_join_trace(tag, views[0], deltas)
    # the two wrappers hold the engine (a bound method) and the views: a
    # cycle the garbage collector would have to find before the store is freed
    del eng._commit, eng._start_views
    del eng, gen, views, deltas
    torch.cuda.empty_cache()
    return {"busy": None if dev_ms is None else dev_ms / wall_ms, "view_kernel_ms": view_ms,
            "view_bound_ms": sum(bounds), "view_joins_profiled": len(joined),
            "views_ms_a_join": views_s * 1e3 / len(joined) if joined else None, **host}


def view_join_trace(tag: str, view, deltas: list) -> dict:
    """The host's side of a view's join: ``CRDTTable.join_rows`` of each
    committed epoch kept from the profiled window into one view again (a
    join is idempotent: the view keeps its rows, so the kernel moves no
    payload, and the host runs the same calls), first each join between
    two synchronises, then all of them under torch.profiler with the host's
    activity too: the host time by operation, the device time in all."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not deltas:
        return {}
    walls = []
    for d in deltas:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        view.join_rows(*d)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for d in deltas:
            view.join_rows(*d)
        torch.cuda.synchronize()
    ops = prof.key_averages()
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count) for e in ops
                   if e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0),
                  key=lambda x: -x[1])
    device_ms = sum(getattr(e, "self_device_time_total", 0.0) / 1e3 for e in ops
                    if e.device_type == DeviceType.CUDA)
    host_ms = sum(ms for _, ms, _ in host)
    launches = sum(n for key, _, n in host if key in ("cudaLaunchKernel", "cuLaunchKernel",
                                                      "cudaLaunchKernelExC"))
    n = len(deltas)
    print(f"{tag} the host's side of a view's join ({n} committed epochs of the profiled "
          f"window joined into one view again): {sum(walls) / n:.3f} ms a join between "
          f"synchronises (each: {', '.join(f'{w:.3f}' for w in walls)}); traced, "
          f"the host's operations {host_ms / n:.3f} ms "
          f"({launches / n:.1f} kernel launches a join), the device {device_ms / n:.4f} ms; "
          f"the host's largest, ms a join:")
    for key, ms, cnt in host[:8]:
        print(f"    {ms / n:8.4f} ms  {cnt / n:5.1f} calls  {key[:80]}")
    return {"view_join_wall_ms": sum(walls) / n, "view_join_host_ms": host_ms / n,
            "view_join_device_ms": device_ms / n}


def run_stream(dev, counters: dict, wan: dict) -> dict:
    """Phase 34: the streaming engine and per-node views.  (a) card against
    CPU; (b) the loaded YCSB store without and with feedback (phase 32's
    geococo run's digests, commits and WAN bytes; the same write-write
    aborts) and the loaded TPC-C database with feedback; (c) the launches;
    a profiled window of a third feedback run."""
    import torch

    t_phase = time.perf_counter()
    memory_line("[34]", "start")
    stream_check(dev)

    from repro_torch.serve import ServeConfig

    def serve(n_keys: int):
        # phase 35 (c-ii): the serving plane over the views, at full size
        return ServeConfig(clients_per_node=SERVE_CLIENTS, read_ratio=0.95,
                           max_staleness_ms=SERVE_BOUND_MS, policy="redirect",
                           cache_keys=SERVE_CACHE_KEYS, n_keys=n_keys)

    def ycsb(feedback: bool, serving: bool = False):
        return lambda: wan_cluster("geococo", False, WAN_KEYS, dev, modeled=False, streaming=True,
                                   staleness_feedback=feedback, epoch_ms=STREAM_EPOCH_MS,
                                   serve=serve(WAN_KEYS) if serving else None)

    print(f"[34] (b) phase 32's YCSB store ({WAN_KEYS:,} records x {WAN_VALUE_BYTES} B, loaded) "
          f"and testbed, geococo, {WAN_EPOCHS} epochs at {STREAM_EPOCH_MS:g} ms, filter CPU "
          f"measured on the card")
    off = stream_main_run("[34] (b) YCSB streamed", ycsb(False), WAN_EPOCHS, WAN_TXNS, counters)
    geo = wan["runs"]["geococo"]["rs"]
    got = (off["rs"].state_digest, off["rs"].value_digest, off["rs"].committed,
           off["rs"].wan_bytes)
    if got != (geo.state_digest, geo.value_digest, geo.committed, geo.wan_bytes):
        fail(f"[34] (b) the streamed YCSB run {got} differs from phase 32's geococo run")
    print(f"[34] (b) the streamed run ends in phase 32's geococo state: digests "
          f"{geo.state_digest[:12]}..., {geo.committed:,} committed, WAN "
          f"{geo.wan_bytes / 1e6:.3f} MB")
    on = stream_main_run("[34] (b) YCSB with five views", ycsb(True, serving=True), WAN_EPOCHS,
                         WAN_TXNS, counters)
    if [e.ww_aborts for e in on["rs"].epochs] != [e.ww_aborts for e in off["rs"].epochs]:
        fail("[34] (b) the feedback run's write-write aborts differ from the streamed run's")
    print(f"[34] (b) with the views: the same write-write aborts, epoch for epoch "
          f"({on['rs'].ww_aborts:,}); {on['rs'].read_aborts:,} read aborts more")
    print(f"[34] (b) phase 33 (b)'s TPC-C database ({TPCC_WAREHOUSES} x {TPCC_ITEMS:,} rows of "
          f"{TPCC_VALUE_BYTES} B, loaded), TPCC-A, geococo, feedback, {TPCC_EPOCHS} epochs at "
          f"{STREAM_EPOCH_MS:g} ms")
    tp = stream_main_run("[34] (b) TPC-C with six tables",
                         lambda: tpcc_cluster("geococo", dev, full=True, modeled=False,
                                              streaming=True, staleness_feedback=True,
                                              epoch_ms=STREAM_EPOCH_MS,
                                              serve=serve(TPCC_WAREHOUSES * TPCC_ITEMS)),
                         TPCC_EPOCHS, TPCC_TXNS, counters)
    prof = stream_profile("[34]", ycsb(True), WAN_TXNS)
    memory_line("[34]", "end")
    took = time.perf_counter() - t_phase
    print(f"[34] took {took:.1f} s (aim {STREAM_PHASE_LIMIT_S:g} s)")
    runs = (off, on, tp)
    return {"launches": sum(r["launches"] for r in runs),
            "view_joins": sum(r["views"] for r in runs), "seconds": took, **prof}


def geo_wan_cluster(n: int, rounds: int, seed: int):
    """``benchmarks/common.py:60-65``'s ``wan_cluster`` from the port's
    latency module: the latency matrix, regions, bandwidth matrix and
    jittered trace."""
    import numpy as np

    from repro_torch.core.latency import (GeoClusterSpec, bandwidth_matrix,
                                          geo_clustered_matrix, jitter_trace)

    rng = np.random.default_rng(seed)
    spec = GeoClusterSpec(n_nodes=n, n_clusters=max(2, min(5, n // 3)))
    lat, regions = geo_clustered_matrix(spec, rng)
    bw = bandwidth_matrix(regions, n, rng)
    return lat, np.asarray(regions), bw, jitter_trace(lat, rounds, np.random.default_rng(seed + 1))


def fig16_cluster(device, *, grouping: bool, filtering: bool, tiv: bool = True,
                  compression: bool = False):
    """Phase 35 (a): ``benchmarks/common.py:79-117``'s ``run_engine`` at Fig
    16's quick settings, built on ``device``."""
    from repro_torch.core.replication import EngineConfig, GeoCluster
    from repro_torch.core.workload import YCSBConfig, YCSBGenerator

    n = FIG16_NODES
    _, regions, _, trace = geo_wan_cluster(n, FIG16_EPOCHS, FIG16_SEED)
    wan = regions[:, None] != regions[None, :]
    eng = GeoCluster(EngineConfig(n_nodes=n, grouping=grouping, filtering=filtering, tiv=tiv,
                                  compression=compression, planner="milp", modeled_cpu=True),
                     bandwidth_mbps=lan_wan_bandwidth(regions, n, 40.0), wan_mask=wan, seed=7,
                     device=device)
    gen = YCSBGenerator(YCSBConfig(n_keys=20_000, theta=0.7, read_ratio=0.5, hot_write_frac=0.35,
                                   hot_locality=True, rewrite_frac=0.10, value_bytes=100),
                        n, seed=8, node_region=regions)
    return eng, gen, trace, FIG16_EPOCHS, FIG16_TXNS


def serve_text(s) -> str:
    """A ``ServeStats``' summary, the served rate unrounded."""
    return (f"{s.reads_total:,.0f} reads, served {s.throughput_rps!r} reads/s; redirect "
            f"{s.redirect_rate:.4f}, reject {s.reject_rate:.4f}, stale {s.stale_serve_rate:.4f}, "
            f"cache hits {s.cache_hit_rate:.4f}; p50 {s.read_latency_p50_ms:.2f} ms, p99 "
            f"{s.read_latency_p99_ms:.2f} ms (bound {s.max_staleness_ms:g} ms, {s.policy})")


def serve_fields(s) -> dict:
    """A ``ServeStats``' fields: per-epoch lists, totals, latency classes."""
    return {"epochs": [dataclasses.asdict(e) for e in s.epochs],
            "totals": dataclasses.asdict(s.totals), "values": s.latency_values_ms.tolist(),
            "weights": s.latency_weights.tolist(), "wall_ms": s.wall_ms,
            "summary": s.summary()}


def only_joins(tag: str, counts: dict, want: int) -> None:
    """Gate: ``want`` join launches, every other kernel 0."""
    others = {k: v for k, v in counts.items() if k != "crdt_join_rows" and v}
    if others or counts["crdt_join_rows"] != want:
        fail(f"{tag} kernel counts {counts}, {want} joins expected (one a commit)")


def fig16_check(dev, counters: dict) -> int:
    """Phase 35 (a): Fig 16's four runs on the card and on the CPU, equal;
    one digest; the normalized makespans the reference's.  Returns the
    card runs' join launches."""
    runs = {"baseline": dict(grouping=False, filtering=False, tiv=False),
            "zlib": dict(grouping=False, filtering=False, tiv=False, compression=True),
            "geococo": dict(grouping=True, filtering=True),
            "geococo+zlib": dict(grouping=True, filtering=True, compression=True)}
    card, counts = counted(counters, lambda: card_equals_cpu(
        "[35]", [(name, functools.partial(fig16_cluster, **kw)) for name, kw in runs.items()],
        dev))
    only_joins("[35] (a)", counts, len(runs) * FIG16_EPOCHS)
    base = card["baseline"].makespans_ms.mean()
    norm = {k: float(rs.makespans_ms.mean() / base) for k, rs in card.items()}
    if {k: round(v, 5) for k, v in norm.items()} != FIG16_NORM:
        fail(f"[35] (a) normalized makespans {norm}, the reference's {FIG16_NORM}")
    if len({rs.state_digest for rs in card.values()}) != 1:
        fail("[35] (a) the four runs end in different states")
    print("[35] (a) Fig 16 on the card: one state; normalized makespans "
          + ", ".join(f"{k} {v!r}" for k, v in norm.items())
          + "; WAN " + ", ".join(f"{k} {rs.wan_bytes / 1e6:.6f} MB" for k, rs in card.items()))
    return counts["crdt_join_rows"]


def zlib_at_scale(dev, counters: dict, wan: dict) -> dict:
    """Phase 35 (b): geococo-zlib on phase 32's loaded store and settings,
    filter and compression CPU measured: its digests phase 32's geococo
    run's; one join an epoch, every other kernel 0."""
    import torch

    eng, gen, trace = wan_cluster("geococo-zlib", False, WAN_KEYS, dev, modeled=False)
    _, load_s = loaded_store(eng, gen)

    def main_path():
        t0 = time.perf_counter()
        rs = eng.run(gen, trace, txns_per_node=WAN_TXNS, n_epochs=WAN_EPOCHS)
        torch.cuda.synchronize()
        return rs, time.perf_counter() - t0

    (rs, wall), counts = counted(counters, main_path)
    geo = wan["runs"]["geococo"]["rs"]
    if (rs.state_digest, rs.value_digest, rs.committed) != (geo.state_digest, geo.value_digest,
                                                             geo.committed):
        fail(f"[35] (b) geococo-zlib ends in {rs.state_digest[:16]}... ({rs.committed} "
             f"committed), phase 32's geococo in {geo.state_digest[:16]}... ({geo.committed})")
    only_joins("[35] (b)", counts, WAN_EPOCHS)
    times = list(eng.epoch_times)
    tot = {k: sum(t[k] for t in times) * 1e3 for k in times[0] if k.endswith("_s")}
    z = {k: sum(t[f"{k}_bytes"] for t in times) for k in ("stream", "zlib_in", "zlib_out")}
    epochs_s = sum(tot.values()) / 1e3
    print(f"[35] (b) geococo-zlib on phase 32's store ({WAN_KEYS:,} records x {WAN_VALUE_BYTES} B, "
          f"loaded in {load_s * 1e3:.1f} ms), {WAN_EPOCHS} epochs {epochs_s * 1e3:.1f} ms "
          f"({epochs_s / WAN_EPOCHS * 1e3:.2f} ms an epoch): {wan_times_text(times)}; "
          f"compression: the streams built on the card {tot['stream_s']:.1f} ms, copied to the "
          f"host {tot['stream_copy_s']:.1f}, zlib {tot['zlib_s']:.1f}; the rest of run() (the "
          f"two digests) {(wall - epochs_s) * 1e3:.1f} ms")
    for e, (st, t) in enumerate(zip(rs.epochs, times)):
        print(f"    epoch {e:2d}: draws {t['draw_s'] * 1e3:6.1f} ms, copy {t['copy_s'] * 1e3:5.1f}, "
              f"device {t['device_s'] * 1e3:6.1f}, host {t['host_s'] * 1e3:6.1f}, streams "
              f"{t['stream_s'] * 1e3:5.1f}, their copies {t['stream_copy_s'] * 1e3:5.1f}, zlib "
              f"{t['zlib_s'] * 1e3:6.1f}; WAN {st.wan_bytes / 1e6:.3f} MB, filter CPU "
              f"{st.filter_cpu_ms:.2f} ms, sync {st.sync_ms:.2f} ms")
    print(f"[35] (b) zlib: {z['zlib_in'] / 1e6:.3f} MB in, {z['zlib_out'] / 1e6:.3f} MB out "
          f"(ratio {z['zlib_in'] / max(z['zlib_out'], 1):.1f}), "
          f"{z['zlib_in'] / (tot['zlib_s'] / 1e3) / 1e6:.1f} MB/s on the host with the cuts; "
          f"the streams {z['stream'] / 1e6:.3f} MB, their copies "
          f"{z['stream'] / (tot['stream_copy_s'] / 1e3) / 1e9:.3f} GB/s")
    print(f"[35] (b) the digests of phase 32's geococo run ({geo.state_digest[:12]}..., "
          f"{rs.committed:,} committed); WAN {rs.wan_bytes / 1e6:.3f} MB against geococo's "
          f"{geo.wan_bytes / 1e6:.3f} MB ({rs.wan_bytes / geo.wan_bytes - 1:+.1%}); modeled "
          f"{rs.throughput_tps:,.0f} txn/s against {geo.throughput_tps:,.0f}; crdt_join_rows "
          f"{counts['crdt_join_rows']} launches, every other kernel 0")
    out = {"rs": rs, "launches": counts["crdt_join_rows"], "zlib": dict(z), "times": tot}
    del eng, gen
    torch.cuda.empty_cache()
    return out


def serving_check(dev, counters: dict) -> int:
    """Phase 35 (c-i): ``bench_serving.py``'s quick regime on the card: the
    bounds, flat against geococo, serving on against off; the card's
    ``ServeStats`` equal to the CPU's in one run; the reference's served
    reads/s.  Returns the card runs' join launches."""
    from repro_torch.serve import ServeConfig

    def run(strategy: str, bound: float | None, device):
        serve = None if bound is None else ServeConfig(
            clients_per_node=SERVE_CLIENTS, read_ratio=0.95, max_staleness_ms=bound,
            policy="redirect", cache_keys=SERVE_CACHE_KEYS)
        eng, gen, trace = tpcc_cluster(strategy, device, full=False, modeled=True,
                                       rounds=SERVE_EPOCHS, streaming=True, epoch_ms=10.0,
                                       serve=serve)
        return eng.run(gen, trace, txns_per_node=SERVE_TXNS, n_epochs=SERVE_EPOCHS)

    keys = [*SERVE_RPS, ("geococo", None)]
    t0 = time.perf_counter()
    card, counts = counted(counters, lambda: {key: run(*key, dev) for key in keys})
    card_s = time.perf_counter() - t0
    only_joins("[35] (c-i)", counts, len(keys) * SERVE_EPOCHS)
    on, off = card[("geococo", SERVE_BOUND_MS)], card[("geococo", None)]
    cpu = run("geococo", SERVE_BOUND_MS, "cpu")
    differ = [k for k, v in serve_fields(on.serve).items() if serve_fields(cpu.serve)[k] != v]
    if differ or wan_fields(dataclasses.replace(on, serve=None)) != \
            wan_fields(dataclasses.replace(cpu, serve=None)):
        fail(f"[35] (c-i) geococo at {SERVE_BOUND_MS:g} ms: the card's run differs from the "
             f"CPU's (ServeStats {differ})")
    if (off.state_digest, off.value_digest, off.wan_bytes, [e.wall_ms for e in off.epochs]) != \
            (on.state_digest, on.value_digest, on.wan_bytes, [e.wall_ms for e in on.epochs]):
        fail("[35] (c-i) serving changed the run's digests, WAN bytes or times")
    if len({rs.state_digest for rs in card.values()}) != 1:
        fail("[35] (c-i) flat and geococo end in different states")
    for key, rps in SERVE_RPS.items():
        if round(card[key].serve.throughput_rps) != rps:
            fail(f"[35] (c-i) {key}: {card[key].serve.throughput_rps!r} reads/s, the "
                 f"reference's {rps:,}")
    print(f"[35] (c-i) bench_serving.py's quick regime on the card ({len(keys)} runs, "
          f"{card_s:.1f} s): geococo at {SERVE_BOUND_MS:g} ms equals its CPU run (ServeStats "
          f"field for field, every EpochStats field, digests); serving on = off in digests, WAN "
          f"bytes and times; one state across flat and geococo; {counts['crdt_join_rows']} "
          f"joins, every other kernel 0")
    for (strategy, bound), rps in SERVE_RPS.items():
        print(f"[35] (c-i) {strategy} at {bound:g} ms: "
              f"{serve_text(card[(strategy, bound)].serve)} (the reference: {rps:,})")
    return counts["crdt_join_rows"]


def raft_check() -> dict:
    """Phase 35 (d): Fig 11b's Raft plane (host numpy), flat against
    GeoCoCo's relay over four payloads, without and with bandwidth: the
    reference's gains."""
    from repro_torch.core.replication import RaftCluster

    _, _, bw, trace = geo_wan_cluster(RAFT_NODES, RAFT_STEPS, RAFT_SEED)
    out = {}
    for with_bw in (False, True):
        t0 = time.perf_counter()
        kw = {"bandwidth_mbps": bw} if with_bw else {}
        gains = {}
        for wl, payload in RAFT_PAYLOADS.items():
            base = RaftCluster(RAFT_NODES, grouping=False, tiv=False, **kw).throughput(
                trace, payload_bytes=payload)
            geo = RaftCluster(RAFT_NODES, grouping=True, tiv=True, **kw).throughput(
                trace, payload_bytes=payload)
            gains[wl] = (base, geo, 100.0 * (geo / base - 1.0))
        for wl, pct in RAFT_GAINS[with_bw].items():
            if round(gains[wl][2], 1) != pct:
                fail(f"[35] (d) {wl} {'with' if with_bw else 'without'} bandwidth: "
                     f"{gains[wl][2]:+.3f}%, the reference's {pct:+.1f}%")
        how = "with its bandwidth matrix" if with_bw else "without bandwidth (as the benchmark)"
        print(f"[35] (d) Fig 11b, RaftCluster on wan_cluster({RAFT_NODES}, {RAFT_STEPS}, "
              f"seed={RAFT_SEED}) {how}, {time.perf_counter() - t0:.2f} s: "
              + "; ".join(f"{wl} {b!r} -> {g!r} ops/s ({p:+.2f}%)"
                          for wl, (b, g, p) in gains.items()))
        out[with_bw] = gains
    return out


def run_planes(dev, counters: dict, wan: dict) -> dict:
    """Phase 35: WAN compression (Fig 16 card against CPU; geococo-zlib at
    scale), the serving plane (bench_serving.py's regime card against CPU)
    and the Raft plane (Fig 11b).  Phase 34 (b) serves at full size."""
    import torch

    t_phase = time.perf_counter()
    memory_line("[35]", "start")
    launches = fig16_check(dev, counters)
    print(f"[35] (a) took {time.perf_counter() - t_phase:.1f} s")
    t = time.perf_counter()
    big = zlib_at_scale(dev, counters, wan)
    print(f"[35] (b) took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    launches += big["launches"] + serving_check(dev, counters)
    print(f"[35] (c-i) took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    raft = raft_check()
    print(f"[35] (d) took {time.perf_counter() - t:.1f} s")
    torch.cuda.empty_cache()
    memory_line("[35]", "end")
    took = time.perf_counter() - t_phase
    print(f"[35] took {took:.1f} s (aim {PLANES_PHASE_AIM_S:g} s)")
    return {"launches": launches, "zlib": big, "raft": raft, "seconds": took}


# the EpochStats fields that read the filter's measured CPU time (phase 32
# measures it on the card, so a second run's differ)
MEASURED_FIELDS = ("filter_cpu_ms", "sync_ms", "wall_ms", "sync_serial_ms", "sync_overlap_ms",
                   "sync_cpu_hidden_ms", "sync_wan_overlap_ms", "pipeline_overlap_ms",
                   "stream_commit_ms")


def checker_theorems(tag: str, mc, scope, names, want: dict, counters: dict, dev) -> dict:
    """Each theorem of ``names`` at ``scope`` on the card's tables, its
    instances and info gated against ``want`` (the reference's), zero
    violations, every instance counted clean, joins through
    ``crdt_join_rows`` only (at least one a table theorem); returns each
    theorem's wall time and join launches."""
    import torch

    out = {}
    for name in names:
        mc.reset_model_checked_count()
        t0 = time.perf_counter()
        report, counts = counted(counters, lambda: mc.run_tier(scope, only=[name],
                                                               selftest=False, device=dev))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rep = report.theorems[0]
        info = {k: v for k, v in rep.info.items() if k != "corpus"}
        if rep.violations or (rep.instances, info) != want[name] or \
                mc.model_checked_count(name) != rep.instances:
            fail(f"{tag} {name}: {rep.instances} instances, info {info}, "
                 f"{len(rep.violations)} violations (first: "
                 f"{rep.violations[0] if rep.violations else None}); the reference's "
                 f"{want[name]}")
        joins = counts["crdt_join_rows"]
        others = {k: v for k, v in counts.items() if k != "crdt_join_rows" and v}
        if others or (name != "admission") != (joins > 0):
            fail(f"{tag} {name}: kernel counts {counts}")
        out[name] = {"s": wall, "joins": joins, "instances": rep.instances}
        shown = {k: float(v) if isinstance(v, float) else v for k, v in info.items()}
        print(f"{tag} {name}: {rep.instances:,} instances, 0 violations, {shown} (the "
              f"reference's), {wall:.2f} s on the card, {joins:,} crdt_join_rows launches "
              f"({wall / rep.instances * 1e3:.3f} ms an instance)")
    return out


def run_checker(dev, counters: dict) -> dict:
    """Phase 36 (a): the model checker's smoke tier on the card and its four
    seeded mutants."""
    from repro_torch.analysis import modelcheck as mc

    t0 = time.perf_counter()
    smoke = checker_theorems("[36] (a) smoke", mc, mc.scope_for("smoke"), mc.THEOREMS,
                             MODELCHECK_SMOKE, counters, dev)
    t = time.perf_counter()
    reports, counts = counted(counters, lambda: mc.selftest_reports(dev))
    got = {name: len(r.violations) for name, r in reports.items()}
    if got != MODELCHECK_MUTANTS:
        fail(f"[36] (a) the seeded mutants' violations {got}, the reference's "
             f"{MODELCHECK_MUTANTS}")
    self_s = time.perf_counter() - t
    print(f"[36] (a) self-test: 4 of 4 seeded mutants rejected, violations {got} (the "
          f"reference's), {self_s:.2f} s, {counts['crdt_join_rows']:,} joins")
    smoke_s = time.perf_counter() - t0
    launches = sum(r["joins"] for r in smoke.values()) + counts["crdt_join_rows"]
    print(f"[36] (a) the smoke tier and self-test {smoke_s:.1f} s, {launches:,} "
          f"crdt_join_rows launches")
    return {"launches": launches, "smoke": smoke, "selftest_s": self_s}


@contextlib.contextmanager
def verifier_clock():
    """The schedule verifier's host time inside the block: the one-shot
    ``verify_schedule`` (as ``WANSimulator.run`` calls it) and the per-epoch
    ``StreamScheduleVerifier.check_epoch``, each call timed; ``rounds``
    keeps the schedules verified one-shot, in order."""
    from repro_torch.analysis import schedule_check as sc

    clock = {"s": 0.0, "calls": 0, "rounds": []}
    one, per_epoch = sc.verify_schedule, sc.StreamScheduleVerifier.check_epoch

    def timed_one(schedule, **kw):
        t0 = time.perf_counter()
        try:
            return one(schedule, **kw)
        finally:
            clock["s"] += time.perf_counter() - t0
            clock["calls"] += 1
            clock["rounds"].append(schedule)

    def timed_epoch(self, *args, **kw):
        t0 = time.perf_counter()
        try:
            return per_epoch(self, *args, **kw)
        finally:
            clock["s"] += time.perf_counter() - t0
            clock["calls"] += 1

    sc.verify_schedule, sc.StreamScheduleVerifier.check_epoch = timed_one, timed_epoch
    try:
        yield clock
    finally:
        sc.verify_schedule, sc.StreamScheduleVerifier.check_epoch = one, per_epoch


def verified_run(tag: str, build, epochs: int, counters: dict) -> dict:
    """One run from a store loaded before its epochs through ``run()``, the
    verifier's host time and calls counted; gated one join a commit (and one
    a view's epoch), every other kernel 0."""
    import torch

    from repro_torch.analysis import schedule_check as sc

    eng, gen, trace = build()
    loaded_store(eng, gen)
    sc.reset_verified_schedule_count()
    with verifier_clock() as clock:
        t0 = time.perf_counter()
        rs, counts = counted(counters, lambda: eng.run(gen, trace, txns_per_node=WAN_TXNS,
                                                       n_epochs=epochs))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    want = eng.store.merges + eng.view_merges
    others = {k: v for k, v in counts.items() if k != "crdt_join_rows" and v}
    if others or eng.store.merges != epochs or counts["crdt_join_rows"] != want:
        fail(f"{tag}: kernel counts {counts} in {epochs} epochs ({eng.store.merges} commits, "
             f"{eng.view_merges} views' joins)")
    epochs_s = sum(sum(t.values()) for t in eng.epoch_times)
    out = {"rs": rs, "wall": wall, "epochs_s": epochs_s, "verified": sc.verified_schedule_count(),
           "verify_s": clock["s"], "verify_calls": clock["calls"], "rounds": clock["rounds"],
           "launches": counts["crdt_join_rows"], "lat": trace[0]}
    del eng, gen
    torch.cuda.empty_cache()
    return out


def verify_text(r: dict, epochs: int) -> str:
    return (f"{r['verified']} schedules verified clean ({r['verify_calls']} verifier calls), "
            f"the verifier {r['verify_s'] * 1e3:.3f} ms of host time, "
            f"{r['verify_s'] / epochs * 1e3:.4f} ms an epoch against an epoch's "
            f"{r['epochs_s'] / epochs * 1e3:.2f} ms ({r['verify_s'] / r['epochs_s']:.3%}); "
            f"run() {r['wall']:.2f} s")


def run_verified(dev, counters: dict, wan: dict | None) -> dict:
    """Phase 36 (b), (c): phase 32's geococo run verified, against phase 32's
    run (every field but the measured filter CPU's times, both digests);
    phase 34 (b)'s five-view run verified, against an unverified run of the
    same cut (modeled CPU: every field); every mutator rejected."""
    import numpy as np

    from repro_torch.analysis import mutate
    from repro_torch.analysis.schedule_check import ScheduleVerificationError
    from repro_torch.core.schedule import stitch_schedules
    from repro_torch.core.simulator import WANSimulator

    def geococo(verify: bool):
        return lambda: wan_cluster("geococo", False, WAN_KEYS, dev, modeled=False,
                                   verify_schedules=verify)

    def views(verify: bool):
        return lambda: wan_cluster("geococo", False, WAN_KEYS, dev, modeled=True, streaming=True,
                                   staleness_feedback=True, epoch_ms=STREAM_EPOCH_MS,
                                   verify_schedules=verify)

    def deterministic(rs) -> dict:
        f = wan_fields(rs)
        f["epochs"] = [{k: v for k, v in e.items() if k not in MEASURED_FIELDS}
                       for e in f["epochs"]]
        del f["summary"]
        return f

    if wan is None:
        geo = verified_run("[36] (b) phase 32's geococo run", geococo(False), WAN_EPOCHS,
                           counters)["rs"]
    else:
        geo = wan["runs"]["geococo"]["rs"]
    ver = verified_run("[36] (b) geococo verified", geococo(True), WAN_EPOCHS, counters)
    if deterministic(ver["rs"]) != deterministic(geo) or ver["verified"] != WAN_EPOCHS:
        fail(f"[36] (b) the verified geococo run differs from phase 32's, or verified "
             f"{ver['verified']} schedules in {WAN_EPOCHS} epochs")
    rs = ver["rs"]
    print(f"[36] (b) geococo on phase 32's loaded store ({WAN_KEYS:,} keys), "
          f"verify_schedules=True, {WAN_EPOCHS} epochs: phase 32's digests "
          f"{rs.state_digest[:12]}... / {rs.value_digest[:12]}..., {rs.committed:,} committed, "
          f"{rs.aborted:,} aborted (read {rs.read_aborts}, write-write {rs.ww_aborts:,}), WAN "
          f"{rs.wan_bytes / 1e6:.3f} MB, every EpochStats field but the measured filter CPU's "
          f"times equal; {verify_text(ver, WAN_EPOCHS)}")
    runs = {}
    for verify in (False, True):
        runs[verify] = verified_run(f"[36] (b) five views, verify={verify}", views(verify),
                                    VERIFY_VIEW_EPOCHS, counters)
    plain, checked = runs[False], runs[True]
    if wan_fields(plain["rs"]) != wan_fields(checked["rs"]) or \
            checked["verified"] != 2 * VERIFY_VIEW_EPOCHS or plain["verified"] != 0:
        fail(f"[36] (b) the verified five-view run differs from the unverified one, or "
             f"verified {checked['verified']} schedules in {VERIFY_VIEW_EPOCHS} epochs")
    rs = checked["rs"]
    print(f"[36] (b) phase 34 (b)'s five-view YCSB run at {STREAM_EPOCH_MS:g} ms, modeled "
          f"filter CPU, {VERIFY_VIEW_EPOCHS} epochs, verify_schedules=True against False: every "
          f"EpochStats and summary field and both digests equal ({rs.state_digest[:12]}...); "
          f"read aborts {rs.read_aborts:,} (rate {rs.read_abort_rate:.4f}), write-write "
          f"{rs.ww_aborts:,}, view lag mean {rs.summary.view_lag_mean:.3f}, max "
          f"{rs.summary.view_lag_max}; {checked['launches']} joins ({VERIFY_VIEW_EPOCHS} "
          f"commits and the views'); {verify_text(checked, VERIFY_VIEW_EPOCHS)}")
    # (c) every mutator on a round of (b) or the stream its rounds stitch into
    rounds = checked["rounds"]
    lat = checked["lat"]
    n = len(WAN_REGIONS)
    bases = {"round": rounds[-1],
             "stitched": stitch_schedules(rounds[:4], node_exec_ms=[[1.0] * n] * 4,
                                          epoch_ms=STREAM_EPOCH_MS, n=n)}
    rng = np.random.default_rng(36)
    caught = []
    for rule in mutate.MUTATORS:
        base, mut = next(((b, m) for b, m in ((b, mutate.mutate_schedule(s, rule, rng, n_nodes=n))
                                            for b, s in bases.items()) if m is not None),
                         (None, None))
        if mut is None:
            fail(f"[36] (c) no mutant for {rule!r} on (b)'s schedules")
        try:
            WANSimulator(lat, WAN_BANDWIDTH_MBPS, verify=True).run(mut)
        except ScheduleVerificationError as err:
            rules = {v.rule for v in err.violations}
            if rule not in rules:
                fail(f"[36] (c) the {rule!r} mutant was rejected for {sorted(rules)} only")
            caught.append(f"{rule} ({base}, {len(err.violations)})")
        else:
            fail(f"[36] (c) WANSimulator(verify=True) ran the {rule!r} mutant")
    print(f"[36] (c) every mutator rejected by WANSimulator(verify=True), its rule among the "
          f"violations (base, violations): {', '.join(caught)}")
    return {"launches": ver["launches"] + plain["launches"] + checked["launches"],
            "geococo": {k: ver[k] for k in ("verify_s", "epochs_s", "wall", "verified")},
            "views": {k: checked[k] for k in ("verify_s", "epochs_s", "wall", "verified")}}


def run_analysis(dev, counters: dict, wan: dict | None) -> dict:
    """Phase 36: the static-analysis package on the card: (a) the model
    checker, (b) verified schedules at scale, (c) the mutators rejected."""
    import torch

    t_phase = time.perf_counter()
    memory_line("[36]", "start")
    checker = run_checker(dev, counters)
    print(f"[36] (a) took {time.perf_counter() - t_phase:.1f} s")
    t = time.perf_counter()
    verified = run_verified(dev, counters, wan)
    print(f"[36] (b, c) took {time.perf_counter() - t:.1f} s")
    torch.cuda.empty_cache()
    memory_line("[36]", "end")
    took = time.perf_counter() - t_phase
    print(f"[36] took {took:.1f} s (aim {ANALYSIS_PHASE_AIM_S:g} s)")
    return {"launches": checker["launches"] + verified["launches"], "checker": checker,
            "verified": verified, "seconds": took}


def run_topk(shapes, dev, filter_ms: float) -> dict:
    """Phase 20: geococo's chunked top-k (``topk_select``: f32 g + r, per
    chunk of 2048 the top 10% by magnitude, the sent values and the new
    residual) over phase 9's gradient share, one process, no exchange: its
    device time by CUDA events around the leaves' launches, against its
    bound (g and r read, sent and new residual written: 16 B an element)."""
    import torch

    from repro_torch.dist.collectives import topk_select

    memory_line("[20]", "start")
    leaves = _tensors(shapes)
    n = sum(x.numel() for x in leaves)
    gen = torch.Generator(device=dev).manual_seed(0)
    g = [torch.randn(x.shape, generator=gen, device=dev) for x in leaves]
    r = [torch.randn(x.shape, generator=gen, device=dev) * 0.5 for x in leaves]
    density, chunk = POD_SYNC["density"], POD_SYNC["chunk"]

    def run():
        for gl, rl in zip(g, r):
            topk_select(gl, rl, density=density, chunk=chunk)

    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    bound, by = _bound(16 * n, 0)
    dev_ms, by_name = profile_step(run)
    print(f"[20] chunked top-k over {len(leaves)} leaves, {n:,} elements (phase 9's share), f32 g "
          f"and r, chunk {chunk}, density {density}: {ms:.4f} ms on the device (CUDA events, "
          f"median of {len(times)}), bound {bound:.4f} ms ({by}, 16 B an element): "
          f"{bound / ms:.1%}; the white-data filter over the same share {filter_ms:.4f} ms")
    if dev_ms is not None:
        print(f"  kernels' device time in one pass {dev_ms:.2f} ms (torch.profiler), the largest:")
        for name, kms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
            print(f"    {kms:9.3f} ms  {name[:100]}")
    del g, r
    torch.cuda.empty_cache()
    memory_line("[20]", "end")
    return {"ms": ms, "bound_ms": bound, "device_ms": dev_ms}


def build_all(_build) -> None:
    """Phase 2: one nvcc per source, all started together."""
    def timed(name):
        t0 = time.perf_counter()
        return _build.build(name), time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(_build.SOURCES)) as pool:
        futures = {name: pool.submit(timed, name) for name in _build.SOURCES}
        for name, fut in futures.items():
            log, secs = fut.result()
            print(f"[2] {name}: {'built' if log else 'up to date'} in {secs:.2f} s")
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")


def main() -> None:
    t_start = time.perf_counter()
    import torch

    # ---- 1. device
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs only on the card")
    from repro_torch.kernels import _build
    from repro_torch.kernels.crdt_merge import ops as merge_ops
    from repro_torch.kernels.crdt_merge.ref import (crdt_join_rows_ref, crdt_merge_ref,
                                                    crdt_merge_rows_ref)
    from repro_torch.kernels.rglru_scan import ops as rglru_ops
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_backward_ref, rglru_scan_ref
    from repro_torch.kernels.rwkv6_wkv import ops as wkv6_ops
    from repro_torch.kernels.rwkv6_wkv.ref import wkv6_backward_ref, wkv6_ref
    from repro_torch.kernels.whitedata_filter import ops as filter_ops
    from repro_torch.kernels.whitedata_filter.ref import whitedata_filter_ref
    from repro_torch.train.train_step import TrainConfig

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"[1] device: {torch.cuda.get_device_name(0)}; count {torch.cuda.device_count()}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi.splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---- 2. build
    build_all(_build)

    # ---- 3. kernels vs plain
    t_phase = time.perf_counter()
    print("[3] kernels vs plain PyTorch on the card")
    entries = {"wkv6": phase_wkv6(wkv6_ops, wkv6_ref),
               "wkv6_backward": phase_wkv6_backward(wkv6_ops, wkv6_backward_ref),
               "rglru_scan": phase_rglru(rglru_ops, rglru_scan_ref),
               "rglru_scan_backward": phase_rglru_backward(rglru_ops, rglru_scan_ref,
                                                           rglru_scan_backward_ref)}
    filter_errs = phase_filter_small(filter_ops, whitedata_filter_ref, dev)
    merge_errs = phase_merge_small(merge_ops, crdt_merge_ref, dev)
    join = phase_join(merge_ops, crdt_merge_ref, crdt_merge_rows_ref, crdt_join_rows_ref, dev)
    entries["crdt_merge_rows"] = kernel_entry(
        "crdt_merge_rows", "src/repro_torch/csrc/crdt_merge.cu",
        "src/repro/kernels/crdt_merge/crdt_merge.py:24", join["errs"], join["ranked"],
        library_ms=join["ranked"]["library_ms"], tpcc_commit=join["tpcc_ranked"])
    entries["crdt_join_rows"] = kernel_entry(
        "crdt_join_rows", "src/repro_torch/csrc/crdt_merge.cu",
        "src/repro/kernels/crdt_merge/crdt_merge.py:24", join["errs"], join["join"],
        library_ms=join["join"]["library_ms"], eager_call_ms=join["join"]["eager_call_ms"],
        replaced_ms=join["join"]["replaced_ms"],
        replaced_eager_call_ms=join["join"]["replaced_eager_call_ms"],
        tpcc_commit=join["tpcc_join"])
    counters = kernel_counters()

    print(f"  [3] took {time.perf_counter() - t_phase:.1f} s")

    tcfg = TrainConfig()
    t_phase = time.perf_counter()
    entries["wkv6"]["launches"] = run_rwkv6(dev, tcfg, counters)["wkv6"]
    torch.cuda.empty_cache()
    print(f"  released the {RWKV} weights: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          f"still allocated; [4-5] took {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    entries["rglru_scan"]["launches"] = run_recurrentgemma(dev, tcfg, counters)["rglru_scan"]
    torch.cuda.empty_cache()
    print(f"  released the {RG} weights: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          f"still allocated; [6-8] took {time.perf_counter() - t_phase:.1f} s")

    # ---- 9. the white-data filter over a gradient tree
    t_phase = time.perf_counter()
    filt = run_filter(filter_ops, whitedata_filter_ref, counters, gradient_shapes(), dev)
    print(f"[9] took {time.perf_counter() - t_phase:.1f} s")
    entries["whitedata_filter"] = kernel_entry(
        "whitedata_filter", "src/repro_torch/csrc/whitedata_filter.cu",
        "src/repro/kernels/whitedata_filter/whitedata_filter.py:24", filter_errs,
        filt["timings"]["f32"], bf16_g=filt["timings"]["bf16 g"])
    entries["whitedata_filter"]["launches"] = filt["launches"]["whitedata_filter"]

    # ---- 10. the CRDT merge over three replicas of a YCSB table
    t_phase = time.perf_counter()
    merge = run_merge(merge_ops, crdt_merge_ref, counters, dev)
    print(f"[10] took {time.perf_counter() - t_phase:.1f} s")
    entries["crdt_merge"] = kernel_entry(
        "crdt_merge", "src/repro_torch/csrc/crdt_merge.cu",
        "src/repro/kernels/crdt_merge/crdt_merge.py:24", merge_errs, merge["main"],
        library_ms=merge["main"]["plain_ms"], commit_size=join["dense"])
    entries["crdt_merge"]["launches"] = merge["launches"]["crdt_merge"]
    entries["crdt_merge_rows"]["launches"] = merge["ranked_launches"]

    # ---- 11-14. the global-attention decoders: minitron-8b, then granite-moe-3b-a800m
    # (phase 14's prefill counted once more for phase 31)
    card_steps = {}
    for arch, run in ((DENSE, run_minitron), (MOE, run_granite)):
        t_phase = time.perf_counter()
        res = run(dev, tcfg, counters)
        if arch == MOE:
            card_steps["prefill"] = res["counted"]
        torch.cuda.empty_cache()
        print(f"  released the {arch} weights: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
              f"still allocated; {time.perf_counter() - t_phase:.1f} s")

    # ---- 15-17. training at full width through train(), each on an emptied card
    for tag, arch, layers, (b, s_len), kernels in (
            ("[15]", RWKV, 8, (2, 4096), ("wkv6", "wkv6_backward")),
            ("[16]", RG, 3, (1, 4096), ("rglru_scan", "rglru_scan_backward")),
            ("[17]", MOE, 16, (1, 4096), None)):
        t_phase = time.perf_counter()
        res = run_training(tag, *cut_config(arch, layers), b, s_len, dev, counters, kernels,
                           count=tag == "[15]")
        if tag == "[15]":
            card_steps["train"] = res["counted"]
        if kernels is not None:
            for name in kernels:
                entries[name]["train_launches"] = res["launches"][name]
                entries[name]["train_step_ms"] = res["kernel_ms"].get(name)
            entries[kernels[1]]["launches"] = res["launches"][kernels[1]]
        torch.cuda.empty_cache()
        print(f"  {tag} took {time.perf_counter() - t_phase:.1f} s; "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated")

    # ---- 18. demo-100m: the loss falls; a resumed run matches
    t_phase = time.perf_counter()
    run_demo(dev, counters)
    print(f"  [18] took {time.perf_counter() - t_phase:.1f} s")

    # ---- 19. rwkv6-7b across two pods on the emptied card (its ranks also
    # compute phase 21's yardstick on the same mesh, kept in inpod_dir)
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    inpod_dir = tempfile.TemporaryDirectory(prefix="inpod-")
    flat_bytes, inpod_ref = run_pods(inpod_dir.name)
    print(f"  [19] took {time.perf_counter() - t_phase:.1f} s")

    # ---- 20. geococo's chunked top-k over phase 9's gradient share
    t_phase = time.perf_counter()
    run_topk(gradient_shapes(), dev, filt["timings"]["f32"]["ms"])
    print(f"  [20] took {time.perf_counter() - t_phase:.1f} s")

    # ---- 21. rwkv6-7b on a (2, 2, 1) mesh on the emptied card
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    run_inpod(flat_bytes, inpod_ref, inpod_dir.name)
    inpod_dir.cleanup()
    print(f"  [21] took {time.perf_counter() - t_phase:.1f} s")

    # ---- 22. granite-moe-3b-a800m, heads and experts split over model, on the emptied card
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    tp_history = run_tp()
    print(f"  [22] took {time.perf_counter() - t_phase:.1f} s")

    # ---- 23. the trainer on four pods of the emptied card
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    run_trainer()
    print(f"  [23] took {time.perf_counter() - t_phase:.1f} s")

    # ---- 24-26. MLA, cross-attention and the frames frontend, each on the emptied card
    for tag, run in (("[24]", run_deepseek), ("[25]", run_vision), ("[26]", run_hubert)):
        torch.cuda.empty_cache()
        t_phase = time.perf_counter()
        run(dev, tcfg, counters)
        torch.cuda.empty_cache()
        print(f"  {tag} took {time.perf_counter() - t_phase:.1f} s; "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated")

    # ---- 27-29. training deepseek-v3's dense prefix, hubert-xlarge and
    # llama-3.2-vision's cross block, each on the emptied card
    run_new_training(dev, counters)

    # ---- 30. serving on a (1, 2, 2) mesh of the emptied card
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    mesh_counts = run_serve_mesh(dev)
    print(f"  [30] took {time.perf_counter() - t_phase:.1f} s")

    # ---- 31. the dry-run against the card (nothing allocated on it)
    t_phase = time.perf_counter()
    run_dryrun_check(card_steps, tp_history, mesh_counts)
    print(f"  [31] took {time.perf_counter() - t_phase:.1f} s")

    # ---- 32. the WAN sync plane: a 10M-record YCSB store on the emptied card
    torch.cuda.empty_cache()
    wan = run_wan(dev, counters)
    entries["crdt_join_rows"]["wan_kernel_ms"] = wan["kernel_ms"]
    entries["crdt_join_rows"]["wan_bound_ms"] = wan["kernel_bound_ms"]

    # ---- 33. TPC-C: the benchmark's regime card against CPU, then 10^7 loaded rows
    torch.cuda.empty_cache()
    tpcc = run_tpcc(dev, counters)
    entries["crdt_join_rows"]["tpcc_kernel_ms"] = tpcc["kernel_ms"]
    entries["crdt_join_rows"]["tpcc_bound_ms"] = tpcc["kernel_bound_ms"]

    # ---- 34. the streaming engine and per-node views, on the emptied card
    torch.cuda.empty_cache()
    stream = run_stream(dev, counters, wan)
    entries["crdt_join_rows"]["launches"] = (wan["launches"] + tpcc["launches"]
                                              + stream["launches"])
    entries["crdt_join_rows"]["view_joins"] = stream["view_joins"]
    entries["crdt_join_rows"]["view_kernel_ms"] = stream["view_kernel_ms"]
    entries["crdt_join_rows"]["view_bound_ms"] = stream["view_bound_ms"]

    # ---- 35. WAN compression, the serving plane and the Raft plane, on the emptied card
    torch.cuda.empty_cache()
    planes = run_planes(dev, counters, wan)
    entries["crdt_join_rows"]["launches"] += planes["launches"]

    # ---- 36. the static-analysis package: the model checker on the card's tables,
    # verified schedules at scale, the mutators rejected; on the emptied card
    torch.cuda.empty_cache()
    analysis = run_analysis(dev, counters, wan)
    entries["crdt_join_rows"]["launches"] += analysis["launches"]

    leaked = sorted(m for m in sys.modules if m == "jax" or m.split(".")[0] == "repro")
    if leaked:
        fail(f"the port imported {leaked}")
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.0f} s on "
          f"{smi.splitlines()[0]}")
    print(json.dumps({"kernels": list(entries.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
