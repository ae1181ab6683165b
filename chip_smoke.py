"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. the card's name and power limit (nvidia-smi), and the kernel build
   from the sources in this checkout (``src/repro_torch/kernels``);
2. every kernel of the main paths against its plain PyTorch version, on
   the card, at the shapes the gateway gives it, with its time (CUDA
   events), the plain version's time, the time of one PyTorch library
   call computing the same function where there is one, and its bound
   on this card (``paged_attention`` at three decode shapes: contexts
   1-600, the serving stream's 9-96 and 8 x 4096 tokens, each back to
   back, in a CUDA graph and, the last, L2-cold; ``paged_decode_write``
   back to back and in a graph; the last three back to back also as the
   extension call alone, without the wrapper's Python); ``masked_dequant``
   bit for bit on two weight slices of a unit (back to back, in a graph,
   L2-cold) and on a whole stacked (36, 2048, 11008) leaf, as one launch
   and as the per-slice loop with a stack; ``delta_apply_inplace`` (the
   ``delta_apply_parts`` kernel with one rows segment) also in a graph
   beside ``index_put_``, and at a real stage step's shape in phase 5;
   then the prefill
   attention and int8 MLP product
   (``flash_attention`` and ``ops.quant_matmul``, which no serving path
   calls) driven through their entry points at qwen2.5-3b's shapes, with
   the launch counters zeroed just before and read just after, and the
   same checks and times;
3. the serving path: ``LicensedGateway`` serving requests in two license
   tiers at the full width and depth of qwen2.5-3b (random bf16 weights
   from a seed), through float views and through int8 views built by the
   fused masked-dequant, each decode step and each prefill chunk a CUDA
   graph replay or capture (the gateway's default on the card; every
   run prints its prefill captures, replays, the chunk p50 of the
   ``step_prefill_s`` histogram and the KV pool's bytes); the launch
   counters are zeroed just before and
   read just after, and every kernel must have run; each view build is
   timed (host clock and CUDA events, masked_dequant launches, peak
   memory); then the whole int8 view of the free and full tiers rebuilt
   from the store and held bit for bit against the plain version, and
   ``quant_matmul`` on a real leaf of the int8 store (unit 0's
   ``ffn/w_up``) against x @ its masked-dequant.  Every gateway of the
   script is the default one (prefix cache and telemetry on) unless a
   phase says otherwise.  The float stream runs three times: with
   ``telemetry=False``, with telemetry (the run phase 4 reads), and
   without again; the greedy tokens must be identical, and tokens/s, ms
   per step and telemetry's overhead are printed (not gated).  The
   telemetry run's Chrome trace must pass ``validate_chrome_trace`` and
   its ``metrics()`` ``validate_gateway_metrics``; the six latency
   histograms (p50 / p99 / count) and counters read back from the
   Prometheus page are printed.  Then 8 decode steps of the same stream
   run under ``torch.profiler`` (CPU and CUDA): the device-busy share of
   the window (the union of kernel, copy and set intervals), kernel
   launches per step (on the device, and the host's launch calls) and
   the five kernels with the most device time;
3c. the compiled decode and prefill steps and the in-scan int8
   dequant: phase 3's stream through float views and through the int8
   store dequantized inside every step (``quantized=True``), each served
   three times in turns, eager (the slot's decode and prefill graphs
   taken away), then twice through the CUDA graphs, the launch counters zeroed
   just before each run and read just after: ``paged_attention`` and
   ``paged_decode_write`` once a layer of every eager decode step or
   decode capture warm-up, and on the in-scan path ``masked_dequant``
   once per int8 leaf of every unit of those and of every eager prefill
   chunk or prefill capture warm-up (the warm-up is the chunk: every
   other chunk must be a replay).  Every run's greedy tokens must equal
   phase 3's (float), or phase 3's through materialized int8 views
   (in-scan); ms per step, tokens/s, captures, replays, the chunk p50
   and the graphs' pool memory are printed.  The first and the last run
   of each mode (eager, graph) profile 8 decode steps as in phase 3; then the
   in-scan third run's gateway serves the stream again (prefix cache
   emptied) and profiles its first 8 steps, whose device trace must
   hold each prefill chunk's ``masked_dequant`` launches and each decode
   step's kernels;
3d. long prompts through the compiled chunked prefill (full tier, float
   views): (a) 4 prompts of 1,024 tokens, 8 new tokens each, in one
   micro-batch, two waves, served with eager prefill and through the
   prefill graphs; greedy tokens must be identical or part at near-ties
   (phase 4's rule), the graphs may capture at most 7 widths x 1 lane
   bucket and nothing in the second wave; (b) 2 prompts of 4,096 tokens
   through the graphs only, at most 9 captures.  Each prints TTFT p50,
   the chunk p50 (every step synchronized), captures and their time,
   replays, and the KV and graph pools' bytes;
3b. the shared-prefix stream (a 48-token system prefix, own suffixes of
   1-16 tokens, exact repeats; two waves) at full width and depth, launch
   counters zeroed just before and read just after: (a) with the prefix
   cache, (b) without it, (c) with it on a 12-block pool, (d) with it
   through int8 views.  (a) must reuse prefix tokens, copy shared tails
   and prefill fewer lane-tokens than (b); (c) must evict retained chains
   and preempt; every request must finish; no decode write may target a
   shared block; after each drain the allocator holds only the tree's
   references; and the greedy tokens of (a) and (c) must equal (b)'s or
   part at a near-tie by phase 4's rule.  (a) and (c) run sanitized
   (``sanitize=True``: shadow refcounts on every allocator call,
   ``check_decode_writes`` before each decode write, ``check_drained`` at
   each drain), and the shadow must equal the allocator's refcounts;
   each run prints its prefill captures, replays and chunk p50;
4. one decode step's logits through the kernels vs the plain path on the
   same pool state; every lane whose argmax differs must be a near-tie
   (the plain path's gap between the two tokens below the step's max
   |logit diff|); then the greedy-token agreement of a whole plain-path
   run with phase 3's float stream, and for each request the first step
   at which its tokens part, read from both streams' own logits rows at
   that step: the plain path's gap between the two tokens must lie below
   the lane's max |logit diff|, and that diff within the decode step's
   tolerance;
5. the update path (paper §3.1.2, §4.3), launch counters zeroed just
   before: a ``LicenseServer`` over an in-memory ``WeightStore`` gets v1
   (phase 3's weights) and a ``free`` tier; a float gateway boots
   ``from_server`` at full width and depth (the boot pull through the
   ``delta_apply`` kernel, checked bit for bit against v1) and takes
   phase 3's request stream; v2 (units 32-35 changed: norms and q/k/v
   biases as rows, 1% of each block matrix as chunk pages) is published
   and staged mid-stream (``begin_sync`` then ``run``).  The in-flight
   requests must stay on v1 with phase 3's tokens, exactly one flip must
   happen, the flipped weights must equal v2 bit for bit, and a request
   after the flip must be served on v2 through a prewarmed view.  The
   audit must hold one ``sync_begin`` and one ``version_flip``, the trace
   one ``stager:<phase>`` span per stager step; their ``h_stager`` p50 /
   p99 / max (host clock, no synchronize) print beside the script's
   synchronized longest step.  The third step carrying a stage step runs
   under ``torch.profiler`` as in phase 3, its stager step in a range of
   its own whose device records must hold one ``delta_apply_parts``
   kernel and no pageable host-to-device copy.  Every stage step carrying
   parts must make exactly one ``delta_apply_parts`` launch (the
   staged sync's one apply a step: rows and chunk pages packed into a
   pinned ``StepRing`` slot, one upload) and no ``to_tensor``; the stage
   steps' host span is split into its parts (host-clock laps:
   ``StageProbe``) and printed with the launches, the steps with parts
   and the ring's pinned bytes.  After the sync the kernel runs again at
   the shape of one of those stage steps (its rows parts and pages, on
   clones of its layers; ``step_case``): bit for bit the plain version,
   back to back beside the per-page route it replaced, alone in a CUDA
   graph against its bound, and the pinned upload alone; this case joins
   phase 2's ``delta_apply_inplace`` row.  This gateway boots through
   a kill-switch transport (every wire call times out while it is
   down) on the host clock plus an offset the phase moves while the
   gateway is idle, with ``lease_policy="floor"``; its lease state is
   printed after the boot and after the flip, and after the sync the
   lease walks healthy -> degraded -> offline -> healthy: a new tier
   grant must be refused while degraded, a ``full`` request made offline
   must be served as ``free`` with the tokens of a straight ``free``
   request of the same prompt, the audit must hold the three lease
   events, and ``degraded_seconds_total`` must be the offset span plus
   the host time between the two ticks;
6. the same sync on an int8 gateway with materialized views, at full
   width and a depth of 4 units (a second full-depth boot pull would
   cost the same host time again); its v2 int8 store must equal
   ``quantize_serving_params(v2)``, and its stage steps are checked,
   split and printed as phase 5's.  Both ``delta_apply`` forms must have
   been launched on phases 5-6 (the in-place one as ``delta_apply_parts``);
7. Algorithm 1 on phase 3's weights (re-created from the seed and
   checked): the quantile edges of every maskable magnitude (by a count
   of bf16 bit patterns on the card, checked against a sort on one
   leaf), ``calibrate_license`` to a top-1 agreement of 0.9 over 16
   teacher-forced 64-token prompts, the tier re-evaluated, its float view
   in a gateway held bit for bit against ``apply_license``, and the
   shared-prefix stream served in it with the prefix cache;
7b. the fleet on phase 3's weights: a ``FleetGateway`` with two slots,
   float views and the in-scan int8 dequant, each serving phase 3's
   stream.  Each fleet run has its own launch window (counters zeroed
   just before its first submission, read just after its drain): every
   slot's decode steps must all be graph replays, its prefill chunks
   replays or captures, and the wrappers' counts must be what the slots'
   decode and prefill capture warm-ups give, each of
   ``paged_attention``, ``paged_decode_write`` and ``masked_dequant``
   above 0.  (a) without a budget, each slot's greedy
   tokens must equal phase 3's float stream and phase 3c's in-scan
   stream; then both slots are brought to a steady decode and 8 fleet
   steps profiled, whose device trace must show each slot's decode
   kernels (as in phase 3); the same streams then run on two isolated
   gateways back to back, timed and instrumented as run (a) is (their
   launches kept apart; tokens/s of both and their ratio printed, one
   run against one).  (b) under a cache budget of 40 blocks, each slot's
   stream in two waves, the bytes in use must stay within the budget
   after every fleet step, retained chains of one slot must be evicted
   for the other, every request must finish, tokens may part from (a)
   only at near-ties (phase 4's rule), and three tenants (a rate limit,
   an entitlement revoked while two requests queue, a zero quota) must
   end with the expected counts and nothing in flight.  Captures,
   graph pools, evictions, preemptions and the fleet's ``metrics()``
   are printed;
8. the offline lifecycle (paper Fig. 3): (a) ``examples/quickstart.py``
   step for step at the paper's size (``TABLE1_A``): ``train_mlp`` 600
   steps (accuracy at least 0.95), ``compress_pipeline`` at 0.8,
   ``finetune_pruned_mlp`` 200 steps (every pruned zero still 0), both
   through their SGD step's CUDA graph (one each) and again eager on the
   same data (accuracies and the largest parameter difference printed),
   publish, ``calibrate_license`` to 0.70, a full and a free
   ``EdgeClient`` pull (free accuracy below paid) and a 25-weight delta
   update (25 entries), the launch counters zeroed just before the pulls
   and read just after (``delta_apply`` must have run; its count joins
   the ``kernels`` line); (b) ``compress_pipeline`` on phase 3's weights
   (seconds per pass, peak memory above the weights, every pruned leaf's
   non-zero count recounted against its threshold, the stacked q
   projection pruned and quantized again on the CPU and held bit for
   bit) and ``weight_share`` on one 2048 x 11008 slice (indices below k,
   MSE below the linear init's); (c) ``train_loop`` on phase 3's weights
   at full depth, one 2 x 256-token batch repeated for 4 steps, eager
   and then through its CUDA graph (ms per step, tokens/s, peak memory,
   the graph's captures, replays and pool bytes; losses and grad norms
   bit for bit, or else the first differing step printed and every value
   within 1e-3 relative; finite, the last loss below the first, the
   first within 1e-3 of ``lm_loss``), then 2 steps through the graph at
   2 units checkpointed into an in-memory ``WeightStore`` at
   step 2 (seconds and rows per commit; the history must hold "step 2":
   a commit of the 2-unit model takes about a minute of host time, so
   one commit, not one a step); then internvl2-26b at full width cut to
   4 of its 48 units (``VLM_TRAIN``), random weights from the seed, 2
   rows of 256 patch embeddings (numpy, from the seed) and 256 tokens
   through ``train_loop``, 2 steps eager and 2 through its CUDA graph:
   losses and grad norms bit for bit (or within 1e-3 relative), finite,
   the first loss within 1e-3 of ``lm_loss(..., patch_embeds=)``;
9. the dense family beyond qwen at full width (random bf16 weights from
   the seed, the first 8 requests of phase 3's stream, decode and prefill
   graphs on), each gateway's launch counters zeroed just before its
   stream and read just after, every run's tokens/s, ms per step, peak
   memory, captures and replays printed, then the stream submitted again
   and 8 steady decode steps timed (graph replays on every route,
   synchronized on each side): (a)
   nemotron-4-15b (squared ReLU) at 4 of its 32 layers on float views
   through the kernels and through the plain route (tokens equal,
   parting only at near-ties by phase 4's rule), then from its int8 store
   (``quantize_serving_params``, one unit at a time) with the in-scan
   dequant (24 ``masked_dequant`` launches a step); (b) minitron-8b at 4
   of its 32 layers, both routes; (c) granite-34b
   (48 q heads on one kv head, ``paged_attention``'s instance for groups
   above 32) at 44 of its 88 layers from an int8 store built unit by unit
   on the card, both routes (308 launches a step); (d) the gateway's fallbacks
   at qwen2.5-3b on phase 3's weights, every step a graph replay or
   capture (the gather/scatter decode, the bucket prefill and its
   prefix-hit suffix prefill): phase 3's stream with
   ``kernel_decode=False`` (tokens equal phase 3's up to near-ties), with
   ``chunk_size=0`` and the cache off, and with ``paged=False`` (whose
   bucket prefill pads prompts on the left: tokens equal the paged bucket
   run's up to near-ties), each then timed in a steady decode window in
   turns, graph and eager on the same gateway (``steady_turns``), and
   served again on a gateway with its compiled steps taken away, whose
   greedy tokens must be identical; phase 3b's stream with
   ``chunk_size=0`` with the prefix cache on and off (equal up to
   near-ties, hits with it on; each also served eagerly, tokens
   identical), and a fleet with a contiguous slot beside a paged one
   (each slot's tokens equal its isolated run's, every family
   replayed); each run prints its families' captures, replays and the
   graphs' pool bytes.  Phase 2 also runs
   ``paged_attention`` at granite's decode shape (48/1 heads, contexts
   9-96 and 8 x 4096) back to back, in a graph and L2-cold;
10. DeepSeek MoE and MLA at full width, 14 of their 28 and 27 layers
   (``MOE_UNITS``), as phase 9 runs its
   models (random bf16 weights, phase 9's requests and tiers, each run's
   counters zeroed just before its stream and read just after, a steady
   decode step, peak memory, captures, replays and the KV pool's block
   bytes printed): (a) deepseek-moe-16b (MHA 16/16 heads, 64 experts
   top-6 + 2 shared) on float views through the kernels (graph replays)
   and through the plain route (graph replays too), tokens equal up to
   near-ties;
   (b) deepseek-moe-16b in-scan from an int8 store built unit by unit
   (10 ``masked_dequant`` launches a unit a step: 140); (c)
   deepseek-v2-lite-16b (MLA) on float views on the default route, whose
   graphs launch no paged kernel (MLA's paged decode is plain PyTorch,
   as the JAX package has it); (d) deepseek-v2-lite-16b in-scan (140 a
   step); (e) deepseek-v2-lite-16b under long_500k's 4,096-token sliding
   window on the same weights, drop-free (a capacity factor of experts /
   top-k, so a row's length changes no route), through the slot's own
   route (bucket prefill, gather/scatter decode on the contiguous pool
   of 4,096-slot latent rings, each step a graph replay or capture): a
   4,160-token prompt in tier full and a 1,024-token one in tier free,
   both in the 4,160-token bucket (longer than the ring), 64 greedy
   tokens each, every step synchronized and timed; then the same
   gateway's steady decode step in turns, graph and eager; then its
   graphs dropped and the two requests served eagerly with every router
   call recorded (tokens identical to the graph run's); the ring's leaves must hold
   4,096 slots (66.1 MB a lane at 14 layers), and the tokens must equal the argmax of
   a cacheless windowed ``forward`` over each whole sequence,
   teacher-forced, up to near-ties (the gap below the row's max |logit
   diff|), and with every layer's expert picks pinned to the gateway's
   every row within phase 4's tolerance (the bucket prefill's seconds,
   synchronized graph and eager decode steps and peak memory printed).  Phase
   10 must launch ``paged_attention``,
   ``paged_decode_write`` and ``masked_dequant``.  Phase 2 also runs
   ``paged_attention`` at deepseek-moe-16b's decode shape (16/16 heads,
   a GQA group of 1; contexts 9-96 and 8 x 4096) back to back, in a graph
   and L2-cold;
11. the recurrent family at full width and depth, as phase 9 runs its
   models (random bf16 weights, phase 9's requests and tiers, each run's
   counters zeroed just before its stream and read just after, a steady
   decode step and peak memory printed; every run of (a)-(d) but the
   materialized views and the f32 witness also served again on the eager
   route on the same gateway, tokens identical, and its steady decode
   step timed in turns, graph and eager, every compiled family captured
   and replayed): (a) recurrentgemma-2b (8 units
   of (rec, rec, attn) + 2 tail RG-LRU layers, MQA under a 2,048-token
   window) on float views with ``kernel_decode=True`` asked for: the
   gateway must choose the paged pool, the bucket prefill (chunk_size 0),
   no prefix cache and the gather/scatter decode (CUDA graphs, as the
   bucket prefill), and launch no paged kernel; (b) the same from an
   int8 store built unit by unit, in-scan (200 ``masked_dequant``
   launches a step: 23 leaves a unit, 8 a tail block, through the
   wrappers' warm-ups and in the device trace of 4 graph-replayed decode
   steps) and on materialized int8 views, and ``masked_dequant`` on the
   store's rank-2 tail leaf ``tail/t0/mixer/w_r`` bit for bit against the
   plain version, timed (its row joins the ``kernels`` line's cases);
   (c) recurrentgemma-2b past its window: two prompts of 2,500 and 3,000
   tokens in a 3,072-token bucket, 16 new tokens each, on the contiguous
   pool (nothing to page at that capacity) whose rings wrap; (d)
   mamba2-130m (24 Mamba-2 layers) on the contiguous pool, float, in f32
   and in-scan (48 launches a step, in the trace too); in (a), (c) and
   (d) the first 4 greedy tokens of every request are held against a cacheless
   ``forward`` over the sequence so far (the bucket's left padding
   included), parting only at near-ties by phase 4's rule, and in f32
   every row within 1e-3 x max(|logit|, 1) of it; (e) a fleet of qwen2.5-3b,
   mamba2-130m and recurrentgemma-2b: every request served, qwen's
   ``paged_attention`` launched, the recurrent slots' tokens equal their
   isolated runs' up to near-ties, every slot's decode steps graph
   replays;
12. LayerNorm, the front-end stubs and int8 KV caches at full width and
   24 of their 48 layers (``FRONTEND_UNITS``), as phase 9 runs its
   models: (a) musicgen-large (MHA 32/32 at head dim 64 with LayerNorm,
   codec vocabulary 2,048) on
   float views through the kernels (graph replays) and the plain route
   (eager), tokens equal up to near-ties, each steady step beside its
   weight-read bound; (b) musicgen-large in-scan from its int8 store (7
   ``masked_dequant`` launches a unit a step: 168); (c) musicgen-large
   with ``kv_cache_int8``: the paged pool of int8 codes and f32 scales
   (69,632 bytes a layer-block), the kernel-resident step and its graphs
   over the plain gather, no paged kernel launched, tokens equal (a)'s
   plain route's up to near-ties; (d) internvl2-26b (GQA 48/8) on float
   views of the ``full`` tier alone (a float ``free`` view
   beside it would not fit), kernel route, then one full-width
   ``prefill_step`` of 256 vision patches and 64 text tokens eager (time,
   peak memory, finite logits) and through ``serving.compiled.MeshGraphs``
   on plain tensors (the capture, then two timed replays, logits bit for
   bit the eager step's; captures, replays and pool bytes); (e) internvl2-26b in-scan in both tiers from
   an int8 store built unit by unit, ``vision_proj`` float beside it
   (168 launches a step).  Phase 12 must launch ``paged_attention``,
   ``paged_decode_write`` and ``masked_dequant``.  Phase 2 also runs
   ``paged_attention`` at both models' decode shapes (32/32 heads at
   head dim 64, 48/8 at 128; 8 x 4096 tokens) back to back, in a graph
   and L2-cold;
13. the batch engine, host sampling and the launch tools on phase 3's
   weights (qwen2.5-3b at full width and depth, tiers full, pro and
   free): (a) ``ServingEngine`` on float views, 6 requests (prompts of
   64-256 tokens, 16 new, greedy) through its CUDA graphs (the first run
   captures them), then in turns eager, graph, graph on the same
   engine, each decode step timed with a synchronize on each side, greedy
   tokens identical in every run, captures, replays and pool bytes
   printed; its tokens held against the same requests
   through ``engine.gateway(record_logits=True)`` on the kernel route,
   parting only at near-ties by phase 4's rule from the rows both
   computed; (b) the same with ``quantized=True`` (252 ``masked_dequant``
   launches every eager step, and a replayed prefill or decode step in
   the device trace of one more graph run) against the gateway's in-scan
   route; (c) phase
   3's stream with greedy lanes and lanes at temperature 0.8 (top_k 0, 5
   and 50) through the kernel route with ``fuse_sampling`` True and
   False (three waves, the last timed: the second still captures
   graphs), fused with its rows kept and with ``record_logits`` (one wave
   each): tokens identical in all four, the recorded rows equal to the
   fused rows bit for bit, ms a step both ways, and the median epilogue
   and batched device draw of the timed wave; (d)
   ``launch.roofline``'s decode bound at (a)'s largest group beside its
   graph and eager steps and phase 3's graph step, and ``launch.dryrun``'s weight and
   cache bytes beside what ``init_params`` and ``init_cache`` allocate
   (within 1%).  Phase 13 must launch ``paged_attention``,
   ``paged_decode_write`` and ``masked_dequant``;
14. the host mesh: ``launch.mesh.make_host_mesh()`` over the card (NCCL,
   a world of one rank, a (1, 1) mesh named ("data", "model")), phase 3's
   weights (re-created from the seed) placed by
   ``distribution.sharding.params_shardings`` as DTensors, and phase 3's
   first 8 prompts right-aligned into one ``prefill_step`` and 16 greedy
   ``serve_step``s on a contiguous cache placed by ``cache_shardings``,
   under ``implicit_replication``: (a) float weights, (b) the int8 store
   in-scan in tier free, ``masked_dequant`` launched through
   ``local_map`` (252 a step, as many as the plain in-scan steps launch).
   Each run is held to the same steps on plain tensors: greedy tokens
   identical; logits bit for bit, or, where they differ, the first
   differing step, the ops whose counts differ between the two decode
   steps and phase 4's tolerance.  The synchronized decode step on the
   mesh and plain (the host's cost of DTensor dispatch), the prefill,
   the collectives of a prefill and a decode step on the one-rank world
   and the peak memory are printed.  The same steps then run through
   ``serving.compiled.MeshGraphs`` on the mesh (CUDA graphs of the
   DTensor steps: one prefill graph, one decode graph a set, the float
   tree's and the int8 store's), in turns with the eager mesh steps
   (eager, graph, graph, eager; the last eager turn MESH_AFTER steps):
   tokens identical and logits bit for bit the eager mesh steps', the medians of the three printed beside each
   other with the captures, replays and pool bytes; the device trace of
   a replayed in-scan prefill and 3 decode steps must show 252
   ``masked_dequant`` launches a step.  Before it, one functional
   ``all_reduce`` and its ``wait`` on the NCCL group are captured after
   an eager warm-up and replayed three times on new values.  (c) The
   sharded training step the JAX dry run compiles: ``make_train_step``
   with ``grad_accum`` 4 and AdamW, 2 steps of 4 x 256 tokens from phase
   3's weights, first on plain tensors, then, that run freed, on the
   mesh (params by ``params_shardings``, the moments by
   ``opt_state_shardings``, the batches by ``data_shardings``): losses,
   grad norms and the bit sums of every updated param and moment bit for
   bit the plain steps' (else the losses and grad norms within 1e-3
   relative), placements unmoved, no collective on the one-rank world;
   both runs' ms a step and peak memory printed;
15. a ``kernels`` JSON line, and the result line last.

Imports nothing of JAX.  Exits non-zero without a result when no CUDA
device is present or when run outside a checkout of the repository.
"""
from __future__ import annotations

import contextlib
import gc
import json
import resource
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
ARCH = "qwen2.5-3b"
FREE_TIER = {"*": ((0.0, 0.01),)}



def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` in ms: CUDA events around ``iters``
    back-to-back calls, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_graph_ms(fn, iters: int = 20, reps: int = 5, warmup: int = 4) -> float:
    """Device time of ``fn`` in ms without the host's cost of launching it:
    ``iters`` calls captured in one CUDA graph, replayed ``reps`` times
    between CUDA events (a decode step would run captured, too)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def host_split_ms(wrapped, bare, reps: int = 5):
    """Back-to-back ms of a wrapper and of its extension call alone (pybind,
    device guard, launch; none of the wrapper's Python), ``reps`` rounds
    of ``time_ms`` alternating which goes first; the two medians."""
    import statistics

    got = ([], [])
    for r in range(reps):
        for i in ((0, 1) if r % 2 == 0 else (1, 0)):
            got[i].append(time_ms((wrapped, bare)[i]))
    return statistics.median(got[0]), statistics.median(got[1])


def rotating(fns):
    """One callable that runs ``fns`` in turn, one per call: timed, each
    call reads another copy of its operands, so copies whose sum exceeds
    the card's L2 are read from device memory."""
    turn = [0]

    def call():
        fns[turn[0] % len(fns)]()
        turn[0] += 1
    return call


def sync() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def bound_ms(nbytes: float, flops: float, peaks, rate: int = 1) -> tuple:
    """Least time for the work on this card: the larger of bytes over the
    memory rate and operations over the f32 rate (``rate=2``: the bf16
    tensor-core rate)."""
    t_bytes = nbytes / peaks[0] * 1e3
    t_ops = flops / peaks[rate] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# paged_attention at qwen2.5-3b's decode shape (16 q heads over 2 kv heads,
# head_dim 128) on 16-token blocks, bf16 in the cases below, held to 1e-5 of
# the plain version (both compute in f32 from the same values; only the
# order of the sums differs).  Beyond phase 2's ragged case (contexts
# 1-600): the serving stream's own contexts (prompts 9-64 plus up to 32 new
# tokens) and a decode after a 4096-token prefill on each of 8 lanes, also
# timed L2-cold over PA_COLD_COPIES copies of its 33.6 MB of K/V
PA_SHAPE = (16, 2, 128, 16)           # q heads, kv heads, head_dim, block size
PA_TOL = 1e-5
PA_CASES = {"serving": [9, 23, 40, 57, 64, 75, 88, 96], "long": [4096] * 8}
PA_COLD_COPIES = 4
# granite-34b's decode shape (phase 9c): 48 q heads on ONE kv head (a GQA
# group of 48, the kernel's instance for groups above 32), the same
# contexts; the group-8 cases above stay
PA_GRANITE = (48, 1, 128, 16)
PA_GRANITE_CASES = {"granite_serving": PA_CASES["serving"], "granite_long": PA_CASES["long"]}
# deepseek-moe-16b's decode shape (phase 10): MHA, 16 q heads on 16 kv heads
# (a GQA group of 1), the same contexts
PA_MHA = (16, 16, 128, 16)
PA_MHA_CASES = {"mha_serving": PA_CASES["serving"], "mha_long": PA_CASES["long"]}
# phase 12's decode shapes at 8 x 4096 tokens: musicgen-large's MHA (32
# q heads on 32 kv heads at head dim 64: a group of 1, 268 MB of K/V) and
# internvl2-26b's GQA (48 on 8 at head dim 128: a group of 6)
PA_FRONTEND_CASES = {"musicgen_long": ((32, 32, 64, 16), PA_CASES["long"]),
                     "internvl_long": ((48, 8, 128, 16), PA_CASES["long"])}


def paged_bound(peaks, q, lens, shape=PA_SHAPE):
    """Bound of one ``paged_attention`` call: q, every live K/V row of its
    kv heads, the table, the lengths and the f32 output once; q.k and p.v
    over the live keys at the rate of the inputs' type (bf16 on the
    tensor cores, f32 on the CUDA cores)."""
    h, kh, hd, bs = shape
    b, elt, live = q.shape[0], q.element_size(), int(lens.sum())
    t_cols = -(-int(lens.max()) // bs)
    nbytes = (q.numel() * elt + 2 * live * kh * hd * elt + b * t_cols * 4 + b * 4
              + q.numel() * 4)
    return bound_ms(nbytes, 4 * live * h * hd, peaks, rate=1 if elt == 4 else 2)


def paged_plan(kernels_pa, t_cols, b, torch, shape=PA_SHAPE, elt=2):
    """The (splits, columns per split) the wrapper launches at this shape."""
    h, kh, hd, bs = shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return list(kernels_pa.split_plan(t_cols, bs, b, kh, sms, groups=h // kh, head_dim=hd,
                                      elt=elt))


def paged_case(torch, kernels_pa, ref, peaks, gen, lens, cold=False, shape=PA_SHAPE):
    """One bf16 decode step at contexts ``lens`` and ``shape`` (q heads, kv
    heads, head_dim, block size): error against the plain version, times
    back to back (the wrapper and the extension call alone), in a CUDA graph
    and (``cold``) L2-cold in a graph, bound and split plan.  Dead table
    entries name the null block."""
    from repro_torch.kernels.build import load_extension

    dev = torch.device("cuda")
    h, kh, hd, bs = shape
    b, t_cols = len(lens), -(-max(lens) // bs)
    p = b * t_cols + 1
    tables = torch.randperm(p - 1, generator=gen)[: b * t_cols].reshape(b, t_cols)
    for i, n in enumerate(lens):
        tables[i, -(-n // bs):] = p - 1
    tables = tables.int().to(dev)
    ctx = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = torch.randn(b, h, hd, generator=gen).bfloat16().to(dev)
    kb = torch.randn(p, bs, kh, hd, generator=gen).bfloat16().to(dev)
    vb = torch.randn(p, bs, kh, hd, generator=gen).bfloat16().to(dev)

    def attend(k=kb, v=vb):
        return kernels_pa.paged_attention(q, k, v, tables, ctx)

    got = attend()
    want = ref.paged_attention(q, kb, vb, tables, ctx)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not torch.isfinite(got).all() or err > PA_TOL:
        fail(f"paged_attention at contexts {min(lens)}-{max(lens)} disagrees with its "
             f"plain version (max_abs_err {err:.3e})")
    del got, want
    bnd, by = paged_bound(peaks, q, ctx, shape)
    splits, cols = paged_plan(kernels_pa, t_cols, b, torch, shape)
    ws = torch.empty((splits, b, h, hd + 2) if splits > 1 else (0,), device=dev)
    ext = load_extension()
    ms, ms_ext = host_split_ms(attend, lambda: ext.paged_attention(q, kb, vb, tables, ctx,
                                                                   ws, cols))
    row = dict(heads=f"{h}/{kh}", lens=f"{min(lens)}-{max(lens)}", table_cols=t_cols,
               live_tokens=sum(lens),
               max_abs_err=err, ms=ms, ms_ext=ms_ext, ms_graph=time_graph_ms(attend),
               plain_ms=time_ms(lambda: ref.paged_attention(q, kb, vb, tables, ctx),
                                iters=10, warmup=2),
               bound_ms=bnd, bound_by=by, split_plan=[splits, cols])
    if cold:
        pools = [(kb, vb)] + [(kb.clone(), vb.clone()) for _ in range(PA_COLD_COPIES - 1)]
        row["ms_cold"] = time_graph_ms(rotating([lambda k=k, v=v: attend(k, v)
                                                 for k, v in pools]))
        row["cold_copies"] = PA_COLD_COPIES
        del pools
        torch.cuda.empty_cache()
    return row


# ------------------------------------------------------------ phase 2
def check_kernels(peaks, torch, ops, ref, kernels_pa, kernels_md):
    """Each kernel vs its plain version at the main path's shapes."""
    from repro_torch.kernels.build import load_extension

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    rows = {}

    # paged_attention: a decode step of 8 lanes, 16 heads over 2 kv heads,
    # head_dim 128, 16-token blocks, ragged contexts up to ~600 tokens
    h, kh, hd, bs = PA_SHAPE
    b = 8
    ctx = torch.tensor([1, 17, 100, 255, 311, 480, 555, 600], dtype=torch.int32)
    t_cols = int((ctx.max() + bs - 1) // bs)
    p = b * t_cols + 1
    tables = torch.randperm(p - 1, generator=gen)[: b * t_cols].reshape(b, t_cols)
    for i, n in enumerate(ctx.tolist()):           # dead entries -> null block
        tables[i, -(-n // bs):] = p - 1
    tables, lens = tables.int().to(dev), ctx.to(dev)
    errs = {}
    for dtype, tol in ((torch.float32, PA_TOL), (torch.bfloat16, PA_TOL)):
        # both versions compute in f32 from the same (upcast) inputs; only
        # the summation order differs, over <= 600 keys
        q = torch.randn(b, h, hd, generator=gen).to(dtype).to(dev)
        kb = torch.randn(p, bs, kh, hd, generator=gen).to(dtype).to(dev)
        vb = torch.randn(p, bs, kh, hd, generator=gen).to(dtype).to(dev)
        got = kernels_pa.paged_attention(q, kb, vb, tables, lens)
        want = ref.paged_attention(q, kb, vb, tables, lens)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        errs[str(dtype)] = err
        log(f"  paged_attention {dtype}: max_abs_err {err:.3e} (tol {tol:g})")
        if not torch.isfinite(got).all() or err > tol:
            fail(f"paged_attention {dtype} disagrees with its plain version")
    bnd, by = paged_bound(peaks, q, lens)

    def attend():
        return kernels_pa.paged_attention(q, kb, vb, tables, lens)

    cases = {"phase2": dict(
        heads=f"{h}/{kh}", lens="1-600", table_cols=t_cols, live_tokens=int(ctx.sum()),
        max_abs_err=max(errs.values()), ms=time_ms(attend), ms_graph=time_graph_ms(attend),
        plain_ms=time_ms(lambda: ref.paged_attention(q, kb, vb, tables, lens)),
        bound_ms=bnd, bound_by=by, split_plan=paged_plan(kernels_pa, t_cols, b, torch))}
    pa_gen = torch.Generator(device="cpu").manual_seed(SEED + 5)
    for name, case_lens in PA_CASES.items():
        cases[name] = paged_case(torch, kernels_pa, ref, peaks, pa_gen, case_lens,
                                 cold=name == "long")
    for name, case_lens in PA_GRANITE_CASES.items():
        cases[name] = paged_case(torch, kernels_pa, ref, peaks, pa_gen, case_lens,
                                 cold=name == "granite_long", shape=PA_GRANITE)
    for name, case_lens in PA_MHA_CASES.items():
        cases[name] = paged_case(torch, kernels_pa, ref, peaks, pa_gen, case_lens,
                                 cold=True, shape=PA_MHA)
    for name, (shape, case_lens) in PA_FRONTEND_CASES.items():
        cases[name] = paged_case(torch, kernels_pa, ref, peaks, pa_gen, case_lens,
                                 cold=True, shape=shape)
    for name, c in cases.items():
        cold = f", L2-cold {c['ms_cold']:.4f} ms" if "ms_cold" in c else ""
        alone = f" (extension call alone {c['ms_ext']:.4f})" if "ms_ext" in c else ""
        log(f"  paged_attention {name} bf16 [{c['heads']} heads, ctx {c['lens']}, "
            f"{c['table_cols']} table "
            f"columns, split plan {c['split_plan']}]: max_abs_err {c['max_abs_err']:.3e} "
            f"(tol {PA_TOL:g}), {c['ms']:.4f} ms back to back{alone}, {c['ms_graph']:.4f} ms in "
            f"a CUDA graph{cold}, plain {c['plain_ms']:.4f} ms, bound {c['bound_ms']:.4f} "
            f"ms ({c['bound_by']})")
    head = cases["phase2"]
    rows["paged_attention"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:91",
        max_abs_err=max(c["max_abs_err"] for c in cases.values()),
        ms=head["ms"], ms_graph=head["ms_graph"], plain_ms=head["plain_ms"],
        bound_ms=head["bound_ms"], bound_by=head["bound_by"], library_ms=None,
        headline="phase2 bf16", cases=cases)

    # paged_decode_write: one bf16 token per lane into the pool, 2 pad
    # lanes aimed at the null block
    pool_k = torch.randn(p, bs, kh, hd, generator=gen).bfloat16().to(dev)
    pool_v = torch.randn(p, bs, kh, hd, generator=gen).bfloat16().to(dev)
    nk = torch.randn(b, kh, hd, generator=gen).bfloat16().to(dev)
    nv = torch.randn(b, kh, hd, generator=gen).bfloat16().to(dev)
    ids = torch.cat([torch.randperm(p - 1, generator=gen)[: b - 2],
                     torch.tensor([p - 1, p - 1])]).int().to(dev)
    offs = torch.randint(0, bs, (b,), generator=gen).int().to(dev)
    k1, v1 = kernels_pa.paged_decode_write(pool_k.clone(), pool_v.clone(), nk, nv, ids, offs)
    k2, v2 = ref.paged_decode_write(pool_k.clone(), pool_v.clone(), nk, nv, ids, offs)
    torch.cuda.synchronize()
    err = max((k1[:-1].float() - k2[:-1].float()).abs().max().item(),
              (v1[:-1].float() - v2[:-1].float()).abs().max().item())
    log(f"  paged_decode_write bf16: max_abs_err {err:.3e} (exact; null block excluded)")
    if err != 0.0:
        fail("paged_decode_write disagrees with its plain version")
    nbytes = 2 * (2 * b * kh * hd * 2) + 2 * b * 4
    bnd, by = bound_ms(nbytes, 0, peaks)

    def write():
        return kernels_pa.paged_decode_write(pool_k, pool_v, nk, nv, ids, offs)

    ext = load_extension()
    ms, ms_ext = host_split_ms(write, lambda: ext.paged_decode_write(pool_k, pool_v, nk, nv,
                                                                     ids, offs))
    rows["paged_decode_write"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:160", max_abs_err=err,
        ms=ms, ms_ext=ms_ext, ms_graph=time_graph_ms(write),
        plain_ms=time_ms(lambda: ref.paged_decode_write(pool_k, pool_v, nk, nv, ids, offs)),
        bound_ms=bnd, bound_by=by, library_ms=None)
    row = rows["paged_decode_write"]
    log(f"  paged_decode_write: {row['ms']:.4f} ms back to back (median of 5; the extension "
        f"call alone {row['ms_ext']:.4f} ms), {row['ms_graph']:.4f} ms in a CUDA graph")

    rows["masked_dequant"] = check_masked_dequant(peaks, torch, ops, ref, kernels_md, gen)
    rows.update(check_delta_apply(peaks, torch, ref, dev, gen))
    for name, row in rows.items():
        log(f"  {name}: {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return rows


# masked_dequant at the shapes of a licensed view of qwen2.5-3b: the MLP
# weight slices of one unit both ways and the whole stacked ffn/w_up leaf,
# bf16 out, the free tier's interval plus an inert slot; every output held
# bit for bit against the plain version
MD_INTERVALS = [(0.0, 0.01), (0.3, 0.3)]
MD_SLICES = [(2048, 11008), (11008, 2048)]
MD_LEAF = (36, 2048, 11008)
MD_SOURCE = "src/repro_torch/kernels/csrc/masked_dequant.cu"


def md_bound(peaks, n, cols_scale, live, out_bytes=2):
    """Bytes: the codes, the scale and the 16 interval floats read once and
    the output written once; operations: a multiply, an abs and, per live
    interval, two compares and a select per element (f32 rate)."""
    return bound_ms(n + cols_scale * 4 + 16 * 4 + n * out_bytes, n * (2 + 3 * live), peaks)


def md_exact(got, want):
    """Same dtype and the same bit patterns (+0.0 and -0.0 differ)."""
    import torch

    bits = torch.int16 if got.element_size() == 2 else torch.int32
    return got.dtype == want.dtype and bool(torch.equal(got.view(bits), want.view(bits)))


def check_masked_dequant(peaks, torch, ops, ref, kernels_md, gen):
    """The slices and the leaf above: bit-exact against the plain version,
    times back to back, in a CUDA graph and (slices) L2-cold in a graph
    over COLD_COPIES copies of the codes; the leaf both as one launch and
    as the per-slice loop with a stack (a view build one 2-D slice per
    launch)."""
    dev = torch.device("cuda")
    lo, hi = ops.pack_intervals(MD_INTERVALS, device=dev)
    live = sum(1 for a, b in MD_INTERVALS if a < b)
    cases = {}

    def call(codes, scale):
        return kernels_md.masked_dequant(codes, scale, lo, hi, out_dtype=torch.bfloat16)

    for r_, c_ in MD_SLICES:
        codes = torch.randint(-127, 128, (r_, c_), generator=gen, dtype=torch.int8).to(dev)
        scale = (torch.rand(1, c_, generator=gen) * 4e-4 + 1e-5).to(dev)
        got = call(codes, scale)
        want = ref.masked_dequant(codes, scale, lo, hi, torch.bfloat16)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if not md_exact(got, want):
            fail(f"masked_dequant {r_}x{c_} disagrees with its plain version "
                 f"(max_abs_err {err:.3e})")
        masked = float((got == 0).float().mean())
        del got, want
        copies = [codes] + [codes.clone() for _ in range(COLD_COPIES - 1)]
        bnd, by = md_bound(peaks, r_ * c_, c_, live)
        cases[f"slice {r_}x{c_}"] = dict(
            max_abs_err=err, masked=masked, ms=time_ms(lambda: call(codes, scale)),
            ms_graph=time_graph_ms(lambda: call(codes, scale)),
            ms_cold=time_graph_ms(rotating([lambda c=c: call(c, scale) for c in copies])),
            plain_ms=time_ms(lambda: ref.masked_dequant(codes, scale, lo, hi, torch.bfloat16),
                             iters=10),
            bound_ms=bnd, bound_by=by)
        del copies, codes
        torch.cuda.empty_cache()

    u, r_, c_ = MD_LEAF
    codes = torch.randint(-127, 128, MD_LEAF, generator=gen, dtype=torch.int8).to(dev)
    scale = (torch.rand(u, 1, c_, generator=gen) * 4e-4 + 1e-5).to(dev)

    def per_slice():
        return torch.stack([call(codes[i], scale[i]) for i in range(u)])

    want = ref.masked_dequant(codes, scale, lo, hi, torch.bfloat16)
    forms = {"per_slice_stack": per_slice, "one_launch": lambda: call(codes, scale)}
    bnd, by = md_bound(peaks, codes.numel(), u * c_, live)
    leaf = dict(shape=f"{MD_LEAF} int8, scale ({u}, 1, {c_}), bf16 out", bound_ms=bnd,
                bound_by=by, max_abs_err=0.0)
    for name, fn in forms.items():
        got = fn()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if not md_exact(got, want):
            fail(f"masked_dequant on the {MD_LEAF} leaf ({name}) disagrees with its plain "
                 f"version (max_abs_err {err:.3e})")
        del got
        leaf["max_abs_err"] = max(leaf["max_abs_err"], err)
        leaf[f"{name}_ms"] = time_ms(fn, iters=10, warmup=2)
        leaf[f"{name}_ms_graph"] = time_graph_ms(fn, iters=5, reps=3, warmup=1)
        torch.cuda.empty_cache()
    del want
    torch.cuda.empty_cache()
    leaf["plain_ms"] = time_ms(lambda: ref.masked_dequant(codes, scale, lo, hi, torch.bfloat16),
                               iters=2, warmup=1)
    # a yardstick of the card's streaming rate, not the function: a copy
    # of a bf16 tensor of the leaf's shape (its bytes read and written once)
    dst = torch.empty(MD_LEAF, dtype=torch.bfloat16, device=dev)
    src = torch.zeros_like(dst)
    leaf["copy_ms"] = time_ms(lambda: dst.copy_(src), iters=10, warmup=2)
    leaf["copy_tb_s"] = 2 * dst.numel() * 2 / leaf["copy_ms"] / 1e9
    leaf["one_launch_tb_s"] = codes.numel() * 3 / leaf["one_launch_ms"] / 1e9
    del dst, src
    cases["leaf ffn/w_up"] = leaf
    del codes, scale
    torch.cuda.empty_cache()

    for name, c in cases.items():
        if name.startswith("slice"):
            log(f"  masked_dequant {name} bf16: bit-exact, masked "
                f"{c['masked']:.3f}, {c['ms']:.4f} ms back to back, {c['ms_graph']:.4f} ms in "
                f"a CUDA graph, L2-cold {c['ms_cold']:.4f} ms ({COLD_COPIES} copies), plain "
                f"{c['plain_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms ({c['bound_by']})")
        else:
            log(f"  masked_dequant {name} [{c['shape']}]: bit-exact; per-slice "
                f"launches + stack {c['per_slice_stack_ms']:.4f} ms back to back, "
                f"{c['per_slice_stack_ms_graph']:.4f} ms in a graph; one launch "
                f"{c['one_launch_ms']:.4f} ms back to back ({c['one_launch_tb_s']:.2f} TB/s), "
                f"{c['one_launch_ms_graph']:.4f} ms in a graph; plain "
                f"{c['plain_ms']:.4f} ms, a bf16 copy of the leaf's shape {c['copy_ms']:.4f} "
                f"ms ({c['copy_tb_s']:.2f} TB/s), bound {c['bound_ms']:.4f} ms ({c['bound_by']})")
    head = cases[f"slice {MD_SLICES[0][0]}x{MD_SLICES[0][1]}"]
    return dict(route="cuda", source=MD_SOURCE,
                replaces="src/repro/kernels/masked_dequant.py:39",
                max_abs_err=max(c["max_abs_err"] for c in cases.values()),
                ms=head["ms"], ms_graph=head["ms_graph"], ms_cold=head["ms_cold"],
                plain_ms=head["plain_ms"], bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                library_ms=None, headline=f"slice {MD_SLICES[0][0]}x{MD_SLICES[0][1]} bf16",
                cases=cases)


def view_build(torch, ops, build):
    """One licensed view build: its result, and its time on the stream
    (CUDA events around it), on the host clock (ending in a synchronize),
    its masked_dequant launches and the peak device memory during it (and
    above what was allocated before it)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    n0 = ops.LAUNCHES["masked_dequant"]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    view = build()
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    return view, dict(device_ms=start.elapsed_time(end), host_s=host_s,
                      launches=ops.LAUNCHES["masked_dequant"] - n0, peak_gb=peak / 1e9,
                      peak_above_gb=(peak - before) / 1e9)


def view_bound(peaks, store, live):
    """Bound of one int8 view build: md_bound summed over the store's
    quantized leaves (bf16 out)."""
    n = scales = 0
    for _, leaf in _qpaths(store):
        n += leaf["codes"].numel()
        scales += leaf["scale"].numel()
    return md_bound(peaks, n, scales, live)


def view_cases(peaks, torch, ops, store, free, dtype, reps=3):
    """The whole int8 view of the free tier and of the full one, built
    from ``store`` by ``materialize_licensed_view`` ``reps`` times each (the
    gateway's path without its cache), bit-exact against the plain
    version leaf by leaf; the median build and the largest peak."""
    import statistics

    from repro_torch.kernels import ref
    from repro_torch.serving.quantized import materialize_licensed_view, tier_intervals

    cases = {}
    for tier in (free, None):
        name = f"view {tier.name if tier else 'full'}"
        dev = next(_qpaths(store))[1]["codes"].device
        li = tier_intervals(tier, device=dev)
        live = 0 if li is None else int((li[1] > li[0]).sum())
        runs = []
        for _ in range(reps):
            view, got = view_build(torch, ops, lambda: materialize_licensed_view(
                store, tier, dtype))
            runs.append(got)
            if len(runs) < reps:
                del view
        lo, hi = li if li is not None else ops.pack_intervals([], device=dev)
        for path, q in _qpaths(store):
            want = ref.masked_dequant(q["codes"], q["scale"], lo, hi, dtype)
            if not md_exact(_at(view, path), want):
                fail(f"masked_dequant: {name} differs from the plain version at {path}")
            del want
        del view
        torch.cuda.empty_cache()
        bnd, by = view_bound(peaks, store, live)
        cases[name] = dict(
            device_ms=statistics.median(r["device_ms"] for r in runs),
            host_s=statistics.median(r["host_s"] for r in runs),
            launches=runs[0]["launches"], peak_gb=max(r["peak_gb"] for r in runs),
            peak_above_gb=max(r["peak_above_gb"] for r in runs), reps=reps,
            bound_ms=bnd, bound_by=by)
        c = cases[name]
        log(f"  masked_dequant {name} (bf16, bit-exact): {c['launches']} "
            f"launches, {c['device_ms']:.3f} ms on the stream, {c['host_s']:.4f} s host "
            f"(medians of {reps}), peak {c['peak_gb']:.2f} GB ({c['peak_above_gb']:.2f} GB "
            f"above the store), bound {c['bound_ms']:.4f} ms ({c['bound_by']})")
    return cases


def _qpaths(tree, path=()):
    if isinstance(tree, dict) and "codes" in tree and "scale" in tree:
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _qpaths(v, path + (k,))


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def check_delta_apply(peaks, torch, ref, dev, gen):
    """Both forms of the scatter kernel vs the plain version, bit-exact:
    out of place at the boot pull's largest layer (every index of a
    36x2048x11008 bf16 buffer, bf16 values), in place at a staged-sync
    part (a 36x2048 bf16 norm, f32 values for units 32-35, plus padding
    indices equal to N).  The library column is one ``index_put`` call
    (in-range indices, values already in buf's dtype)."""
    from repro_torch.kernels.delta_apply import delta_apply

    forms = {}
    # out of place, boot shape: every index of the buffer (n = N)
    n = 36 * 2048 * 11008
    buf = torch.zeros(n, dtype=torch.bfloat16, device=dev)
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    val = torch.randn(n, dtype=torch.float32, device=dev).bfloat16()
    got = delta_apply(buf, idx, val)
    want = ref.delta_apply(buf, idx, val)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if not torch.equal(got, want) or buf.count_nonzero().item():
        fail("delta_apply (out of place) disagrees with its plain version")
    del got, want
    # the function's bytes, not the clone-then-scatter design's: n int64
    # indices and bf16 values read, buf read once and the output written
    # once (N x 2 B each)
    bnd, by = bound_ms(n * (8 + 2) + 2 * n * 2, 0, peaks)
    forms["delta_apply"] = dict(
        shape=f"N={n} bf16, n={n} int64 / bf16", max_abs_err=err,
        replaces="src/repro/kernels/delta_apply.py:63",
        ms=time_ms(lambda: delta_apply(buf, idx, val), iters=20, warmup=2),
        plain_ms=time_ms(lambda: ref.delta_apply(buf, idx, val), iters=3, warmup=1),
        library_ms=time_ms(lambda: buf.index_put((idx,), val), iters=20, warmup=2),
        bound_ms=bnd, bound_by=by)
    del buf, idx, val
    torch.cuda.empty_cache()

    # in place, a sync part: 8,192 f32 values into a bf16 norm + padding
    n_buf, pad = 36 * 2048, 16
    buf = torch.randn(n_buf, generator=gen).bfloat16().to(dev)
    live = torch.arange(32 * 2048, 36 * 2048, dtype=torch.int64)
    idx = torch.cat([live[torch.randperm(live.numel(), generator=gen)],
                     torch.full((pad,), n_buf, dtype=torch.int64)]).to(dev)
    val = torch.randn(idx.numel(), generator=gen).to(dev)
    work = buf.clone()
    got = delta_apply(work, idx, val, donate=True)
    want = ref.delta_apply(buf.clone(), idx, val, donate=True)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if got.data_ptr() != work.data_ptr() or not torch.equal(got, want):
        fail("delta_apply_inplace disagrees with its plain version")
    n_live = live.numel()
    # every int64 index and f32 value read; only the in-range entries write
    bnd, by = bound_ms(idx.numel() * (8 + 4) + n_live * 2, 0, peaks)
    in_range, cast = idx[:n_live], val[:n_live].bfloat16()
    forms["delta_apply_inplace"] = dict(
        kernel="delta_apply_parts (one rows segment)", cases={},
        shape=f"N={n_buf} bf16, n={idx.numel()} int64 / f32 ({pad} padding)",
        max_abs_err=err, replaces="src/repro/kernels/delta_apply.py:82",
        ms=time_ms(lambda: delta_apply(work, idx, val, donate=True)),
        ms_graph=time_graph_ms(lambda: delta_apply(work, idx, val, donate=True)),
        plain_ms=time_ms(lambda: ref.delta_apply(work, idx, val, donate=True)),
        library_ms=time_ms(lambda: work.index_put_((in_range,), cast)),
        library_ms_graph=time_graph_ms(lambda: work.index_put_((in_range,), cast)),
        bound_ms=bnd, bound_by=by)
    for name, f in forms.items():
        graph = (f"; in a CUDA graph {f['ms_graph']:.4f} ms, index_put_ "
                 f"{f['library_ms_graph']:.4f} ms" if "ms_graph" in f else "")
        log(f"  {name} [{f['shape']}]: max_abs_err {f['max_abs_err']:.1e} (exact), "
            f"{f['ms']:.4f} ms, plain {f['plain_ms']:.4f} ms, index_put "
            f"{f['library_ms']:.4f} ms back to back{graph}, bound {f['bound_ms']:.4f} ms "
            f"({f['bound_by']})")
    return {name: dict(route="cuda", source="src/repro_torch/kernels/csrc/delta_apply.cu",
                       **f) for name, f in forms.items()}


# the prefill attention and MLP shapes of qwen2.5-3b (16 q heads over 2 kv
# heads, head_dim 128, d_model 2048, d_ff 11008): one layer of a 4096-token
# prompt's causal prefill, the same under a 1024-token window, and the
# prompt's last 256-token chunk; the int8 up / down products at an 8-lane
# decode step and at a 4096-token prefill
FLASH_HEADS = (16, 2, 128, 4096)      # q heads, kv heads, head_dim, prompt tokens
FLASH_CASES = {"causal": dict(sq=4096, window=0, q_offset=0),
               "window1024": dict(sq=4096, window=1024, q_offset=0),
               "chunk256": dict(sq=256, window=0, q_offset=3840)}
QMM_CASES = {"up_m8": (8, 2048, 11008), "down_m8": (8, 11008, 2048),
             "up_m4096": (4096, 2048, 11008), "down_m4096": (4096, 11008, 2048)}
FLASH_TOL = 2e-3      # abs and rel, the JAX kernel tests' tolerance
# copies of the codes rotated through for the cold-L2 times of the
# decode-sized products: 4 x 22.5 MB exceeds the H100's 50 MB L2, as one
# decode step reads each weight once
COLD_COPIES = 4


def qmm_tol(k: int) -> float:
    """quant_matmul's tolerance for bf16 x and bf16 out, relative to the
    largest |output|.  The products are exact on both sides; the tensor
    cores add each k16 step into the f32 accumulator with truncation,
    losing up to about one f32 ulp (2^-23) of the partial sum per step,
    and then each side rounds its f32 sum to bf16 once, which can differ
    by one bf16 ulp (at most 2^-7 of the value)."""
    return -(-k // 16) * 2.0 ** -23 + 2.0 ** -7


def attention_pairs(sq, sk, window, q_offset):
    """Unmasked (q, k) pairs of one head under the causal and window masks."""
    import numpy as np

    pos = q_offset + np.arange(sq)
    hi = np.minimum(sk, pos + 1)
    lo = np.maximum(0, pos - window + 1) if window else np.zeros_like(pos)
    return int(np.maximum(hi - lo, 0).sum())


def check_prefill_mlp(peaks, torch, ops, ref):
    """``flash_attention`` and ``quant_matmul`` at the shapes above.  No
    path of either package calls them: their public entry points are the
    path, driven once with the launch counters zeroed just before and read
    just after; then each output is held against the plain version, and
    kernel, plain version and library call are timed."""
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import quant_matmul as qmm_mod
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import roofline

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED + 3)
    bh, bkh, hd, sk = FLASH_HEADS
    qkv = {}
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn(bh, sk, hd, generator=gen).to(dtype).to(dev)
        k = torch.randn(bkh, sk, hd, generator=gen).to(dtype).to(dev)
        v = torch.randn(bkh, sk, hd, generator=gen).to(dtype).to(dev)
        for name, c in FLASH_CASES.items():
            qkv[name, dtype] = (q[:, -c["sq"]:].contiguous(), k, v)
    mlp = {}
    for name, (m, kdim, n) in QMM_CASES.items():
        mlp[name] = (torch.randn(m, kdim, generator=gen).bfloat16().to(dev),
                     torch.randint(-127, 128, (kdim, n), generator=gen,
                                   dtype=torch.int8).to(dev),
                     (torch.rand(n, generator=gen) * 4e-4 + 1e-5).to(dev))

    def attend(key):
        c = FLASH_CASES[key[0]]
        return flash_attention(*qkv[key], causal=True, window=c["window"],
                               q_offset=c["q_offset"], groups=bh // bkh)

    ops.reset_launches()
    outs = {key: attend(key) for key in qkv}
    outs.update({name: ops.quant_matmul(*mlp[name]) for name in mlp})
    torch.cuda.synchronize()
    launches = {name: ops.LAUNCHES[name] for name in ("flash_attention", "quant_matmul")}
    log(f"  prefill / MLP entry points: {len(qkv)} flash_attention and {len(mlp)} "
        f"quant_matmul calls, launches {launches}")
    if launches["flash_attention"] < len(qkv) or launches["quant_matmul"] < len(mlp):
        fail(f"flash_attention / quant_matmul launched {launches}, fewer than the "
             f"{len(qkv)} / {len(mlp)} calls made")

    cases = {}
    for key, got in outs.items():
        if isinstance(key, tuple):
            name, dtype = key
            c = FLASH_CASES[name]
            q, k, v = qkv[key]
            want = ref.flash_attention(q, k, v, causal=True, window=c["window"],
                                       q_offset=c["q_offset"], groups=bh // bkh)
            torch.cuda.synchronize()
            diff = (got - want).abs()
            err = diff.max().item()
            ok = bool((diff <= FLASH_TOL + FLASH_TOL * want.abs()).all())
            label = f"flash_attention {name} {str(dtype)[6:]}"
            pairs = bh * attention_pairs(c["sq"], sk, c["window"], c["q_offset"])
            elt = q.element_size()
            nbytes = q.numel() * elt + 2 * k.numel() * elt + got.numel() * 4
            rate = 2 if dtype == torch.bfloat16 else 1
            bnd, by = bound_ms(nbytes, 4 * hd * pairs, peaks, rate)
            row = dict(shape=f"q ({bh}, {c['sq']}, {hd}) k/v ({bkh}, {sk}, {hd}), window "
                             f"{c['window']}, q_offset {c['q_offset']}",
                       max_abs_err=err, tol=f"{FLASH_TOL} abs + {FLASH_TOL} rel",
                       ms=time_ms(lambda: attend(key), iters=20, warmup=3),
                       plain_ms=time_ms(lambda: ref.flash_attention(
                           q, k, v, causal=True, window=c["window"],
                           q_offset=c["q_offset"], groups=bh // bkh), iters=3, warmup=1),
                       bound_ms=bnd, bound_by=by, bound_rate=roofline.RATE_NAMES[rate],
                       flop=4 * hd * pairs, bytes=nbytes, library_ms=None,
                       design=fa_mod.design(dtype, hd))
            if name == "causal" and dtype == torch.bfloat16:
                sdpa = torch.nn.functional.scaled_dot_product_attention
                q4, k4, v4 = (t.unsqueeze(0) for t in (q, k, v))
                row["library_ms"] = time_ms(lambda: sdpa(q4, k4, v4, is_causal=True,
                                                         enable_gqa=True), iters=20)
                row["library"] = ("scaled_dot_product_attention(is_causal=True, "
                                  "enable_gqa=True), bf16 out")
        else:
            label = f"quant_matmul {key}"
            x, codes, scale = mlp[key]
            m, kdim, n = QMM_CASES[key]
            want = ref.quant_matmul(x, codes, scale, torch.bfloat16)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            top = want.float().abs().max().item()
            tol = qmm_tol(kdim)
            ok = got.dtype == torch.bfloat16 and err <= tol * top
            nbytes = x.numel() * 2 + codes.numel() + scale.numel() * 4 + got.numel() * 2
            bnd, by = bound_ms(nbytes, 2 * m * kdim * n, peaks, 2)
            row = dict(shape=f"x ({m}, {kdim}) bf16 @ codes ({kdim}, {n}) int8, bf16 out",
                       max_abs_err=err, tol=f"{tol:.6g} x max|out| ({top:.4g})",
                       ms=time_ms(lambda: ops.quant_matmul(x, codes, scale), iters=20),
                       plain_ms=time_ms(lambda: ref.quant_matmul(x, codes, scale,
                                                                 torch.bfloat16), iters=5),
                       bound_ms=bnd, bound_by=by, bound_rate=roofline.RATE_NAMES[2],
                       flop=2 * m * kdim * n, bytes=nbytes,
                       design=qmm_mod.design(x.dtype, m))
            cold = m <= qmm_mod.SMALL_M
            row.update(qmm_library(torch, x, codes, scale, cold))
            if cold:
                row["ms_graph"] = time_graph_ms(lambda: ops.quant_matmul(x, codes, scale))
                copies = [codes.clone() for _ in range(COLD_COPIES)]
                row["ms_cold"] = time_graph_ms(rotating(
                    [lambda c=c: ops.quant_matmul(x, c, scale) for c in copies]))
                del copies
        if not torch.isfinite(got).all() or not ok:
            fail(f"{label} disagrees with its plain version (max_abs_err {err:.3e})")
        cases[label] = row
        lib = (f", library {row['library_ms']:.4f} ms"
               if row.get("library_ms") is not None else "")
        if "dense_bf16_ms" in row:
            lib += f" (bf16 matmul on the dequantized weight {row['dense_bf16_ms']:.4f} ms)"
        if "ms_cold" in row:
            lib += (f"; in a CUDA graph: kernel {row['ms_graph']:.4f} ms warm; L2-cold "
                    f"({COLD_COPIES} copies of the weight): kernel {row['ms_cold']:.4f} ms, "
                    f"library {row['library_ms_cold']:.4f} ms, bf16 matmul "
                    f"{row['dense_bf16_ms_cold']:.4f} ms")
        log(f"  {label} [{row['shape']}, {row['design']}]: max_abs_err {err:.3e} "
            f"(tol {row['tol']}), "
            f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms{lib}, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}, {row['bound_rate']})")
    del outs, qkv, mlp
    torch.cuda.empty_cache()

    rows = {}
    for kernel, head, source, replaces in (
            ("flash_attention", "flash_attention causal bfloat16",
             "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
             "src/repro/kernels/flash_attention.py:84"),
            ("quant_matmul", "quant_matmul up_m4096",
             "src/repro_torch/kernels/csrc/quant_matmul_sm90.cu",
             "src/repro/kernels/quant_matmul.py:40")):
        mine = {k: v for k, v in cases.items() if k.startswith(kernel)}
        top = mine[head]
        rows[kernel] = dict(route="cuda", source=source, replaces=replaces,
                            max_abs_err=max(v["max_abs_err"] for v in mine.values()),
                            ms=top["ms"], plain_ms=top["plain_ms"],
                            bound_ms=top["bound_ms"], bound_by=top["bound_by"],
                            bound_rate=top["bound_rate"], library_ms=top["library_ms"],
                            headline=head, cases=mine)
    return rows, launches


def qmm_library(torch, x, codes, scale, cold=False):
    """Yardsticks, timed only: ``torch._weight_int8pack_mm``, PyTorch's one
    call computing x @ (codes * scale) from int8 weights (it takes them as
    (N, K)), and a bf16 ``torch.matmul`` on the weight dequantized
    beforehand (``dense_bf16_ms``: the dense tensor-core rate on the same
    shape).  ``cold``: also each rotated over ``COLD_COPIES`` copies of its
    weight in a CUDA graph (``*_ms_cold``), as the kernel is."""
    packed, s = codes.t().contiguous(), scale.to(x.dtype)
    w = (codes.float() * scale[None, :]).to(x.dtype)
    row = dict(library_ms=time_ms(lambda: torch._weight_int8pack_mm(x, packed, s),
                                  iters=5, warmup=1),
               library="torch._weight_int8pack_mm (weight (N, K) int8)",
               dense_bf16_ms=time_ms(lambda: torch.matmul(x, w), iters=20))
    if cold:
        packs = [packed.clone() for _ in range(COLD_COPIES)]
        row["library_ms_cold"] = time_graph_ms(rotating(
            [lambda p=p: torch._weight_int8pack_mm(x, p, s) for p in packs]), iters=8, reps=2)
        del packs
        ws = [w.clone() for _ in range(COLD_COPIES)]
        row["dense_bf16_ms_cold"] = time_graph_ms(rotating(
            [lambda w=w: torch.matmul(x, w) for w in ws]))
    return row


def store_leaf_check(codes, scale, torch, ops):
    """``quant_matmul`` on a real int8 store leaf (the int8 gateway's unit
    0 ``ffn/w_up``) against x @ masked_dequant(codes, scale, []), the
    weight the gateway's full-tier view serves."""
    gen = torch.Generator(device="cpu").manual_seed(SEED + 4)
    w = ops.masked_dequant(codes, scale, [], out_dtype=torch.float32)
    worst = 0.0
    for m in (8, 4096):
        x = torch.randn(m, codes.shape[0], generator=gen).bfloat16().to(codes.device)
        got = ops.quant_matmul(x, codes, scale)
        want = (x.float() @ w).bfloat16()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        top = want.float().abs().max().item()
        tol = qmm_tol(codes.shape[0])
        log(f"  quant_matmul on the int8 store's unit-0 ffn/w_up {tuple(codes.shape)}, "
            f"M={m}: max_abs_err {err:.3e} vs x @ masked_dequant (tol {tol:.6g} x "
            f"max|out| {top:.4g})")
        if not torch.isfinite(got).all() or err > tol * top:
            fail("quant_matmul disagrees with x @ masked_dequant on the store leaf")
        worst = max(worst, err / top)
    return worst


# ------------------------------------------------------------ phase 3 / 4
PROMPT_LENS = [23, 64, 37, 50, 9, 61, 17, 44, 30, 58, 12, 40]
GEOMETRY = dict(max_batch=8, max_prompt=64, max_new_cap=32)


def stream_jobs(cfg, np):
    """(prompt, tier, max_new_tokens) of the serving stream, from ``SEED``."""
    rng = np.random.default_rng(SEED)
    return [(rng.integers(0, cfg.vocab_size, n, dtype=np.int32),
             "free" if i % 2 else "full", 16 + (i % 3) * 8)
            for i, n in enumerate(PROMPT_LENS)]


def submit_all(gw, cfg, np):
    return [gw.submit(p, license=tier, max_new_tokens=new)
            for p, tier, new in stream_jobs(cfg, np)]


def serve(label, gw, cfg, np, torch):
    """Build both tiers' views (each timed by ``view_build``), then drain
    one request stream; returns its requests and timings."""
    from repro_torch.kernels import ops

    views = {}
    for tier in ("full", "free"):                  # build the views first
        _, views[tier] = view_build(torch, ops, lambda: gw.view_for(tier))
        v = views[tier]
        log(f"  {label}: view of tier {tier} built in {v['host_s']:.3f} s "
            f"({v['device_ms']:.2f} ms on the stream, {v['launches']} masked_dequant "
            f"launches, peak {v['peak_gb']:.2f} GB, {v['peak_above_gb']:.2f} GB above "
            f"the weights)")
    t_views = sum(v["host_s"] for v in views.values())
    chunk_s = time_chunks(gw)
    reqs = submit_all(gw, cfg, np)
    t0 = time.perf_counter()
    gw.run()
    sync()
    t_run = time.perf_counter() - t0
    del gw._run_chunked_prefill
    bad = [r.rid for r in reqs if r.state.value != "done"
           or len(r.out_tokens) != r.max_new_tokens]
    if bad:
        fail(f"{label}: requests {bad} did not finish")
    toks = [t for r in reqs for t in r.out_tokens]
    if not all(0 <= t < cfg.vocab_size for t in toks):
        fail(f"{label}: token ids outside the vocabulary")
    m = gw.metrics()
    pre = prefill_report(gw, chunk_s)
    # a bucket prefill (chunk_size=0) is one step a batch, not a chunk
    prefills = m["prefill_chunks"] if gw.chunked else m["prefill_batches"]
    log(f"  {label}: {len(reqs)} requests, {m['tokens_generated']} tokens, "
        f"{m['decode_steps']} decode steps, {prefills} prefill "
        f"{'chunks' if gw.chunked else 'batches'}; "
        f"views {t_views:.2f} s, serving {t_run:.2f} s "
        f"({m['tokens_generated'] / t_run:.1f} tokens/s, "
        f"{1e3 * t_run / max(1, m['decode_steps'] + prefills):.1f} ms/step); "
        f"{pre['text']}")
    return reqs, dict(views_s=t_views, views=views, serve_s=t_run,
                      tokens=m["tokens_generated"], decode_steps=m["decode_steps"],
                      prefill_chunks=m["prefill_chunks"], prefill_batches=m["prefill_batches"],
                      prefill=pre["numbers"])


def time_chunks(gw):
    """Time each prefill chunk of ``gw`` on the host clock between two
    synchronizes (the chunk ends in a copy to the host anyway), by kind:
    a graph replay, a capture (its warm-up is the chunk) or an eager
    chunk.  Returns the lists of seconds; ``del gw._run_chunked_prefill``
    takes the timer away."""
    out = {"replay": [], "capture": [], "eager": []}
    run = gw._run_chunked_prefill

    def timed(act):
        pg = gw._prefill_graphs
        n = None if pg is None else pg.captures
        sync()
        t0 = time.perf_counter()
        run(act)
        sync()
        kind = "eager" if pg is None else "capture" if pg.captures > n else "replay"
        out[kind].append(time.perf_counter() - t0)

    gw._run_chunked_prefill = timed
    return out


def prefill_report(gw, chunk_s=None):
    """The prefill chunks of ``gw`` so far: the prefill graphs' captures
    and replays (None when it prefills eagerly), the chunk p50 of the
    ``step_prefill_s`` histogram (host clock, bucket-interpolated; none
    with telemetry off), with ``chunk_s`` (``time_chunks``) the exact
    p50 of each kind, and the KV pool's bytes.  Returns the numbers and
    a line of text."""
    import numpy as np

    pg = gw._prefill_graphs
    h = gw.metrics()["latency"]["step_prefill_s"]
    n = dict(prefill_captures=None if pg is None else pg.captures,
             prefill_replays=None if pg is None else pg.replays,
             chunk_p50_ms=1e3 * h["p50"] if h["count"] else None,
             kv_pool_gb=gw.pool.nbytes / 1e9)
    bucket = {f.strip("_"): g for f, g in graph_families(gw).items()
              if f in ("_bucket_graphs", "_suffix_graphs")}
    how = (f"prefill graphs: {pg.captures} captures, {pg.replays} replays" if pg is not None
           else "; ".join(f"{k} {g.captures} captures, {g.replays} replays"
                          for k, g in bucket.items()) if bucket else "eager prefill")
    p50 = "not recorded" if n["chunk_p50_ms"] is None else f"{n['chunk_p50_ms']:.2f} ms"
    text = f"{how}, chunk p50 (step_prefill_s) {p50}"
    if chunk_s is not None:
        n["chunk_ms"] = {k: [1e3 * x for x in v] for k, v in chunk_s.items() if v}
        n["chunk_p50_synced_ms"] = {k: float(np.median(v)) for k, v in n["chunk_ms"].items()}
        text += ", synchronized p50 " + ", ".join(
            f"{k} {v:.2f} ms ({len(n['chunk_ms'][k])})"
            for k, v in n["chunk_p50_synced_ms"].items())
    return dict(numbers=n, text=text + f", KV pool {n['kv_pool_gb']:.3f} GB")


def record_rows(gw):
    """Keep, on the card, every logits row a token of ``gw``'s stream is
    sampled from (the gateway's own scores), keyed by (request id, token
    index); a row recomputed after a preemption replaces the earlier one.
    Costs one device copy a step."""
    rows = {}
    sample = gw._sample

    def recorded(logits, reqs, greedy=None, emit=None):
        kept = logits[: len(reqs)].clone()
        for i, r in enumerate(reqs):
            rows[(r.rid, len(r.out_tokens))] = kept[i]
        return sample(logits, reqs, greedy, emit)

    gw._sample = recorded
    return rows


def stream_parts(kernel_reqs, plain_reqs, kernel_rows, plain_rows, vocab):
    """For each request, the first step at which the kernel path's and
    the plain path's greedy tokens part (None: they never do); there,
    from both paths' own logits rows at that step over the ``vocab``
    real ids (the same tokens came before it), the plain path's gap
    between its token and the kernel path's, the kernel path's gap the
    other way, the lane's max |logit diff| and the plain row's max
    |logit|.  Later tokens continue different texts."""
    parts = []
    for rk, rp in zip(kernel_reqs, plain_reqs):
        t = next((i for i, (a, b) in enumerate(zip(rk.out_tokens, rp.out_tokens))
                  if a != b), None)
        if t is None:
            parts.append(dict(request=rk.rid, step=None))
            continue
        k = kernel_rows[(rk.rid, t)][:vocab].float()
        p = plain_rows[(rp.rid, t)][:vocab].float()
        kt, pt = rk.out_tokens[t], rp.out_tokens[t]
        if (int(k.argmax()), int(p.argmax())) != (kt, pt):
            fail(f"request {rk.rid} step {t}: the recorded logits rows do not give "
                 f"the tokens the gateways emitted")
        parts.append(dict(request=rk.rid, step=t, kernel_token=kt, plain_token=pt,
                          plain_gap=(p[pt] - p[kt]).item(), kernel_gap=(k[kt] - k[pt]).item(),
                          lane_max_abs_diff=(k - p).abs().max().item(),
                          plain_max_abs=p.abs().max().item()))
    return parts


def mid_decode(gw, cfg, np, torch):
    """Bring phase 3's stream to mid-decode on ``gw`` and return ``step(
    kernel)``, which runs the next decode step of one tier's running
    requests eagerly through the kernels (``kernel=True``) or the plain
    path on a copy of the pool's blocks, and the number of real lanes."""
    from repro_torch.serving.engine import serve_step_paged

    submit_all(gw, cfg, np)
    group = []
    while len(group) < 4:
        if gw.step() is None:
            fail("stream drained before reaching mid-decode")
        group = [r for r in gw.scheduler.running
                 if r.state.value == "running" and len(r.out_tokens) >= 3]
    tier = group[0].license
    reqs = gw._grow_block_tables([r for r in group if r.license == tier])
    bsz, bs, dev = gw.max_batch, gw.pool.block_size, gw.device
    lanes = gw.pool.pad_lanes([r.lane for r in reqs], bsz)
    toks = np.zeros((bsz, 1), np.int32)
    poss = np.zeros(bsz, np.int32)
    for i, r in enumerate(reqs):
        toks[i, 0], poss[i] = r.out_tokens[-1], r.pos
    used = max(r.pos // bs + 1 for r in reqs)
    tables = gw.pool.pad_tables([r.blocks[:used] for r in reqs], bsz, used)
    view, _ = gw.view_for(tier)

    def step(kernel):
        cache = gw.pool.decode_cache(lanes)
        for path, t in gw.pool.leaves.items():
            unit, block, name = path.split("/")
            cache[unit][block][name] = t.clone()
        logits, _ = serve_step_paged(
            view, cfg, torch.from_numpy(toks).to(dev), cache,
            torch.from_numpy(tables).to(dev), torch.from_numpy(poss).to(dev),
            kernel=kernel)
        return logits[: len(reqs), : cfg.vocab_size].float()

    return step, len(reqs), tier


def decode_logits_check(gw, cfg, np, torch):
    """Bring a stream to mid-decode, then run one decode step through the
    kernels and through the plain path on two copies of the same pool."""
    step, n, tier = mid_decode(gw, cfg, np, torch)
    out = [step(kernel) for kernel in (True, False)]
    reqs = range(n)
    if not (torch.isfinite(out[0]).all() and torch.isfinite(out[1]).all()):
        fail("decode logits are not finite")
    diff = (out[0] - out[1]).abs()
    err = diff.max().item()
    scale = out[1].abs().max().item()
    top2 = out[1].topk(2, dim=-1)
    flips = []                        # lanes whose argmax differs
    for i in range(len(reqs)):
        kernel_tok, plain_tok = int(out[0][i].argmax()), int(top2.indices[i, 0])
        if kernel_tok != plain_tok:
            flips.append(dict(lane=i, plain_token=plain_tok, kernel_token=kernel_tok,
                              plain_top2_gap=(top2.values[i, 0] - top2.values[i, 1]).item(),
                              plain_gap_to_kernel_token=(
                                  out[1][i, plain_tok] - out[1][i, kernel_tok]).item(),
                              lane_max_abs_diff=diff[i].max().item()))
    return err, scale, len(reqs) - len(flips), len(reqs), tier, flips


def pinned_routes(torch, record, pinned=None):
    """Replace ``models.moe.route`` for one eager step: append each call's
    (probs, top_e) to ``record`` and, with ``pinned`` (an earlier step's
    record), take that call's expert picks instead of its own, weighted
    by this step's own router probabilities.  Returns the original."""
    from repro_torch.models import moe

    route = moe.route

    def recorded(p, x, cfg):
        probs, top_p, top_e = route(p, x, cfg)
        if pinned is not None:
            top_e = pinned[len(record)][1]
            top_p = probs.gather(-1, top_e)
            if cfg.moe_renormalize:
                top_p = top_p / top_p.sum(-1, keepdim=True)
        record.append((probs, top_e))
        return probs, top_p, top_e

    moe.route = recorded
    return route


def moe_route_check(label, gw, cfg, np, torch):
    """One decode step of an MoE model mid-stream, both routes eager on
    copies of the same pool.  A router turns the routes' rounding into
    discrete expert swaps, so the kernel route runs twice: on its own
    picks, and pinned to the plain route's picks with its own router
    probabilities.  Pinned, every lane's logits must lie within phase 4's
    tolerance (0.05 x max(|logit|, 1)) of the plain route's, as must, on
    its own picks, every lane whose picks equal the plain route's in every
    layer; argmax flips must be near-ties (the plain gap below the lane's
    |logit diff|).  Returns the numbers."""
    from repro_torch.models import moe

    step, n, tier = mid_decode(gw, cfg, np, torch)
    rec = {"kernel": [], "plain": [], "pinned": []}
    out = {}
    for name, kernel in (("plain", False), ("kernel", True), ("pinned", True)):
        route = pinned_routes(torch, rec[name], rec["plain"] if name == "pinned" else None)
        try:
            out[name] = step(kernel)
        finally:
            moe.route = route
    units = cfg.pattern_units
    if not all(len(r) == units for r in rec.values()):
        fail(f"{label}: {[len(r) for r in rec.values()]} router calls, not {units} each")
    # layers a lane's expert set differs between the routes
    swaps = [sum(set(k[1][i].reshape(-1).tolist()) != set(p[1][i].reshape(-1).tolist())
                 for k, p in zip(rec["kernel"], rec["plain"])) for i in range(n)]
    ref = out["plain"]
    tol = 0.05 * max(ref.abs().max().item(), 1.0)
    diff = {name: (out[name] - ref).abs().amax(-1).tolist() for name in ("kernel", "pinned")}
    res = dict(lanes=n, tier=tier, tol=tol, swapped_layers=swaps,
               lane_max_abs_diff=diff["kernel"], pinned_lane_max_abs_diff=diff["pinned"],
               router_max_abs_diff=max((k[0][:n] - p[0][:n]).abs().max().item()
                                       for k, p in zip(rec["kernel"], rec["plain"])))
    log(f"  {label}: one decode step of {n} lanes (tier {tier}), eager: layers whose "
        f"expert picks differ between the routes per lane {swaps} of {units}; max |router "
        f"prob diff| {res['router_max_abs_diff']:.2e}; lane max |logit diff| own picks "
        f"{[round(d, 4) for d in diff['kernel']]}, pinned to the plain route's "
        f"{[round(d, 4) for d in diff['pinned']]} (tol {tol:.4f})")
    bad = [i for i in range(n) if diff["pinned"][i] > tol
           or (swaps[i] == 0 and diff["kernel"][i] > tol)]
    if bad:
        fail(f"{label}: lanes {bad} differ beyond {tol:.4f} with the same expert picks")
    for name in ("kernel", "pinned"):
        for i in range(n):
            kt, pt = int(out[name][i].argmax()), int(ref[i].argmax())
            if kt != pt and not (ref[i, pt] - ref[i, kt]).item() < diff[name][i]:
                fail(f"{label}: lane {i} argmax {kt} ({name}) vs {pt} is not a near-tie")
    return res


# ------------------------------------------------------------ telemetry
# the series read back from the Prometheus page, against metrics()
PROM_READBACK = {"serving_tokens_generated_total": "tokens_generated",
                 "serving_decode_steps_total": "decode_steps",
                 "serving_prefill_chunks_total": "prefill_chunks",
                 "serving_requests_completed_total": "completed",
                 "serving_prefix_tokens_reused_total": "prefix_tokens_reused"}


def prom_values(text):
    """Sample lines of a Prometheus page: series (with labels) -> value."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            out[name] = float(value)
    return out


def telemetry_report(label, gw):
    """Validate what ``gw`` recorded (the Chrome trace, the metrics()
    schema, the Prometheus page against the counters) and print the six
    latency histograms.  Any failure fails the run."""
    from repro_torch.serving import validate_chrome_trace, validate_gateway_metrics

    try:
        events = validate_chrome_trace(gw.chrome_trace())
    except ValueError as e:
        fail(f"{label}: chrome_trace() is not a valid trace: {e}")
    m = gw.metrics()
    try:
        # decode_path.kernels: the port's one key outside the JAX schema
        validate_gateway_metrics(m, extra=("decode_path.kernels",))
    except AssertionError as e:
        fail(f"{label}: metrics() fails the gateway schema: {e}")
    prom = prom_values(gw.render_prometheus())
    read = {}
    for series, key in PROM_READBACK.items():
        read[series] = prom[f'{series}{{model="{gw.model}"}}']
        if read[series] != m[key]:
            fail(f"{label}: {series} reads {read[series]}, metrics() {key} {m[key]}")
    hist = {k: dict(count=v["count"], p50_ms=1e3 * v["p50"], p99_ms=1e3 * v["p99"],
                    sum_s=v["sum"]) for k, v in m["latency"].items()}
    audit = {}
    for e in gw.audit_events():
        audit[e["event"]] = audit.get(e["event"], 0) + 1
    log(f"  {label}: chrome_trace valid ({len(events)} events, {len(gw.tracer.events)} on "
        f"the tape), metrics() passes validate_gateway_metrics; audit {audit}")
    log(f"  {label}: histograms (host clock; count, p50 / p99 ms): " + "; ".join(
        f"{k} {h['count']}, {h['p50_ms']:.2f} / {h['p99_ms']:.2f}" for k, h in hist.items()))
    log(f"  {label}: read back from render_prometheus(): "
        + ", ".join(f"{k} {v:g}" for k, v in read.items()))
    return dict(trace_events=len(events), histograms=hist, prometheus=read, audit=audit)


def busy_union(intervals, lo, hi):
    """Length of the union of ``intervals`` clipped to [lo, hi]."""
    total, cur = 0.0, None
    for a, b in sorted((max(lo, a), min(hi, b)) for a, b in intervals if b > lo and a < hi):
        if cur is None or a > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    return total + (cur[1] - cur[0] if cur is not None else 0.0)


# the port's kernels in a device trace: label -> a substring of the
# kernel's name (csrc/paged_attention.cu, csrc/masked_dequant.cu)
TRACE_KERNELS = {"paged_attention": "paged_attention_split_kernel",
                 "paged_attention_combine": "paged_attention_combine_kernel",
                 "paged_decode_write": "paged_decode_write_kernel",
                 "masked_dequant": "masked_dequant_"}
# marker kernels a profile launches before its window.  Late in the
# script a trace can lack the first device records of its session (phase
# 7b's first graph replay lacked its first kernels, PERF.md section 6);
# the last marker's record, which must be in the trace, shows the window
# clear of that loss
PROFILE_LEAD_IN = 1024


def profile_window(label, fn, torch, steps, keep_kernels=False, sub=None):
    """Run ``fn`` (``steps`` scheduler steps, then a synchronize) under
    torch.profiler with CPU and CUDA activities.  Returns the window's
    length, the union of its device intervals (kernels, copies, sets) as
    a share of it, kernel launches per step, the five kernels with the
    most device time and the port's kernels among those the window's
    CUDA calls launched (with ``keep_kernels``, every such kernel's
    (name, start us, duration us) too, under ``kernel_events``); None
    when the trace holds no device events.  With ``sub``, the name of a
    ``record_function`` range ``fn`` opens, also what the CUDA calls made
    inside that range put on the device (``sub_records``: kernels and
    copies/sets by name).  Fails when the trace lost the last of the
    lead-in's marker kernels."""
    from torch.profiler import ProfilerActivity, profile, record_function

    out_dir = ROOT / "build" / "profiles"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{label}.json"
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("chip_smoke_lead_in"):
            mark = torch.zeros(1, device="cuda")
            for _ in range(PROFILE_LEAD_IN):
                mark.add_(1)
            sync()
        with record_function("chip_smoke_window"):
            fn()
            sync()
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("name") == "chip_smoke_window"
           and e.get("cat") == "user_annotation"]
    dev = [e for e in xs if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not win or not dev:
        log(f"  profile {label}: the trace holds no device events (window "
            f"{len(win)}); device busy share not measured")
        return None
    lo = float(win[0]["ts"])
    hi = lo + float(win[0]["dur"])
    lead = [e for e in xs if e.get("name") == "chip_smoke_lead_in"
            and e.get("cat") == "user_annotation"]

    def calls_in(a, b):
        return [e for e in xs if e.get("cat", "").startswith("cuda_")
                and a <= float(e["ts"]) <= b]

    def launched(calls):
        """The device records of ``calls`` (a graph's kernels carry its
        launch's correlation id)."""
        ids = {e.get("args", {}).get("correlation") for e in calls}
        return [e for e in dev if e.get("args", {}).get("correlation") in ids]

    marks = sorted((e for e in calls_in(float(lead[0]["ts"]), float(lead[0]["ts"])
                                        + float(lead[0]["dur"])) if "Launch" in e["name"]),
                   key=lambda e: float(e["ts"])) if lead else []
    if not marks or not launched(marks[-1:]):
        fail(f"profile {label}: the trace lost the last of the lead-in's "
             f"{PROFILE_LEAD_IN} marker kernels, so it may have cut the window's start")
    lost = len(marks) - len(launched(marks))
    # the window's own records: one the trace holds from before it is not
    # the window's
    mine = launched(calls_in(lo, hi))
    busy = busy_union([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in mine],
                      lo, hi)
    kernels = [e for e in mine if e["cat"] == "kernel"]
    # the host's launch calls (CUDA API events), CUDA graph replays among them
    calls = [e["name"] for e in xs if e.get("cat", "").startswith("cuda_")
             and "Launch" in e["name"] and lo <= float(e["ts"]) <= hi]
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (t + float(e["dur"]), n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    most = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5]
    # what the device ran of the port's kernels, by kernel name: the only
    # count of a CUDA graph's replays, whose launches no wrapper sees
    port = {label: sum(n for name, (_, n) in by_name.items() if key in name)
            for label, key in TRACE_KERNELS.items()}
    out = dict(window_ms=(hi - lo) / 1e3, device_busy_ms=busy / 1e3,
               busy_share=busy / (hi - lo), steps=steps,
               kernel_launches_per_step=len(kernels) / steps,
               host_launch_calls_per_step=len(calls) / steps,
               graph_launches_per_step=sum("Graph" in c for c in calls) / steps,
               copies_and_sets_per_step=(len(mine) - len(kernels)) / steps,
               port_kernels=port,
               records_not_from_window=len(dev) - len(mine), lead_in_lost=lost,
               kernel_ms_per_step=sum(float(e["dur"]) for e in kernels) / 1e3 / steps,
               top_kernels=[dict(name=n[:120], ms=t / 1e3, launches=c)
                            for n, (t, c) in top],
               most_launched=[dict(name=n[:120], ms=t / 1e3, launches=c)
                              for n, (t, c) in most])
    if keep_kernels:
        out["kernel_events"] = [(e["name"], float(e["ts"]), float(e["dur"])) for e in kernels]
    if sub is not None:
        recs = {"kernels": {}, "copies_and_sets": {}, "ranges": 0}
        for r in (e for e in xs if e.get("name") == sub and e.get("cat") == "user_annotation"):
            recs["ranges"] += 1
            t = float(r["ts"])
            for e in launched(calls_in(t, t + float(r["dur"]))):
                kind = "kernels" if e["cat"] == "kernel" else "copies_and_sets"
                recs[kind][e["name"][:80]] = recs[kind].get(e["name"][:80], 0) + 1
        out["sub_records"] = recs
    log(f"  profile {label} ({steps} step(s), torch.profiler CPU+CUDA, trace "
        f"{path.relative_to(ROOT)}): window {out['window_ms']:.2f} ms, device busy "
        f"{out['device_busy_ms']:.2f} ms = {100 * out['busy_share']:.1f}% (union of kernel, "
        f"copy and set intervals), {out['kernel_launches_per_step']:.0f} kernels and "
        f"{out['copies_and_sets_per_step']:.0f} copies/sets per step on the device from "
        f"{out['host_launch_calls_per_step']:.1f} launch calls of the host "
        f"({out['graph_launches_per_step']:.1f} of them CUDA graph launches), kernel time "
        f"{out['kernel_ms_per_step']:.2f} ms per step; the port's kernels launched from the "
        f"window: {port} ({out['records_not_from_window']} device records in the trace "
        f"were not; of the lead-in's {len(marks)} marker kernels the trace lost {lost})")
    for title, rows in (("most device time", out["top_kernels"]),
                        ("most launches", out["most_launched"])):
        log(f"    the five kernels with the {title} (ms over the window, launches):")
        for k in rows:
            log(f"    {k['ms']:8.3f} ms  {k['launches']:5d} x  {k['name']}")
    return out


def decode_profile(gw, cfg, np, torch, steps=8, label="decode_steps"):
    """Bring phase 3's stream to a steady decode (every lane admitted and
    decoding, nothing prefilling) on ``gw``, time ``steps`` scheduler
    steps (host clock, ending in a synchronize), then profile the next
    ``steps``.  The profiler's own host cost lengthens its window, so the
    device time it records is also given as a share of the unprofiled
    steps' time.  Leaves the stream mid-flight."""
    gw.__dict__.pop("_sample", None)           # drop record_rows's per-step copy
    submit_all(gw, cfg, np)
    while not (len(gw.scheduler.running) == gw.max_lanes and all(
            r.state.value == "running" for r in gw.scheduler.running)):
        if gw.step() is None:
            fail("profile: the stream drained before every lane decoded")
    kinds = []
    sync()
    t0 = time.perf_counter()
    kinds.extend(gw.step().kind for _ in range(steps))
    sync()
    plain_ms = 1e3 * (time.perf_counter() - t0) / steps
    captures = gw._graphs.captures if gw._graphs is not None else 0
    prof = profile_window(label, lambda: kinds.extend(
        gw.step().kind for _ in range(steps)), torch, steps)
    # a graph captured in the window ran its step once more, eagerly
    warmups = (gw._graphs.captures if gw._graphs is not None else 0) - captures
    if kinds != ["decode"] * (2 * steps):
        fail(f"profile: the windows ran {kinds}, not {2 * steps} decode steps")
    if prof is not None:
        prof["unprofiled_ms_per_step"] = plain_ms
        prof["busy_share_of_unprofiled"] = prof["device_busy_ms"] / steps / plain_ms
        log(f"  profile {label}: {steps} unprofiled steps before it took {plain_ms:.2f} ms "
            f"each (host clock, synchronized); the profiled device time "
            f"{prof['device_busy_ms'] / steps:.2f} ms a step is "
            f"{100 * prof['busy_share_of_unprofiled']:.1f}% of that")
        prof["warmups_in_window"] = warmups
        check_trace_launches(label, cfg, prof, [(gw, steps + warmups, 0)])
    return prof


def prefill_profile(gw, cfg, np, torch, steps=8, label="prefill_steps"):
    """Drain ``gw``, then submit phase 3's stream again (its graphs
    captured by a first drain, its prefix cache emptied so the chunks
    take the first drain's shapes) and profile its first ``steps``
    scheduler steps:
    prefill chunks (replays, or captures whose warm-up is the chunk) and
    decode steps; at least one chunk must be a replay.  The device trace
    must hold each decode step's kernels and, on the in-scan path, each
    chunk's ``masked_dequant`` launches, which no wrapper sees in a
    replay.  Leaves the stream mid-flight."""
    gw.__dict__.pop("_sample", None)
    gw.run()
    gw.prefix.drop_scope()
    submit_all(gw, cfg, np)
    dg, pg, st = gw._graphs, gw._prefill_graphs, gw.stats
    before = (st["resident_decode_steps"], dg.captures, st["prefill_chunks"], pg.captures,
              pg.replays)
    kinds = []
    prof = profile_window(label, lambda: kinds.extend(
        gw.step().kind for _ in range(steps)), torch, steps)
    decodes, d_caps, chunks, p_caps, p_reps = (
        a - b for a, b in zip((st["resident_decode_steps"], dg.captures, st["prefill_chunks"],
                               pg.captures, pg.replays), before))
    if prof is None:
        fail(f"profile {label}: the profile holds no device trace, so the chunks' kernels "
             f"cannot be counted")
    if chunks != p_caps + p_reps or not p_reps:
        fail(f"profile {label}: {chunks} prefill chunks in the window, {p_reps} replays and "
             f"{p_caps} captures; at least one replay expected")
    log(f"  profile {label}: the window ran {kinds}: {chunks} prefill chunks ({p_reps} "
        f"replays, {p_caps} captures), {decodes} decode steps ({d_caps} captures)")
    check_trace_launches(label, cfg, prof, [(gw, decodes + d_caps, chunks)])
    prof.update(prefill_chunks=chunks, prefill_replays=p_reps, prefill_captures=p_caps,
                decode_steps=decodes, decode_captures=d_caps)
    return prof


def check_trace_launches(label, cfg, prof, runs):
    """Fail unless the device trace of a window in which each gateway of
    ``runs`` (gateway, decodes, chunks) ran the decode step ``decodes``
    times (its steps, and the warm-ups of graphs captured in it) and
    ``chunks`` prefill chunks (replays, or captures' warm-ups) shows
    ``paged_attention``'s split kernel and ``paged_decode_write`` once a
    layer of each decode, and ``masked_dequant`` once per int8 leaf of
    every unit of each decode and chunk on the in-scan path (never
    elsewhere).  Through CUDA graphs this is the only count of what the
    replays launched."""
    from repro_torch.serving.quantized import qleaves

    units = cfg.pattern_units
    want = dict(paged_attention=0, paged_decode_write=0, masked_dequant=0)
    for gw, n, chunks in runs:
        in_scan = gw.quantized and not gw.materialize_int8_views
        leaves = sum(1 for _ in qleaves(gw._weights[gw.version]["units"])) if in_scan else 0
        want["paged_attention"] += units * n
        want["paged_decode_write"] += units * n
        want["masked_dequant"] += leaves * units * (n + chunks)
    total = sum(n for _, n, _ in runs)
    chunks = sum(c for _, _, c in runs)
    got = {k: prof["port_kernels"][k] for k in want}
    if got != want:
        fail(f"profile {label}: the trace shows {got} kernels in {total} runs of the decode "
             f"step and {chunks} prefill chunks, which give {want}")
    log(f"  profile {label}: the trace shows the kernels of {total} runs of the decode step "
        f"(steps and capture warm-ups) and {chunks} prefill chunks: {got}, combines "
        f"{prof['port_kernels']['paged_attention_combine']}")


# ------------------------------------------------------------ phase 3c
# the compiled decode step (one CUDA graph per view and table width, per
# version and width on the in-scan path) and the compiled prefill chunk
# (one per view, pow2 lane count and width) against the eager kernel
# path (both taken away through the slot's private ``_graphs`` and
# ``_prefill_graphs``), for float views and the in-scan int8 dequant, in
# turns: eager, graph, graph on phase 3's stream (the closing eager run
# cut to pay for phases 8c and 14c; ``STREAM_TURNS``, phase 13's too)
COMPILED_MODES = {"float": {}, "in_scan": dict(quantized=True)}
COMPILED_TURNS = ("eager", "graph", "graph", "eager")
STREAM_TURNS = ("eager", "graph", "graph")
# every compiled step family a gateway may hold (``ModelSlot.compile_steps``):
# the kernel-resident decode, the chunked prefill, and the bucket path's
# gather/scatter decode, bucket prefill and prefix-hit suffix prefill
GRAPH_FAMILIES = ("_graphs", "_prefill_graphs", "_gather_graphs", "_bucket_graphs",
                  "_suffix_graphs")
# decode steps timed in each turn of ``steady_turns``
TURN_STEPS = 4


def graph_families(gw):
    """``gw``'s compiled step families that are on, by attribute."""
    return {f: getattr(gw, f) for f in GRAPH_FAMILIES if getattr(gw, f) is not None}


class eager_route:
    """Inside it, ``gw``'s compiled steps are taken away (the eager
    route of every step); they come back, graphs and counts, after it."""

    def __init__(self, gw):
        self.gw = gw

    def __enter__(self):
        self.saved = graph_families(self.gw)
        for f in self.saved:
            setattr(self.gw, f, None)
        return self.gw

    def __exit__(self, *exc):
        for f, g in self.saved.items():
            setattr(self.gw, f, g)


def graph_report(gw):
    """Captures and replays of each family of ``gw`` and the bytes of
    their one memory pool, with a line of text."""
    fams = graph_families(gw)
    counts = {f.strip("_"): dict(captures=g.captures, replays=g.replays)
              for f, g in fams.items()}
    pool = next(iter(fams.values())).backend.pool_bytes() if fams else 0
    text = ("eager" if not fams else
            "graphs: " + ", ".join(f"{k} {v['captures']} captures / {v['replays']} replays"
                                   for k, v in counts.items())
            + f", pool {pool / 1e9:.3f} GB")
    return dict(families=counts, pool_bytes=pool, text=text)


def eager_steps_of(gw, m):
    """The forward steps ``gw`` ran through Python (so through the kernel
    wrappers, which count them): each family's capture warm-ups, and the
    steps of a kind no family compiled (``m``: its ``metrics()``)."""
    dec = gw._graphs if gw.kernel_decode else gw._gather_graphs
    pre = [g for g in ((gw._prefill_graphs,) if gw.chunked
                       else (gw._bucket_graphs, gw._suffix_graphs)) if g is not None]
    decodes = dec.captures if dec is not None else m["decode_steps"]
    prefills = (sum(g.captures for g in pre) if pre else
                m["prefill_chunks"] if gw.chunked else m["prefill_batches"])
    return decodes, prefills


def steady_turns(label, gw, jobs, steps=TURN_STEPS):
    """Submit ``jobs`` ((prompt, tier, new tokens)) to ``gw`` again, its
    graphs captured by a first drain, step until no request waits or
    prefills, then time decode steps in turns, COMPILED_TURNS (eager,
    graph, graph, eager), ``steps`` a turn, on the host clock with a
    synchronize on each side: the same gateway's graph replays beside its
    eager steps (``eager_route``) on the same lanes.  No graph may be
    captured in the window.  Returns each turn's ms a step and the
    medians.  Leaves the stream mid-flight."""
    import numpy as np

    gw.__dict__.pop("_sample", None)           # drop record_rows's per-step copy
    reqs = [gw.submit(p, license=t, max_new_tokens=n) for p, t, n in jobs]
    while any(r.state.value in ("queued", "prefilling") for r in reqs):
        if gw.step() is None:
            fail(f"{label}: the stream drained before every request decoded")
    lanes = sum(r.state.value == "running" for r in reqs)
    before = {f: g.captures for f, g in graph_families(gw).items()}
    if not before:
        fail(f"{label}: the gateway holds no compiled steps to time")
    turns = []
    for kind in COMPILED_TURNS:
        with (eager_route(gw) if kind == "eager" else contextlib.nullcontext()):
            sync()
            t0 = time.perf_counter()
            acts = [gw.step() for _ in range(steps)]
            sync()
        if [a.kind if a is not None else None for a in acts] != ["decode"] * steps:
            fail(f"{label}: a {kind} turn ran {acts}, not {steps} decode steps")
        turns.append((kind, 1e3 * (time.perf_counter() - t0) / steps))
    after = {f: g.captures for f, g in graph_families(gw).items()}
    if after != before:
        fail(f"{label}: graphs captured in the timed window: {before} -> {after}")
    out = dict(turns=turns, lanes=lanes, turn_steps=steps,
               graph_ms=float(np.median([ms for k, ms in turns if k == "graph"])),
               eager_ms=float(np.median([ms for k, ms in turns if k == "eager"])))
    log(f"  {label}: a steady decode step {out['graph_ms']:.2f} ms through the graphs against "
        f"{out['eager_ms']:.2f} ms eager on the same gateway ({lanes} lanes; turns "
        + ", ".join(f"{k} {ms:.2f}" for k, ms in turns)
        + f" ms, {steps} steps a turn, host clock, synchronized on each side)")
    return out


def same_tokens(label, reqs, ref_reqs, ref="the eager route"):
    """Greedy tokens of ``reqs`` identical to ``ref_reqs``' (the graphs
    run the eager route's kernels in its order)."""
    got, want = [r.out_tokens for r in reqs], [r.out_tokens for r in ref_reqs]
    if got != want:
        bad = [r.rid for r, a, b in zip(reqs, got, want) if a != b]
        fail(f"{label}: greedy tokens differ from {ref}'s on requests {bad}")
    log(f"  {label}: greedy tokens identical to {ref}'s on {len(reqs)}/{len(reqs)} requests")


def compiled_run(label, gw, cfg, np, torch, graphs, profile):
    """Serve phase 3's stream on ``gw`` (its decode and prefill graphs
    taken away unless ``graphs``), the launch counters zeroed just
    before and read just after; check the wrappers' counts against what
    really ran eagerly: ``paged_attention`` and ``paged_decode_write``
    once a layer of every eager decode step, or through the graphs of
    every decode capture's warm-up (a capture and a replay launch through
    no wrapper), ``masked_dequant`` once per int8 leaf of every unit of
    those steps and of every eager prefill chunk, or through the graphs
    of every prefill capture's warm-up (which is its chunk: every other
    chunk must be a replay).  Then, with ``profile``, the 8-step decode
    profile of phase 3, whose device trace must show each decode step's
    kernels."""
    from repro_torch.kernels import ops
    from repro_torch.serving.compiled import table_width
    from repro_torch.serving.quantized import qleaves

    if not graphs:
        gw._graphs = None
        gw._prefill_graphs = None
    ops.reset_launches()
    reqs, t = serve(label, gw, cfg, np, torch)
    launches = dict(ops.LAUNCHES)
    st = gw.stats
    units = cfg.pattern_units
    leaves = sum(1 for _ in qleaves(gw._weights[gw.version]["units"])) * units
    decodes, chunks = st["resident_decode_steps"], st["prefill_chunks"]
    dg, pg = gw._graphs, gw._prefill_graphs
    captures = dg.captures if graphs else 0
    replays = dg.replays if graphs else 0
    p_caps = pg.captures if graphs else 0
    p_reps = pg.replays if graphs else 0
    eager = captures if graphs else decodes
    eager_chunks = p_caps if graphs else chunks
    want = dict(paged_attention=units * eager, paged_decode_write=units * eager,
                masked_dequant=leaves * (eager + eager_chunks))
    got = {k: launches[k] for k in want}
    if got != want:
        fail(f"{label}: launches {got}, the eager steps and chunks give {want}")
    bpl = gw.pool.blocks_per_lane
    # the kernel path's widths are powers of two (and blocks_per_lane)
    widths = len({table_width(n, bpl) if gw.decode_kernels else n for n in range(1, bpl + 1)})
    views = 1 if gw.quantized and not gw.materialize_int8_views else len(gw.tiers)
    most = widths * views
    # prefill keys: pow2 lane counts up to max_batch times pow2 widths
    lanes = len({min(gw.max_batch, 1 << (n - 1).bit_length())
                 for n in range(1, gw.max_batch + 1)})
    most_p = lanes * widths * views
    if replays != (decodes if graphs else 0) or (graphs and not 0 < captures <= most):
        fail(f"{label}: {replays} replays and {captures} captures (at most {most}) "
             f"for {decodes} decode steps")
    if graphs and not (p_reps == chunks - p_caps and 0 < p_caps <= most_p):
        fail(f"{label}: {p_reps} prefill replays and {p_caps} captures (at most {most_p}) "
             f"for {chunks} prefill chunks")
    t.update(launches=launches, replays=replays, captures=captures,
             resident_decode_steps=decodes, prefill_replays=p_reps, prefill_captures=p_caps)
    if graphs:
        t["graphs_live"] = len(dg)
        t["prefill_graphs_live"] = len(pg)
        t["graph_pool_gb"] = dg.backend.pool_bytes() / 1e9
    log(f"  {label}: launches {got} (as the eager steps give: {units} layers x {eager} "
        f"{'warm-ups' if graphs else 'decode steps'}"
        + (f", {leaves} int8 leaves x ({eager} + {eager_chunks} "
           f"{'prefill warm-ups' if graphs else 'prefill chunks'})" if leaves else "")
        + f"); decode {captures} captures, {replays} replays; prefill {p_caps} captures, "
        f"{p_reps} replays of {chunks} chunks"
        + (f"; {t['graphs_live']} decode and {t['prefill_graphs_live']} prefill graphs live, "
           f"their pool {t['graph_pool_gb']:.3f} GB" if graphs else ""))
    if profile:
        t["decode_profile"] = decode_profile(gw, cfg, np, torch,
                                             label=label.replace(" ", "_"))
        if t["decode_profile"] is None:
            fail(f"{label}: the profile holds no device trace, so the decode steps' "
                 f"kernels cannot be counted")
    return [r.out_tokens for r in reqs], t


def compiled_phase(cfg, params, tiers, np, torch, want_tokens):
    """Phase 3c: each mode served in turns, eager and through the graphs;
    every run's greedy tokens must equal ``want_tokens[mode]`` (phase 3's
    float stream and its int8 stream through materialized views)."""
    from repro_torch.serving import LicensedGateway

    out = {}
    for mode, kw in COMPILED_MODES.items():
        runs = []
        for i, path in enumerate(STREAM_TURNS):
            gw = LicensedGateway(cfg, params, tiers=tiers, **GEOMETRY, **kw)
            toks, t = compiled_run(f"3c {mode} {path} run {i + 1}", gw, cfg, np, torch,
                                   graphs=path == "graph", profile=i != 1)
            if toks != want_tokens[mode]:
                fail(f"3c {mode} {path} run {i + 1}: greedy tokens differ from phase 3's "
                     f"{'float' if mode == 'float' else 'materialized int8'} stream")
            runs.append(dict(path=path, **t))
            if mode == "in_scan" and i == 2:
                profiled = gw       # its prefill window is profiled after the runs
            del gw
            gc.collect()
            torch.cuda.empty_cache()
        if mode == "in_scan":
            # last of the phase's profiles: a late session of a long process
            # can lose device records, the more the sessions before it
            runs[2]["prefill_profile"] = prefill_profile(
                profiled, cfg, np, torch, label=f"3c_{mode}_graph_run_3_prefill")
            del profiled
            gc.collect()
            torch.cuda.empty_cache()
        ms = {p: [1e3 * r["serve_s"] / (r["decode_steps"] + r["prefill_chunks"])
                  for r in runs if r["path"] == p] for p in ("eager", "graph")}
        tps = {p: [r["tokens"] / r["serve_s"] for r in runs if r["path"] == p]
               for p in ("eager", "graph")}
        prof = {r["path"]: r["decode_profile"] for r in runs if "decode_profile" in r}
        p50 = {k: [r["prefill"]["chunk_p50_synced_ms"].get(k) for r in runs]
               for k in ("eager", "replay", "capture")}
        p50 = {k: [v for v in vs if v is not None] for k, vs in p50.items()}
        log(f"  3c {mode}: greedy tokens identical in all {len(runs)} runs and to phase 3's "
            f"{'float' if mode == 'float' else 'materialized int8'} stream; ms per step "
            f"eager {ms['eager']} against graph {ms['graph']}; tokens/s eager "
            f"{tps['eager']} against graph {tps['graph']}; prefill chunk p50 (synchronized) "
            f"eager {p50['eager']} against replayed {p50['replay']} and captured "
            f"{p50['capture']} ms")
        if len(prof) == 2 and all(prof.values()):
            e, g = prof["eager"], prof["graph"]
            log(f"  3c {mode}: steady decode (8 unprofiled steps) eager "
                f"{e['unprofiled_ms_per_step']:.2f} against graph "
                f"{g['unprofiled_ms_per_step']:.2f} ms a step; launch calls of the host "
                f"{e['host_launch_calls_per_step']:.1f} against "
                f"{g['host_launch_calls_per_step']:.1f} a step; device busy "
                f"{100 * e['busy_share_of_unprofiled']:.1f}% against "
                f"{100 * g['busy_share_of_unprofiled']:.1f}% of the unprofiled step")
        out[mode] = dict(runs=runs, ms_per_step=ms, tokens_per_s=tps, chunk_p50_ms=p50)
    return out


# ------------------------------------------------------------ phase 3d
# long prompts through the compiled chunked prefill, full tier, float
# views, phase 3's weights: (a) 4 prompts of 1,024 tokens in one
# micro-batch, served with eager prefill and through the prefill graphs,
# two waves each (the second finds every graph captured); (b) 2 prompts
# of 4,096 tokens through the graphs only
LONG_A = dict(prompts=4, tokens=1024, waves=2)
LONG_B = dict(prompts=2, tokens=4096, waves=1)
LONG_NEW = 8


def long_run(label, cfg, params, np, torch, *, prompts, tokens, waves, graphs, seed):
    """Serve ``waves`` waves of ``prompts`` random prompts of ``tokens``
    tokens (from ``seed``) on a fresh default gateway with ``max_batch``
    = ``prompts``, its prefill graphs taken away unless ``graphs``.  Each
    scheduler step is timed on the host clock between two synchronizes,
    and so is every prefill capture (its warm-up, which is the chunk,
    included).  Returns the requests, their logits rows and a summary."""
    from repro_torch.serving import LicensedGateway

    gw = LicensedGateway(cfg, params, max_batch=prompts, max_prompt=tokens,
                         max_new_cap=LONG_NEW)
    gw.view_for("full")
    if not graphs:
        gw._prefill_graphs = None
    pg = gw._prefill_graphs
    rows = record_rows(gw)
    steps = {"prefill": [], "decode": []}
    capture_s = []
    step = gw.step

    def timed_step(**kw):
        sync()
        t0 = time.perf_counter()
        act = step(**kw)
        sync()
        if act is not None:
            steps[act.kind].append(time.perf_counter() - t0)
        return act

    gw.step = timed_step
    if pg is not None:
        capture = pg._capture

        def timed_capture(*a):
            sync()
            t0 = time.perf_counter()
            graph = capture(*a)
            sync()
            capture_s.append(time.perf_counter() - t0)
            return graph

        pg._capture = timed_capture
    rng = np.random.default_rng(seed)
    reqs, out = [], dict(waves=[])
    for w in range(waves):
        wave = [gw.submit(rng.integers(0, cfg.vocab_size, tokens, dtype=np.int32),
                          max_new_tokens=LONG_NEW) for _ in range(prompts)]
        caps0, chunks0 = (pg.captures if pg else 0), len(steps["prefill"])
        t0 = time.perf_counter()
        gw.run()
        sync()
        dt = time.perf_counter() - t0
        bad = [r.rid for r in wave if r.state.value != "done"
               or len(r.out_tokens) != LONG_NEW
               or not all(0 <= t < cfg.vocab_size for t in r.out_tokens)]
        if bad:
            fail(f"{label}: requests {bad} did not finish with {LONG_NEW} valid tokens")
        ttft = [r.first_token_t - r.submit_t for r in wave]
        chunk = steps["prefill"][chunks0:]
        out["waves"].append(dict(
            serve_s=dt, ttft_s=ttft, ttft_p50_s=float(np.median(ttft)),
            chunks=len(chunk), chunk_p50_ms=1e3 * float(np.median(chunk)),
            captures=(pg.captures if pg else 0) - caps0))
        reqs += wave
    m = gw.metrics()
    pre = prefill_report(gw)
    chunks = gw.stats["prefill_chunks"]
    out.update(prefill=pre["numbers"], prefill_chunks=chunks,
               ttft_hist_p50_s=m["latency"]["ttft_s"]["p50"],
               decode_p50_ms=1e3 * float(np.median(steps["decode"])),
               decode_captures=gw._graphs.captures,
               graph_pool_gb=gw._graphs.backend.pool_bytes() / 1e9,
               capture_s=capture_s)
    if pg is not None and pg.replays != chunks - pg.captures:
        fail(f"{label}: {pg.replays} prefill replays and {pg.captures} captures for "
             f"{chunks} chunks")
    for i, wv in enumerate(out["waves"]):
        log(f"  {label} wave {i + 1}: {prompts} x {tokens} tokens, {LONG_NEW} new each, in "
            f"{wv['serve_s']:.2f} s; TTFT p50 {wv['ttft_p50_s']:.3f} s (host clock, each step "
            f"synchronized); {wv['chunks']} prefill chunks, p50 {wv['chunk_p50_ms']:.2f} ms "
            f"(synchronized); {wv['captures']} prefill captures")
    log(f"  {label}: {pre['text']}; decode step p50 {out['decode_p50_ms']:.2f} ms "
        f"({out['decode_captures']} decode captures); graph pool "
        f"{out['graph_pool_gb']:.3f} GB"
        + (f"; prefill captures took {sum(capture_s):.2f} s (their warm-up chunks included; "
           f"each {[round(c, 3) for c in capture_s]} s)" if pg is not None else ""))
    del gw
    gc.collect()
    torch.cuda.empty_cache()
    return reqs, rows, out


def long_prompt_phase(cfg, params, np, torch):
    """Phase 3d (see the module docstring).  (a)'s greedy tokens through
    the graphs must equal the eager prefill's, or part at a near-tie;
    (a) may capture at most 7 widths x 1 lane bucket, (b) 9, and (a)'s
    second wave nothing."""
    out = {}
    got = {}
    for path in ("eager", "graph"):
        got[path] = long_run(f"3d (a) {path}", cfg, params, np, torch, **LONG_A,
                             graphs=path == "graph", seed=SEED + 8)
        out[f"a_{path}"] = got[path][2]
    g = out["a_graph"]
    if not (0 < g["prefill"]["prefill_captures"] <= 7 and g["waves"][1]["captures"] == 0):
        fail(f"3d (a): {g['prefill']['prefill_captures']} prefill captures (at most 7), "
             f"{g['waves'][1]['captures']} in the second wave (none)")
    out["a_parts"] = near_ties("3d (a) graph", got["graph"][0], got["eager"][0],
                               got["graph"][1], got["eager"][1], cfg.vocab_size,
                               ref="eager prefill")
    e = out["a_eager"]
    log(f"  3d (a): TTFT p50 by wave eager {[w['ttft_p50_s'] for w in e['waves']]} against "
        f"graph {[w['ttft_p50_s'] for w in g['waves']]} s; chunk p50 eager "
        f"{[w['chunk_p50_ms'] for w in e['waves']]} against graph "
        f"{[w['chunk_p50_ms'] for w in g['waves']]} ms")
    del got
    _, _, b = long_run("3d (b) graph", cfg, params, np, torch, **LONG_B, graphs=True,
                       seed=SEED + 9)
    if not 0 < b["prefill"]["prefill_captures"] <= 9:
        fail(f"3d (b): {b['prefill']['prefill_captures']} prefill captures (at most 9)")
    out["b_graph"] = b
    return out


# ------------------------------------------------------------ phase 3b
# the shared-prefix stream: one 48-token system prefix (three full
# blocks) and an own suffix of 1-16 tokens per request, alternating
# tiers, then exact repeats of four earlier prompts (a full match capped
# at len - 1, and the CoW of a partial tail at the first decode); served
# in two waves, the first one request per tier, so the second finds
# both tiers' prefixes cached
SYS_TOKENS = 48
SHARED_N = 16
REPEATS = [0, 1, 2, 5]
SHARED_NEW = 16
# num_blocks of run (c): 2 of the 8 lanes' worth of 16-token blocks, so
# retained chains are evicted and running requests preempted
SMALL_POOL = 12


def shared_stream(cfg, np):
    """(tier, prompt) pairs of the shared-prefix stream, from ``SEED``."""
    rng = np.random.default_rng(SEED + 6)
    head = rng.integers(0, cfg.vocab_size, SYS_TOKENS, dtype=np.int32)
    out = []
    for i in range(SHARED_N):
        tail = rng.integers(0, cfg.vocab_size, 1 + (7 * i) % 16, dtype=np.int32)
        out.append(("free" if i % 2 else "full", np.concatenate([head, tail])))
    return out + [out[i] for i in REPEATS]


def guard_decode_writes(gw):
    """Fail the run if a decode step's write target (block ``pos // bs``
    of a lane) is shared when the step launches: ``_grow_block_tables``
    must have copied it first.  Returns the count of checked writes."""
    grow = gw._grow_block_tables
    checked = [0]

    def guarded(reqs):
        keep = grow(reqs)
        for r in keep:
            b = r.blocks[r.pos // gw.pool.block_size]
            if gw.pool.allocator.refcount(b) != 1:
                fail(f"request {r.rid}: decode would write block {b} with "
                     f"{gw.pool.allocator.refcount(b)} references")
            checked[0] += 1
        return keep

    gw._grow_block_tables = guarded
    return checked


def prefix_run(label, gw, stream, np, tier=None):
    """Serve ``stream`` (every request in ``tier`` when given) in its two
    waves; every request must finish and, after the drain, the allocator
    must hold only the prefix tree's references.  Returns the requests,
    their logits rows and a summary."""
    for t in ({tier} if tier else {t for t, _ in stream}):
        gw.view_for(t)                     # views first, as in phase 3
    checked = guard_decode_writes(gw)
    rows = record_rows(gw)
    reqs = []
    t0 = time.perf_counter()
    for wave in (stream[:2], stream[2:]):
        reqs += [gw.submit(p, license=tier or t, max_new_tokens=SHARED_NEW)
                 for t, p in wave]
        gw.run()
    sync()
    dt = time.perf_counter() - t0
    bad = [r.rid for r in reqs if r.state.value != "done"
           or len(r.out_tokens) != SHARED_NEW]
    if bad:
        fail(f"{label}: requests {bad} did not finish")
    m = gw.metrics()
    pc = m["prefix_cache"]
    held = gw.pool.allocator.num_held
    if held != (pc["retained_blocks"] if pc["enabled"] else 0) or \
            (pc["enabled"] and held != pc["cached_blocks"]):
        fail(f"{label}: after the drain the allocator holds {held} blocks, "
             f"the prefix tree {pc}")
    steps = m["decode_steps"] + (m["prefill_chunks"] if gw.chunked else m["prefill_batches"])
    san = gw.sanitizer
    if san is not None and san.shadow != dict(gw.pool.allocator._ref):
        fail(f"{label}: the sanitizer's shadow refcounts differ from the allocator's")
    out = dict(serve_s=dt, tokens=m["tokens_generated"],
               tokens_per_s=m["tokens_generated"] / dt, steps=steps,
               ms_per_step=1e3 * dt / steps, decode_writes_checked=checked[0],
               **{k: m[k] for k in ("decode_steps", "prefill_chunks",
                                    "prefill_lane_tokens", "prefix_tokens_reused",
                                    "cow_copies", "preempted", "max_blocks_in_use")},
               prefix_cache=pc,
               sanitizer=None if san is None else dict(
                   shadow_blocks=len(san.shadow), step_shapes=san.retrace.stats()))
    log(f"  {label}: {len(reqs)} requests, {out['tokens']} tokens in {dt:.2f} s "
        f"({out['tokens_per_s']:.1f} tokens/s, {out['ms_per_step']:.1f} ms per scheduler "
        f"step over {steps}); prefill_chunks {out['prefill_chunks']}, prefill_lane_tokens "
        f"{out['prefill_lane_tokens']}, prefix_tokens_reused {out['prefix_tokens_reused']}, "
        f"cow_copies {out['cow_copies']}, preempted {out['preempted']}, decode writes "
        f"checked private {checked[0]}")
    pre = prefill_report(gw)
    out["prefill"] = pre["numbers"]
    log(f"  {label}: {pre['text']}")
    log(f"  {label}: prefix_cache {json.dumps(pc)}")
    if san is not None:
        log(f"  {label}: sanitized (shadow refcounts on every allocator call, "
            f"check_decode_writes before each decode, check_drained at each drain): "
            f"clean; {len(san.shadow)} blocks held at the end, step shapes "
            f"{san.retrace.stats()}")
    return reqs, rows, out


def near_ties(label, reqs, ref_reqs, rows, ref_rows, vocab, ref="the cold run",
              capped=True):
    """Greedy tokens of ``reqs`` against ``ref``'s (``ref_reqs``):
    identical, or each request's first parting a near-tie by phase 4's
    rule (the reference's gap between the two tokens at most the lane's
    max |logit diff|, and that diff within 0.05 x max(|logit|, 1) of the
    reference row).  A gap equal to the diff counts: bf16 logits lie on a
    grid, so both are multiples of one step, and a shift of the diff
    brings the two logits to a tie, which argmax breaks towards the lower
    id (musicgen-large's 2,048 logits near 3 sit 0.0156 apart).
    ``capped=False`` drops the cap on the diff: a MoE
    model's routes swap experts where their routers nearly tie, a jump no
    rounding tolerance bounds (``moe_route_check`` holds the cap with the
    picks pinned)."""
    parts = stream_parts(reqs, ref_reqs, rows, ref_rows, vocab)
    split = [p for p in parts if p["step"] is not None]
    for p in split:
        p["tol"] = 0.05 * max(p["plain_max_abs"], 1.0)
        log(f"  {label}: request {p['request']} parts from {ref} at step "
            f"{p['step']}: token {p['kernel_token']} vs {p['plain_token']}; reference gap "
            f"{p['plain_gap']:.4f}, lane max |logit diff| {p['lane_max_abs_diff']:.4f} "
            f"(tol {p['tol']:.4f})")
    wide = [p["request"] for p in split
            if not (p["plain_gap"] <= p["lane_max_abs_diff"]
                    and (p["lane_max_abs_diff"] <= p["tol"] or not capped))]
    if wide:
        fail(f"{label}: requests {wide} part from {ref} at a step that is not a near-tie")
    same = sum(p["step"] is None for p in parts)
    log(f"  {label}: greedy tokens identical to {ref}'s on {same}/{len(parts)} "
        f"requests, every parting a near-tie")
    return parts


def prefix_phase(cfg, params, tiers, np, device="cuda"):
    """Phase 3b: the shared-prefix stream (a) with the prefix cache, (b)
    without, (c) with it on a pool of ``SMALL_POOL`` blocks, and (d) with
    it through int8 views; (a) and (c) sanitized.  Returns the summary of
    each run."""
    from repro_torch.serving import LicensedGateway

    stream = shared_stream(cfg, np)
    runs, got = {}, {}
    for name, kw in (("a_prefix", dict(sanitize=True)), ("b_cold", dict(prefix_cache=False)),
                     ("c_small_pool", dict(num_blocks=SMALL_POOL, sanitize=True)),
                     ("d_int8", dict(quantized=True, materialize_int8_views=True))):
        gw = LicensedGateway(cfg, params, tiers=tiers, device=device, **kw, **GEOMETRY)
        got[name] = prefix_run(f"3b ({name})", gw, stream, np)
        runs[name] = got[name][2]
        del gw
        gc.collect()
    a, b, c, d = (runs[k] for k in ("a_prefix", "b_cold", "c_small_pool", "d_int8"))
    if not (a["prefix_tokens_reused"] > 0 and a["cow_copies"] > 0
            and a["prefill_lane_tokens"] < b["prefill_lane_tokens"]):
        fail(f"3b: the prefix cache saved nothing: {a} against {b}")
    if not (c["prefix_cache"]["evicted_blocks"] > 0 and c["preempted"] > 0):
        fail(f"3b: the small pool neither evicted nor preempted: {c}")
    if not (d["prefix_tokens_reused"] > 0 and d["cow_copies"] > 0):
        fail(f"3b: the int8 run reused nothing: {d}")
    cold = got["b_cold"]
    for name in ("a_prefix", "c_small_pool"):
        reqs, rows, _ = got[name]
        runs[name]["parts"] = near_ties(f"3b ({name})", reqs, cold[0], rows, cold[1],
                                        cfg.vocab_size)
    log(f"  3b: prefill lane-tokens {a['prefill_lane_tokens']} with the cache against "
        f"{b['prefill_lane_tokens']} without ({b['prefill_lane_tokens'] - a['prefill_lane_tokens']} "
        f"saved); {a['ms_per_step']:.1f} against {b['ms_per_step']:.1f} ms per step, "
        f"{a['serve_s']:.2f} against {b['serve_s']:.2f} s")
    del got
    return runs


# ------------------------------------------------------------ phase 7
CAL_PROMPTS = (16, 64)                 # eval_fn's teacher-forced batch
CAL = dict(k_intervals=10, interval_mode="quantile", refine_steps=4)
CAL_TARGET, CAL_TOL = 0.9, 0.02


def agreement_eval(cfg, params, np, torch, device="cuda"):
    """``eval_fn`` of Algorithm 1: the top-1 agreement of a weight set's
    argmax with ``params``' own over seeded teacher-forced prompts,
    through ``models.model.forward`` with no cache.  Returns the
    function and the list its call times go to."""
    from repro_torch.models.model import forward

    rng = np.random.default_rng(SEED + 7)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, CAL_PROMPTS,
                                         dtype=np.int32)).to(device)

    def top1(p):
        with torch.no_grad():
            return forward(p, cfg, toks)[0][..., : cfg.vocab_size].argmax(-1)

    want = top1(params)
    times = []

    def eval_fn(p):
        t0 = time.perf_counter()
        acc = (top1(p) == want).float().mean().item()
        times.append(time.perf_counter() - t0)
        return acc

    return eval_fn, times


def same_bits(a, b, torch):
    bits = torch.int16 if a.element_size() == 2 else torch.int32
    return a.dtype == b.dtype and bool(torch.equal(a.view(bits), b.view(bits)))


def calibration_phase(cfg, params, np, torch, device="cuda"):
    """Phase 7: Algorithm 1 on ``params``, the tier's checks, then the
    shared-prefix stream served in it with the prefix cache."""
    from repro_torch.core import licensing
    from repro_torch.core.pytree_io import flatten_params
    from repro_torch.serving import LicensedGateway

    out = {}
    flat = flatten_params(params)
    maskable = [n for n, t in flat.items()
                if not licensing.is_dynamics_param(n) and t.ndim >= 2]
    leaves = [flat[n] for n in maskable]
    n_weights = sum(t.numel() for t in leaves)
    # the count route on the card against one sort, on a real leaf's slice
    probe = [flat["units/b0/mixer/wq"][0]]
    ks = np.linspace(0, probe[0].numel() - 1, 11).astype(np.int64)
    if licensing._order_stats_16bit(probe, ks) != licensing._order_stats_sorted(probe, ks):
        fail("7: the bit-pattern count and a sort give different order statistics")
    sync()
    t0 = time.perf_counter()
    edges = licensing.magnitude_quantiles(leaves, np.linspace(0.0, 1.0, CAL["k_intervals"] + 1))
    sync()
    out["edges_s"] = time.perf_counter() - t0
    out["edges"] = edges.tolist()
    log(f"  quantile edges of {n_weights} magnitudes over {len(leaves)} leaves "
        f"({cfg.dtype_name}) in {out['edges_s']:.3f} s: {out['edges']}")

    eval_fn, times = agreement_eval(cfg, params, np, torch, device)
    sync()
    t0 = time.perf_counter()
    tier, trace = licensing.calibrate_license(params, eval_fn, CAL_TARGET,
                                              tolerance=CAL_TOL, tier_name="cal", **CAL)
    sync()
    out.update(calibrate_s=time.perf_counter() - t0, evals=len(times),
               eval_ms_median=1e3 * float(np.median(times)),
               eval_ms_max=1e3 * max(times), steps=len(trace),
               layer_order=maskable, accuracy=tier.accuracy,
               trace=[dict(interval=s.interval, layer=s.layer, accuracy=s.accuracy)
                      for s in trace],
               masks={k: [list(iv) for iv in v] for k, v in tier.masks.items()})
    log(f"  calibrate_license (target {CAL_TARGET}, tolerance {CAL_TOL}, {CAL}): "
        f"{len(trace)} steps, {len(times)} evals of {CAL_PROMPTS[0]} x {CAL_PROMPTS[1]} "
        f"tokens (median {out['eval_ms_median']:.1f} ms, max {out['eval_ms_max']:.1f} ms), "
        f"{out['calibrate_s']:.2f} s in all; layer order {maskable}")
    for s in trace:
        log(f"    cut [{s.interval[0]:.6g}, {s.interval[1]:.6g}) on {s.layer}: "
            f"agreement {s.accuracy:.4f}")
    reached = tier.accuracy <= CAL_TARGET + CAL_TOL
    unreachable = len(trace) == CAL["k_intervals"] * len(maskable)
    if not (reached or unreachable):
        fail(f"7: the tier's agreement {tier.accuracy} misses the target "
             f"{CAL_TARGET} + {CAL_TOL} and the trace did not exhaust the intervals")
    again = eval_fn(licensing.apply_license(params, tier))
    if again != tier.accuracy:
        fail(f"7: eval_fn(apply_license(params, tier)) = {again}, the tier "
             f"says {tier.accuracy}")
    out["license_stats"] = licensing.license_stats(params, tier)
    log(f"  tier 'cal': agreement {tier.accuracy:.4f} (re-evaluated {again:.4f}), "
        f"license_stats {out['license_stats']}, masks {out['masks']}")

    gw = LicensedGateway(cfg, params, tiers={"cal": tier}, device=device, **GEOMETRY)
    want = flatten_params(licensing.apply_license(params, tier))
    view = flatten_params(gw.view_for("cal")[0])
    bad = [n for n in want if not same_bits(view[n], want[n], torch)]
    if bad or set(view) != set(want):
        fail(f"7: the gateway's view of the calibrated tier differs from "
             f"apply_license in {bad[:5]}")
    del want, view
    log("  the gateway's float view of tier 'cal' equals apply_license bit for bit")
    stream = shared_stream(cfg, np)
    _, _, served = prefix_run("7 (tier cal, prefix cache)", gw, stream, np, tier="cal")
    if served["prefix_cache"]["hits"] <= 0:
        fail("7: the shared-prefix stream in the calibrated tier had no prefix hits")
    out["served"] = served
    del gw
    gc.collect()
    return out


# ------------------------------------------------------------ phase 7b
# the fleet: two licensed models behind one FleetGateway on phase 3's
# weights, each a slot with GEOMETRY serving phase 3's stream: float views
# (tiers full and free) and the int8 store dequantized inside every step;
# (a) without a budget, (b) under a budget of FLEET_BUDGET_BLOCKS blocks
# (the two pools hold 96), the stream in two waves a slot so the first
# wave's retained prompt chains are there to reclaim, with three tenants
FLEET_SLOTS = {"qwen-float": {}, "qwen-int8": dict(quantized=True)}
FLEET_BUDGET_BLOCKS = 40
FLEET_WAVE = 6                          # requests a slot in the first wave
# the tenants of run (b): the stream under "open" (both streams' 24
# requests are its burst, so one more is rate-limited), "narrow" on the
# int8 slot's free tier alone, revoked while two of its requests queue,
# and "broke" with no quota
FLEET_TENANTS = {"open": dict(entitlements=("*:*",), rate=1e-3, burst=24.0),
                 "narrow": dict(entitlements=("qwen-int8:free",), max_concurrent=4),
                 "broke": dict(max_concurrent=0)}
PORT_EXTRA = ("decode_path.kernels",)   # the port's key beside the JAX schema


def fleet_build(cfg, params, tiers, device, **kw):
    """A FleetGateway with the two slots, each slot's views built first
    (as phase 3 does), so the timed runs hold no view build."""
    from repro_torch.serving import FleetGateway

    fleet = FleetGateway(**kw)
    for name, mode in FLEET_SLOTS.items():
        fleet.add_model(name, cfg, params, tiers=tiers, device=device, **mode, **GEOMETRY)
    for gw in fleet.gateways.values():
        for tier in ("full", "free"):
            gw.view_for(tier)
    return fleet


def cross_evictions(fleet):
    """Count retained blocks that ``_ensure_headroom`` evicted from each
    slot while another slot asked for room: wrap the fleet's hook (to
    know who asks) and each slot's ``PrefixCache.evict``."""
    asking, got = [], {name: 0 for name in fleet.gateways}
    ensure = fleet._ensure_headroom

    def ensure_headroom(gw, n):
        asking.append(gw.model)
        try:
            return ensure(gw, n)
        finally:
            asking.pop()

    fleet._ensure_headroom = ensure_headroom
    for name, gw in fleet.gateways.items():
        evict = gw.prefix.evict

        def counted(n, evict=evict, name=name):
            freed = evict(n)
            if asking and asking[-1] != name:
                got[name] += freed
            return freed
        gw.prefix.evict = counted
    return got


class FleetTenants:
    """Run (b)'s tenant script.  Before the first wave: narrow's
    ``full`` request (not entitled), broke's request (no quota) and
    narrow's first two requests, the int8 slot's oldest (so no
    preemption, which requeues the youngest, takes them back to the
    queue).  Once both are past the queue: narrow's next two (queued), a
    fifth (over its quota of 4), then the revocation.  After the second
    wave's submissions: open's 25th request (rate-limited)."""

    def __init__(self, fleet, cfg, np):
        self.fleet = fleet
        rng = np.random.default_rng(SEED + 7)
        self.prompts = [rng.integers(0, cfg.vocab_size, 20 + 5 * i, dtype=np.int32)
                        for i in range(5)]
        self.rejected = {}
        self.narrow = []
        self.revoked = False

    def _submit(self, model, tenant, tier, prompt):
        return self.fleet.submit(model, prompt, tenant=tenant, license=tier, max_new_tokens=16)

    def before_wave(self, wave):
        if wave == 0:
            self.rejected["narrow full"] = self._submit("qwen-int8", "narrow", "full",
                                                        self.prompts[0])
            self.rejected["broke"] = self._submit("qwen-float", "broke", "free",
                                                  self.prompts[0])
            self.narrow = [self._submit("qwen-int8", "narrow", "free", self.prompts[i])
                           for i in range(2)]

    def after_submit(self, wave):
        if wave == 1:
            self.rejected["open rate"] = self._submit("qwen-float", "open", "full",
                                                      self.prompts[0])

    def after_step(self):
        if self.revoked or any(r.state.value == "queued" for r in self.narrow[:2]):
            return
        self.narrow += [self._submit("qwen-int8", "narrow", "free", self.prompts[i])
                        for i in (2, 3)]
        self.rejected["narrow quota"] = self._submit("qwen-int8", "narrow", "free",
                                                     self.prompts[4])
        self.states_at_revoke = [r.state.value for r in self.narrow]
        self.fleet.tenants.revoke("narrow", "qwen-int8", "free")
        self.revoked = True

    def check(self, label):
        want = {"narrow full": "not entitled", "broke": "quota", "open rate": "rate-limited",
                "narrow quota": "quota"}
        for key, text in want.items():
            r = self.rejected[key]
            if r.state.value != "rejected" or text not in (r.error or ""):
                fail(f"{label}: {key} request {r.state.value} ({r.error}), expected a "
                     f"rejection for {text!r}")
        if not self.revoked or self.states_at_revoke[2:] != ["queued", "queued"] \
                or "queued" in self.states_at_revoke[:2]:
            fail(f"{label}: narrow's requests at the revocation "
                 f"{getattr(self, 'states_at_revoke', None)}: expected two past the queue, "
                 f"two queued")
        got = [(r.state.value, r.preemptions, r.error) for r in self.narrow]
        if [g[:2] for g in got] != [("done", 0), ("done", 0), ("rejected", 0),
                                     ("rejected", 0)] or \
                not all("revoked while queued" in (e or "") for _, _, e in got[2:]):
            fail(f"{label}: narrow's requests ended {got}: the two running must drain, "
                 f"the two queued be rejected at batch formation")
        stats = self.fleet.tenants.stats()
        tokens = sum(len(r.out_tokens) for r in self.narrow)
        want = {"open": (25, 24, 24, 1), "narrow": (6, 4, 2, 4), "broke": (1, 0, 0, 1)}
        for name, (sub, adm, done, rej) in want.items():
            s = stats[name]
            if (s["submitted"], s["admitted"], s["completed"], s["quota_rejections"],
                    s["inflight"]) != (sub, adm, done, rej, 0):
                fail(f"{label}: tenant {name} {s}, expected submitted {sub}, admitted "
                     f"{adm}, completed {done}, quota_rejections {rej}, inflight 0")
        if stats["narrow"]["tokens_generated"] != tokens:
            fail(f"{label}: narrow's tokens {stats['narrow']['tokens_generated']} != {tokens}")
        return stats


def fleet_launch_check(label, fleet, cfg, launches):
    """The wrappers' counts of one fleet run (``launches``) against what
    its slots ran eagerly.  Every decode step of a slot must have been a
    graph replay, and every prefill chunk a replay or a capture (whose
    warm-up is the chunk), so ``paged_attention`` and
    ``paged_decode_write`` launch once a layer of each decode capture's
    warm-up, and ``masked_dequant`` once per int8 leaf of every unit of
    the in-scan slot's decode and prefill warm-ups (as phase 3c counts
    them); each of the three must have launched."""
    from repro_torch.serving.quantized import qleaves

    units = cfg.pattern_units
    want = dict(paged_attention=0, paged_decode_write=0, masked_dequant=0)
    for name, gw in fleet.gateways.items():
        g, pg = gw._graphs, gw._prefill_graphs
        decodes, chunks = gw.stats["resident_decode_steps"], gw.stats["prefill_chunks"]
        if g is None or not 0 < g.replays == decodes:
            fail(f"{label}: {name} ran {decodes} decode steps through "
                 f"{None if g is None else g.replays} graph replays")
        if pg is None or not (0 < pg.captures and pg.replays == chunks - pg.captures):
            fail(f"{label}: {name} ran {chunks} prefill chunks through "
                 f"{None if pg is None else (pg.replays, pg.captures)} replays and captures")
        leaves = sum(1 for _ in qleaves(gw._weights[gw.version]["units"])) * units
        want["paged_attention"] += units * g.captures
        want["paged_decode_write"] += units * g.captures
        want["masked_dequant"] += leaves * (g.captures + pg.captures)
    got = {k: launches[k] for k in want}
    if got != want or not all(got.values()):
        fail(f"{label}: launches {got}, the slots' decode and prefill warm-ups give {want}; "
             f"each of the three must launch")
    log(f"  {label}: launches {got}, as the slots' decode and prefill warm-ups give; every "
        f"decode step a graph replay, every prefill chunk a replay or a capture")


def fleet_run(label, fleet, cfg, np, *, waves, budget=None, tenants=None):
    """Serve phase 3's stream on every slot of ``fleet`` in ``waves``
    (index ranges of the stream), each wave submitted slot by slot and
    drained; with ``budget``, the bytes in use must stay within it after
    every step.  The launch counters are zeroed just before the first
    submission and read just after the last drain (fleet_launch_check);
    only the stepping is timed, each wave from after its submissions to
    a synchronize.  Returns each slot's requests, their logits rows and
    a summary."""
    from repro_torch.kernels import ops

    jobs = stream_jobs(cfg, np)
    rows = {name: record_rows(gw) for name, gw in fleet.gateways.items()}
    reqs = {name: [] for name in fleet.gateways}
    steps, most, dt = 0, 0, 0.0
    tenant = "open" if tenants is not None else None
    ops.reset_launches()
    for w, (lo, hi) in enumerate(waves):
        if tenants is not None:
            tenants.before_wave(w)
        for prompt, tier, new in jobs[lo:hi]:
            for name in fleet.gateways:
                reqs[name].append(fleet.submit(name, prompt, license=tier,
                                               max_new_tokens=new, tenant=tenant))
        if tenants is not None:
            tenants.after_submit(w)
        t0 = time.perf_counter()
        while True:
            act = fleet.step()
            steps += 1
            used = fleet.used_cache_bytes()
            most = max(most, used)
            if budget is not None and used > budget:
                fail(f"{label}: {used} cache bytes in use after step {steps}, over the "
                     f"budget of {budget}")
            if tenants is not None:
                tenants.after_step()
            if act is None:
                break
        sync()
        dt += time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    bad = {name: [r.rid for r in rs if r.state.value != "done"
                  or len(r.out_tokens) != r.max_new_tokens] for name, rs in reqs.items()}
    if any(bad.values()):
        fail(f"{label}: requests {bad} did not finish")
    m = fleet.metrics()
    tokens = m["fleet"]["tokens_generated"]
    out = dict(serve_s=dt, steps=steps, tokens=tokens, tokens_per_s=tokens / dt,
               ms_per_step=1e3 * dt / steps, most_cache_bytes=most, fleet=m["fleet"],
               launches=launches, slots={})
    for name, gw in fleet.gateways.items():
        mm = m["models"][name]
        out["slots"][name] = dict(
            tokens=mm["tokens_generated"], decode_steps=mm["decode_steps"],
            prefill_chunks=mm["prefill_chunks"], preempted=mm["preempted"],
            evicted_blocks=mm["prefix_cache"]["evicted_blocks"],
            max_blocks_in_use=mm["max_blocks_in_use"],
            captures=gw._graphs.captures if gw._graphs is not None else None,
            replays=gw._graphs.replays if gw._graphs is not None else None,
            graph_pool_gb=(gw._graphs.backend.pool_bytes() / 1e9
                           if gw._graphs is not None else None),
            **prefill_report(gw)["numbers"])
    log(f"  {label}: {sum(len(r) for r in reqs.values())} requests, {tokens} tokens in "
        f"{dt:.2f} s ({out['tokens_per_s']:.1f} tokens/s, {out['ms_per_step']:.1f} ms per "
        f"fleet step over {steps}); most cache bytes in use {most}")
    for name, sl in out["slots"].items():
        log(f"  {label}: {name}: {sl}")
    fleet_launch_check(label, fleet, cfg, launches)
    return reqs, rows, out


def fleet_profile(label, fleet, cfg, np, torch, steps=8):
    """Bring phase 3's stream on every slot of ``fleet`` to a steady
    decode (every lane of every slot decoding, nothing prefilling), time
    ``steps`` fleet steps (host clock, ending in a synchronize), then
    profile the next ``steps``: the device trace must show the kernels
    of each slot's decode steps in the window and of the graphs captured
    in it.  Leaves the streams mid-flight."""
    gws = fleet.gateways
    for gw in gws.values():
        gw.__dict__.pop("_sample", None)       # drop record_rows's per-step copy
    for prompt, tier, new in stream_jobs(cfg, np):
        for name in gws:
            fleet.submit(name, prompt, license=tier, max_new_tokens=new)
    while not all(len(gw.scheduler.running) == gw.max_lanes and all(
            r.state.value == "running" for r in gw.scheduler.running) for gw in gws.values()):
        if fleet.step() is None:
            fail(f"profile {label}: the streams drained before every lane decoded")
    acts = []
    sync()
    t0 = time.perf_counter()
    acts.extend(fleet.step() for _ in range(steps))
    sync()
    plain_ms = 1e3 * (time.perf_counter() - t0) / steps
    captures = {name: gw._graphs.captures for name, gw in gws.items()}
    prof = profile_window(label, lambda: acts.extend(fleet.step() for _ in range(steps)),
                          torch, steps)
    kinds = [None if a is None else (a.model, a.kind) for a in acts]
    if any(k is None or k[1] != "decode" for k in kinds):
        fail(f"profile {label}: the windows ran {kinds}, not {2 * steps} decode steps")
    if prof is None:
        fail(f"profile {label}: the profile holds no device trace, so the slots' decode "
             f"steps' kernels cannot be counted")
    by_slot = {name: sum(a.model == name for a in acts[steps:]) for name in gws}
    warmups = {name: gw._graphs.captures - captures[name] for name, gw in gws.items()}
    check_trace_launches(label, cfg, prof, [(gw, by_slot[name] + warmups[name], 0)
                                            for name, gw in gws.items()])
    prof.update(unprofiled_ms_per_step=plain_ms, decode_steps_by_slot=by_slot,
                warmups_in_window=warmups,
                busy_share_of_unprofiled=prof["device_busy_ms"] / steps / plain_ms)
    log(f"  profile {label}: {steps} unprofiled fleet steps before it took {plain_ms:.2f} ms "
        f"each (host clock, synchronized); the window's decode steps by slot {by_slot}; "
        f"the profiled device time {prof['device_busy_ms'] / steps:.2f} ms a step is "
        f"{100 * prof['busy_share_of_unprofiled']:.1f}% of that")
    return prof


def fleet_phase(cfg, params, tiers, np, torch, want_tokens, device="cuda"):
    """Phase 7b: the fleet's runs (a) and (b) and the isolated pair;
    ``want_tokens`` are phase 3's float stream and phase 3c's in-scan
    stream.  Returns a summary."""
    from repro_torch.kernels import ops
    from repro_torch.serving import (LicensedGateway, TenantRegistry,
                                     validate_chrome_trace, validate_fleet_metrics)

    want = dict(zip(FLEET_SLOTS, (want_tokens["float"], want_tokens["in_scan"])))
    out = {}
    fleet = fleet_build(cfg, params, tiers, device)
    got_a = fleet_run("7b (a) no budget", fleet, cfg, np, waves=[(0, len(PROMPT_LENS))])
    for name, reqs in got_a[0].items():
        if [r.out_tokens for r in reqs] != want[name]:
            fail(f"7b (a): {name}'s greedy tokens differ from its isolated stream's "
                 f"(phase 3 / 3c)")
    log("  7b (a): each slot's greedy tokens equal phase 3's float stream and phase 3c's "
        "in-scan stream")
    out["a_no_budget"] = got_a[2]
    # a steady decode of both slots under the profiler: the device trace
    # counts what the slots' graph replays ran
    out["a_no_budget"]["decode_profile"] = fleet_profile("7b_fleet_decode", fleet, cfg, np,
                                                         torch)
    block_bytes = fleet.gateways["qwen-float"].pool.block_bytes
    pool_blocks = sum(g.pool.num_blocks for g in fleet.gateways.values())
    del fleet
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    # the same two streams on two isolated gateways, back to back, timed
    # as run (a) is: views built first, logits rows recorded, from after
    # the submissions to a synchronize
    iso = {"serve_s": 0.0, "tokens": 0, "steps": 0}
    ops.reset_launches()
    for name, mode in FLEET_SLOTS.items():
        gw = LicensedGateway(cfg, params, tiers=tiers, model=name, device=device,
                             **mode, **GEOMETRY)
        for tier in ("full", "free"):
            gw.view_for(tier)
        rows = record_rows(gw)
        reqs = submit_all(gw, cfg, np)
        t0 = time.perf_counter()
        gw.run()
        sync()
        iso["serve_s"] += time.perf_counter() - t0
        if [r.out_tokens for r in reqs] != want[name]:
            fail(f"7b isolated {name}: greedy tokens differ from phase 3 / 3c")
        iso["tokens"] += gw.stats["tokens_generated"]
        iso["steps"] += gw.stats["decode_steps"] + gw.stats["prefill_chunks"]
        del gw, reqs, rows
        gc.collect()
    iso["launches"] = dict(ops.LAUNCHES)
    iso["tokens_per_s"] = iso["tokens"] / iso["serve_s"]
    iso["ms_per_step"] = 1e3 * iso["serve_s"] / iso["steps"]
    a = out["a_no_budget"]
    out["isolated_pair"] = iso
    out["throughput_ratio"] = a["tokens_per_s"] / iso["tokens_per_s"]
    log(f"  7b: fleet (a) {a['tokens_per_s']:.1f} tokens/s, {a['ms_per_step']:.1f} ms per "
        f"step; the two isolated gateways back to back {iso['tokens_per_s']:.1f} tokens/s, "
        f"{iso['ms_per_step']:.1f} ms per step; ratio {out['throughput_ratio']:.3f}")
    if device == "cuda":
        torch.cuda.empty_cache()

    # run (b): the byte budget, two waves a slot, the tenants
    budget = FLEET_BUDGET_BLOCKS * block_bytes
    registry = TenantRegistry(clock=time.perf_counter)
    fleet = fleet_build(cfg, params, tiers, device, cache_budget_bytes=budget,
                        tenants=registry)
    for name, kw in FLEET_TENANTS.items():
        registry.register(name, **kw)
    cross = cross_evictions(fleet)
    tenants = FleetTenants(fleet, cfg, np)
    reqs_b, rows_b, b = fleet_run(
        f"7b (b) budget {FLEET_BUDGET_BLOCKS} x {block_bytes} bytes", fleet, cfg, np,
        waves=[(0, FLEET_WAVE), (FLEET_WAVE, len(PROMPT_LENS))], budget=budget,
        tenants=tenants)
    b.update(budget_bytes=budget, block_bytes=block_bytes, pool_blocks=pool_blocks,
             cross_slot_evicted_blocks=cross)
    if not sum(cross.values()) > 0:
        fail(f"7b (b): no retained chain of one slot was evicted for the other: {cross}")
    b["tenants"] = tenants.check("7b (b)")
    m = fleet.metrics()
    try:
        validate_fleet_metrics(m, extra=PORT_EXTRA)
        validate_chrome_trace(fleet.chrome_trace())
    except (AssertionError, ValueError) as e:
        fail(f"7b (b): fleet metrics() or chrome_trace() off schema: {e}")
    if m["fleet"]["quota_rejections"] != 6:
        fail(f"7b (b): fleet quota_rejections {m['fleet']['quota_rejections']}, expected 6")
    b["audit"] = {ev: len(fleet.audit_events(ev))
                  for ev in ("tenant_register", "quota_reject", "tenant_reject")}
    log(f"  7b (b): budget {budget} bytes ({FLEET_BUDGET_BLOCKS} of the pools' "
        f"{pool_blocks} blocks), never exceeded; blocks evicted for the other slot "
        f"{cross}; tenants {json.dumps(b['tenants'])}; audit {b['audit']}")
    log(f"  7b (b): fleet metrics {json.dumps(m['fleet'])}")
    b["parts"] = {}
    for name in FLEET_SLOTS:
        b["parts"][name] = near_ties(f"7b (b) {name}", reqs_b[name], got_a[0][name],
                                     rows_b[name], got_a[1][name], cfg.vocab_size,
                                     ref="run (a)")
    out["b_budget"] = b
    del fleet, got_a, reqs_b, rows_b, tenants
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ phase 5 / 6
def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def make_v2(v1, units, torch):
    """v1 with ``units`` changed: norm scales and q/k/v biases (rows-mode
    layers) redrawn, and 1% of the entries of each block matrix slice
    (chunk-mode layers) replaced.  Untouched layers are shared with v1."""
    gen = torch.Generator().manual_seed(SEED + 2)
    blk = v1["units"]["b0"]
    new = {"norm1": {}, "norm2": {}, "mixer": {}, "ffn": {}}
    for grp, key in (("norm1", "norm_scale"), ("norm2", "norm_scale"),
                     ("mixer", "bq"), ("mixer", "bk"), ("mixer", "bv")):
        w = blk[grp][key].clone()
        base = 1.0 if grp.startswith("norm") else 0.0
        w[units] = (base + 0.05 * torch.randn(w[units].shape, generator=gen)).to(w.dtype)
        new[grp][key] = w
    for grp, key in (("mixer", "wq"), ("mixer", "wk"), ("mixer", "wv"), ("mixer", "wo"),
                     ("ffn", "w_gate"), ("ffn", "w_up"), ("ffn", "w_down")):
        w = blk[grp][key].clone()
        sl = w[units].reshape(-1)                  # a copy of the slice
        hit = torch.randperm(sl.numel(), generator=gen)[: sl.numel() // 100]
        sl[hit] = (torch.randn(hit.numel(), generator=gen) * 0.02).to(w.dtype)
        w[units] = sl.reshape(w[units].shape)
        new[grp][key] = w
    units_new = {g: {**blk[g], **new[g]} for g in blk}
    return {**v1, "units": {"b0": units_new}}


def flat_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat_leaves(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def same_weights(got, want, torch):
    """Names of the layers where the card's tensors differ from the host
    reference (compared on the card, one layer at a time)."""
    want_flat = dict(flat_leaves(want))
    bad = [name for name, t in flat_leaves(got)
           if not torch.equal(t, want_flat[name].to(t.device))]
    return bad + sorted(set(want_flat) - {n for n, _ in flat_leaves(got)})


class Timed:
    """Host-clock sums around library calls of the boot pull (each ends
    in a device synchronize), installed on the modules that call them."""

    def __init__(self):
        self.s = {}
        self._undo = []

    def wrap(self, owner, attr, label):
        fn = getattr(owner, attr)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            sync()
            self.s[label] = self.s.get(label, 0.0) + time.perf_counter() - t0
            return out

        setattr(owner, attr, timed)
        self._undo.append((owner, attr, fn))

    def restore(self):
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo = []


class StageProbe:
    """The STAGE steps of one staged sync, seen from the host: host-clock
    laps around what the stager calls (the split of a stage step's
    span), a check that each stage step carrying parts makes exactly one
    ``delta_apply_parts`` launch (counted under ``delta_apply_inplace``)
    and no ``to_tensor`` (the per-page route's pageable copy), the
    StepRing's pinned bytes, and the segments of one real step (kept for
    ``step_case``).  Installed on the modules after ``begin_sync``,
    restored after the flip.  Also drives a tree without the parts
    kernel (the per-page route: ``apply_delta`` per part, a pageable
    ``to_tensor`` and a slice ``copy_`` per page), splitting its steps the
    same way, so ``scripts/stage_split.py`` can hold the two against
    each other."""

    def __init__(self):
        self.s = {}
        self.calls = {}
        self.paused = False
        self.parts_route = False
        self.step_segments = None
        self.pinned_bytes = 0
        self.stage_steps = []            # (parts, launches) per stage step
        self._undo = []

    def _counts(self):
        """Laps count on the serving thread only (not the fetch worker's)."""
        return not self.paused and threading.current_thread() is threading.main_thread()

    def _lap(self, owner, attr, label):
        fn = getattr(owner, attr)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                if self._counts():
                    self.s[label] = self.s.get(label, 0.0) + time.perf_counter() - t0
                    self.calls[label] = self.calls.get(label, 0) + 1

        setattr(owner, attr, timed)
        self._undo.append((owner, attr, fn))

    def install(self, stager, np, torch):
        from repro_torch.core import delta as delta_lib
        from repro_torch.serving import updates as upd_mod

        if stager._fetch_queue is not None:
            self._lap(stager._fetch_queue, "get", "queue_wait")
        self._lap(upd_mod.UpdateStager, "_apply_part", "apply_part")
        self.parts_route = hasattr(upd_mod, "part_segments")
        if self.parts_route:
            from repro_torch.kernels import delta_apply as kd

            self._lap(upd_mod, "part_segments", "segments")
            self._lap(kd, "plan_step", "plan")
            self._lap(kd, "write_step", "pack")
            self._lap(kd.StepRing, "_slot", "slot_wait")
            self._lap(kd.StepRing, "apply", "ring_apply")
            self._lap(delta_lib, "to_tensor", "to_tensor")
            keep = upd_mod.UpdateStager._apply_segments

            def apply_segments(st):
                segs = st._segments
                if self.step_segments is None and self._counts() and \
                        any(hasattr(g, "indices") for g in segs) and \
                        any(not hasattr(g, "indices") for g in segs):
                    self.step_segments = list(segs)     # a step with rows and pages
                if st._ring is not None:
                    self.pinned_bytes = max(self.pinned_bytes, st._ring.pinned_bytes)
                return keep(st)

            upd_mod.UpdateStager._apply_segments = apply_segments
            self._undo.append((upd_mod.UpdateStager, "_apply_segments", keep))
            return
        self._lap(upd_mod, "apply_delta", "apply_delta")
        pages = delta_lib.LayerDelta.iter_pages

        def timed_pages(d):
            it = pages(d)
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    return
                finally:
                    if self._counts():
                        self.s["decode"] = self.s.get("decode", 0.0) + time.perf_counter() - t0
                yield item

        delta_lib.LayerDelta.iter_pages = timed_pages
        self._undo.append((delta_lib.LayerDelta, "iter_pages", pages))
        keep_tt = delta_lib.to_tensor

        def to_tensor(arr, device):
            # the per-page route's to_tensor, its two copies timed apart
            t0 = time.perf_counter()
            arr = np.require(arr, requirements=("C", "W"))
            t1 = time.perf_counter()
            if arr.dtype == np.uint16:
                out = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
            else:
                out = torch.from_numpy(arr).to(device)
            if self._counts():
                self.s["host_copy"] = self.s.get("host_copy", 0.0) + t1 - t0
                self.s["pageable_h2d"] = self.s.get("pageable_h2d", 0.0) + \
                    time.perf_counter() - t1
                self.calls["to_tensor"] = self.calls.get("to_tensor", 0) + 1
            return out

        delta_lib.to_tensor = to_tensor
        self._undo.append((delta_lib, "to_tensor", keep_tt))

    def restore(self):
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo = []

    def split_ms(self, span_s, steps):
        """Each part's host ms per stage step; ``rest`` is the stage spans'
        remainder (the stager's own bookkeeping, spans and checkpoints)."""
        s = self.s.get
        if self.parts_route:
            ring = s("ring_apply", 0.0)
            parts = {"queue_wait": s("queue_wait", 0.0),
                     "page_decode_and_segments": s("segments", 0.0),
                     "layer_clones": s("apply_part", 0.0) - s("segments", 0.0),
                     "plan": s("plan", 0.0),
                     "pack_into_pinned": s("pack", 0.0),
                     "slot_wait": s("slot_wait", 0.0),
                     "upload_and_launch": ring - s("plan", 0.0) - s("pack", 0.0)
                     - s("slot_wait", 0.0)}
        else:
            apply = s("apply_delta", 0.0)
            copies = s("host_copy", 0.0) + s("pageable_h2d", 0.0)
            parts = {"queue_wait": s("queue_wait", 0.0),
                     "page_decode": s("decode", 0.0),
                     "host_copies": s("host_copy", 0.0),
                     "pageable_h2d": s("pageable_h2d", 0.0),
                     "launches": apply - s("decode", 0.0) - copies,
                     "layer_clones": s("apply_part", 0.0) - apply}
        parts["rest"] = span_s - sum(parts.values())
        return {k: 1e3 * v / max(steps, 1) for k, v in parts.items()}


def stage_report(label, probe, spans, profiled, device):
    """What the StageProbe saw of a sync's stage steps: the split of their
    host spans (the profiled step left out), the parts kernel's launches
    against the steps that carried parts, the ring's pinned bytes and
    the profiled stager step's own device records.  On the card the
    parts route must launch once a stage step with parts, never through
    ``to_tensor``, and put one ``delta_apply_parts`` kernel and no
    pageable host-to-device copy on the device in the profiled step."""
    stage = [e[5] for e in spans if e[3] == "stager:stage"]
    left_out = 1 if "stager_span_ms" in profiled else 0
    span_s = sum(stage) - profiled.get("stager_span_ms", 0.0) / 1e3
    split = probe.split_ms(span_s, len(stage) - left_out)
    with_parts = sum(1 for p, _ in probe.stage_steps if p)
    launches = sum(n for _, n in probe.stage_steps)
    route = "parts" if probe.parts_route else "per-page"
    sub = (profiled.get("profile") or {}).get("sub_records")
    rep = dict(route=route, split_ms_per_step=split, stage_steps=len(probe.stage_steps),
               steps_with_parts=with_parts, parts_launches=launches,
               ring_pinned_bytes=probe.pinned_bytes,
               to_tensor_calls=probe.calls.get("to_tensor", 0), profiled_stager=sub)
    log(f"  {label}: stage steps on the {route} route, host ms a step (host clock laps, "
        f"{len(stage) - left_out} unprofiled steps, {1e3 * span_s / max(1, len(stage) - left_out):.2f}"
        f" ms of stager:stage span each): "
        + ", ".join(f"{k} {v:.2f}" for k, v in split.items()))
    if probe.parts_route:
        log(f"  {label}: delta_apply_parts launches this sync {launches} over "
            f"{len(probe.stage_steps)} stage steps, {with_parts} carrying parts; the StepRing's "
            f"pinned bytes {probe.pinned_bytes}; to_tensor calls {rep['to_tensor_calls']}")
    if sub is not None:
        log(f"  {label}: the profiled stager step's own device records: kernels "
            f"{sub['kernels']}, copies/sets {sub['copies_and_sets']}")
    if device != "cuda" or not probe.parts_route:
        return rep
    bad = [(p, n) for p, n in probe.stage_steps if n != (1 if p else 0)]
    if bad:
        fail(f"{label}: stage steps (parts, delta_apply_parts launches) {bad}: not one launch "
             f"a step with parts")
    if rep["to_tensor_calls"]:
        fail(f"{label}: {rep['to_tensor_calls']} to_tensor calls (pageable copies) in the stage "
             f"steps")
    if sub is not None:
        kernels = sum(n for k, n in sub["kernels"].items() if "delta_apply_parts" in k)
        pageable = {k: n for k, n in sub["copies_and_sets"].items() if "Pageable" in k}
        if kernels != (1 if profiled.get("stage_step_parts") else 0) or pageable:
            fail(f"{label}: the profiled stager step ran {kernels} delta_apply_parts kernels "
                 f"and pageable copies {pageable}")
    return rep


def step_case(label, segs, peaks, torch):
    """``delta_apply_parts`` at a real STAGE step's shape (``segs``, one
    step of phase 5's sync: its rows parts and chunk pages, on clones of
    the layers they write): bit for bit against the plain version; back to
    back (host clock per call, ending in a synchronize: pack, copy and
    launch) beside the per-page route it replaced (a pageable copy and a
    slice ``copy_`` a page, two copies and the scatter a rows part); the
    kernel alone in a CUDA graph on the uploaded buffer; the pinned
    upload alone.  Bounds: the packed buffer read once and the written
    elements over the memory rate (``bound_ms``), and the packed buffer
    over the pinned host-to-device rate this case measures."""
    from repro_torch.core.weightstore import to_tensor
    from repro_torch.kernels import delta_apply as kd
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.build import load_extension

    saved = dict(ops.LAUNCHES)          # this case's launches are not the main path's
    dev = segs[0].dst.device
    dsts = {}
    for g in segs:
        dsts.setdefault(g.dst.data_ptr(), g.dst)
    kern = {p: t.clone() for p, t in dsts.items()}
    plain = {p: t.clone() for p, t in dsts.items()}
    ks = [g._replace(dst=kern[g.dst.data_ptr()]) for g in segs]
    ps = [g._replace(dst=plain[g.dst.data_ptr()]) for g in segs]
    plan = kd.plan_step(ks)
    ring = kd.StepRing(dev, plan.nbytes, slots=2)
    n0 = ops.LAUNCHES["delta_apply_inplace"]
    kd.delta_apply_parts(ks, ring=ring)
    launches = ops.LAUNCHES["delta_apply_inplace"] - n0
    ref.delta_apply_parts(ps)
    torch.cuda.synchronize()
    err = max((kern[p].float() - plain[p].float()).abs().max().item() for p in dsts)
    if launches != 1 or not all(torch.equal(kern[p], plain[p]) for p in dsts):
        fail(f"{label}: delta_apply_parts at a stage step's shape disagrees with its plain "
             f"version ({launches} launches)")
    rows = [g for g in segs if isinstance(g, kd.Rows)]
    runs = [g for g in segs if isinstance(g, kd.Run)]
    written = sum(int(((g.indices >= 0) & (g.indices < g.dst.numel())).sum())
                  * g.dst.element_size() for g in rows)
    written += sum(g.data.nbytes for g in runs)
    bnd, by = bound_ms(plan.nbytes + written, 0, peaks)

    def per_page():
        # the route the parts kernel replaced (core.delta.apply_delta's)
        for g in ks:
            if isinstance(g, kd.Rows):
                ops.delta_apply(g.dst, to_tensor(g.indices, dev), to_tensor(g.values, dev),
                                donate=True)
            else:
                g.dst[g.offset: g.offset + g.data.size].copy_(to_tensor(g.data, dev))

    def host_ms(fn, iters=10):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / iters

    times = {"parts": [], "per_page": []}
    for r in range(4):                        # in turns: per-page, parts, parts, per-page
        for name in (("per_page", "parts") if r % 2 == 0 else ("parts", "per_page")):
            times[name].append(host_ms(per_page if name == "per_page" else
                                       lambda: kd.delta_apply_parts(ks, ring=ring)))
    host = torch.empty(plan.nbytes, dtype=torch.uint8, pin_memory=True)
    kd.write_step(plan, host.numpy())
    packed = host.to(dev)
    ext = load_extension()
    args = (packed, plan.map_off, plan.payload_off, plan.n_tiles)
    upload_ms = time_ms(lambda: packed.copy_(host, non_blocking=True))
    rate = plan.nbytes / upload_ms * 1e3              # bytes/s
    case = dict(
        shape=f"{len(rows)} rows parts ({sum(g.indices.size for g in rows)} entries), "
              f"{len(runs)} pages, {plan.nbytes} packed bytes, {plan.n_tiles} tiles",
        segments=len(segs), packed_bytes=plan.nbytes, tiles=plan.n_tiles,
        written_bytes=written, max_abs_err=err, launches_per_apply=launches,
        ms=min(times["parts"]), ms_runs=times["parts"],
        per_page_ms=min(times["per_page"]), per_page_ms_runs=times["per_page"],
        ms_graph=time_graph_ms(lambda: ext.delta_apply_parts(*args)),
        plain_ms=time_ms(lambda: ref.delta_apply_parts(ps), iters=3, warmup=1),
        upload_ms=upload_ms, pinned_h2d_gb_s=rate / 1e9,
        bound_ms=bnd, bound_by=by, host_link_bound_ms=plan.nbytes / rate * 1e3,
        library_ms=None)
    ring.close()
    ops.LAUNCHES.update(saved)
    log(f"  {label}: delta_apply_parts at a stage step's shape [{case['shape']}]: "
        f"bit for bit the plain version's, one launch; back to back (host clock, pack + "
        f"copy + launch) {case['ms']:.3f} ms against {case['per_page_ms']:.3f} ms for the "
        f"per-page route (best of 2 turns each); the kernel alone in a CUDA graph "
        f"{case['ms_graph']:.4f} ms against its bound {bnd:.4f} ms ({by}); the pinned upload "
        f"{upload_ms:.4f} ms ({case['pinned_h2d_gb_s']:.1f} GB/s); plain "
        f"{case['plain_ms']:.3f} ms")
    return case


# the lease walk of phase 5: its gateway boots through a kill-switch
# transport on a clock the phase moves (the host clock plus an offset,
# advanced only while the gateway is idle), with the floor policy
PRO_TIER = {"*": ((0.0, 0.02),)}
LEASE_PROMPT = 40


class OffsetClock:
    """The host clock plus ``offset`` seconds."""

    def __init__(self):
        self.offset = 0.0

    def __call__(self):
        return time.perf_counter() + self.offset


def kill_switch(server):
    """The port's ``DirectTransport`` to ``server`` with a kill switch:
    every call times out while ``down``."""
    from repro_torch.core.transport import DirectTransport, TransportTimeout

    class KillSwitch(DirectTransport):
        down = False

        def _call(self, op, thunk):
            if self.down:
                raise TransportTimeout(f"{op}: server unreachable")
            return super()._call(op, thunk)

    return KillSwitch(server)


def lease_walk(label, gw, tr, clock, server, np):
    """Walk the lease HEALTHY -> DEGRADED -> OFFLINE -> HEALTHY: the
    server goes dark and the clock's offset moves past the ttl, then the
    grace; a new tier grant must be refused while degraded; offline, a
    ``full`` request is served as ``free`` with the tokens of a straight
    ``free`` request of the same prompt; the server comes back and the
    probe restores the lease.  ``degraded_seconds_total`` must be the
    offset advanced between the degrade and the restore ticks plus the
    host time between them (bracketed by the host clock)."""
    from repro_torch.core.licensing import LicenseTier

    def state():
        return gw.metrics()["lease"]["state"]

    gw.step()                                 # a probe heals an idle lapse
    if state() != "healthy":
        fail(f"{label}: the lease is {state()} before the walk, with the server up")
    n0 = len(gw.audit_events())
    tr.down = True
    clock.offset += gw.lease_ttl_s + 1.0
    t_deg = (clock(), None)
    gw.step()
    t_deg = (t_deg[0], clock())
    if state() != "degraded":
        fail(f"{label}: {state()} past the ttl with the server down, not degraded")
    server.publish_tier("lm", LicenseTier(name="pro", masks=PRO_TIER))
    prompt = np.random.default_rng(SEED + 8).integers(0, gw.cfg.vocab_size, LEASE_PROMPT,
                                                      dtype=np.int32)
    pro = gw.submit(prompt, license="pro", max_new_tokens=16)
    if pro.state.value != "rejected" or "refusing new tier grant" not in (pro.error or ""):
        fail(f"{label}: a new tier grant while degraded was {pro.state.value} "
             f"({pro.error})")
    clock.offset += gw.lease_grace_s
    offset_span = gw.lease_grace_s
    gw.step()
    if state() != "offline":
        fail(f"{label}: {state()} past the grace with the server down, not offline")
    straight = gw.submit(prompt, license="free", max_new_tokens=16)
    floored = gw.submit(prompt, license="full", max_new_tokens=16)
    if floored.state.value == "rejected" or floored.license != "free":
        fail(f"{label}: offline, a full request was {floored.state.value} as "
             f"{floored.license!r} ({floored.error}), not served as free")
    gw.run()
    sync()
    if not (straight.state.value == floored.state.value == "done"
            and floored.out_tokens == straight.out_tokens):
        fail(f"{label}: the floored request's tokens {floored.out_tokens} differ from a "
             f"straight free request's {straight.out_tokens}")
    tr.down = False
    clock.offset += 2.0
    offset_span += 2.0
    t_res = (clock(), None)
    gw.step()
    t_res = (t_res[0], clock())
    lease = gw.metrics()["lease"]
    if lease["state"] != "healthy":
        fail(f"{label}: {lease['state']} with the server back, not restored")
    events = [e["event"] for e in gw.audit_events()[n0:] if e["event"].startswith("lease")]
    if events != ["lease_degraded", "lease_offline", "lease_restored"]:
        fail(f"{label}: lease audit events {events}")
    degraded = lease["degraded_seconds_total"]
    lo, hi = t_res[0] - t_deg[1], t_res[1] - t_deg[0]
    if not lo <= degraded <= hi:
        fail(f"{label}: degraded_seconds_total {degraded} outside [{lo}, {hi}], the "
             f"clock between the degrade and the restore ticks")
    host = degraded - offset_span
    log(f"  {label}: lease walk healthy -> degraded -> offline -> healthy (audit {events}); "
        f"the new tier 'pro' refused while degraded; offline, 'full' served as 'free' "
        f"with a straight 'free' request's {len(floored.out_tokens)} tokens; "
        f"degraded_seconds_total {degraded:.3f} s = the offset span {offset_span:.1f} s "
        f"plus {host:.3f} s of host time between the ticks")
    return dict(events=events, degraded_seconds_total=degraded, offset_span_s=offset_span,
                host_between_ticks_s=host, floor_tokens=floored.out_tokens, lease=lease)


def update_phase(label, cfg, gw_kw, torch, np, *, device="cuda", ref_tokens=None,
                 max_step_bytes=16 << 20, profile_stage=False, lease=False,
                 parts_case=False):
    """Publish v1, boot a gateway from the server, serve the stream, and
    stage v2 mid-stream; every check of phases 5/6.  The sync's stage
    steps run under a ``StageProbe``: the split of their host span, and
    on the card one ``delta_apply_parts`` launch a stage step that
    carries parts and no pageable ``to_tensor``.  With ``profile_stage``
    the third scheduler step with a stage step rides under torch.profiler
    (and is left out of the step times and the split), its stager step in
    a ``record_function`` range whose device records are counted apart.
    With ``parts_case`` the kernel runs again at the shape of one real
    stage step (``step_case``).  With ``lease`` the gateway boots through
    a kill-switch transport on an offset clock with the floor policy, and
    walks its lease after the sync.  Returns a summary."""
    from repro_torch.core import delta as delta_lib
    from repro_torch.core import transport as transport_lib
    from repro_torch.core.licensing import LicenseTier
    from repro_torch.core.protocol import LicenseServer
    from repro_torch.core.weightstore import WeightStore
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.serving import LicensedGateway
    from repro_torch.serving.quantized import quantize_serving_params

    out = {}
    u = cfg.pattern_units
    units = list(range(max(0, u - 4), u))
    v1 = tree_map(lambda t: t.cpu(), init_params(cfg, seed=SEED, device=device))
    v2 = make_v2(v1, units, torch)
    # chunk pages stored raw: random bf16 weights do not compress, and
    # zlib over the 6.8 GB model would cost about a minute of host time
    server = LicenseServer(WeightStore(":memory:", compress_chunks=False))
    t0 = time.perf_counter()
    server.publish("lm", v1, tag="v1")
    server.publish_tier("lm", LicenseTier(name="free", masks=FREE_TIER))
    out["publish_v1_s"] = time.perf_counter() - t0

    template = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype, device=device), v1)
    if lease:
        tr, clock = kill_switch(server), OffsetClock()
        gw_kw = dict(gw_kw, transport=tr, clock=clock, lease_policy="floor",
                     lease_floor_tier="free")
    timed = Timed()
    timed.wrap(server.store, "delta_since", "delta_query_s")
    timed.wrap(transport_lib, "packet_checksum", "checksums_s")
    timed.wrap(delta_lib, "to_tensor", "transfer_s")
    timed.wrap(ops, "delta_apply", "apply_s")
    t0 = time.perf_counter()
    try:
        gw = LicensedGateway.from_server(cfg, server, "lm", template, device=device,
                                         **gw_kw, **GEOMETRY)
        sync()
    finally:
        timed.restore()
    boot = time.perf_counter() - t0
    del template
    out["boot_pull"] = {"total_s": boot, **timed.s,
                        "other_s": boot - sum(timed.s.values()),
                        "wire_bytes": gw._client.bytes_downloaded}
    log(f"  {label}: boot pull {boot:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in timed.s.items())
        + f"), {gw._client.bytes_downloaded / 1e9:.2f} GB on the wire")
    bad = same_weights(gw._client.params, v1, torch)
    if bad:
        fail(f"{label}: boot pull differs from v1 in {bad[:5]}")
    log(f"  {label}: pulled weights equal v1 bit for bit "
        f"({sum(1 for _ in flat_leaves(v1))} layers)")
    lease_states = {"after_boot": gw.metrics()["lease"]["state"]}

    for tier in ("full", "free"):    # views first, as in phase 3, so the
        gw.view_for(tier)           # step before the sync is a plain one
    reqs = submit_all(gw, cfg, np)
    steps = {"before": [], "during": [], "after": []}
    phases = {}
    flip_t = None
    profiled = {}
    probe = StageProbe()

    def profiled_step(stager):
        from torch.profiler import record_function

        inner = stager.step

        def marked():
            with record_function("chip_smoke_stager"):
                return inner()

        acts = []
        stager.step = marked
        probe.paused = True
        try:
            profiled["profile"] = profile_window(
                "stage_step", lambda: acts.append(LicensedGateway.step(gw)), torch, 1,
                sub="chip_smoke_stager")
        finally:
            probe.paused = False
            del stager.step
        span = [e for e in gw.tracer.events if e[3] == "stager:stage"][-1]
        profiled["stager_span_ms"] = 1e3 * span[5]
        log(f"  {label}: the profiled step's stager:stage span (host clock, no "
            f"synchronize) {profiled['stager_span_ms']:.2f} ms")
        return acts[0]

    def step():
        nonlocal flip_t
        when = ("during" if gw.sync_active else
                "before" if gw.version == 1 else "after")
        stager = gw._stager if gw.sync_active else None
        staging = stager is not None and stager.phase == "stage"
        if staging:
            p0 = stager.stats_["parts_applied"]
            n0 = ops.LAUNCHES["delta_apply_inplace"]
        if gw.sync_active:
            phases[gw._stager.phase] = phases.get(gw._stager.phase, 0) + 1
        profiling = profile_stage and not profiled and staging and phases["stage"] == 3
        if profiling:
            act = profiled_step(stager)
        else:
            t = time.perf_counter()
            act = LicensedGateway.step(gw)
            sync()
            dt = time.perf_counter() - t
            if act is not None or when == "during":
                steps[when].append(dt)
        if staging:
            probe.stage_steps.append((stager.stats_["parts_applied"] - p0,
                                      ops.LAUNCHES["delta_apply_inplace"] - n0))
            if profiling:
                profiled["stage_step_parts"] = probe.stage_steps[-1][0]
        if flip_t is None and gw.version != 1:
            flip_t = time.perf_counter()
        return act

    gw.step = step                 # run() drives this timed step
    gw.step()
    t0 = time.perf_counter()
    server.publish("lm", v2, tag="v2")
    out["publish_v2_s"] = time.perf_counter() - t0
    wire0 = gw._client.bytes_downloaded
    t_begin = time.perf_counter()
    if not gw.begin_sync(max_step_bytes=max_step_bytes):
        fail(f"{label}: begin_sync found no newer version")
    out["begin_sync_s"] = time.perf_counter() - t_begin
    probe.install(gw._stager, np, torch)
    try:
        gw.run()
        sync()
    finally:
        probe.restore()
    st = gw.metrics()["staged_update"]
    lease_states["after_flip"] = gw.metrics()["lease"]["state"]
    log(f"  {label}: lease {lease_states['after_boot']} after the boot, "
        f"{lease_states['after_flip']} after the flip (ttl {gw.lease_ttl_s:.0f} s, grace "
        f"{gw.lease_grace_s:.0f} s, policy {gw.lease_policy})")
    if flip_t is None or st["flips"] != 1 or gw.version != 2:
        fail(f"{label}: expected exactly one flip to v2, got {st['flips']} "
             f"(version {gw.version})")
    bad = [r.rid for r in reqs if r.version != 1 or r.state.value != "done"
           or len(r.out_tokens) != r.max_new_tokens]
    if bad:
        fail(f"{label}: in-flight requests {bad} left v1 or did not finish")
    if ref_tokens is not None and [r.out_tokens for r in reqs] != ref_tokens:
        fail(f"{label}: in-flight tokens differ from the update-free run")
    if gw.quantized:
        want = quantize_serving_params(tree_map(lambda t: t.to(device), v2))
        bad = same_weights(gw._weights[2], want, torch)
        del want
        if bad:
            fail(f"{label}: v2 int8 store differs from quantize_serving_params(v2) "
                 f"in {bad[:5]}")
    bad = same_weights(gw._client.params, v2, torch)
    if bad:
        fail(f"{label}: flipped weights differ from v2 in {bad[:5]}")
    # what the gateway recorded of the sync: one sync_begin and one
    # version_flip, one stager:<phase> span and h_stager observation a step
    from repro_torch.serving import validate_chrome_trace

    audit = {ev: len(gw.audit_events(ev)) for ev in ("sync_begin", "version_flip", "sync_abort")}
    if audit != {"sync_begin": 1, "version_flip": 1, "sync_abort": 0}:
        fail(f"{label}: the audit holds {audit}, not one sync_begin and one version_flip")
    spans = [e for e in gw.tracer.events if e[3].startswith("stager:")]
    span_phases = {}
    for e in spans:
        span_phases[e[3]] = span_phases.get(e[3], 0) + 1
    if {k[len("stager:"):]: v for k, v in span_phases.items()} != phases \
            or gw.h_stager.count != len(spans):
        fail(f"{label}: stager spans {span_phases} / h_stager {gw.h_stager.count} "
             f"do not match the steps {phases}")
    try:
        validate_chrome_trace(gw.chrome_trace())
    except ValueError as e:
        fail(f"{label}: chrome_trace() is not a valid trace: {e}")
    prof = profiled.get("profile")
    if prof is not None and steps["during"]:
        # the profiler lengthens its step; its device time against the
        # median unprofiled step during the sync
        med = 1e3 * float(np.median(steps["during"]))
        prof["busy_share_of_median_step"] = prof["device_busy_ms"] / med
        log(f"  {label}: the profiled stage step's device time {prof['device_busy_ms']:.2f} ms "
            f"is {100 * prof['busy_share_of_median_step']:.1f}% of the median synchronized "
            f"step during the sync ({med:.1f} ms)")
    stager_h = dict(count=gw.h_stager.count, p50_ms=1e3 * gw.h_stager.p50,
                    p99_ms=1e3 * gw.h_stager.p99, max_ms=1e3 * max(e[5] for e in spans),
                    spans_by_phase=span_phases, audit=audit, **profiled)
    out["stage"] = stage_report(label, probe, spans, profiled, device)
    if parts_case and device == "cuda" and probe.step_segments:
        from repro_torch.launch import roofline

        peaks = roofline.CARD_PEAKS[roofline.card_key(torch.cuda.get_device_name(0))]
        out["step_case"] = step_case(label, probe.step_segments, peaks, torch)
    probe.step_segments = None
    misses = gw.views.misses
    late = [gw.submit(np.arange(1, 20, dtype=np.int32), license=t, max_new_tokens=4)
            for t in ("full", "free")]
    gw.run()
    if any(r.version != 2 or r.state.value != "done" for r in late) \
            or gw.views.misses != misses:
        fail(f"{label}: post-flip requests not served on v2 through prewarmed views")
    out.update(
        sync_steps_by_phase=phases, parts_applied=st["parts_applied"],
        bytes_applied=st["bytes_applied"], layers_touched=st["layers_touched"],
        layers_requantized=st["layers_requantized"],
        views_prewarmed=st["views_prewarmed"], wire=st["wire"],
        sync_wire_bytes=gw._client.bytes_downloaded - wire0,
        begin_to_flip_s=flip_t - t_begin,
        step_ms={k: {"n": len(v), "max": 1e3 * max(v) if v else None,
                     "median": 1e3 * float(np.median(v)) if v else None}
                 for k, v in steps.items()},
        stager_histogram=stager_h, lease_states=lease_states,
        tokens=[r.out_tokens for r in reqs])
    log(f"  {label}: v2 staged in {sum(phases.values())} steps {phases}, "
        f"{st['parts_applied']} parts, {st['bytes_applied'] / 1e6:.1f} MB applied, "
        f"{out['sync_wire_bytes'] / 1e6:.1f} MB on the wire; begin_sync "
        f"{out['begin_sync_s']:.2f} s, begin->flip {out['begin_to_flip_s']:.2f} s")
    sm = out["step_ms"]
    log(f"  {label}: longest scheduler step before the sync "
        f"{sm['before']['max']:.1f} ms, during {sm['during']['max']:.1f} ms "
        f"(median {sm['during']['median']:.1f} ms over {sm['during']['n']}), after "
        f"{sm['after']['max']:.1f} ms; in-flight requests stayed on v1, one flip, "
        f"v2 bit-exact, post-flip requests on prewarmed v2 views")
    log(f"  {label}: stager spans {span_phases}; h_stager (host clock around each "
        f"stager step, no synchronize) p50 {stager_h['p50_ms']:.2f}, p99 "
        f"{stager_h['p99_ms']:.2f} (bucket-interpolated), max {stager_h['max_ms']:.2f} ms over "
        f"{gw.h_stager.count}, "
        f"against the script's synchronized longest scheduler step during the sync "
        f"{sm['during']['max']:.1f} ms; audit: one sync_begin, one version_flip")
    if lease:
        out["lease_walk"] = lease_walk(label, gw, tr, clock, server, np)
    del gw
    gc.collect()
    return out


# ------------------------------------------------------------ phase 8
# the offline lifecycle (paper Fig. 3 and the quickstart): the paper's MLP
# trained, compressed, fine-tuned, published, calibrated and pulled; the
# compression pipeline on phase 3's weights; LM training at full width
QUICK = dict(n=8000, train=6000, steps=600, sparsity=0.8, finetune=200,
             target=0.70, k_intervals=12, update=25)
QUICK_MIN_ACC = 0.95
SHARE = dict(k=32, iters=25)
TRAIN = dict(seq=256, batch=2, steps=5, lr=1e-4)
# kernel families of a training step's device trace: the first whose
# words a kernel's name holds (lower case), else "other"
KERNEL_FAMILIES = {"gemm": ("gemm", "xmma", "cutlass", "nvjet"), "softmax": ("softmax",),
                   "reduce": ("reduce",), "elementwise": ("elementwise",),
                   "index": ("index", "gather", "scatter", "embedding", "sort")}
# one checkpoint: a commit of the 2-unit model (its 0.62 B embedding and
# head parameters among 11,856 zlib pages) takes about a minute of host
# time on the card's machine (PERF.md section 5), two would pass 90 s
CKPT = dict(units=2, steps=2, every=2)
LOSS_RTOL = 1e-3
# internvl2-26b's training step with its vision prefix (the patch
# embeddings of every row through ``vision_proj``), cut to 4 of its 48
# units: at full depth its weights and AdamW state would not fit one card
VLM_TRAIN = dict(units=4, batch=2, seq=256, steps=2, lr=1e-4)


class kept_instances:
    """Inside it, the class ``module.name`` is a subclass that keeps its
    instances in the list the ``with`` gives (a compiled step's captures
    and replays, read after its loop returns)."""

    def __init__(self, module, name):
        self.module, self.name = module, name

    def __enter__(self):
        cls = self.cls = getattr(self.module, self.name)
        made = self.made = []

        class Kept(cls):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made.append(self)

        setattr(self.module, self.name, Kept)
        return made

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.cls)


class eager_training:
    """Inside it, the training loops take their eager steps
    (``train_lib._graph_backend`` returns ``None``), the eager twin of the
    CUDA graphs they run on the card."""

    def __enter__(self):
        from repro_torch.training import train_lib

        self.saved = train_lib._graph_backend
        train_lib._graph_backend = lambda device: None

    def __exit__(self, *exc):
        from repro_torch.training import train_lib

        train_lib._graph_backend = self.saved


def max_diff(a, b, torch):
    """The largest |difference| of two param trees' leaves."""
    return max(float((x.float() - y.float()).abs().max()) for x, y in zip(_leaves(a), _leaves(b)))


def quickstart_phase(np, torch, device="cuda"):
    """8a: ``examples/quickstart.py`` step for step at the paper's size
    (``TABLE1_A``): train and fine-tune through the SGD step's CUDA graph
    (each beside an eager twin on the same data: accuracies and the
    largest parameter difference), compress, publish, calibrate a free
    tier, two licensed pulls and a 25-weight delta update.  The launch
    counters are zeroed just before the pulls and read just after."""
    from repro_torch.configs.paper_mlp import TABLE1_A
    from repro_torch.core import compress_pipeline, flatten_params, unflatten
    from repro_torch.core.licensing import calibrate_license
    from repro_torch.core.protocol import EdgeClient, LicenseServer
    from repro_torch.core.weightstore import WeightStore
    from repro_torch.data import classification_data
    from repro_torch.kernels import ops
    from repro_torch.training import finetune_pruned_mlp, mlp_accuracy, train_lib, train_mlp

    out = {}
    x, y = classification_data(QUICK["n"], TABLE1_A.in_dim, TABLE1_A.num_classes, seed=0)
    n = QUICK["train"]
    xtr, ytr, xte, yte = x[:n], y[:n], x[n:], y[n:]

    def twins(label, run):
        """``run()`` through the graphs, then its eager twin; returns the
        graph run's params."""
        with kept_instances(train_lib, "SgdStepGraph") as made:
            t0 = time.perf_counter()
            got = run()
            sync()
            graph_s = time.perf_counter() - t0
        with eager_training():
            t0 = time.perf_counter()
            twin = run()
            sync()
            eager_s = time.perf_counter() - t0
        if device == "cuda" and len(made) != 1:
            fail(f"8a: {label} ran {len(made)} SGD step graphs, not 1")
        row = dict(graph_s=graph_s, eager_s=eager_s, acc=mlp_accuracy(got, xte, yte),
                   eager_acc=mlp_accuracy(twin, xte, yte),
                   max_param_diff=max_diff(got, twin, torch),
                   captures=sum(g.captures for g in made), replays=sum(g.replays for g in made))
        log(f"  {label}: through the graph {graph_s:.2f} s ({row['captures']} capture, "
            f"{row['replays']} replays), acc={row['acc']:.4f}; the eager twin {eager_s:.2f} s, "
            f"acc={row['eager_acc']:.4f}; largest parameter difference {row['max_param_diff']:.3g}")
        return got, row

    params, out["train"] = twins(f"[1] train {TABLE1_A.name}", lambda: train_mlp(
        TABLE1_A, xtr, ytr, steps=QUICK["steps"], device=device))
    out["train_s"], out["trained_acc"] = out["train"]["graph_s"], out["train"]["acc"]
    log(f"  [1] trained {TABLE1_A.name} ({TABLE1_A.num_params} params) {QUICK['steps']} "
        f"steps in {out['train_s']:.2f} s: acc={out['trained_acc']:.4f}")
    if out["trained_acc"] < QUICK_MIN_ACC:
        fail(f"8a: trained accuracy {out['trained_acc']} below {QUICK_MIN_ACC}")

    pruned, _, stats = compress_pipeline(params, sparsity=QUICK["sparsity"])
    zeros = {k: v == 0 for k, v in flatten_params(pruned).items()}
    pruned, out["finetune"] = twins("[2] fine-tune", lambda: finetune_pruned_mlp(
        TABLE1_A, pruned, xtr, ytr, steps=QUICK["finetune"]))
    out["finetune_s"] = out["finetune"]["graph_s"]
    flat = flatten_params(pruned)
    moved = [k for k, z in zeros.items() if bool((flat[k][z] != 0).any())]
    if moved:
        fail(f"8a: pruned zeros became non-zero in fine-tuning: {moved}")
    out["pruned_acc"] = mlp_accuracy(pruned, xte, yte)
    out["stats"] = vars(stats)
    log(f"  [2] pruned {QUICK['sparsity']:.0%} + fine-tuned {QUICK['finetune']} steps "
        f"({out['finetune_s']:.2f} s): acc={out['pruned_acc']:.4f}, every pruned zero "
        f"still 0; storage {stats.full_bytes} B -> {stats.quantized_bytes} B ({out['stats']})")

    store = WeightStore(":memory:")
    store.register_model("prod-mlp", "paper-mlp")
    server = LicenseServer(store)
    v1 = server.publish("prod-mlp", pruned, tag="v1.0")
    out["db"] = store.storage_bytes("prod-mlp")
    log(f"  [3] published version {v1}; DB rows {out['db']['weight_rows']}, {out['db']}")

    t0 = time.perf_counter()
    tier, trace = calibrate_license(pruned, lambda p: mlp_accuracy(p, xte, yte),
                                    target_accuracy=QUICK["target"],
                                    k_intervals=QUICK["k_intervals"], tier_name="free")
    out["calibrate_s"] = time.perf_counter() - t0
    out["evaluations"] = len(trace)
    server.publish_tier("prod-mlp", tier)
    log(f"  [4] calibrated tier 'free': accuracy {tier.accuracy:.4f} after {len(trace)} "
        f"Algorithm-1 evaluations ({out['calibrate_s']:.2f} s)")

    empty = {k: torch.zeros_like(v) for k, v in flat.items()}
    paid = EdgeClient("prod-mlp", dict(empty), license_name="full")
    free = EdgeClient("prod-mlp", dict(empty), license_name="free")
    ops.reset_launches()
    first = [paid.request_update(server), free.request_update(server)]
    out["paid_acc"] = mlp_accuracy(unflatten(paid.params), xte, yte)
    out["free_acc"] = mlp_accuracy(unflatten(free.params), xte, yte)
    log(f"  [5] paid client acc={out['paid_acc']:.4f}, free client acc="
        f"{out['free_acc']:.4f}; packets {[(p.num_entries, p.nbytes) for p in first]}")
    if not out["free_acc"] < out["paid_acc"]:
        fail(f"8a: free accuracy {out['free_acc']} is not below paid {out['paid_acc']}")

    newp = {k: v.clone() for k, v in flat.items()}
    newp["layer3/kernel"].view(-1)[:QUICK["update"]] += 0.01
    server.publish("prod-mlp", unflatten(newp), tag="v1.1")
    packet = paid.request_update(server)
    out["launches"] = dict(ops.LAUNCHES)
    out["packet"] = dict(entries=packet.num_entries, nbytes=packet.nbytes,
                         initial_bytes=paid.bytes_downloaded - packet.nbytes)
    log(f"  [6] delta update: {packet.num_entries} weights, {packet.nbytes} B (vs "
        f"{out['packet']['initial_bytes']} B initial download); launches of the pulls "
        f"{out['launches']}")
    if packet.num_entries != QUICK["update"]:
        fail(f"8a: the delta packet holds {packet.num_entries} entries, not "
             f"{QUICK['update']}")
    if device == "cuda" and out["launches"]["delta_apply"] <= 0:
        fail("8a: the pulls launched no delta_apply")
    store.close()
    return out


def compression_phase(cfg, params, np, torch):
    """8b: ``compress_pipeline`` on ``params`` (every pruned leaf recounted
    against its threshold; one stacked leaf pruned and quantized again on
    the CPU and held bit for bit), then ``weight_share`` on one MLP
    slice."""
    from repro_torch.core import compression
    from repro_torch.core.pytree_io import flatten_params

    out = {}
    cuda = torch.cuda.is_available()
    base = torch.cuda.memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    timings = {}
    pruned, quant, stats = compression.compress_pipeline(params, timings=timings)
    out.update(seconds=timings, stats=vars(stats))
    if cuda:
        out["peak_above_weights_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    log(f"  compress_pipeline(sparsity 0.8): prune {timings['prune']:.3f} s, quantize "
        f"{timings['quantize']:.3f} s, stats {timings['stats']:.3f} s; peak "
        f"{out.get('peak_above_weights_gb', float('nan')):.2f} GB above the weights; "
        f"{out['stats']}")

    flat, pflat = flatten_params(params), flatten_params(pruned)
    for name, w in flat.items():
        if compression.is_dynamics_param(name) or w.ndim < 2:
            if pflat[name] is not w:
                fail(f"8b: {name} is exempt from pruning but was replaced")
            continue
        thr = compression.magnitude_threshold(w, 0.8)
        want = sum(int(((w[s].abs().float() >= thr) & (w[s] != 0)).sum())
                   for s in compression.row_slices(w))
        got = int(torch.count_nonzero(pflat[name]))
        if got != want:
            fail(f"8b: {name} keeps {got} non-zeros; its threshold {float(thr)} implies "
                 f"{want}")
    log(f"  every pruned leaf's non-zero count equals its threshold's recount "
        f"({len(pflat)} leaves)")

    name = "units/b0/mixer/wq"
    t0 = time.perf_counter()
    host = compression.magnitude_prune(flat[name].cpu(), 0.8)
    host_q = compression.quantize_int8(host)
    out["cpu_leaf_s"] = time.perf_counter() - t0
    card = pflat[name].cpu()
    differ = [part for part, same in (
        ("mask", torch.equal(host != 0, card != 0)),
        ("values", same_bits(host, card, torch)),
        ("codes", torch.equal(host_q.codes, quant[name].codes.cpu())),
        ("scales", torch.equal(host_q.scale, quant[name].scale.cpu()))) if not same]
    if differ:
        fail(f"8b: {name} pruned and quantized on the CPU differs from the card's in "
             f"its {differ}")
    log(f"  {name} {tuple(flat[name].shape)} pruned and quantized again on the CPU "
        f"({out['cpu_leaf_s']:.2f} s): masks, values, codes and scales identical")
    del pruned, quant, pflat, host, host_q
    gc.collect()

    w = flat["units/b0/ffn/w_up"][0]
    sync()
    t0 = time.perf_counter()
    shared = compression.weight_share(w, **SHARE)
    sync()
    out["weight_share_s"] = time.perf_counter() - t0
    vals = w.float().reshape(-1)
    lo, hi = vals.min(), vals.max()
    k = SHARE["k"]
    init = lo + (hi - lo) * (torch.arange(k, dtype=torch.float32, device=w.device) + 0.5) / k
    mse = float(((shared.codebook[shared.indices.reshape(-1).long()] - vals) ** 2).mean())
    mse_init = float(((init[compression._assign(vals, init)] - vals) ** 2).mean())
    top = int(shared.indices.max())
    out.update(weight_share_mse=mse, linear_init_mse=mse_init, max_index=top,
               shared_nbytes=shared.nbytes)
    log(f"  weight_share(k={k}, iters={SHARE['iters']}) on ffn/w_up[0] "
        f"{tuple(w.shape)}: {out['weight_share_s']:.3f} s, MSE {mse:.4g} against the "
        f"linear init's {mse_init:.4g}, max index {top}, {shared.nbytes} B")
    if top >= k:
        fail(f"8b: a shared index {top} is not below k = {k}")
    if not mse < mse_init:
        fail(f"8b: k-means MSE {mse} is not below the linear init's {mse_init}")
    return out


def kernel_families(events):
    """Device ms and kernels of ``events`` ((name, start us, duration
    us)) by ``KERNEL_FAMILIES``, and the same of the step's tail: every
    kernel after its last GEMM (the embedding's gradient, the grad norm
    and AdamW)."""
    def family(name):
        low = name.lower()
        return next((f for f, words in KERNEL_FAMILIES.items()
                     if any(w in low for w in words)), "other")

    def split(evs):
        out, by_name = {}, {}
        for name, _, dur in evs:
            f = out.setdefault(family(name), dict(ms=0.0, kernels=0))
            f["ms"] += dur / 1e3
            f["kernels"] += 1
            by_name[name] = by_name.get(name, 0.0) + dur / 1e3
        for f, v in out.items():          # each family's heaviest kernel
            v["top"] = max((n for n in by_name if family(n) == f), key=by_name.get)[:100]
        return out

    gemms = [ts for name, ts, _ in events if family(name) == "gemm"]
    tail = [e for e in events if gemms and e[1] > max(gemms)]
    return dict(families=split(events), tail=split(tail),
                tail_ms=sum(d for _, _, d in tail) / 1e3, tail_kernels=len(tail))


def training_run(label, cfg, params, batch, ocfg, np, torch, compiled, steps=TRAIN["steps"],
                 profile=True):
    """One ``train_loop`` of ``steps`` steps on ``params`` (``batch``
    repeated), through its CUDA graph or, ``compiled=False``, eager: each
    step's ms (host clock between log lines, each after a synchronize),
    its loss and exact grad norm (the graph's static output, or the eager
    step's metric), the peak memory and, through the graph, its captures,
    replays and pool bytes, and with ``profile`` its last step's replay
    profiled (``kernel_families`` of its device trace)."""
    import itertools

    from repro_torch.training import train_lib, train_loop

    cuda = torch.cuda.is_available()
    lines, stamps, gnorms, pools, last = [], [], [], [], []
    make_train_step = train_lib.make_train_step

    def recording(*a, **kw):
        fn = make_train_step(*a, **kw)

        def step(*sa, **skw):
            out = fn(*sa, **skw)
            last[:] = [out[2]]
            return out
        return step

    profiles = []

    def profiled(graph):
        """``graph.step`` for one call under the profiler."""
        step = graph.step

        def once(b):
            del graph.step
            got = []
            profiles.append(profile_window("train_step_replay", lambda: got.append(step(b)),
                                           torch, 1, keep_kernels=True))
            return got[0]
        return once

    def log_fn(line):
        sync()
        stamps.append(time.perf_counter())
        if made:
            gnorms.append(float(made[0].metrics["grad_norm"]))
            pools.append(made[0].backend.pool_bytes() if cuda else 0)
            if cuda and profile and len(stamps) == steps - 1:
                made[0].step = profiled(made[0])
        else:
            gnorms.append(float(last[0]["grad_norm"]))
        lines.append(line)
        log(f"    {line}")

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with contextlib.ExitStack() as stack:
        made = stack.enter_context(kept_instances(train_lib, "TrainStepGraph"))
        if not compiled:
            stack.enter_context(eager_training())
            train_lib.make_train_step = recording
            stack.callback(setattr, train_lib, "make_train_step", make_train_step)
        sync()
        t0 = time.perf_counter()
        trained, hist = train_loop(cfg, ocfg, itertools.repeat(batch), steps,
                                   params=params, log_every=1, log_fn=log_fn)
    del trained
    gc.collect()
    if compiled and cuda and len(made) != 1:
        fail(f"8c: the {label} loop ran {len(made)} step graphs, not 1")
    step_ms = [1e3 * (b - a) for a, b in zip([t0] + stamps, stamps)]
    tokens = batch["tokens"].size
    # the first step captures, the last is profiled: the median of the others
    steady = step_ms[1:-1] if steps > 2 else step_ms[1:]
    out = dict(loss=hist["loss"], grad_norm=gnorms, step_ms=step_ms,
               tokens_per_s=[1e3 * tokens / ms for ms in step_ms],
               steady_ms=float(np.median(steady)))
    if cuda:
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if made:
        out.update(captures=made[0].captures, replays=made[0].replays,
                   pool_gb=max(pools) / 1e9)
    graphs = (f"; {out['captures']} capture, {out['replays']} replays, pool "
              f"{out['pool_gb']:.3f} GB" if made else "")
    rows, seq = batch["tokens"].shape
    log(f"  8c {label}: {steps} steps of {rows} x {seq} tokens: "
        f"ms per step {[round(ms, 2) for ms in step_ms]} ("
        + (f"steps 2-{steps - 1} median" if steps > 2 else "step 2")
        + f" {out['steady_ms']:.2f}), tokens/s {[round(t, 1) for t in out['tokens_per_s']]}; peak "
        f"{out.get('peak_gb', 0):.1f} GB{graphs}")
    prof = profiles[0] if profiles else None
    if prof is not None:
        split = kernel_families(prof.pop("kernel_events"))
        out["replay_profile"] = dict(kernel_ms=prof["kernel_ms_per_step"],
                                     kernels=prof["kernel_launches_per_step"],
                                     busy_share=prof["busy_share"], window_ms=prof["window_ms"],
                                     **split)
        fams = sorted(split["families"].items(), key=lambda kv: -kv[1]["ms"])
        log(f"  8c {label}: the last step's replay in the device trace: "
            f"{prof['kernel_ms_per_step']:.2f} ms of kernels in "
            f"{prof['kernel_launches_per_step']:.0f} launches; by family (ms / kernels) "
            + ", ".join(f"{f} {v['ms']:.2f} / {v['kernels']}" for f, v in fams)
            + "; heaviest kernel of each: " + "; ".join(f"{f} {v['top']}" for f, v in fams)
            + f"; after the last GEMM {split['tail_ms']:.2f} ms in {split['tail_kernels']} "
            f"kernels (" + ", ".join(f"{f} {v['ms']:.2f} / {v['kernels']}"
                                     for f, v in split["tail"].items()) + ")")
    return out


def training_phase(cfg, params, np, torch):
    """8c: ``train_loop`` on ``params`` at full depth (one batch
    repeated), eager and then through its CUDA graph: step times, peak
    memory, and losses and grad norms bit for bit (else the first
    differing step, and every value within ``LOSS_RTOL`` relative); then
    a checkpointed run through the graph at ``CKPT['units']`` units into
    an in-memory ``WeightStore``."""
    import itertools

    from repro_torch.core.weightstore import WeightStore
    from repro_torch.data import LMDataConfig, lm_batches
    from repro_torch.models.model import lm_loss
    from repro_torch.training import OptimizerConfig, train_loop

    out = {}
    device = next(iter(_leaves(params))).device
    batch = next(lm_batches(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN["seq"],
                                         batch_size=TRAIN["batch"], seed=SEED)))
    ocfg = OptimizerConfig(lr=TRAIN["lr"], warmup_steps=1, total_steps=TRAIN["steps"])
    with torch.no_grad():
        want = float(lm_loss(params, cfg, torch.from_numpy(batch["tokens"]).to(device),
                             torch.from_numpy(batch["labels"]).to(device))[0])
    n_params = sum(t.numel() for t in _leaves(params))
    eager = training_run("eager", cfg, params, batch, ocfg, np, torch, compiled=False)
    graph = training_run("graph", cfg, params, batch, ocfg, np, torch, compiled=True)
    out.update(graph, eager=eager, lm_loss=want, optimizer_state_bytes=8 * n_params)
    pairs = list(zip(graph["loss"] + graph["grad_norm"], eager["loss"] + eager["grad_norm"]))
    differ = [i % TRAIN["steps"] for i, (a, b) in enumerate(pairs) if a != b]
    out["first_differing_step"] = min(differ) if differ else None
    worst = max(abs(a - b) / abs(b) for a, b in pairs)
    log(f"  8c: the graph step {graph['steady_ms']:.2f} ms against {eager['steady_ms']:.2f} ms "
        f"eager (medians of steps 2-{TRAIN['steps'] - 1}), peak {graph.get('peak_gb', 0):.1f} GB "
        f"against {eager.get('peak_gb', 0):.1f}; losses and grad norms "
        + ("bit for bit" if not differ else
           f"first differ at step {out['first_differing_step']}, at most {worst:.3g} relative")
        + f"; optimizer state {out['optimizer_state_bytes'] / 1e9:.2f} GB; lm_loss of the batch "
        f"{want:.6f}")
    if differ and worst > LOSS_RTOL:
        fail(f"8c: the graph loop's losses or grad norms differ from the eager loop's by "
             f"{worst} relative, above {LOSS_RTOL}")
    hist = graph
    if not all(np.isfinite(hist["loss"])) or not all(np.isfinite(hist["grad_norm"])):
        fail(f"8c: non-finite loss {hist['loss']} or grad norm {hist['grad_norm']}")
    if not hist["loss"][-1] < hist["loss"][0]:
        fail(f"8c: the loss did not fall: {hist['loss']}")
    if abs(hist["loss"][0] - want) > LOSS_RTOL * abs(want):
        fail(f"8c: the first step's loss {hist['loss'][0]} differs from lm_loss {want} "
             f"by more than {LOSS_RTOL} relative")

    # the checkpointed run at reduced depth: the first units of the weights
    cfg_c = cfg.replace(num_layers=CKPT["units"])
    small = {k: v for k, v in params.items() if k != "units"}
    small["units"] = {"b0": tree_map(lambda t: t[:CKPT["units"]], params["units"]["b0"])}
    store = WeightStore(":memory:")
    commits = []
    commit = store.commit

    def timed_commit(*a, **kw):
        t = time.perf_counter()
        version = commit(*a, **kw)
        rows = [store.conn.execute(f"SELECT COUNT(*) FROM {table} WHERE version_fk=?",
                                   (version,)).fetchone()[0]
                for table in ("weight", "weight_chunk")]
        commits.append(dict(version=version, s=time.perf_counter() - t, weight_rows=rows[0],
                            chunk_pages=rows[1]))
        return version

    store.commit = timed_commit
    t0 = time.perf_counter()
    trained, hist = train_loop(cfg_c, ocfg, itertools.repeat(batch), CKPT["steps"],
                               params=small, log_every=1, store=store,
                               checkpoint_every=CKPT["every"],
                               log_fn=lambda line: log(f"    {line}"))
    out["checkpointed"] = dict(units=CKPT["units"], steps=CKPT["steps"],
                               every=CKPT["every"], s=time.perf_counter() - t0,
                               loss=hist["loss"], commits=commits,
                               history=[h["message"] for h in store.history(cfg.name)])
    for c in commits:
        log(f"  checkpoint v{c['version']}: {c['s']:.2f} s, {c['weight_rows']} weight "
            f"rows, {c['chunk_pages']} chunk pages")
    messages = out["checkpointed"]["history"]
    if messages != [f"step {i}" for i in range(CKPT["every"], CKPT["steps"] + 1,
                                               CKPT["every"])]:
        fail(f"8c: the store's history is {messages}, not one checkpoint every "
             f"{CKPT['every']} steps")
    log(f"  checkpointed run ({CKPT['units']} units, {CKPT['steps']} steps, every "
        f"{CKPT['every']}): {out['checkpointed']['s']:.2f} s, history {messages}")
    store.close()
    del store, trained, small
    gc.collect()
    torch.cuda.empty_cache()
    out["vlm"] = vlm_training(np, torch)
    return out


def vlm_training(np, torch, device="cuda"):
    """8c's vision part: internvl2-26b at full width, VLM_TRAIN['units']
    units, random weights from ``SEED``, one batch of token rows with
    ``num_patches`` patch embeddings each (numpy, from the seed), through
    ``train_loop`` VLM_TRAIN['steps'] steps eager and as many through its
    CUDA graph: losses and grad norms bit for bit (else every value within
    ``LOSS_RTOL`` relative), finite, and the first loss within
    ``LOSS_RTOL`` of ``lm_loss(..., patch_embeds=)``."""
    from repro_torch.configs import get_config
    from repro_torch.data import LMDataConfig, lm_batches
    from repro_torch.models import init_params
    from repro_torch.models.model import lm_loss
    from repro_torch.training import OptimizerConfig

    t0 = time.perf_counter()
    full = get_config("internvl2-26b")
    cfg = full.replace(num_layers=VLM_TRAIN["units"])
    rows, seq, steps = VLM_TRAIN["batch"], VLM_TRAIN["seq"], VLM_TRAIN["steps"]
    params = init_params(cfg, seed=SEED, device=device)
    batch = next(lm_batches(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                         batch_size=rows, seed=SEED)))
    rng = np.random.default_rng(SEED + 8)
    batch["patch_embeds"] = (0.1 * rng.standard_normal(
        (rows, cfg.num_patches, cfg.d_model))).astype(np.float32)
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"  8c internvl2-26b at full width, {cfg.num_layers} units (depth cut from "
        f"{full.num_layers}; d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, "
        f"vocab {cfg.padded_vocab}, {n_params / 1e9:.3f} B parameters): {rows} rows of "
        f"{cfg.num_patches} patches through vision_proj and {seq} tokens")
    ocfg = OptimizerConfig(lr=VLM_TRAIN["lr"], warmup_steps=1, total_steps=steps)
    with torch.no_grad():
        dev = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        want = float(lm_loss(params, cfg, dev["tokens"], dev["labels"],
                             patch_embeds=dev["patch_embeds"])[0])
        del dev
    eager = training_run("internvl2-26b eager", cfg, params, batch, ocfg, np, torch,
                         compiled=False, steps=steps, profile=False)
    graph = training_run("internvl2-26b graph", cfg, params, batch, ocfg, np, torch,
                         compiled=True, steps=steps, profile=False)
    del params
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    pairs = list(zip(graph["loss"] + graph["grad_norm"], eager["loss"] + eager["grad_norm"]))
    worst = max(abs(a - b) / abs(b) for a, b in pairs)
    out = dict(units=cfg.num_layers, cut_from=full.num_layers, rows=rows, seq=seq,
               patches=cfg.num_patches, params=n_params, eager=eager, graph=graph,
               lm_loss=want, max_rel_diff=worst, s=time.perf_counter() - t0)
    first = "equal" if graph["loss"][0] == want else f"{graph['loss'][0]:.6f}"
    log(f"  8c internvl2-26b: the graph step {graph['steady_ms']:.2f} ms against "
        f"{eager['steady_ms']:.2f} ms eager (step 2), peak {graph.get('peak_gb', 0):.1f} GB "
        f"against {eager.get('peak_gb', 0):.1f}; losses {graph['loss']} and grad norms "
        + ("bit for bit the eager loop's" if worst == 0 else
           f"at most {worst:.3g} relative from the eager loop's")
        + f"; lm_loss(patch_embeds=) of the batch {want:.6f} (the first loss {first}); "
        f"{out['s']:.1f} s")
    if worst > LOSS_RTOL:
        fail(f"8c internvl2-26b: the graph loop's losses or grad norms differ from the eager "
             f"loop's by {worst} relative, above {LOSS_RTOL}")
    if not all(np.isfinite(graph["loss"] + graph["grad_norm"])):
        fail(f"8c internvl2-26b: non-finite loss {graph['loss']} or grad norm "
             f"{graph['grad_norm']}")
    if abs(graph["loss"][0] - want) > LOSS_RTOL * abs(want):
        fail(f"8c internvl2-26b: the first step's loss {graph['loss'][0]} differs from "
             f"lm_loss(patch_embeds=) {want} by more than {LOSS_RTOL} relative")
    return out


# ------------------------------------------------------------ phase 9
# the dense family beyond qwen at full width: nemotron-4-15b (squared
# ReLU, 48 q heads over 8) and minitron-8b (squared ReLU, 32 over 8) at
# DENSE_CUT_UNITS layers, granite-34b (SwiGLU at d_ff 24576, 48 q heads on
# ONE kv head: 47.25 B parameters, 94.5 GB of bf16 at its 88 layers) at
# GRANITE_UNITS from an int8 store built unit by unit.  Random bf16
# weights from SEED, phase 3's GEOMETRY, the first DENSE_REQUESTS requests
# of phase 3's stream in tiers full and free; decode and prefill graphs on
# (the default gateway).  At full depth granite's 88 units of int8 codes
# (47.9 GB) fit beside the graph pools on an 80 GB card
DENSE_REQUESTS = 8
# 9a and 9b run nemotron-4-15b and minitron-8b at this depth (of their 32
# layers), 9c granite-34b at GRANITE_UNITS (of 88): every width, head
# group and kernel instance stays; the depth cuts pay for phase 10e
DENSE_CUT_UNITS = 4
GRANITE_UNITS = 44
# decode steps timed in each run's steady window (``steady_decode_ms``)
DENSE_STEADY_STEPS = 8
# 9d: the gateway's fallbacks on phase 3's weights (qwen2.5-3b), each run
# on phase 3's stream with the run its tokens are held to: the
# gather/scatter decode against phase 3's own stream; the contiguous pool
# prefills by buckets (as the JAX slot does), whose left padding changes
# the model's input, so it is held to the paged pool's bucket prefill
FALLBACK_RUNS = {"kernel_decode_off": (dict(kernel_decode=False), "phase 3's float stream"),
                 "bucket_prefill": (dict(chunk_size=0, prefix_cache=False), None),
                 "contiguous_pool": (dict(paged=False), "bucket_prefill")}
FALLBACK_SLOTS = {"qwen-paged": {}, "qwen-contiguous": dict(paged=False)}


def dense_jobs(cfg, np):
    return stream_jobs(cfg, np)[:DENSE_REQUESTS]


def steady_decode_ms(label, gw, jobs, steps=DENSE_STEADY_STEPS):
    """Submit ``jobs`` to ``gw`` again (its graphs captured by a first
    drain), step until no request waits or prefills, then time ``steps``
    decode steps on the host clock with a synchronize on each side:
    graph replays of the route's decode step on the card, eager steps
    where its graphs were taken away.  Returns the ms a step, the lanes
    decoding at the window's start and the decode graphs captured inside
    it (0 expected).  Leaves the stream mid-flight."""
    gw.__dict__.pop("_sample", None)           # drop record_rows's per-step copy
    reqs = [gw.submit(p, license=t, max_new_tokens=n) for p, t, n in jobs]
    while any(r.state.value in ("queued", "prefilling") for r in reqs):
        if gw.step() is None:
            fail(f"{label}: the stream drained before every request decoded")
    lanes = sum(r.state.value == "running" for r in reqs)
    g = gw._graphs if gw.kernel_decode else gw._gather_graphs
    captures = g.captures if g is not None else 0
    sync()
    t0 = time.perf_counter()
    kinds = [gw.step().kind for _ in range(steps)]
    sync()
    ms = 1e3 * (time.perf_counter() - t0) / steps
    if kinds != ["decode"] * steps:
        fail(f"{label}: the steady window ran {kinds}, not {steps} decode steps")
    return dict(step_ms=ms, lanes=lanes,
                captures_in_window=(g.captures if g is not None else 0) - captures)


def random_unit(cfg, u, torch, device="cuda"):
    """Unit ``u``'s block leaves, stacked on a unit axis of one, with
    ``init_params``' distributions, from the seed (SEED, u): a one-unit
    model of the config's widths (its vocabulary cut to 256, the
    embedding and head unused)."""
    from repro_torch.models import init_params

    one = init_params(cfg.replace(num_layers=len(cfg.layer_pattern), vocab_size=256),
                      seed=SEED * 100_003 + 1 + u, device=device)
    return one["units"]


def store_by_unit(cfg, torch, device="cuda"):
    """The int8 serving store of ``cfg`` with random weights, built one
    unit at a time: each unit's bf16 leaves (``random_unit``) through
    ``quantize_serving_params``, copied into preallocated stacked codes
    and scales, so the whole model's bf16 never exists at once (94.5 GB
    for granite-34b); then the tail blocks (recurrentgemma-2b's two,
    rank-2 leaves), drawn as a model of the tail's layers alone.  The
    scale reduces over the contraction dim only, so this is the store of
    the stacked tree."""
    from repro_torch.models import init_params
    from repro_torch.serving.quantized import quantize_serving_params

    units, stack = cfg.pattern_units, None
    for u in range(units):
        one = quantize_serving_params({"units": random_unit(cfg, u, torch, device)})["units"]
        if stack is None:
            stack = tree_map(lambda t: t.new_empty((units, *t.shape[1:])), one)
        for dst, src in zip(_leaves(stack), _leaves(one)):
            dst[u].copy_(src[0])
    store = {**dense_outer(cfg, torch, device), "units": stack}
    if cfg.tail_pattern:
        tail = init_params(cfg.replace(num_layers=len(cfg.tail_pattern), vocab_size=256),
                           seed=SEED * 100_003 + 1 + units, device=device)["tail"]
        store["tail"] = quantize_serving_params({"tail": tail})["tail"]
    return store


def dense_outer(cfg, torch, device="cuda"):
    """The embedding, final norm and head of ``init_params(cfg, seed=SEED)``
    without its units."""
    from repro_torch.models import init_params

    full = init_params(cfg.replace(num_layers=0), seed=SEED, device=device)
    return {k: v for k, v in full.items() if k != "units"}


def dense_run(label, cfg, params, tiers, np, torch, device="cuda", route=None, check=None,
              geometry=GEOMETRY, jobs=None, view_tiers=("full", "free"), turns=False,
              trace_steps=0, **kw):
    """One gateway (``kw`` its arguments beside ``geometry``) serving
    ``jobs`` ((prompt, tier, new tokens); by default the first
    DENSE_REQUESTS of phase 3's stream): the views of ``view_tiers`` (both
    tiers by default) built first (as
    phase 3 does), then the launch counters zeroed, the stream drained and
    the counters read.  Checks each kernel the route runs: on the kernel
    route ``paged_attention`` and ``paged_decode_write`` launch once a unit
    for each decode capture's warm-up (replays pass no wrapper); on an
    in-scan store ``masked_dequant`` launches once per int8 leaf of every
    unit and tail block of each eager step or warm-up.  ``route`` maps
    gateway attributes to the values the gateway must have chosen;
    ``check(gw, reqs, rows)`` runs after the drain.  With ``turns`` (a
    gateway without a prefix cache) the stream is served again on the
    eager route (``eager_route``), its greedy tokens identical to the
    graphs', and the steady decode step is timed in turns, graph beside
    eager (``steady_turns``); then ``trace_steps`` decode steps through
    the graphs are profiled and the device trace's ``masked_dequant``
    launches a step read.  Returns the requests, their logits rows and
    a summary; the gateway is dropped."""
    from repro_torch.kernels import ops
    from repro_torch.serving import LicensedGateway
    from repro_torch.serving.quantized import qleaves

    jobs = dense_jobs(cfg, np) if jobs is None else jobs
    torch.cuda.reset_peak_memory_stats()
    gw = LicensedGateway(cfg, params, tiers=tiers, device=device, **kw, **geometry)
    # the views stay the gateway's alone (this frame binds none), so they
    # go with it: two float views of nemotron-4-15b do not fit beside a
    # third
    views = {tier: view_build(torch, ops, lambda: gw.view_for(tier))[1]
             for tier in view_tiers}
    got_route = {k: getattr(gw, k) for k in (route or {})}
    if got_route != (route or {}):
        fail(f"{label}: the gateway chose {got_route}, not {route}")
    rows = record_rows(gw)
    ops.reset_launches()
    reqs = [gw.submit(p, license=t, max_new_tokens=n) for p, t, n in jobs]
    t0 = time.perf_counter()
    gw.run()
    sync()
    dt = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    bad = [r.rid for r in reqs if r.state.value != "done"
           or len(r.out_tokens) != r.max_new_tokens]
    if bad:
        fail(f"{label}: requests {bad} did not finish")
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens):
        fail(f"{label}: token ids outside the vocabulary")
    m = gw.metrics()
    # the route's decode and prefill families (None: eager)
    g = gw._graphs if gw.kernel_decode else gw._gather_graphs
    pg = gw._prefill_graphs if gw.chunked else gw._bucket_graphs
    graphs = graph_report(gw)
    units = cfg.pattern_units
    # the forward steps: decode steps and prefill chunks, or the bucket
    # prefills where there are no chunks (``prefill_batches`` counts the
    # chunked path's admissions, which run no forward)
    steps = m["decode_steps"] + (m["prefill_chunks"] if gw.chunked else m["prefill_batches"])
    out = dict(serve_s=dt, tokens=m["tokens_generated"], tokens_per_s=m["tokens_generated"] / dt,
               ms_per_step=1e3 * dt / steps, decode_steps=m["decode_steps"],
               prefill_chunks=m["prefill_chunks"],
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               views_s=sum(v["host_s"] for v in views.values()),
               captures=None if g is None else g.captures,
               replays=None if g is None else g.replays,
               prefill_captures=None if pg is None else pg.captures,
               prefill_replays=None if pg is None else pg.replays,
               graph_pool_gb=graphs["pool_bytes"] / 1e9, graphs=graphs["families"],
               launches=launches)
    out["block_bytes"] = gw.pool.block_bytes if gw.paged else None
    if gw.decode_kernels:
        # MLA's paged decode has no kernel route: its graphs run no paged kernel
        want = 0 if cfg.use_mla else units * g.captures
        if not (g.replays == m["resident_decode_steps"] > 0 and g.captures > 0
                and launches["paged_attention"] == launches["paged_decode_write"] == want):
            fail(f"{label}: {m['resident_decode_steps']} decode steps, {g.replays} replays, "
                 f"launches {launches}: the decode captures' warm-ups give {want}")
    elif launches["paged_attention"] or launches["paged_decode_write"]:
        fail(f"{label}: the plain route launched {launches}")
    if gw.quantized and not gw.materialize_int8_views:
        store = gw._weights[gw.version]
        leaves = (sum(1 for _ in qleaves(store["units"])) * units
                  + sum(1 for _ in qleaves(store.get("tail", {}))))
        eager = sum(eager_steps_of(gw, m))
        out["masked_dequant_per_step"] = launches["masked_dequant"] / eager
        if launches["masked_dequant"] != leaves * eager:
            fail(f"{label}: {launches['masked_dequant']} masked_dequant launches over "
                 f"{eager} eager steps and warm-ups, not {leaves} each")
    if route:
        out["route"] = got_route
    if check is not None:
        out["check"] = check(gw, reqs, rows)
    if turns:
        if gw.prefix is not None:
            fail(f"{label}: an eager rerun on a gateway with a prefix cache takes other steps")
        gw.__dict__.pop("_sample", None)
        ops.reset_launches()
        with eager_route(gw):
            again = [gw.submit(p, license=t, max_new_tokens=n) for p, t, n in jobs]
            t0 = time.perf_counter()
            gw.run()
            sync()
            out["eager_serve_s"] = time.perf_counter() - t0
        out["eager_launches"] = dict(ops.LAUNCHES)
        out["eager_tokens_per_s"] = sum(len(r.out_tokens) for r in again) / out["eager_serve_s"]
        same_tokens(label, reqs, again)
        out.update(steady_turns(label, gw, jobs))
        out["step_ms"] = out["graph_ms"]
        idle = {f: c for f, c in graph_report(gw)["families"].items()
                if not (c["captures"] > 0 and c["replays"] > 0)}
        if idle:
            fail(f"{label}: compiled families not both captured and replayed: {idle}")
        if trace_steps:
            kinds = []
            prof = profile_window(label.replace(" ", "_"), lambda: kinds.extend(
                gw.step().kind for _ in range(trace_steps)), torch, trace_steps)
            if prof is None or kinds != ["decode"] * trace_steps:
                fail(f"{label}: the profiled window ran {kinds} (device trace "
                     f"{'missing' if prof is None else 'present'})")
            out["trace"] = dict(steps=trace_steps, busy_share=prof["busy_share"],
                                graph_launches_per_step=prof["graph_launches_per_step"],
                                kernels_per_step=prof["kernel_launches_per_step"],
                                masked_dequant_per_step=(prof["port_kernels"]["masked_dequant"]
                                                         / trace_steps))
            log(f"  {label}: the device trace of {trace_steps} graph-replayed decode steps "
                f"shows {out['trace']['masked_dequant_per_step']:.0f} masked_dequant launches "
                f"a step")
    else:
        out.update(steady_decode_ms(label, gw, jobs))
    how = graphs["text"]
    per = (f", masked_dequant {out['masked_dequant_per_step']:.0f} a step"
           if "masked_dequant_per_step" in out else "")
    steady = (f"a steady decode step {out['graph_ms']:.2f} ms through the graphs, "
              f"{out['eager_ms']:.2f} ms eager (in turns; the eager rerun "
              f"{out['eager_tokens_per_s']:.1f} tokens/s)" if turns else
              f"a steady decode step {out['step_ms']:.2f} ms "
              f"({'graph replays' if g is not None else 'eager'}, {DENSE_STEADY_STEPS} steps "
              f"of {out['lanes']} lanes, host clock, synchronized; "
              f"{out['captures_in_window']} captures in the window; device ms not measured)")
    log(f"  {label}: {len(reqs)} requests, {out['tokens']} tokens in {dt:.2f} s "
        f"({out['tokens_per_s']:.1f} tokens/s, {out['ms_per_step']:.1f} ms per step over "
        f"{steps} with the captures); {steady}; {how}; launches {launches}{per}; peak "
        f"{out['peak_gb']:.1f} GB; views {out['views_s']:.2f} s; "
        + (f"KV pool {out['block_bytes']} bytes a block of {gw.pool.block_size} tokens"
           if gw.paged else f"contiguous pool {gw.pool.nbytes / 1e9:.3f} GB"))
    del gw
    gc.collect()
    torch.cuda.empty_cache()
    return reqs, rows, out


def dense_pair(label, cfg, params, tiers, np, torch, device="cuda", **kw):
    """``dense_run`` on the kernel route and then on the plain route
    (``decode_kernels=False``); the plain run's greedy tokens must equal
    the kernel run's, parting only at near-ties by phase 4's rule (on a
    MoE model without its cap, and ``moe_route_check`` on a third
    gateway)."""
    from repro_torch.serving import LicensedGateway

    k_reqs, k_rows, kern = dense_run(f"{label}, kernel route", cfg, params, tiers, np, torch,
                                     device, **kw)
    gc.collect()
    torch.cuda.empty_cache()
    p_reqs, p_rows, plain = dense_run(f"{label}, plain route", cfg, params, tiers, np, torch,
                                      device, decode_kernels=False, **kw)
    gc.collect()
    torch.cuda.empty_cache()
    parts = near_ties(f"{label}, plain route", p_reqs, k_reqs, p_rows, k_rows,
                      cfg.vocab_size, ref="the kernel route", capped=not cfg.num_experts)
    del k_rows, p_rows
    out = dict(kernel=kern, plain=plain, parts=parts)
    if cfg.num_experts:
        gw = LicensedGateway(cfg, params, tiers=tiers, device=device, **kw, **GEOMETRY)
        out["route_check"] = moe_route_check(f"{label}, routes", gw, cfg, np, torch)
        del gw
        gc.collect()
        torch.cuda.empty_cache()
    return out


def dense_phase(np, torch, device="cuda", config=None):
    """Phases 9a-9c (``config(name)`` gives each model's config, by
    default ``get_config``); returns each sub-phase's summary and the
    launches of all their runs."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.core.licensing import LicenseTier
    from repro_torch.serving.quantized import quantize_serving_params

    tiers = {"free": LicenseTier(name="free", masks=FREE_TIER)}
    config = config or get_config
    out, launches = {}, {}

    def add(run):
        for k, v in run["launches"].items():
            launches[k] = launches.get(k, 0) + v

    # 9a: nemotron-4-15b, float (kernel and plain routes), then in-scan int8
    t9 = time.perf_counter()
    if device == "cuda":
        log(f"phase 9: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated before it")
    cfg = config("nemotron-4-15b").replace(num_layers=DENSE_CUT_UNITS)
    log(f"phase 9a: nemotron-4-15b at full width, {cfg.num_layers} units (depth cut from 32; "
        f"d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, d_ff {cfg.d_ff} "
        f"{cfg.mlp_type}, vocab {cfg.padded_vocab}, {cfg.dtype_name})")
    params = init_params(cfg, seed=SEED, device=device)
    n = sum(t.numel() for t in _leaves(params))
    log(f"  {n / 1e9:.3f} B parameters, {2 * n / 1e9:.1f} GB of bf16")
    a = dense_pair("9a nemotron-4-15b float views", cfg, params, tiers, np, torch, device)
    t0 = time.perf_counter()
    store = quantize_serving_params(params)
    sync()
    a["store_s"] = time.perf_counter() - t0
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  9a: int8 store built (quantize_serving_params) in {a['store_s']:.2f} s, "
        f"{sum(t.numel() * t.element_size() for t in _leaves(store)) / 1e9:.2f} GB")
    _, _, a["in_scan"] = dense_run("9a nemotron-4-15b in-scan int8", cfg, store, tiers, np,
                                   torch, device, already_quantized=True)
    del store
    gc.collect()
    torch.cuda.empty_cache()
    for run in (a["kernel"], a["plain"], a["in_scan"]):
        add(run)
    a["s"] = time.perf_counter() - t9
    out["nemotron-4-15b"] = a

    # 9b: minitron-8b, float (kernel and plain routes)
    t9 = time.perf_counter()
    cfg = config("minitron-8b").replace(num_layers=DENSE_CUT_UNITS)
    log(f"phase 9b: minitron-8b at full width, {cfg.num_layers} units (depth cut from 32; "
        f"{cfg.num_heads}/"
        f"{cfg.num_kv_heads} heads, d_ff {cfg.d_ff} {cfg.mlp_type}, vocab {cfg.padded_vocab})")
    params = init_params(cfg, seed=SEED, device=device)
    n = sum(t.numel() for t in _leaves(params))
    log(f"  {n / 1e9:.3f} B parameters, {2 * n / 1e9:.1f} GB of bf16")
    b = dense_pair("9b minitron-8b float views", cfg, params, tiers, np, torch, device)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    for run in (b["kernel"], b["plain"]):
        add(run)
    b["s"] = time.perf_counter() - t9
    out["minitron-8b"] = b

    # 9c: granite-34b from an int8 store built unit by unit on the card
    t9 = time.perf_counter()
    cfg = config("granite-34b").replace(num_layers=GRANITE_UNITS)
    log(f"phase 9c: granite-34b at full width, {cfg.num_layers} units (depth cut from 88; "
        f"{cfg.num_heads}/"
        f"{cfg.num_kv_heads} heads, d_ff {cfg.d_ff} {cfg.mlp_type}, vocab "
        f"{cfg.padded_vocab}), served from an int8 store built unit by unit")
    t0 = time.perf_counter()
    store = store_by_unit(cfg, torch, device)
    sync()
    c = dict(store_s=time.perf_counter() - t0,
             store_gb=sum(t.numel() * t.element_size() for t in _leaves(store)) / 1e9)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  9c: int8 store built in {c['store_s']:.2f} s, {c['store_gb']:.2f} GB")
    c.update(dense_pair("9c granite-34b in-scan int8", cfg, store, tiers, np, torch, device,
                        already_quantized=True))
    del store
    gc.collect()
    torch.cuda.empty_cache()
    for run in (c["kernel"], c["plain"]):
        add(run)
    c["s"] = time.perf_counter() - t9
    out["granite-34b"] = c
    return out, launches


# ------------------------------------------------------------ phase 10
# DeepSeek MoE and MLA through the licensed gateway at full width and
# depth: deepseek-moe-16b (MHA 16/16 heads at hd 128, 64 routed experts
# top-6 + 2 shared, 28 units, 16.88 B parameters) and deepseek-v2-lite-16b
# (MLA with a 512 + 64 compressed cache, the same MoE, 27 units), random
# bf16 weights from SEED, phase 9's requests and tiers.  In-scan, each unit
# dequantizes 10 int8 leaves a step: 4 attention, 3 expert stacks (one
# launch each, (64, 2048, 1408) codes) and 3 shared
MOE_LEAVES_PER_UNIT = 10
# phase 10 runs deepseek-moe-16b and deepseek-v2-lite-16b at this depth (of
# their 28 and 27 layers): every width, head group and kernel instance
# stays; the cut pays for phase 14
MOE_UNITS = 14


def moe_phase(np, torch, device="cuda", config=None):
    """Phase 10: (a) deepseek-moe-16b on float views, kernel route (graph
    replays) against the plain route (graph replays of the plain step),
    tokens equal up to near-ties; (b) deepseek-moe-16b in-scan from an int8 store built unit
    by unit; (c) deepseek-v2-lite-16b on float views on the default route
    (graphs; MLA's paged block has no kernel route); (d) deepseek-v2-lite-
    16b in-scan from an int8 store built unit by unit.  Returns each run's
    summary and the launches of all the runs."""
    from repro_torch.configs import get_config
    from repro_torch.core.licensing import LicenseTier
    from repro_torch.models import init_params

    tiers = {"free": LicenseTier(name="free", masks=FREE_TIER)}
    config = config or get_config
    out, launches = {}, {}

    def add(run):
        for k, v in run["launches"].items():
            launches[k] = launches.get(k, 0) + v

    def in_scan(label, cfg):
        t0 = time.perf_counter()
        store = store_by_unit(cfg, torch, device)
        sync()
        res = dict(store_s=time.perf_counter() - t0,
                   store_gb=sum(t.numel() * t.element_size() for t in _leaves(store)) / 1e9)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"  {label}: int8 store built unit by unit in {res['store_s']:.2f} s, "
            f"{res['store_gb']:.2f} GB")
        _, _, run = dense_run(f"{label} in-scan int8", cfg, store, tiers, np, torch, device,
                              already_quantized=True)
        del store
        gc.collect()
        torch.cuda.empty_cache()
        want = MOE_LEAVES_PER_UNIT * cfg.pattern_units
        if run["masked_dequant_per_step"] != want:
            fail(f"{label}: {run['masked_dequant_per_step']} masked_dequant launches a step "
                 f"in-scan, not {want}")
        add(run)
        res["run"] = run
        return res

    def params_of(cfg):
        params = init_params(cfg, seed=SEED, device=device)
        n = sum(t.numel() for t in _leaves(params))
        log(f"  {n / 1e9:.3f} B parameters, {2 * n / 1e9:.1f} GB of bf16 (the router f32)")
        return params

    if device == "cuda":
        log(f"phase 10: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated before it")
    t10 = time.perf_counter()
    full = config("deepseek-moe-16b")
    cfg = full.replace(num_layers=min(full.num_layers, MOE_UNITS))
    log(f"phase 10a: deepseek-moe-16b at full width, {cfg.num_layers} units (depth cut from "
        f"{full.num_layers}; d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, {cfg.num_experts} experts "
        f"top-{cfg.experts_per_token} of d_ff {cfg.moe_d_ff} + {cfg.num_shared_experts} "
        f"shared, vocab {cfg.padded_vocab}, {cfg.dtype_name})")
    params = params_of(cfg)
    a = dense_pair("10a deepseek-moe-16b float views", cfg, params, tiers, np, torch, device)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    add(a["kernel"])
    add(a["plain"])
    log("phase 10b: deepseek-moe-16b in-scan from an int8 store built unit by unit")
    a["in_scan"] = in_scan("10b deepseek-moe-16b", cfg)
    a["s"] = time.perf_counter() - t10
    out["deepseek-moe-16b"] = a

    t10 = time.perf_counter()
    full = config("deepseek-v2-lite-16b")
    cfg = full.replace(num_layers=min(full.num_layers, MOE_UNITS))
    log(f"phase 10c: deepseek-v2-lite-16b at full width, {cfg.num_layers} units (depth cut "
        f"from {full.num_layers}; MLA "
        f"kv_lora_rank {cfg.kv_lora_rank}, qk_nope {cfg.qk_nope_dim} + rope "
        f"{cfg.rope_head_dim}, v {cfg.v_head_dim}, {cfg.num_heads} heads; "
        f"{cfg.num_experts} experts top-{cfg.experts_per_token} + "
        f"{cfg.num_shared_experts} shared), float views on the default route")
    params = params_of(cfg)
    _, _, run = dense_run("10c deepseek-v2-lite-16b float views", cfg, params, tiers, np,
                          torch, device)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    add(run)
    c = dict(float=run)
    log("phase 10d: deepseek-v2-lite-16b in-scan from an int8 store built unit by unit")
    c["in_scan"] = in_scan("10d deepseek-v2-lite-16b", cfg)
    log(f"phase 10e: deepseek-v2-lite-16b under a {WINDOW_MLA}-token sliding window on the "
        f"same weights, the latent ring on the slot's own route")
    t0 = time.perf_counter()
    params = params_of(cfg)
    c["window"] = window_mla_phase(cfg, params, tiers, np, torch, device)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    add(c["window"])
    c["window"]["s"] = time.perf_counter() - t0
    log(f"  phase 10e took {c['window']['s']:.1f} s")
    c["s"] = time.perf_counter() - t10
    out["deepseek-v2-lite-16b"] = c
    return out, launches


# phase 10e: long_500k's sliding window on deepseek-v2-lite-16b, the field
# ``launch.shapes.adapt_config`` sets, over the latent ring (each MLA
# layer's ``ckv`` and ``k_rope`` in 4,096 slots)
WINDOW_MLA = 4096
WINDOW_MLA_JOBS = (("full", 4160), ("free", 1024))      # (tier, prompt tokens)
WINDOW_MLA_NEW = 64
WINDOW_MLA_GEOMETRY = dict(max_batch=1, max_prompt=4160, max_new_cap=WINDOW_MLA_NEW)
# new tokens a request of the turns window: the first request runs to its
# end on the one lane, the second leaves 2 x 4 x TURN_STEPS decode steps
WINDOW_MLA_TURN_NEW = 2 * len(COMPILED_TURNS) * TURN_STEPS
WINDOW_MLA_TOL = 0.05          # phase 4's: x max(|logit|, 1) of the reference row


def window_mla_phase(cfg, params, tiers, np, torch, device="cuda"):
    """Phase 10e: ``cfg`` (deepseek-v2-lite-16b) under a WINDOW_MLA
    sliding window and drop-free, through ``LicensedGateway`` on the
    route the slot picks (no per-token leaf to page: the contiguous pool,
    bucket prefill, gather/scatter decode, no prefix cache), two requests
    of WINDOW_MLA_JOBS, greedy, every step synchronized and timed, every
    router call recorded.  Then, per request, the teacher-forced
    reference: a cacheless windowed ``forward`` of the bucket's row and
    the generated tokens on the tier's view, on its own expert picks and
    with every layer's picks pinned to the gateway's.  Returns the
    summary (with the wrappers' launches: none, MLA has no kernel)."""
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.models.model import forward
    from repro_torch.serving import LicensedGateway
    from repro_torch.serving.engine import right_align

    label = "10e deepseek-v2-lite-16b windowed"
    geo = WINDOW_MLA_GEOMETRY
    wcfg = cfg.replace(window=WINDOW_MLA,
                       moe_capacity_factor=cfg.num_experts / cfg.experts_per_token)
    longest = geo["max_prompt"] + WINDOW_MLA_NEW - 1
    if not all(moe.capacity(n, wcfg) >= n for n in (1, geo["max_prompt"], longest)):
        fail(f"{label}: the capacity factor {wcfg.moe_capacity_factor} drops tokens")
    rng = np.random.default_rng(SEED + 10)
    jobs = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), tier)
            for tier, n in WINDOW_MLA_JOBS]
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    gw = LicensedGateway(wcfg, params, tiers=tiers, device=device, **geo)
    route = dict(paged=gw.paged, chunk_size=gw.chunk_size, kernel_decode=gw.kernel_decode,
                 decode_kernels=gw.decode_kernels, prefix_cache=gw.prefix is not None,
                 graphs=sorted(graph_families(gw)))
    want_route = dict(paged=False, chunk_size=0, kernel_decode=False, decode_kernels=False,
                      prefix_cache=False,
                      graphs=sorted(("_bucket_graphs", "_gather_graphs")) if device == "cuda"
                      else [])
    if route != want_route:
        fail(f"{label}: the slot chose {route}, not {want_route}")
    leaves = {path.rsplit("/", 1)[-1]: t for path, t in gw.pool.leaves.items()
              if path.rsplit("/", 1)[-1] in ("ckv", "k_rope")}
    units = wcfg.pattern_units
    lane_bytes = sum(t[:, 0].numel() * t.element_size() for t in leaves.values())
    elt = torch.empty((), dtype=wcfg.dtype).element_size()
    want_bytes = units * WINDOW_MLA * (wcfg.kv_lora_rank + wcfg.rope_head_dim) * elt
    shapes = {k: tuple(t.shape) for k, t in leaves.items()}
    if not (set(leaves) == {"ckv", "k_rope"}
            and all(t.shape[2] == WINDOW_MLA and t.dtype == wcfg.dtype
                    for t in leaves.values())
            and lane_bytes == want_bytes):
        fail(f"{label}: ring leaves {shapes}, {lane_bytes} bytes a lane, not {WINDOW_MLA} "
             f"slots and {want_bytes}")
    log(f"  {label}: route {route}; the ring's leaves {shapes} (units, lanes + scratch, "
        f"slots, dim): {lane_bytes / 1e6:.1f} MB a lane")
    for tier in ("full", "free"):
        gw.view_for(tier)
    # the graph route first: every step a capture or a replay, timed; then
    # the same gateway in turns, graph and eager; then its graphs dropped
    # for the eager run below, which records every step's router calls
    ops.reset_launches()
    g_reqs = [gw.submit(p, license=t, max_new_tokens=WINDOW_MLA_NEW) for p, t in jobs]
    g_steps = timed_steps(gw)
    if any(ops.LAUNCHES.values()):
        fail(f"{label}: launches {dict(ops.LAUNCHES)} on a route with no kernel")
    g_decode = sorted(1e3 * dt for kind, dt in g_steps if kind != "prefill")
    turns = steady_turns(label, gw, [(p, t, WINDOW_MLA_TURN_NEW) for p, t in jobs])
    graphs = graph_report(gw)
    idle = {f: c for f, c in graphs["families"].items()
            if not (c["captures"] > 0 and c["replays"] > 0)}
    if device == "cuda" and idle:
        fail(f"{label}: compiled families not both captured and replayed: {idle}")
    log(f"  {label}: through the graphs, bucket prefills "
        f"{[round(dt, 3) for kind, dt in g_steps if kind == 'prefill']} s and a decode step "
        f"p50 {g_decode[len(g_decode) // 2]:.2f} ms, max {g_decode[-1]:.2f} (over "
        f"{len(g_decode)} steps, synchronized on each side); {graphs['text']}")
    gw.slot.compile_steps(None)
    gw.run()                             # the turns window's stream, eagerly
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    rows = record_rows(gw)
    calls, marks = [], []               # router calls; (calls so far, [(rid, token index)])
    sample = gw._sample

    def marked(logits, reqs, greedy=None, emit=None):
        marks.append((len(calls), [(r.rid, len(r.out_tokens)) for r in reqs]))
        return sample(logits, reqs, greedy, emit)

    gw._sample = marked
    ops.reset_launches()
    reqs = [gw.submit(p, license=t, max_new_tokens=WINDOW_MLA_NEW) for p, t in jobs]
    route_fn = pinned_routes(torch, calls)
    try:
        steps = timed_steps(gw)
    finally:
        moe.route = route_fn
    launches = dict(ops.LAUNCHES)
    if any(launches.values()):
        fail(f"{label}: launches {launches} on a route with no kernel")
    bad = [r.rid for r in reqs if r.state.value != "done"
           or len(r.out_tokens) != WINDOW_MLA_NEW]
    if bad:
        fail(f"{label}: requests {bad} did not finish")
    same_tokens(label, g_reqs, reqs, ref="the graph route")
    prefill_s = [dt for kind, dt in steps if kind == "prefill"]
    decode_ms = sorted(1e3 * dt for kind, dt in steps if kind != "prefill")
    peak = torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" else 0.0
    out = dict(route=route, ring_shapes=shapes, ring_lane_bytes=lane_bytes,
               prefill_s=prefill_s, decode_steps=len(decode_ms),
               decode_ms_p50=decode_ms[len(decode_ms) // 2], decode_ms_max=decode_ms[-1],
               graph_prefill_s=[dt for kind, dt in g_steps if kind == "prefill"],
               graph_decode_ms_p50=g_decode[len(g_decode) // 2], graph_decode_ms_max=g_decode[-1],
               turns=turns, graphs=graphs["families"], graph_pool_bytes=graphs["pool_bytes"],
               peak_gb=peak, launches=launches, requests=[])
    log(f"  {label}: {len(reqs)} requests x {WINDOW_MLA_NEW} tokens; bucket prefill of "
        f"{geo['max_prompt']} tokens {[round(s, 3) for s in prefill_s]} s (synchronized); "
        f"a steady eager decode step p50 {out['decode_ms_p50']:.2f} ms, max "
        f"{out['decode_ms_max']:.2f} (over {len(decode_ms)} steps, host clock, synchronized "
        f"on each side); peak {peak:.1f} GB; launches {launches}")

    # every step's router calls by (request, token index): the prefill's
    # rows give positions [0, max_prompt), decode step t position
    # max_prompt + t - 1
    picks = {}
    for (end, members), start in zip(marks, [0] + [m[0] for m in marks[:-1]]):
        if end - start != units:
            fail(f"{label}: {end - start} router calls in a step, not {units}")
        for row, key in enumerate(members):
            picks[key] = [calls[u][1][row:row + 1] for u in range(start, end)]
    del calls
    vocab = cfg.vocab_size
    for (prompt, tier), r in zip(jobs, reqs):
        seq = np.concatenate([right_align([prompt], geo["max_prompt"], 1)[0],
                              np.asarray(r.out_tokens[:-1], np.int32)])
        pinned = [(None, torch.cat([picks[(r.rid, t)][u] for t in range(WINDOW_MLA_NEW)], 1))
                  for u in range(units)]
        if pinned[0][1].shape[1] != len(seq):
            fail(f"{label}: {pinned[0][1].shape[1]} pinned positions for {len(seq)} tokens")
        got = torch.stack([rows[(r.rid, t)] for t in range(WINDOW_MLA_NEW)])[:, :vocab].float()
        view, li = gw.view_for(tier)
        res = dict(rid=r.rid, tier=tier, prompt=len(prompt))
        for name, pin in (("own", None), ("pinned", pinned)):
            rec = []
            fn = pinned_routes(torch, rec, pin)
            try:
                with torch.no_grad():
                    logits, _ = forward(view, wcfg, torch.from_numpy(seq[None]).to(device),
                                        license_intervals=li)
            finally:
                moe.route = fn
            ref = logits[0, geo["max_prompt"] - 1:, :vocab].float()
            del logits, rec
            res[name] = teacher_forced_parts(f"{label} request {r.rid} ({tier}), {name} "
                                             f"expert picks", r.out_tokens, got, ref,
                                             capped=name == "pinned")
            del ref
        out["requests"].append(res)
        del got, pinned
    del gw, rows, picks
    gc.collect()
    torch.cuda.empty_cache()
    return out


def timed_steps(gw):
    """Step ``gw`` until it is idle, each step timed on the host clock
    between two synchronizes; returns [(kind, seconds)]."""
    steps = []
    while True:
        sync()
        t0 = time.perf_counter()
        act = gw.step()
        sync()
        if act is None:
            return steps
        steps.append((act.kind, time.perf_counter() - t0))


def teacher_forced_parts(label, tokens, got, ref, capped):
    """Greedy ``tokens`` (n,) and their logits rows ``got`` (n, V) against
    a teacher-forced reference's rows ``ref`` (n, V) at the same
    positions: every position where the argmaxes part must be a near-tie
    (the reference's gap between its token and the emitted one at most
    the row's max |logit diff|), and with ``capped`` every row's diff
    within WINDOW_MLA_TOL x max(|logit|, 1) of the reference row (phase
    4's tolerance).  Returns the numbers."""
    if [int(i) for i in got.argmax(-1).tolist()] != list(tokens):
        fail(f"{label}: the recorded rows do not give the emitted tokens")
    diff = (got - ref).abs().amax(-1)
    tol = WINDOW_MLA_TOL * ref.abs().amax(-1).clamp(min=1.0)
    ref_tok = ref.argmax(-1)
    emitted = ref_tok.new_tensor(list(tokens))
    gap = ref.gather(1, ref_tok[:, None])[:, 0] - ref.gather(1, emitted[:, None])[:, 0]
    parted = (ref_tok != emitted).nonzero()[:, 0].tolist()
    wide = [t for t in parted if not gap[t] <= diff[t]]
    over = (diff > tol).nonzero()[:, 0].tolist()
    res = dict(positions=len(tokens), parted=parted, max_abs_diff=diff.max().item(),
               tol=tol.min().item(), rows_over_tol=len(over),
               gaps=[round(gap[t].item(), 4) for t in parted],
               diffs=[round(diff[t].item(), 4) for t in parted])
    log(f"  {label}: argmax equal at {len(tokens) - len(parted)}/{len(tokens)} positions; "
        f"partings {parted} with reference gaps {res['gaps']} against row diffs "
        f"{res['diffs']}; max |logit diff| {res['max_abs_diff']:.4f}, {len(over)} rows over "
        f"{WINDOW_MLA_TOL} x max(|logit|, 1) (min {res['tol']:.4f})")
    if wide:
        fail(f"{label}: positions {wide} part from the cacheless forward at no near-tie")
    if capped and over:
        fail(f"{label}: rows {over} differ beyond phase 4's tolerance with the picks pinned")
    return res


def host_rows(rows):
    """Recorded logits rows moved to the host (kept across phases)."""
    return {k: v.cpu() for k, v in rows.items()}


def eager_twin(label, cfg, params, tiers, np, device, graph_reqs, **kw):
    """Phase 3's stream on a gateway of ``kw`` with its compiled steps
    taken away (``compile_steps(None)``: every step eager), timed; its
    greedy tokens must equal the graph route's ``graph_reqs``.  Returns
    the seconds and tokens/s."""
    from repro_torch.serving import LicensedGateway

    gw = LicensedGateway(cfg, params, tiers=tiers, device=device, **kw)
    gw.slot.compile_steps(None)
    for tier in ("full", "free"):
        gw.view_for(tier)
    reqs = submit_all(gw, cfg, np)
    t0 = time.perf_counter()
    gw.run()
    sync()
    dt = time.perf_counter() - t0
    tokens = sum(len(r.out_tokens) for r in reqs)
    same_tokens(label, graph_reqs, reqs)
    log(f"  {label}: the eager route served the stream in {dt:.2f} s ({tokens / dt:.1f} "
        f"tokens/s)")
    del gw
    gc.collect()
    return dict(serve_s=dt, tokens_per_s=tokens / dt)


def fallback_phase(cfg, params, tiers, np, torch, ref_reqs, ref_rows, device="cuda"):
    """Phase 9d: the gateway's fallbacks on phase 3's weights.  Phase 3's
    stream with ``kernel_decode=False`` (greedy tokens equal phase 3's
    float stream, ``ref_reqs`` with its logits rows ``ref_rows`` on the
    host, parting only at near-ties), with ``chunk_size=0`` and the prefix
    cache off, and with ``paged=False`` (equal to the bucket prefill's up
    to near-ties); phase 3b's shared-prefix stream with ``chunk_size=0``,
    the prefix cache on and off (equal up to near-ties, hits > 0 with it
    on); a two-slot fleet with one contiguous slot (each slot's tokens
    equal to its isolated run's).  Returns each run's summary and their
    launches."""
    from repro_torch.kernels import ops
    from repro_torch.serving import FleetGateway, LicensedGateway

    out, launches = {}, {}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    iso = {"qwen-paged": [r.out_tokens for r in ref_reqs]}
    ran = {"phase 3's float stream": (ref_reqs, ref_rows)}
    for name, (kw, ref) in FALLBACK_RUNS.items():
        gw = LicensedGateway(cfg, params, tiers=tiers, device=device, **kw, **GEOMETRY)
        rows = record_rows(gw)
        ops.reset_launches()
        reqs, t = serve(f"9d {name}", gw, cfg, np, torch)
        add(ops.LAUNCHES)
        t["launches"] = dict(ops.LAUNCHES)
        m = gw.metrics()
        t.update(cache_pool_paged=m["cache_pool"]["paged"], decode_path=m["decode_path"],
                 chunked_prefill=m["chunked_prefill"])
        t.update(steady_turns(f"9d {name}", gw, dense_jobs(cfg, np)))
        t["graphs"] = graph_report(gw)
        idle = {f: c for f, c in t["graphs"]["families"].items()
                if not (c["captures"] > 0 and c["replays"] > 0)}
        log(f"  9d {name}: {t['graphs']['text']}")
        if device == "cuda" and (idle or not t["graphs"]["families"]):
            fail(f"9d {name}: compiled families not both captured and replayed: {idle}")
        del gw
        t["eager"] = eager_twin(f"9d {name}", cfg, params, tiers, np, device, reqs,
                                **kw, **GEOMETRY)
        ran[name] = (reqs, host_rows(rows))
        if ref is not None:
            t["parts"] = near_ties(f"9d {name}", reqs, ran[ref][0], ran[name][1], ran[ref][1],
                                   cfg.vocab_size, ref=ref)
        out[name] = t
        if name == "contiguous_pool":
            iso["qwen-contiguous"] = [r.out_tokens for r in reqs]
        del rows
        gc.collect()
        torch.cuda.empty_cache()
    del ran

    stream = shared_stream(cfg, np)
    got = {}
    for name, kw in (("bucket_prefix_on", {}), ("bucket_prefix_off", dict(prefix_cache=False))):
        gw = LicensedGateway(cfg, params, tiers=tiers, device=device, chunk_size=0, **kw,
                             **GEOMETRY)
        ops.reset_launches()
        got[name] = prefix_run(f"9d ({name})", gw, stream, np)
        add(ops.LAUNCHES)
        got[name][2]["launches"] = dict(ops.LAUNCHES)
        got[name][2]["admission_grouping"] = gw.metrics()["admission_grouping"]
        got[name][2]["graphs"] = graph_report(gw)
        fams = got[name][2]["graphs"]["families"]
        want = {"graphs", "bucket_graphs"} | ({"suffix_graphs"} if not kw else set())
        if device == "cuda" and not (set(fams) == want
                                     and all(c["captures"] > 0 for c in fams.values())):
            fail(f"9d ({name}): compiled families {fams}, not {sorted(want)} each captured")
        out[name] = got[name][2]
        del gw
        gc.collect()
        egw = LicensedGateway(cfg, params, tiers=tiers, device=device, chunk_size=0, **kw,
                              **GEOMETRY)
        egw.slot.compile_steps(None)
        t0 = time.perf_counter()
        ereqs = []
        for wave in (stream[:2], stream[2:]):
            ereqs += [egw.submit(p, license=t, max_new_tokens=SHARED_NEW) for t, p in wave]
            egw.run()
        sync()
        out[name]["eager_serve_s"] = time.perf_counter() - t0
        same_tokens(f"9d ({name})", got[name][0], ereqs)
        log(f"  9d ({name}): the eager route served the stream in "
            f"{out[name]['eager_serve_s']:.2f} s against {out[name]['serve_s']:.2f} s "
            f"through the graphs")
        del egw, ereqs
        gc.collect()
    on, off = out["bucket_prefix_on"], out["bucket_prefix_off"]
    if not (on["prefix_tokens_reused"] > 0 and on["prefix_cache"]["hits"] > 0):
        fail(f"9d: the bucket prefill's prefix cache had no hit: {on}")
    on["parts"] = near_ties("9d (bucket_prefix_on)", got["bucket_prefix_on"][0],
                            got["bucket_prefix_off"][0], got["bucket_prefix_on"][1],
                            got["bucket_prefix_off"][1], cfg.vocab_size,
                            ref="the cache-off run")
    log(f"  9d: bucket prefill lane-tokens {on['prefill_lane_tokens']} with the cache against "
        f"{off['prefill_lane_tokens']} without; prefix_tokens_reused "
        f"{on['prefix_tokens_reused']}, suffix-width batches "
        f"{on['admission_grouping']['batches_by_suffix_width']}")
    del got
    gc.collect()
    torch.cuda.empty_cache()

    fleet = FleetGateway()
    for name, kw in FALLBACK_SLOTS.items():
        fleet.add_model(name, cfg, params, tiers=tiers, device=device, **kw, **GEOMETRY)
        for tier in ("full", "free"):
            fleet.gateways[name].view_for(tier)
    ops.reset_launches()
    reqs = {name: [fleet.submit(name, p, license=t, max_new_tokens=n)
                   for p, t, n in stream_jobs(cfg, np)] for name in FALLBACK_SLOTS}
    t0 = time.perf_counter()
    steps = 0
    while fleet.step() is not None:
        steps += 1
    sync()
    dt = time.perf_counter() - t0
    add(ops.LAUNCHES)
    for name, rs in reqs.items():
        if [r.out_tokens for r in rs] != iso[name]:
            fail(f"9d fleet: {name}'s greedy tokens differ from its isolated run's")
    m = fleet.metrics()
    tokens = m["fleet"]["tokens_generated"]
    out["fleet"] = dict(serve_s=dt, steps=steps, tokens=tokens, tokens_per_s=tokens / dt,
                        ms_per_step=1e3 * dt / steps, launches=dict(ops.LAUNCHES),
                        cache_used_bytes=m["fleet"]["cache_used_bytes"],
                        paged={n: m["models"][n]["cache_pool"]["paged"] for n in reqs},
                        graphs={n: graph_report(gw) for n, gw in fleet.gateways.items()})
    for n, rep in out["fleet"]["graphs"].items():
        if device == "cuda" and not all(c["replays"] > 0 for c in rep["families"].values()):
            fail(f"9d fleet: {n}'s steps were not all graph replays: {rep['text']}")
        log(f"  9d fleet {n}: {rep['text']}")
    log(f"  9d fleet (a paged and a contiguous slot): {sum(len(r) for r in reqs.values())} "
        f"requests, {tokens} tokens in {dt:.2f} s ({out['fleet']['tokens_per_s']:.1f} tokens/s, "
        f"{out['fleet']['ms_per_step']:.1f} ms per fleet step over {steps}); each slot's greedy "
        f"tokens equal its isolated run's (phase 3's float stream, 9d contiguous_pool)")
    del fleet, reqs
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


# ------------------------------------------------------------ phase 11
# the recurrent family through the licensed gateway at full width and
# depth: recurrentgemma-2b (8 units of (rec, rec, attn) + 2 tail rec
# layers, d_model 2560, MQA 10/1 heads of 256 under a 2,048-token window,
# SwiGLU d_ff 7680, vocab 256000) and mamba2-130m (24 Mamba-2 layers,
# d_model 768, 24 SSD heads of 64, state 128), random bf16 weights from
# SEED, phase 9's requests and tiers.  In-scan, recurrentgemma dequantizes
# 23 int8 leaves a unit and 8 a tail block a step, mamba2 2 a unit
RECURRENT_DEQUANTS = {"recurrentgemma-2b": 8 * 23 + 2 * 8, "mamba2-130m": 24 * 2}
# (c): past the window, on the contiguous pool (a 3,088-token capacity
# caps every attention cache at the window: nothing to page)
WINDOW_GEOMETRY = dict(max_batch=2, max_prompt=3072, max_new_cap=16)
WINDOW_PROMPTS = (2500, 3000)
# decode steps held against a cacheless forward over the sequence so far
FORWARD_CHECK_STEPS = 4
# graph-replayed decode steps profiled in-scan for their masked_dequant launches
TRACE_STEPS = 4
# (d): mamba2-130m served in f32 as well, every checked row (agreeing
# tokens included) within this share of max(|logit|, 1) of the cacheless
# f32 forward: the witness that the bf16 runs' distance from theirs is
# rounding, not the cached path
F32_WITNESS_CAP = 1e-3
RECURRENT_ROUTES = {
    "recurrentgemma-2b": dict(paged=True, chunk_size=0, prefix=None, kernel_decode=False,
                              decode_kernels=False),
    "mamba2-130m": dict(paged=False, chunk_size=0, prefix=None, kernel_decode=False,
                        decode_kernels=False),
}
TRIO = ("qwen2.5-3b", "mamba2-130m", "recurrentgemma-2b")


def forward_check(label, gw, cfg, reqs, rows, np, torch, steps=FORWARD_CHECK_STEPS,
                  cap=None):
    """The first ``steps`` greedy tokens of each request against a
    cacheless ``forward`` over its sequence so far: its prompt as the
    bucket prefill saw it (right-aligned into ``max_prompt`` with
    first-token padding: the padding enters the recurrent state, so the
    reference must see it too) followed by the tokens the gateway emitted,
    through the request's own view.  One forward a request gives every
    step's reference row (causal).  A token may differ from the
    reference's argmax only at a near-tie by phase 4's rule: the
    reference's gap between the two below the lane's max |logit diff|
    against the gateway's own row, that diff within 0.05 x max(|logit|,
    1) of the reference row.  With ``cap`` every row, agreeing tokens'
    included, must lie within ``cap`` x max(|logit|, 1) of the reference
    row.  Returns the largest diff, the largest diff over max(|logit|,
    1) and the partings."""
    from repro_torch.models.model import forward
    from repro_torch.serving.engine import right_align

    worst, rel, parts = 0.0, 0.0, []
    for r in reqs:
        params, li = gw.view_for(r.license, r.version)
        row = right_align([r.prompt], gw.max_prompt, 1)[0]
        seq = np.concatenate([row, np.asarray(r.out_tokens[: steps - 1], np.int32)])
        with torch.no_grad():
            logits, _ = forward(params, cfg, torch.from_numpy(seq[None]).to(gw.device),
                                license_intervals=li)
        want = logits[0, gw.max_prompt - 1: gw.max_prompt - 1 + steps, : cfg.vocab_size]
        for t in range(steps):
            ref, got = want[t].float(), rows[(r.rid, t)][: cfg.vocab_size].float()
            diff = (ref - got).abs().max().item()
            scale = max(ref.abs().max().item(), 1.0)
            worst, rel = max(worst, diff), max(rel, diff / scale)
            if cap is not None and diff > cap * scale:
                fail(f"{label}: request {r.rid} step {t} lies {diff:.3e} from the cacheless "
                     f"forward, past {cap} x max(|logit|, 1) = {cap * scale:.3e}")
            tok, ref_tok = r.out_tokens[t], int(ref.argmax())
            if tok != ref_tok:
                gap = (ref[ref_tok] - ref[tok]).item()
                tol = 0.05 * scale
                parts.append(dict(request=r.rid, step=t, token=tok, reference_token=ref_tok,
                                  reference_gap=gap, lane_max_abs_diff=diff, tol=tol))
                if not gap < diff <= tol:
                    fail(f"{label}: request {r.rid} step {t} emits {tok}, the cacheless "
                         f"forward {ref_tok} with a gap of {gap:.4f} against a max |logit "
                         f"diff| of {diff:.4f} (tol {tol:.4f}): not a near-tie")
        del logits, want
    log(f"  {label}: the first {steps} tokens of {len(reqs)} requests against a cacheless "
        f"forward over the sequence so far: max |logit diff| {worst:.4f}, "
        f"{rel:.3e} of max(|logit|, 1)" + ("" if cap is None else f" (cap {cap})")
        + f", {len(parts)} near-tie partings")
    return dict(max_abs_diff=worst, max_rel_diff=rel, cap=cap, parts=parts, steps=steps,
                requests=len(reqs))


def window_run(label, cfg, params, tiers, np, torch, device="cuda"):
    """Phase 11c: ``dense_run`` of recurrentgemma-2b past its window on
    the contiguous pool (``NoPagedLeavesError`` at this capacity): two
    prompts of WINDOW_PROMPTS tokens in one bucket prefill (more than the
    ring's slots: each ring keeps the last 2,048 positions) and 16 new
    tokens each, so every decode read wraps the ring; the ring must hold
    the window's slots, and ``forward_check`` holds the first steps."""
    rng = np.random.default_rng(SEED + 11)
    jobs = [(rng.integers(0, cfg.vocab_size, n, dtype=np.int32), t,
             WINDOW_GEOMETRY["max_new_cap"]) for n, t in zip(WINDOW_PROMPTS, ("full", "free"))]

    def check(gw, reqs, rows):
        ring = gw.pool.leaves["units/b2/k"].shape[2]
        if ring != cfg.window:
            fail(f"{label}: a ring of {ring} slots, not the window's {cfg.window}")
        return dict(ring_slots=ring, **forward_check(label, gw, cfg, reqs, rows, np, torch))

    _, _, out = dense_run(label, cfg, params, tiers, np, torch, device,
                          route=RECURRENT_ROUTES["mamba2-130m"], check=check,
                          geometry=WINDOW_GEOMETRY, jobs=jobs, turns=True)
    return out


def rank2_dequant_case(peaks, store, torch, ops):
    """``masked_dequant`` on a rank-2 tail leaf of the int8 store
    (``tail/t0/mixer/w_r``, 2560 x 2560, scale (1, 2560)) in the free
    tier's intervals, bf16 out: bit-exact against the plain version, its
    time back to back and in a CUDA graph, the plain version's and the
    bound."""
    from repro_torch.kernels import masked_dequant as kernels_md
    from repro_torch.kernels import ref

    leaf = store["tail"]["t0"]["mixer"]["w_r"]
    codes, scale = leaf["codes"], leaf["scale"]
    lo, hi = ops.pack_intervals(MD_INTERVALS, device=codes.device)
    live = sum(1 for a, b in MD_INTERVALS if a < b)

    def call():
        return kernels_md.masked_dequant(codes, scale, lo, hi, out_dtype=torch.bfloat16)

    n0 = ops.LAUNCHES["masked_dequant"]
    got, want = call(), ref.masked_dequant(codes, scale, lo, hi, torch.bfloat16)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if not md_exact(got, want) or ops.LAUNCHES["masked_dequant"] != n0 + 1:
        fail(f"masked_dequant on the rank-2 leaf {tuple(codes.shape)} disagrees with its "
             f"plain version (max_abs_err {err:.3e}) or did not launch once")
    bnd, by = md_bound(peaks, codes.numel(), codes.shape[-1], live)
    case = dict(shape=f"{tuple(codes.shape)} int8, scale {tuple(scale.shape)}, bf16 out",
                max_abs_err=err, masked=float((got == 0).float().mean()),
                ms=time_ms(call), ms_graph=time_graph_ms(call),
                plain_ms=time_ms(lambda: ref.masked_dequant(codes, scale, lo, hi,
                                                            torch.bfloat16), iters=10),
                bound_ms=bnd, bound_by=by)
    log(f"  masked_dequant tail/t0/mixer/w_r [{case['shape']}]: bit-exact, masked "
        f"{case['masked']:.3f}, {case['ms']:.4f} ms back to back, {case['ms_graph']:.4f} ms in "
        f"a CUDA graph, plain {case['plain_ms']:.4f} ms, bound {case['bound_ms']:.4f} ms "
        f"({case['bound_by']})")
    return case


def recurrent_phase(peaks, np, torch, device="cuda", config=None):
    """Phase 11 (see the module docstring): (a) recurrentgemma-2b on
    float views, ``kernel_decode=True`` asked for and turned off; (b)
    recurrentgemma-2b in-scan from an int8 store built unit by unit, then
    on materialized int8 views of the same store, and ``masked_dequant``
    on a rank-2 tail leaf; (c) recurrentgemma-2b past its window; (d)
    mamba2-130m on the contiguous pool, float, f32 and in-scan; (e) the trio
    fleet.  Returns each run's summary, the rank-2 case and the launches
    of all the runs."""
    from repro_torch.configs import get_config
    from repro_torch.core.licensing import LicenseTier
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.serving import FleetGateway

    tiers = {"free": LicenseTier(name="free", masks=FREE_TIER)}
    config = config or get_config
    out, launches = {}, {}

    def add(run):
        for k, v in run["launches"].items():
            launches[k] = launches.get(k, 0) + v

    def params_of(cfg):
        params = init_params(cfg, seed=SEED, device=device)
        n = sum(t.numel() for t in _leaves(params))
        log(f"  {n / 1e9:.3f} B parameters, {2 * n / 1e9:.2f} GB of bf16 (the SSM and RG-LRU "
            f"dynamics f32)")
        return params

    def check(label, cfg, cap=None):
        return lambda gw, reqs, rows: forward_check(label, gw, cfg, reqs, rows, np, torch,
                                                    cap=cap)

    def in_scan(label, cfg, route, store):
        # dense_run holds the launches to the store's int8 leaves; at full
        # size they must also be the count predicted above, as must the
        # graphs' replayed steps in the device trace
        _, _, run = dense_run(f"{label} in-scan int8", cfg, store, tiers, np, torch, device,
                              route=route, already_quantized=True, turns=True,
                              trace_steps=TRACE_STEPS if device == "cuda" else 0)
        want = RECURRENT_DEQUANTS.get(cfg.name)
        traced = run.get("trace", {}).get("masked_dequant_per_step", want)
        if want is not None and not run["masked_dequant_per_step"] == traced == want:
            fail(f"{label}: {run['masked_dequant_per_step']} masked_dequant launches a step "
                 f"in-scan through the wrappers, {traced} in the trace, not {want}")
        add(run)
        return run

    t11 = time.perf_counter()
    if device == "cuda":
        log(f"phase 11: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated before it")
    cfg = config("recurrentgemma-2b")
    rg = RECURRENT_ROUTES["recurrentgemma-2b"]
    log(f"phase 11a: recurrentgemma-2b at full width, {cfg.num_layers} layers ({cfg.pattern_units} "
        f"units of {cfg.layer_pattern} + tail {cfg.tail_pattern}; d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, window {cfg.window}, "
        f"lru_width {cfg.lru_width}, d_ff {cfg.d_ff}, vocab {cfg.padded_vocab}), float views, "
        f"kernel_decode=True asked for")
    params = params_of(cfg)
    rg_reqs, rg_rows, a = dense_run("11a recurrentgemma-2b float views", cfg, params, tiers,
                                    np, torch, device, route=rg, kernel_decode=True,
                                    check=check("11a recurrentgemma-2b float views", cfg),
                                    turns=True)
    add(a)
    log("phase 11c: recurrentgemma-2b past its window (contiguous pool, the ring wraps)")
    c = window_run("11c recurrentgemma-2b past the window", cfg, params, tiers, np, torch,
                   device)
    add(c)
    fleet_params = {"recurrentgemma-2b": params}
    del params
    log("phase 11b: recurrentgemma-2b in-scan from an int8 store built unit by unit, then on "
        "materialized int8 views of it")
    t0 = time.perf_counter()
    store = store_by_unit(cfg, torch, device)
    sync()
    b = dict(store_s=time.perf_counter() - t0,
             store_gb=sum(t.numel() * t.element_size() for t in _leaves(store)) / 1e9)
    log(f"  11b: int8 store built in {b['store_s']:.2f} s, {b['store_gb']:.2f} GB")
    b["rank2"] = rank2_dequant_case(peaks, store, torch, ops) if device == "cuda" else None
    b["in_scan"] = in_scan("11b recurrentgemma-2b", cfg, rg, store)
    _, _, b["int8_views"] = dense_run("11b recurrentgemma-2b materialized int8 views", cfg,
                                      store, tiers, np, torch, device, route=rg,
                                      already_quantized=True, materialize_int8_views=True)
    add(b["int8_views"])
    del store
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    out["recurrentgemma-2b"] = dict(float=a, int8=b, window=c)

    cfg = config("mamba2-130m")
    log(f"phase 11d: mamba2-130m at full width, {cfg.num_layers} layers (d_model "
        f"{cfg.d_model}, {cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim} SSD heads of "
        f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, conv {cfg.ssm_conv}, vocab "
        f"{cfg.padded_vocab}), contiguous pool, float and in-scan")
    params = params_of(cfg)
    mb = RECURRENT_ROUTES["mamba2-130m"]
    mb_reqs, mb_rows, d = dense_run("11d mamba2-130m float views", cfg, params, tiers, np,
                                    torch, device, route=mb,
                                    check=check("11d mamba2-130m float views", cfg),
                                    turns=True)
    add(d)
    fleet_params["mamba2-130m"] = params
    del params
    cfg32 = cfg.replace(dtype_name="float32")
    _, _, d32 = dense_run("11d mamba2-130m f32 witness", cfg32,
                          init_params(cfg32, seed=SEED, device=device), tiers, np, torch,
                          device, route=mb,
                          check=check("11d mamba2-130m f32 witness", cfg32, F32_WITNESS_CAP))
    add(d32)
    out["mamba2-130m"] = dict(float=d, f32=d32,
                              in_scan=in_scan("11d mamba2-130m", cfg, mb,
                                              store_by_unit(cfg, torch, device)))

    log(f"phase 11e: FleetGateway of {', '.join(TRIO)} at full width, float views")
    qcfg = config(ARCH)
    fleet_params[ARCH] = init_params(qcfg, seed=SEED, device=device)
    fleet = FleetGateway()
    fleet_rows = {}
    for name in TRIO:
        gw = fleet.add_model(name, config(name), fleet_params[name], tiers=tiers,
                             device=device, **GEOMETRY)
        for tier in ("full", "free"):
            gw.view_for(tier)
        fleet_rows[name] = record_rows(gw)
    del fleet_params
    ops.reset_launches()
    reqs = {name: [fleet.submit(name, p, license=t, max_new_tokens=n)
                   for p, t, n in dense_jobs(config(name), np)] for name in TRIO}
    t0 = time.perf_counter()
    steps = 0
    while fleet.step() is not None:
        steps += 1
    sync()
    dt = time.perf_counter() - t0
    e = dict(serve_s=dt, fleet_steps=steps, launches=dict(ops.LAUNCHES))
    add(e)
    for name, rs in reqs.items():
        bad = [r.rid for r in rs if r.state.value != "done"
               or len(r.out_tokens) != r.max_new_tokens]
        if bad:
            fail(f"11e: {name}'s requests {bad} did not finish")
    if e["launches"]["paged_attention"] <= 0:
        fail(f"11e: qwen2.5-3b's slot launched no paged_attention: {e['launches']}")
    e["parts"] = {
        name: near_ties(f"11e {name} in the fleet", reqs[name], ref_reqs, fleet_rows[name],
                        ref_rows, config(name).vocab_size, ref="its isolated run")
        for name, ref_reqs, ref_rows in (("recurrentgemma-2b", rg_reqs, rg_rows),
                                         ("mamba2-130m", mb_reqs, mb_rows))}
    e["tokens"] = {name: sum(len(r.out_tokens) for r in rs) for name, rs in reqs.items()}
    e["routes"] = {name: dict(paged=gw.paged, kernel_decode=gw.kernel_decode,
                              chunk_size=gw.chunk_size, prefix=gw.prefix is not None)
                   for name, gw in fleet.gateways.items()}
    e["graphs"] = {name: graph_report(gw) for name, gw in fleet.gateways.items()}
    for name, rep in e["graphs"].items():
        fams = rep["families"]
        dec = fams.get("graphs") or fams.get("gather_graphs")
        if device == "cuda" and not (dec and dec["captures"] > 0 and dec["replays"] > 0):
            fail(f"11e: {name}'s decode steps were not graph replays: {rep['text']}")
    log(f"  11e: {sum(e['tokens'].values())} tokens ({e['tokens']}) in {dt:.2f} s over "
        f"{steps} fleet steps; routes {e['routes']}; launches {e['launches']}; "
        + "; ".join(f"{n} {r['text']}" for n, r in e["graphs"].items()))
    del fleet, fleet_rows, rg_rows, mb_rows
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    out["trio_fleet"] = e
    out["s"] = time.perf_counter() - t11
    log(f"  phase 11 took {out['s']:.1f} s")
    return out, launches


# ------------------------------------------------------------ phase 12
# LayerNorm, the front-end stubs and int8 KV caches at full width,
# random bf16 weights from SEED, phase 9's requests and tiers:
# musicgen-large (48 layers, MHA 32/32 at head dim 64, LayerNorm with
# biases, SwiGLU d_ff 8192, the codec vocabulary of 2,048) and
# internvl2-26b (48 layers, GQA 48/8 at head dim 128, SwiGLU d_ff 16384,
# vocab 92553, a 256-patch vision prefix through ``vision_proj``).  In-scan,
# each unit dequantizes 7 int8 leaves a step (168 a step at FRONTEND_UNITS); with
# ``kv_cache_int8`` a layer-block of 16 tokens holds int8 codes and f32
# scales: 16 x 32 x (2 x 64 + 2 x 4) = 69,632 bytes for musicgen-large
# against 131,072 in bf16.  A float ``free`` view of internvl2-26b beside
# its ``full`` weights would be 2 x 39.8 GB, so its float run serves the
# ``full`` tier alone
FRONTEND_DEQUANTS = 7
# phase 12 runs musicgen-large and internvl2-26b at this depth (of their 48
# layers): every width, head group and kernel instance stays; with phase
# 10's cut it pays for phase 14
FRONTEND_UNITS = 24
KV8_LAYER_BLOCK = 16 * 32 * (2 * 64 + 2 * 4)
VLM_PREFILL = dict(patches=256, text=64)


def weight_bound(peaks, params):
    """Every byte of ``params`` over the card's memory rate (ms; None
    without a card): phase 9's weight-read bound of a decode step, which
    counts the whole embedding table though a step reads 8 of its rows
    (internvl2-26b's table is 1.1 of its 39.8 GB)."""
    if peaks is None:
        return None
    return 1e3 * sum(t.numel() * t.element_size() for t in _leaves(params)) / peaks[0]


def vlm_prefill(label, cfg, params, np, torch, device="cuda", backend=None):
    """One ``prefill_step(patch_embeds=)`` of VLM_PREFILL's patches and
    text tokens on one lane at full width, twice (the second warm): host
    clock ending in a synchronize, peak memory, and the last row's logits
    finite over the vocabulary and -1e9 past it.  Then the same prefill
    through ``MeshGraphs`` on plain tensors (``backend``: the default
    ``CudaGraphBackend``): its capture (the warm-up is the step) and two
    timed replays, each one's logits equal to the eager step's bit for
    bit."""
    from repro_torch.models import init_cache
    from repro_torch.serving.compiled import MeshGraphs
    from repro_torch.serving.engine import prefill_step

    rng = np.random.default_rng(SEED + 12)
    p, n = VLM_PREFILL["patches"], VLM_PREFILL["text"]
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n), dtype=np.int32)).to(device)
    patches = torch.from_numpy(rng.standard_normal((1, p, cfg.d_model), dtype=np.float32)
                               ).to(device, cfg.dtype)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(2):
        cache = init_cache(cfg, 1, p + n, device=device)
        sync()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, cache = prefill_step(params, cfg, toks, cache, patch_embeds=patches)
        sync()
        times.append(1e3 * (time.perf_counter() - t0))
    lens = cache["units"]["b0"]["len"]
    if tuple(logits.shape) != (1, cfg.padded_vocab) or not bool((lens == p + n).all()):
        fail(f"{label}: logits {tuple(logits.shape)}, cache lengths {lens.unique().tolist()} "
             f"after {p} patches and {n} tokens")
    if not (bool(torch.isfinite(logits[:, :cfg.vocab_size]).all())
            and bool((logits[:, cfg.vocab_size:] == -1e9).all())):
        fail(f"{label}: non-finite logits, or a padded id not at -1e9")
    out = dict(patches=p, text=n, first_ms=times[0], warm_ms=times[1],
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               max_abs_logit=float(logits[:, :cfg.vocab_size].abs().max()))
    log(f"  {label}: prefill_step of 1 x ({p} patches + {n} tokens) {times[1]:.2f} ms warm "
        f"(first {times[0]:.2f} ms; host clock, synchronized, eager), peak "
        f"{out['peak_gb']:.1f} GB, last-row logits finite (max |logit| "
        f"{out['max_abs_logit']:.3f})")
    del cache
    graphs = MeshGraphs(cfg, params, backend=backend)
    host = toks.cpu().numpy()
    times = []
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        got, _ = graphs.prefill(host, p + n, patch_embeds=patches)
        sync()
        times.append(1e3 * (time.perf_counter() - t0))
        if not torch.equal(got, logits.float()):
            fail(f"{label}: the prefill graph's logits differ from the eager step's (max "
                 f"|diff| {float((got - logits.float()).abs().max()):.4g})")
    out.update(graph_capture_ms=times[0], graph_ms=times[1:], graph_captures=graphs.captures,
               graph_replays=graphs.replays, graph_pool_bytes=graphs.backend.pool_bytes())
    if (graphs.captures, graphs.replays) != (1, 2):
        fail(f"{label}: {graphs.captures} captures and {graphs.replays} replays of one prefill "
             f"key, not 1 and 2")
    log(f"  {label}: the same prefill through MeshGraphs on plain tensors: replays "
        f"{times[1]:.2f} / {times[2]:.2f} ms (host clock, synchronized, the inputs' copies "
        f"included) against {out['warm_ms']:.2f} ms eager; the capture {times[0]:.2f} ms (its "
        f"warm-up is the step); logits of all three bit for bit the eager step's; "
        f"{graphs.captures} capture, {graphs.replays} replays, pool "
        f"{out['graph_pool_bytes'] / 1e9:.3f} GB")
    del graphs, logits, got
    return out


def frontend_phase(peaks, np, torch, device="cuda", config=None):
    """Phase 12 (see the module docstring): (a) musicgen-large on float
    views, kernel route and plain route (graphs both), tokens equal up
    to near-ties; (b) musicgen-large in-scan from its int8 store; (c)
    musicgen-large with ``kv_cache_int8``: the kernel-resident step and
    its graphs over the plain gather, no paged kernel, tokens against
    (a)'s plain route up to near-ties; (d) internvl2-26b on float views of
    the ``full`` tier, kernel route, and one full-width prefill with its
    vision prefix; (e) internvl2-26b in-scan, both tiers, from an int8
    store built unit by unit.  Returns each run's summary and the
    launches of all the runs."""
    from repro_torch.configs import get_config
    from repro_torch.core.licensing import LicenseTier
    from repro_torch.models import init_params
    from repro_torch.serving.quantized import quantize_serving_params

    tiers = {"free": LicenseTier(name="free", masks=FREE_TIER)}
    config = config or get_config
    out, launches = {}, {}

    def add(run):
        for k, v in run["launches"].items():
            launches[k] = launches.get(k, 0) + v

    def steady(label, run, bound):
        if bound is not None:
            log(f"  {label}: steady step {run['step_ms']:.2f} ms against its "
                f"{bound:.2f} ms weight-read bound ({run['step_ms'] / bound:.1f}x)")
        run["weight_bound_ms"] = bound

    def in_scan(label, cfg, store, **kw):
        _, _, run = dense_run(f"{label} in-scan int8", cfg, store, tiers, np, torch, device,
                              already_quantized=True, **kw)
        want = FRONTEND_DEQUANTS * cfg.pattern_units
        if run["masked_dequant_per_step"] != want:
            fail(f"{label}: {run['masked_dequant_per_step']} masked_dequant launches a step "
                 f"in-scan, not {want}")
        add(run)
        return run

    t12 = time.perf_counter()
    gc.collect()          # phase 11's gateways and fleet, cyclic garbage since its return
    if device == "cuda":
        torch.cuda.empty_cache()
        log(f"phase 12: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated before it")
    full = config("musicgen-large")
    cfg = full.replace(num_layers=min(full.num_layers, FRONTEND_UNITS))
    log(f"phase 12a: musicgen-large at full width, {cfg.num_layers} layers (depth cut from "
        f"{full.num_layers}; d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, "
        f"LayerNorm, d_ff {cfg.d_ff} {cfg.mlp_type}, vocab {cfg.padded_vocab}, front end "
        f"{cfg.frontend!r}), float views, kernel and plain routes")
    params = init_params(cfg, seed=SEED, device=device)
    n = sum(t.numel() for t in _leaves(params))
    log(f"  {n / 1e9:.3f} B parameters, {2 * n / 1e9:.2f} GB of bf16")
    bound = weight_bound(peaks, params)
    k_reqs, k_rows, kern = dense_run("12a musicgen-large float views, kernel route", cfg,
                                     params, tiers, np, torch, device)
    steady("12a kernel route", kern, bound)
    p_reqs, p_rows, plain = dense_run("12a musicgen-large float views, plain route", cfg,
                                      params, tiers, np, torch, device, decode_kernels=False)
    a = dict(kernel=kern, plain=plain,
             parts=near_ties("12a musicgen-large, plain route", p_reqs, k_reqs, p_rows,
                             k_rows, cfg.vocab_size, ref="the kernel route"))
    del k_rows
    add(kern)
    add(plain)
    log("phase 12c: musicgen-large with kv_cache_int8 on float views (paged int8 codes and "
        "f32 scales, graphs over the plain gather)")
    cfg8 = cfg.replace(kv_cache_int8=True)

    def kv8_check(gw, reqs, rows):
        if gw._graphs is None and device == "cuda":
            fail("12c: the int8-KV gateway captured no decode graphs")
        if gw.pool.block_bytes != cfg.num_layers * KV8_LAYER_BLOCK and device == "cuda":
            fail(f"12c: {gw.pool.block_bytes} bytes a block, not {cfg.num_layers} x "
                 f"{KV8_LAYER_BLOCK}")
        leaves = sorted(p.rsplit("/", 1)[-1] for p in gw.pool.leaves)
        if leaves != ["k", "k_scale", "v", "v_scale"]:
            fail(f"12c: paged leaves {leaves}")
        return dict(block_bytes=gw.pool.block_bytes,
                    layer_block_bytes=gw.pool.block_bytes // cfg.num_layers,
                    bf16_layer_block_bytes=16 * cfg.num_kv_heads * cfg.head_dim * 4)

    c_reqs, c_rows, c = dense_run("12c musicgen-large int8 KV", cfg8, params, tiers, np,
                                  torch, device, check=kv8_check,
                                  route=dict(kernel_decode=True, decode_kernels=False))
    steady("12c int8 KV", c, bound)
    c["parts"] = near_ties("12c musicgen-large int8 KV", c_reqs, p_reqs, c_rows, p_rows,
                           cfg.vocab_size, ref="12a's plain route")
    del p_rows, c_rows
    add(c)
    t0 = time.perf_counter()
    store = quantize_serving_params(params)
    sync()
    store_s = time.perf_counter() - t0
    del params
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    log(f"phase 12b: musicgen-large in-scan from its int8 store (quantize_serving_params, "
        f"{store_s:.2f} s, {sum(t.numel() * t.element_size() for t in _leaves(store)) / 1e9:.2f}"
        f" GB)")
    b = in_scan("12b musicgen-large", cfg, store)
    steady("12b in-scan", b, bound)
    del store
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    out["musicgen-large"] = dict(float=a, in_scan=b, kv_int8=c, store_s=store_s)

    full = config("internvl2-26b")
    cfg = full.replace(num_layers=min(full.num_layers, FRONTEND_UNITS))
    log(f"phase 12d: internvl2-26b at full width, {cfg.num_layers} layers (depth cut from "
        f"{full.num_layers}; d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, d_ff "
        f"{cfg.d_ff} {cfg.mlp_type}, vocab {cfg.padded_vocab}, {cfg.num_patches} patches "
        f"through vision_proj), float views of the full tier, kernel route")
    params = init_params(cfg, seed=SEED, device=device)
    n = sum(t.numel() for t in _leaves(params))
    log(f"  {n / 1e9:.3f} B parameters, {2 * n / 1e9:.2f} GB of bf16")
    bound = weight_bound(peaks, params)
    full_jobs = [(p, "full", m) for p, _, m in dense_jobs(cfg, np)]
    _, _, d = dense_run("12d internvl2-26b float views (full tier)", cfg, params, {}, np,
                        torch, device, jobs=full_jobs, view_tiers=("full",))
    steady("12d kernel route", d, bound)
    add(d)
    d["prefill"] = vlm_prefill("12d internvl2-26b", cfg, params, np, torch, device)
    del params
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    log("phase 12e: internvl2-26b in-scan, tiers full and free, from an int8 store built unit "
        "by unit (vision_proj float beside it)")
    t0 = time.perf_counter()
    store = store_by_unit(cfg, torch, device)
    sync()
    e_store = dict(store_s=time.perf_counter() - t0,
                   store_gb=sum(t.numel() * t.element_size() for t in _leaves(store)) / 1e9)
    if not (torch.is_tensor(store.get("vision_proj"))
            and store["vision_proj"].dtype == cfg.dtype):
        fail("12e: the int8 store lacks a float vision_proj")
    log(f"  12e: int8 store built in {e_store['store_s']:.2f} s, {e_store['store_gb']:.2f} GB")
    e = in_scan("12e internvl2-26b", cfg, store)
    steady("12e in-scan", e, bound)
    e.update(e_store)
    del store
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    out["internvl2-26b"] = dict(float=d, in_scan=e)
    out["s"] = time.perf_counter() - t12
    log(f"  phase 12 took {out['s']:.1f} s")
    return out, launches


# ------------------------------------------------------------ phase 13
# the batch engine, host sampling and the launch tools at qwen2.5-3b's
# full width and depth on phase 3's weights: 6 requests in three tiers
# (two a tier: the engine's groups), prompts of 64-256 tokens, one length
# a group (the engine pads a shorter prompt of its group on the left with
# its first token, which the gateway does not), 16 new tokens each,
# greedy; 13c's stream is phase 3's with its lanes greedy or sampling at
# temperature 0.8 (top_k 0, 5 and 50, a seed each)
ENGINE_PROMPTS = [64, 256, 128, 64, 256, 128]
ENGINE_TIERS = ["full", "pro", "free", "full", "pro", "free"]
ENGINE_NEW = 16
ENGINE_PRO = {"*": ((0.0, 0.005),)}
ENGINE_GEOMETRY = dict(max_batch=8, max_prompt=256, max_new_cap=ENGINE_NEW)
HOST_SAMPLING = [dict(), dict(temperature=0.8, top_k=0, seed=11),
                 dict(temperature=0.8, top_k=5, seed=12), dict(),
                 dict(temperature=0.8, top_k=50, seed=13), dict(temperature=0.8, top_k=5, seed=14)]


def engine_jobs(cfg, np):
    """(prompt, tier) of phase 13's engine requests, from ``SEED``."""
    rng = np.random.default_rng(SEED + 13)
    return [(rng.integers(0, cfg.vocab_size, n, dtype=np.int32), t)
            for n, t in zip(ENGINE_PROMPTS, ENGINE_TIERS)]


def engine_run(label, eng, jobs, torch, profile=False):
    """Serve ``jobs`` through ``ServingEngine.generate`` (greedy) on one
    engine: first through its graphs (``eng._graphs``, whose captures it
    makes), keeping a host copy of the logits row each token comes from
    by (request index, token index); then STREAM_TURNS (eager, graph,
    graph), every decode step timed on the host clock with a
    synchronize on each side (eager: ``serve_step``, its
    ``masked_dequant`` launches counted; graph: ``EngineGraphs.decode``,
    the inputs' fill and the replay).  Every run's greedy tokens must
    equal the first run's, and no turn may capture a graph.  With
    ``profile``, one more graph run under ``torch.profiler``: the device
    trace's ``masked_dequant`` launches a replayed step.  Returns the
    requests (each with ``rid`` = its index), the rows and a summary."""
    from types import SimpleNamespace

    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.serving import Request
    from repro_torch.serving import engine as engine_mod

    graphs = eng._graphs
    if graphs is None:
        fail(f"{label}: the engine holds no compiled steps")
    rows, steps, group = {}, [], []
    generate_group, serve_step = eng._generate_group, engine_mod.serve_step
    prefill, decode = graphs.prefill, graphs.decode

    def in_group(g, tier, seed):
        group[:] = g
        return generate_group(g, tier, seed)

    def keep(out):
        host = out[0].float().cpu()          # the record's copy; the engine copies no row
        for i, r in enumerate(group):
            rows[(index[id(r)], len(r.out_tokens))] = host[i]
        return out

    def timed(fn, counted):
        def step(*a, **kw):
            n = ops.LAUNCHES["masked_dequant"]
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            sync()
            steps.append((time.perf_counter() - t0,
                          ops.LAUNCHES["masked_dequant"] - n if counted else None))
            return out
        return step

    def run(kind, record=False):
        nonlocal index
        reqs = [Request(prompt=p, max_new_tokens=ENGINE_NEW, license=t) for p, t in jobs]
        index = {id(r): i for i, r in enumerate(reqs)}
        steps.clear()
        if record:
            graphs.prefill = lambda *a, **kw: keep(prefill(*a, **kw))
            graphs.decode = lambda *a, **kw: keep(decode(*a, **kw))
        elif kind == "graph":
            graphs.decode = timed(decode, counted=False)
        else:
            engine_mod.serve_step = timed(serve_step, counted=True)
            eng._graphs = None
        try:
            sync()
            t0 = time.perf_counter()
            eng.generate(reqs)
            sync()
            dt = time.perf_counter() - t0
        finally:
            graphs.__dict__.pop("prefill", None)
            graphs.__dict__.pop("decode", None)
            engine_mod.serve_step = serve_step
            eng._graphs = graphs
        if any(len(r.out_tokens) != ENGINE_NEW for r in reqs):
            fail(f"{label}: a request did not get its {ENGINE_NEW} tokens")
        return reqs, dt, list(steps)

    index = {}
    eng._generate_group = in_group
    try:
        first, first_s, _ = run("graph", record=True)
        captures = graphs.captures
        turns = []
        for kind in STREAM_TURNS:
            replays = graphs.replays
            reqs, dt, st = run(kind)
            if kind == "graph":
                per_run = graphs.replays - replays
            if [r.out_tokens for r in reqs] != [r.out_tokens for r in first]:
                bad = [i for i, (a, b) in enumerate(zip(reqs, first))
                       if a.out_tokens != b.out_tokens]
                fail(f"{label}: the {kind} turn's greedy tokens differ from the graph run's on "
                     f"requests {bad}")
            turns.append((kind, dt, st))
        if graphs.captures != captures:
            fail(f"{label}: graphs captured in the timed turns: {captures} -> {graphs.captures}")
        prof = None
        if profile:
            replays = graphs.replays
            prof = profile_window(label.replace(" ", "_").replace(",", ""),
                                  lambda: run("graph"), torch, per_run)
            replayed = graphs.replays - replays
    finally:
        del eng._generate_group
    eager_s = sorted(s for k, _, st in turns if k == "eager" for s, _ in st)
    graph_s = sorted(s for k, _, st in turns if k == "graph" for s, _ in st)
    dequants = sorted({d for k, _, st in turns if k == "eager" for _, d in st})
    out = dict(first_generate_s=first_s, decode_steps=len(eager_s) // STREAM_TURNS.count("eager"),
               decode_ms_p50=1e3 * eager_s[len(eager_s) // 2], decode_ms_max=1e3 * eager_s[-1],
               graph_ms_p50=1e3 * graph_s[len(graph_s) // 2], graph_ms_max=1e3 * graph_s[-1],
               turns=[(k, 1e3 * float(np.median([s for s, _ in st])), dt) for k, dt, st in turns],
               masked_dequant_per_step=dequants, captures=graphs.captures,
               replays=graphs.replays, keys=len(graphs), pool_bytes=graphs.backend.pool_bytes())
    log(f"  {label}: {len(first)} requests in {len({t for _, t in jobs})} tier groups, "
        f"{len(first) * ENGINE_NEW} tokens, the first (capturing) run {first_s:.2f} s; a decode "
        f"step p50 {out['graph_ms_p50']:.2f} ms through the graphs (max "
        f"{out['graph_ms_max']:.2f}) against {out['decode_ms_p50']:.2f} ms eager (max "
        f"{out['decode_ms_max']:.2f}), {out['decode_steps']} steps a turn, synchronized on each "
        f"side; turns " + ", ".join(f"{k} {ms:.2f} ms ({dt:.2f} s)" for k, ms, dt in out["turns"])
        + f"; greedy tokens identical in all {1 + len(turns)} runs; {out['captures']} captures, "
        f"{out['replays']} replays, {out['keys']} graphs, pool {out['pool_bytes'] / 1e9:.3f} GB; "
        f"masked_dequant launches an eager step {dequants}")
    if prof is not None:
        per = prof["port_kernels"]["masked_dequant"] / replayed
        out["trace"] = dict(replays=replayed, masked_dequant=prof["port_kernels"]["masked_dequant"],
                            masked_dequant_per_step=per, busy_share=prof["busy_share"],
                            kernels=prof["kernel_launches_per_step"])
        log(f"  {label}: the device trace of one graph run ({replayed} replayed prefill and "
            f"decode steps) shows {prof['port_kernels']['masked_dequant']} masked_dequant "
            f"launches, {per:.0f} a step")
    return [SimpleNamespace(rid=i, out_tokens=r.out_tokens) for i, r in enumerate(first)], \
        rows, out


def engine_gateway_run(label, eng, jobs, np, torch):
    """The same requests through ``eng.gateway(record_logits=True)`` (the
    kernel route on the card, graphs and all): its requests and their
    rows by (rid, token index)."""
    gw = eng.gateway(record_logits=True, **ENGINE_GEOMETRY)
    reqs = [gw.submit(p, license=t, max_new_tokens=ENGINE_NEW) for p, t in jobs]
    t0 = time.perf_counter()
    gw.run()
    sync()
    dt = time.perf_counter() - t0
    if any(r.state.value != "done" or len(r.logits_rows) != ENGINE_NEW for r in reqs):
        fail(f"{label}: a request did not finish with one logits row a token")
    m = gw.metrics()
    log(f"  {label}: the same requests through engine.gateway(record_logits=True) in "
        f"{dt:.2f} s ({m['decode_steps']} decode steps, {m['prefill_chunks']} prefill chunks, "
        f"kernels {m['decode_path']['kernels']}, decode graphs "
        f"{0 if gw._graphs is None else gw._graphs.captures} captured)")
    rows = {(r.rid, t): torch.from_numpy(row) for r in reqs for t, row in enumerate(r.logits_rows)}
    return reqs, rows, dict(serve_s=dt, decode_steps=m["decode_steps"],
                            prefill_chunks=m["prefill_chunks"])


def host_sampling_run(label, cfg, params, tiers, np, torch, device, record=False, waves=1,
                      **kw):
    """Phase 3's stream with HOST_SAMPLING's lanes, in ``waves`` waves on
    one gateway (``kw`` its arguments): the first captures the graphs, the
    last is timed (host clock, synchronized at the ends), and so are, in
    that wave, each step's epilogue (``gateway._sample``: the draws, the
    argmax, the copies to the host; synchronized before, and it ends with
    its own copy of the tokens) and each batched draw of the sampling
    lanes (``gateway._draw``, synchronized on each side).  ``record``
    keeps the fused rows (``record_rows``).  Returns every wave's
    requests, the rows, the last wave's ms a step, and the medians of the
    epilogue's and the draw's ms."""
    from repro_torch.serving import LicensedGateway
    from repro_torch.serving import gateway as gateway_mod

    gw = LicensedGateway(cfg, params, tiers=tiers, device=device, **GEOMETRY, **kw)
    rows = record_rows(gw) if record else None
    out, ms, draws, epilogues = [], None, [], []
    draw, epilogue = gateway_mod._draw, gw._sample

    def timed_draw(*a):
        sync()
        t0 = time.perf_counter()
        toks = draw(*a)
        sync()
        draws.append(1e3 * (time.perf_counter() - t0))
        return toks

    def timed_epilogue(*a, **k):
        sync()
        t0 = time.perf_counter()
        toks = epilogue(*a, **k)
        epilogues.append(1e3 * (time.perf_counter() - t0))
        return toks

    gateway_mod._draw, gw._sample = timed_draw, timed_epilogue
    try:
        for _ in range(waves):
            draws.clear()
            epilogues.clear()
            out += serve_wave(label, gw, cfg, np)
            ms = out.pop()
    finally:
        gateway_mod._draw = draw
        gw._sample = epilogue
    draw_ms = float(np.median(draws)) if draws else None
    epi_ms = float(np.median(epilogues))
    log(f"  {label}: {len(out)} requests in {waves} wave(s), fuse_sampling "
        f"{gw.fuse_sampling}, record_logits {gw.record_logits}; last wave {ms:.2f} ms a "
        f"step, its epilogue {epi_ms:.3f} ms (median of {len(epilogues)}), "
        f"{len(draws)} batched draws of {draw_ms:.3f} ms (median); decode graphs "
        f"{0 if gw._graphs is None else gw._graphs.captures} captured, "
        f"{0 if gw._graphs is None else gw._graphs.replays} replayed")
    return out, rows, ms, dict(epilogue_ms=epi_ms, draw_ms=draw_ms, draws=len(draws))


def serve_wave(label, gw, cfg, np):
    """One wave of phase 3's stream with HOST_SAMPLING's lanes on ``gw``;
    returns its requests and, last, its ms a step."""
    m0 = gw.metrics()
    reqs = [gw.submit(p, license=t, max_new_tokens=n, **HOST_SAMPLING[i % len(HOST_SAMPLING)])
            for i, (p, t, n) in enumerate(stream_jobs(cfg, np))]
    sync()
    t0 = time.perf_counter()
    gw.run()
    sync()
    dt = time.perf_counter() - t0
    m = gw.metrics()
    steps = (m["decode_steps"] + m["prefill_chunks"]
             - m0["decode_steps"] - m0["prefill_chunks"])
    if any(r.state.value != "done" for r in reqs):
        fail(f"{label}: a request did not finish")
    return reqs + [1e3 * dt / steps]


def engine_phase(cfg, params, np, torch, graph_step_ms=None, alloc_weight_bytes=None,
                 device="cuda"):
    """Phase 13 (see the module docstring): (a) ``ServingEngine`` on float
    views, its CUDA graphs beside its eager steps in turns (identical
    tokens), against ``engine.gateway(record_logits=True)``, greedy
    tokens equal up to near-ties; (b) the same with ``quantized=True``
    (the in-scan dequant, 252 ``masked_dequant`` launches a step, eager
    and in the device trace of replayed steps) against the gateway's
    in-scan route; (c) host sampling: phase 3's stream with
    greedy and sampling lanes through the kernel route, fused and host
    mode, tokens identical and the ``record_logits`` rows equal to the
    fused run's bit for bit; (d) ``launch.roofline``'s decode bound and
    ``launch.dryrun``'s bytes beside the measured step and allocation.
    Returns each part's summary and the launches of all of them."""
    from repro_torch.core.licensing import LicenseTier
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.shapes import InputShape
    from repro_torch.models import init_cache
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.quantized import qleaves

    t13 = time.perf_counter()
    tiers = {"free": LicenseTier(name="free", masks=FREE_TIER),
             "pro": LicenseTier(name="pro", masks=ENGINE_PRO)}
    jobs = engine_jobs(cfg, np)
    out = {}
    ops.reset_launches()

    log(f"phase 13a: ServingEngine on float views, {cfg.name} at full width and depth, "
        f"tiers full/pro/free, prompts {ENGINE_PROMPTS}, {ENGINE_NEW} new tokens, greedy")
    eng = ServingEngine(cfg, params, tiers=tiers, device=device)
    e_reqs, e_rows, a = engine_run("13a engine, float views", eng, jobs, torch)
    g_reqs, g_rows, a["gateway"] = engine_gateway_run("13a", eng, jobs, np, torch)
    a["parts"] = near_ties("13a engine", e_reqs, g_reqs, e_rows, g_rows, cfg.vocab_size,
                           ref="the gateway's kernel route")
    out["a_float"] = a
    del eng, e_rows, g_rows
    gc.collect()

    log("phase 13b: ServingEngine(quantized=True): one int8 store, each tier's intervals "
        "dequantized in every step")
    eng = ServingEngine(cfg, params, tiers=tiers, quantized=True, device=device)
    want = len(list(qleaves(eng.base_params["units"]))) * cfg.pattern_units
    e_reqs, e_rows, b = engine_run("13b engine, in-scan int8", eng, jobs, torch,
                                   profile=device == "cuda")
    if b["masked_dequant_per_step"] != [want]:
        fail(f"13b: masked_dequant launches an eager step {b['masked_dequant_per_step']}, "
             f"not {want}")
    if device == "cuda" and (b.get("trace") is None
                             or b["trace"]["masked_dequant_per_step"] != want):
        fail(f"13b: the device trace shows {b.get('trace')} masked_dequant launches for the "
             f"replayed steps, not {want} a step")
    g_reqs, g_rows, b["gateway"] = engine_gateway_run("13b", eng, jobs, np, torch)
    b["parts"] = near_ties("13b engine in-scan", e_reqs, g_reqs, e_rows, g_rows,
                           cfg.vocab_size, ref="the gateway's in-scan route")
    out["b_in_scan"] = b
    del eng, e_rows, g_rows
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    log("phase 13c: host sampling on the kernel route: phase 3's stream with greedy lanes and "
        "lanes at temperature 0.8 (top_k 0, 5, 50), fused against host mode")
    fused, _, fused_ms, fused_t = host_sampling_run("13c fused", cfg, params, tiers, np,
                                                    torch, device, waves=3)
    host, _, host_ms, host_t = host_sampling_run("13c host", cfg, params, tiers, np, torch,
                                                 device, waves=3, fuse_sampling=False)
    kept, fused_rows, _, _ = host_sampling_run("13c fused, rows kept", cfg, params, tiers, np,
                                               torch, device, record=True)
    recorded, _, _, _ = host_sampling_run("13c record_logits", cfg, params, tiers, np, torch,
                                          device, record_logits=True)
    toks = [[r.out_tokens for r in run] for run in (fused, host)]
    if toks[0] != toks[1] or not all([r.out_tokens for r in run] == toks[0][:len(run)]
                                     for run in (kept, recorded)):
        fail("13c: fused and host sampling gave different tokens")
    sampled = sum(len(r.out_tokens) for r in fused if r.temperature > 0)
    n_rows = 0
    for r, k in zip(recorded, kept):
        if len(r.logits_rows) != len(r.out_tokens):
            fail(f"13c: request {r.rid} kept {len(r.logits_rows)} rows for "
                 f"{len(r.out_tokens)} tokens")
        for t, row in enumerate(r.logits_rows):
            if not torch.equal(fused_rows[(k.rid, t)].cpu(), torch.from_numpy(row)):
                fail(f"13c: request {r.rid}'s record_logits row {t} differs from the fused "
                     f"run's")
            n_rows += 1
    log(f"  13c: tokens identical in all four runs ({sum(map(len, toks[0]))} tokens in the "
        f"three-wave runs, {sampled} of them drawn at temperature 0.8); {n_rows} record_logits "
        f"rows equal to the fused run's bit for bit; {fused_ms:.2f} ms a step fused against "
        f"{host_ms:.2f} host; the epilogue {fused_t['epilogue_ms']:.3f} ms fused against "
        f"{host_t['epilogue_ms']:.3f} host (medians), a batched draw {fused_t['draw_ms']:.3f} "
        f"ms fused and {host_t['draw_ms']:.3f} host (medians)")
    out["c_host_sampling"] = dict(fused_ms_per_step=fused_ms, host_ms_per_step=host_ms,
                                  fused_epilogue_ms=fused_t["epilogue_ms"],
                                  host_epilogue_ms=host_t["epilogue_ms"],
                                  fused_draw_ms=fused_t["draw_ms"], host_draw_ms=host_t["draw_ms"],
                                  tokens=sum(map(len, toks[0])),
                                  sampled_tokens=sampled, rows_bit_equal=n_rows)
    del fused, host, kept, recorded, fused_rows
    gc.collect()

    groups = {}
    for (p, t) in jobs:
        groups.setdefault(t, []).append(len(p))
    batch = max(len(v) for v in groups.values())
    cap = max(max(v) for v in groups.values()) + ENGINE_NEW
    log(f"phase 13d: launch.roofline and launch.dryrun at 13a's largest engine group "
        f"(batch {batch}, capacity {cap})")
    rep = dryrun.dry_run(cfg, InputShape("engine_13a", "decode", cap, batch))
    before = torch.cuda.memory_allocated() if device == "cuda" else 0
    cache = init_cache(cfg, batch, cap, device=device)
    alloc_cache = (torch.cuda.memory_allocated() - before if device == "cuda"
                   else sum(t.numel() * t.element_size() for t in _leaves(cache)))
    del cache
    bound_ms = 1e3 * rep["bound_s"]
    graph = "not measured" if graph_step_ms is None else f"{graph_step_ms:.2f} ms"
    log(f"  13d: decode bound {bound_ms:.4f} ms ({rep['dominant']}: {rep['bytes'] / 1e9:.4f} GB "
        f"at {roofline.CARD_PEAKS[rep['card']][0] / 1e12:.2f} TB/s, {rep['flops'] / 1e9:.2f} "
        f"GFLOP counted against {rep['model_flops'] / 1e9:.2f} of model_step_flops) beside "
        f"13a's engine step {a['graph_ms_p50']:.2f} ms through its graphs and "
        f"{a['decode_ms_p50']:.2f} eager, and phase 3's graph step (8 lanes) {graph}")
    log(f"  13d: dryrun weight bytes {rep['weight_bytes'] / 1e9:.4f} GB against "
        f"{'not measured' if alloc_weight_bytes is None else f'{alloc_weight_bytes / 1e9:.4f} GB'}"
        f" allocated by init_params; cache bytes {rep['cache_bytes'] / 1e6:.4f} MB against "
        f"{alloc_cache / 1e6:.4f} MB allocated by init_cache")
    if alloc_weight_bytes is not None and \
            abs(rep["weight_bytes"] - alloc_weight_bytes) > 0.01 * alloc_weight_bytes:
        fail("13d: the dry run's weight bytes are more than 1% off the allocation")
    if abs(rep["cache_bytes"] - alloc_cache) > 0.01 * alloc_cache:
        fail("13d: the dry run's cache bytes are more than 1% off the allocation")
    out["d_roofline"] = dict(batch=batch, capacity=cap, bound_ms=bound_ms,
                             dominant=rep["dominant"], bytes=rep["bytes"], flops=rep["flops"],
                             model_flops=rep["model_flops"], weight_bytes=rep["weight_bytes"],
                             cache_bytes=rep["cache_bytes"], alloc_weight_bytes=alloc_weight_bytes,
                             alloc_cache_bytes=alloc_cache, graph_step_ms=graph_step_ms,
                             engine_step_ms=a["decode_ms_p50"],
                             engine_graph_step_ms=a["graph_ms_p50"])
    launches = dict(ops.LAUNCHES)
    out["s"] = time.perf_counter() - t13
    log(f"  phase 13 took {out['s']:.1f} s")
    return out, launches


# phase 14: the host mesh, on phase 3's first requests
MESH_REQUESTS = 8
MESH_NEW = 16
MESH_AFTER = 2                 # the eager mesh turn after the graph runs: steps
MESH_TOL = 0.05                # phase 4's: x max(|logit|, 1)
# 14c: the sharded training step the JAX dry run compiles (grad_accum 4,
# AdamW on ZeRO-1-placed moments), eager, on batches of 4 x 256 tokens
MESH_TRAIN = dict(batch=4, seq=256, grad_accum=4, steps=2, lr=1e-4)


def mesh_training(cfg, params, mesh, np, torch, device="cuda"):
    """14c: ``make_train_step(grad_accum=4)`` for MESH_TRAIN['steps']
    steps from ``params``, first on plain tensors, then (its params, state
    and outputs freed: the two sets of AdamW moments are never resident
    together) on ``mesh`` with the params placed by ``params_shardings``,
    the state by ``opt_state_shardings`` and each batch by
    ``data_shardings`` under ``implicit_replication``; the first step
    writes new params, the next ones into the last step's (``out=``).
    Each step is timed with a synchronize on each side; the first mesh
    step runs under :func:`collective_count` (the collectives one rank
    issues: none on a world of one).  Losses, grad norms and a digest of
    every updated leaf (params, m, v: the int64 sum of its bits) must be
    the plain steps' bit for bit, else the largest relative difference of
    the losses and grad norms is printed and must stay within
    ``LOSS_RTOL``."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.core.pytree_io import flatten_params
    from repro_torch.data import LMDataConfig, lm_batches
    from repro_torch.distribution import sharding as shd
    from repro_torch.training import OptimizerConfig, init_state, make_train_step

    t0 = time.perf_counter()
    steps = MESH_TRAIN["steps"]
    ocfg = OptimizerConfig(lr=MESH_TRAIN["lr"], warmup_steps=1, total_steps=steps,
                           grad_accum=MESH_TRAIN["grad_accum"])
    train_step = make_train_step(cfg, ocfg)
    data = lm_batches(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=MESH_TRAIN["seq"],
                                   batch_size=MESH_TRAIN["batch"], seed=SEED))
    host = [next(data) for _ in range(steps)]
    cuda = torch.device(device).type == "cuda"

    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    def run(on_mesh):
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        p, state = params, init_state(params)
        if on_mesh:
            p = shd.distribute_tree(params, shd.params_shardings(params, mesh, cfg), mesh)
            state = shd.distribute_tree(state, shd.opt_state_shardings(state, params, mesh),
                                        mesh)
            placed = placements_of(p, state)
        res = dict(loss=[], grad_norm=[], step_ms=[])
        for i, b in enumerate(host):
            batch = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
            modes = contextlib.ExitStack()
            if on_mesh:
                batch = shd.distribute_tree(batch, shd.data_shardings(batch, mesh), mesh)
                modes.enter_context(implicit_replication())
                if i == 0:
                    cost = modes.enter_context(collective_count())
            with modes:
                sync()
                t = time.perf_counter()
                p, state, m = train_step(p, state, batch, out=None if i == 0 else p)
                sync()
            res["step_ms"].append(1e3 * (time.perf_counter() - t))
            for k in ("loss", "grad_norm"):
                res[k].append(float(full(m[k])))
        res["digests"] = {}
        for name, tree in (("params", p), ("m", state.m), ("v", state.v)):
            flat = flatten_params(tree)
            res["digests"].update(zip((f"{name}/{k}" for k in flat),
                                      leaf_sums({k: full(t) for k, t in flat.items()}, torch)))
        if on_mesh:
            res["collectives"] = dict(cost.counts)
            now = placements_of(p, state)
            res["placements_moved"] = [k for k in placed if now.get(k) != placed[k]]
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
        return res

    plain = run(False)
    gc.collect()
    meshed = run(True)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    pairs = list(zip(meshed["loss"] + meshed["grad_norm"], plain["loss"] + plain["grad_norm"]))
    worst = max(abs(a - b) / abs(b) for a, b in pairs)
    differ = [k for k in plain["digests"] if plain["digests"][k] != meshed["digests"][k]]
    out = dict(plain=plain, mesh=meshed, max_rel_diff=worst, leaves_differ=len(differ),
               leaves=len(plain["digests"]), s=time.perf_counter() - t0, **MESH_TRAIN)
    log(f"  14c: make_train_step (grad_accum {MESH_TRAIN['grad_accum']}, AdamW) on "
        f"{MESH_TRAIN['batch']} x {MESH_TRAIN['seq']} tokens, {steps} steps: ms per step on "
        f"the mesh {[round(ms, 2) for ms in meshed['step_ms']]} (the first with its "
        f"collectives counted) against {[round(ms, 2) for ms in plain['step_ms']]} plain "
        f"eager; host clock, synchronized on each side; peak memory {meshed['peak_gb']} GB on "
        f"the mesh, {plain['peak_gb']} GB plain; collectives of the first mesh step on the "
        f"one-rank world {meshed['collectives'] or 'none'}; losses "
        f"{meshed['loss']}, grad norms {meshed['grad_norm']}; "
        + ("losses, grad norms and all " + str(out["leaves"]) + " leaf digests (params, m, v) "
           "bit for bit the plain steps'" if worst == 0 and not differ else
           f"largest relative difference of the losses and grad norms {worst:.3g}, "
           f"{len(differ)} of {out['leaves']} leaf digests differ")
        + f"; placements moved {meshed['placements_moved'] or 'none'}; {out['s']:.1f} s")
    if meshed["collectives"]:
        fail(f"14c: the one-rank world issued collectives {meshed['collectives']}")
    if meshed["placements_moved"]:
        fail(f"14c: placements moved in the mesh steps: {meshed['placements_moved']}")
    if not all(np.isfinite(meshed["loss"] + meshed["grad_norm"])):
        fail(f"14c: non-finite loss or grad norm {meshed['loss']} {meshed['grad_norm']}")
    if worst > LOSS_RTOL:
        fail(f"14c: the mesh steps' losses or grad norms differ from the plain steps' by "
             f"{worst} relative, above {LOSS_RTOL}")
    return out


def collective_count():
    """A dispatch mode counting, by name, the functional collectives
    DTensor issues under it (``op_cost.OpCostMode``'s collective count
    without its per-op costing, which slows a full-width training step
    2.7x): ``.counts``."""
    from collections import Counter

    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.launch import op_cost

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.counts = Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            if func.namespace == op_cost._C10D and \
                    func.overloadpacket.__name__.startswith(op_cost._COLLECTIVES):
                self.counts[func.overloadpacket.__name__] += 1
            return func(*args, **(kwargs or {}))

    return Count()


def placements_of(params, state):
    """{path: placements} of a placed params tree and AdamW state."""
    from repro_torch.core.pytree_io import flatten_params

    trees = (("params", params), ("m", state.m), ("v", state.v),
             ("step", {"step": state.step}))
    return {f"{name}/{k}": tuple(t.placements) for name, tree in trees
            for k, t in flatten_params(tree).items()}


def captured_all_reduce(mesh, torch, device="cuda"):
    """One functional ``all_reduce`` and its ``wait`` on the mesh's
    "model" group, run eagerly (NCCL sets up its communicator on a first
    collective, which a capture cannot), then captured in a CUDA graph and
    replayed on three new values: the sum over the world of one is the
    input."""
    from torch.distributed import _functional_collectives as fc

    group = mesh.get_group("model")
    x = torch.ones(1024, device=device)
    eager = fc.wait_tensor(fc.all_reduce(x, "sum", group))
    sync()
    if not torch.equal(eager, x):
        fail("14: the eager all_reduce over the world of one changed its input")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = fc.wait_tensor(fc.all_reduce(x, "sum", group))
    for k in (2.0, 3.0, 5.0):
        x.fill_(k)
        graph.replay()
        sync()
        if not bool((y == k).all()):
            fail(f"14: the replayed all_reduce gave {y.unique().tolist()}, not {k}")
    log(f"  14: a functional all_reduce and its wait on the {torch.distributed.get_backend(group)}"
        f" group of the mesh's 'model' axis captured in a CUDA graph after an eager warm-up, "
        f"replayed 3 times on new values: each sum right")
    return dict(replays=3)


def mesh_phase(cfg, params, np, torch, device="cuda", backend=None):
    """Phase 14 (see the module docstring): ``launch.mesh.make_host_mesh``
    over the card (NCCL, a world of one), the weights and a contiguous
    cache placed by ``distribution.sharding``, and phase 3's first
    MESH_REQUESTS prompts (right-aligned to the longest) through one
    ``prefill_step`` and MESH_NEW greedy ``serve_step``s under
    ``implicit_replication``, (a) on float weights and (b) on the int8
    store in-scan in the free tier, ``masked_dequant`` launched through
    ``local_map``; each held to the same steps on plain tensors, then run
    through ``MeshGraphs`` (``backend``: the default ``CudaGraphBackend``)
    in turns with the eager mesh steps.  Returns the summary and the
    mesh runs' launches."""
    import os
    import statistics

    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.core.licensing import LicenseTier
    from repro_torch.distribution import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.launch import op_cost
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_cache
    from repro_torch.serving.compiled import MeshGraphs
    from repro_torch.serving.engine import prefill_step, right_align, serve_step
    from repro_torch.serving.quantized import qleaves, quantize_serving_params, tier_intervals

    t14 = time.perf_counter()
    prompts = [p for p, _, _ in stream_jobs(cfg, np)[:MESH_REQUESTS]]
    width, b = max(map(len, prompts)), len(prompts)
    tokens = torch.from_numpy(right_align(prompts, width, b).astype(np.int64)).to(device)
    # NCCL's bootstrap of a one-rank world binds a socket: on the loopback
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    t0 = time.perf_counter()
    mesh = make_host_mesh(device)
    log(f"phase 14: the host mesh, {cfg.name} at full width and depth: "
        f"make_host_mesh({device!r}) {tuple(mesh.shape)} {mesh.mesh_dim_names} over "
        f"{torch.distributed.get_backend()} in {time.perf_counter() - t0:.2f} s; "
        f"{b} prompts of phase 3's stream right-aligned to {width} tokens, one prefill_step "
        f"and {MESH_NEW} greedy serve_steps on a contiguous cache")
    collective = captured_all_reduce(mesh, torch, device) if device == "cuda" else None

    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    def placed(tree, shardings):
        return shd.distribute_tree(tree, shardings, mesh)

    def run(p, li, on_mesh, count=None, steps=MESH_NEW):
        cache = init_cache(cfg, b, width + MESH_NEW, device=device)
        toks = tokens
        if on_mesh:
            p = placed(p, shd.params_shardings(p, mesh, cfg))
            cache = placed(cache, shd.cache_shardings(cache, mesh, b))
            toks = placed({"t": tokens}, shd.data_shardings({"t": tokens}, mesh))["t"]
        rows, picks, step_ms = [], [], []
        modes = contextlib.ExitStack()
        if on_mesh:
            modes.enter_context(implicit_replication())
        if count is not None:
            modes.enter_context(count)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        with modes:
            sync()
            t = time.perf_counter()
            lg, cache = prefill_step(p, cfg, toks, cache, license_intervals=li)
            rows.append(full(lg).float())
            sync()
            prefill_ms = 1e3 * (time.perf_counter() - t)
            for i in range(1 if count is not None else steps):
                nxt = rows[-1].argmax(-1)
                picks.append(nxt)
                pos = torch.full((b,), width + i, dtype=torch.int32, device=device)
                sync()
                t = time.perf_counter()
                lg, cache = serve_step(p, cfg, nxt[:, None], cache, pos, li)
                rows.append(full(lg).float())
                sync()
                step_ms.append(1e3 * (time.perf_counter() - t))
        return dict(rows=rows, tokens=torch.stack(picks).T.tolist() if picks else [],
                    prefill_ms=prefill_ms, step_ms=step_ms, launches=dict(ops.LAUNCHES),
                    peak_gb=torch.cuda.max_memory_allocated() / 1e9)

    def graph_run(graphs, li, steps=MESH_NEW):
        """``run``'s schedule through ``graphs``: the prefill (captured
        on the first run: its warm-up is the step) and ``steps`` greedy
        decode steps, each timed with a synchronize on each side."""
        rows, picks, step_ms = [], [], []
        host = tokens.cpu().numpy()
        sync()
        t = time.perf_counter()
        lg, greedy = graphs.prefill(host, width + MESH_NEW, intervals=li)
        rows.append(lg.clone())
        sync()
        prefill_ms = 1e3 * (time.perf_counter() - t)
        for i in range(steps):
            picks.append(greedy.clone())
            sync()
            t = time.perf_counter()
            lg, greedy = graphs.decode(greedy, width + i, width + MESH_NEW, intervals=li)
            rows.append(lg.clone())
            sync()
            step_ms.append(1e3 * (time.perf_counter() - t))
        return dict(rows=rows, tokens=torch.stack(picks).T.tolist(), prefill_ms=prefill_ms,
                    step_ms=step_ms)

    def op_counts(p, li, on_mesh):
        """aten ops of one decode step after the prefill, by name (DTensor's
        local ops on the mesh)."""
        from collections import Counter

        from torch.utils._python_dispatch import TorchDispatchMode

        class Names(TorchDispatchMode):
            def __init__(self):
                super().__init__()
                self.n = Counter()

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                self.n[str(func)] += 1
                return func(*args, **(kwargs or {}))

        cache = init_cache(cfg, b, width + 1, device=device)
        toks, pos = tokens, torch.full((b,), width, dtype=torch.int32, device=device)
        ctx = contextlib.nullcontext()
        if on_mesh:
            p = placed(p, shd.params_shardings(p, mesh, cfg))
            cache = placed(cache, shd.cache_shardings(cache, mesh, b))
            ctx = implicit_replication()
        names = Names()
        with ctx:
            lg, cache = prefill_step(p, cfg, toks, cache, license_intervals=li)
            with names:
                serve_step(p, cfg, full(lg).argmax(-1)[:, None], cache, pos, li)
        return names.n

    def graph_mesh(label, key, graphs, g_runs, meshed, meshed_after, plain, li, graph_launches):
        """The graph runs against the eager mesh turns around them: tokens
        identical, logits bit for bit, the medians; in-scan on the card,
        the device trace of a replayed prefill and 3 decode steps."""
        for n, g in enumerate(g_runs):
            if g["tokens"] != meshed["tokens"]:
                fail(f"{label}: graph run {n + 1}'s greedy tokens differ from the eager mesh "
                     f"steps'")
            if not all(torch.equal(a, b) for a, b in zip(g["rows"], meshed["rows"])):
                diff = max(float((a - b).abs().max()) for a, b in zip(g["rows"], meshed["rows"]))
                fail(f"{label}: graph run {n + 1}'s logits differ from the eager mesh steps' "
                     f"(max |diff| {diff:.4g})")
        if meshed_after["tokens"] != [t[:MESH_AFTER] for t in meshed["tokens"]]:
            fail(f"{label}: the second eager mesh turn's tokens differ from the first's")
        g_steps = [ms for g in g_runs for ms in g["step_ms"]][1:]     # the capture's out
        e_steps = meshed["step_ms"] + meshed_after["step_ms"]
        res = dict(graph_step_ms=statistics.median(g_steps),
                   eager_mesh_step_ms=statistics.median(e_steps),
                   graph_prefill_ms=g_runs[1]["prefill_ms"],
                   graph_capture_prefill_ms=g_runs[0]["prefill_ms"],
                   graph_capture_decode_ms=g_runs[0]["step_ms"][0],
                   eager_mesh_prefill_ms=meshed_after["prefill_ms"],
                   turns=[("eager", statistics.median(meshed["step_ms"])),
                          ("graph", statistics.median(g_runs[0]["step_ms"][1:])),
                          ("graph", statistics.median(g_runs[1]["step_ms"])),
                          ("eager", statistics.median(meshed_after["step_ms"]))],
                   graph_captures=graphs.captures, graph_replays=graphs.replays,
                   graph_keys=sorted(map(str, graphs.keys())),
                   graph_pool_bytes=graphs.backend.pool_bytes(), graph_launches=graph_launches)
        log(f"  {label}: through MeshGraphs on the mesh, decode step {res['graph_step_ms']:.2f} "
            f"ms (median of {len(g_steps)} replays) against {res['eager_mesh_step_ms']:.2f} ms "
            f"eager on the mesh (median of {len(e_steps)}) and "
            f"{statistics.median(plain['step_ms']):.2f} ms plain eager; turns "
            + ", ".join(f"{k} {ms:.2f}" for k, ms in res["turns"])
            + f" ms; prefill {res['graph_prefill_ms']:.1f} ms replayed against "
            f"{res['eager_mesh_prefill_ms']:.1f} eager on the mesh (captures: prefill "
            f"{res['graph_capture_prefill_ms']:.1f} ms, its warm-up the step; decode "
            f"{res['graph_capture_decode_ms']:.1f} ms with its replay); host clock, synchronized "
            f"on each side; greedy tokens identical and logits of all {len(meshed['rows'])} "
            f"steps bit for bit the eager mesh steps' in both graph runs; {graphs.captures} "
            f"captures, {graphs.replays} replays, keys {res['graph_keys']}, pool "
            f"{res['graph_pool_bytes'] / 1e9:.3f} GB; launches of the warm-ups {graph_launches}")
        if key == "b_in_scan" and device == "cuda":
            want = len(list(qleaves(graphs.params["units"]))) * cfg.pattern_units
            replays = graphs.replays
            prof = profile_window("14b_mesh_graph_steps",
                                  lambda: graph_run(graphs, li, steps=3), torch, 4)
            n = graphs.replays - replays
            got = None if prof is None else prof["port_kernels"]["masked_dequant"]
            if got is None or n != 4 or got != want * n:
                fail(f"14b: the device trace of {n} replayed steps shows {got} masked_dequant "
                     f"launches, not {want} a step")
            res["trace"] = dict(replays=n, masked_dequant=got, masked_dequant_per_step=got / n,
                                busy_share=prof["busy_share"])
            log(f"  14b: the device trace of {n} replayed mesh steps (the prefill and 3 decode "
                f"steps) shows {got} masked_dequant launches, {got // n} a step")
        return res

    out, launches = {}, {}
    if collective is not None:
        out["captured_all_reduce"] = collective
    tiers = {"free": LicenseTier(name="free", masks=FREE_TIER)}
    try:
        for key, label in (("a_float", "14a float weights"),
                           ("b_in_scan", "14b int8 store in-scan, tier free")):
            if key == "a_float":
                p, li = params, None
            else:
                t0 = time.perf_counter()
                p = quantize_serving_params(params)
                li = tier_intervals(tiers["free"], device=device)
                sync()
                log(f"  14b: int8 store built in {time.perf_counter() - t0:.2f} s")
            plain = run(p, li, False)
            meshed = run(p, li, True)
            graphs = MeshGraphs(cfg, placed(p, shd.params_shardings(p, mesh, cfg)), mesh=mesh,
                                backend=backend)
            ops.reset_launches()
            g_runs = [graph_run(graphs, li) for _ in range(2)]
            graph_launches = dict(ops.LAUNCHES)
            meshed_after = run(p, li, True, steps=MESH_AFTER)
            cost = op_cost.OpCostMode()
            run(p, li, True, count=cost)
            per_step = meshed["launches"].get("masked_dequant", 0) // (MESH_NEW + 1)
            res = dict(
                mesh_step_ms=statistics.median(meshed["step_ms"]),
                plain_step_ms=statistics.median(plain["step_ms"]),
                mesh_prefill_ms=meshed["prefill_ms"], plain_prefill_ms=plain["prefill_ms"],
                mesh_peak_gb=meshed["peak_gb"], plain_peak_gb=plain["peak_gb"],
                launches=meshed["launches"], plain_launches=plain["launches"],
                collectives=dict(cost.collectives.count_by_kind),
                collective_bytes=cost.collectives.total_bytes)
            log(f"  {label}: decode step {res['mesh_step_ms']:.2f} ms on the mesh against "
                f"{res['plain_step_ms']:.2f} ms plain eager (median of {MESH_NEW}, host clock, "
                f"synchronized on each side: {res['mesh_step_ms'] / res['plain_step_ms']:.2f}x, "
                f"the host's cost of DTensor dispatch); prefill {res['mesh_prefill_ms']:.1f} "
                f"against {res['plain_prefill_ms']:.1f} ms (the mesh's first call included)")
            log(f"  {label}: collectives of the prefill and one decode step on the one-rank world "
                f"{res['collectives'] or 'none'}, {res['collective_bytes']} bytes; "
                f"peak memory {res['mesh_peak_gb']:.2f} GB on the mesh, {res['plain_peak_gb']:.2f} "
                f"GB plain; launches on the mesh {meshed['launches']}")
            res.update(graph_mesh(label, key, graphs, g_runs, meshed, meshed_after, plain, li,
                                  graph_launches))
            del graphs, g_runs, meshed_after
            if meshed["tokens"] != plain["tokens"]:
                fail(f"{label}: greedy tokens on the mesh differ from the plain steps'")
            diffs = [float((m - q).abs().max()) for m, q in zip(meshed["rows"], plain["rows"])]
            scale = max(float(q.abs().max()) for q in plain["rows"])
            res["max_abs_logit_diff"] = max(diffs)
            if res["max_abs_logit_diff"] == 0.0:
                log(f"  {label}: logits of all {len(diffs)} steps bit for bit equal to the plain "
                    f"steps'; greedy tokens identical ({b} x {MESH_NEW})")
            else:
                first = next(i for i, d in enumerate(diffs) if d)
                got, want = op_counts(p, li, True), op_counts(p, li, False)
                moved = {k: (got[k], want[k]) for k in set(got) | set(want)
                         if got[k] != want[k]}
                res["op_count_diff"] = moved
                log(f"  {label}: logits differ from the plain steps' from step {first} (0 is "
                    f"the prefill), max |diff| {res['max_abs_logit_diff']:.4g} against max "
                    f"|logit| {scale:.3f} (tol {MESH_TOL * max(scale, 1.0):.4f}); greedy tokens "
                    f"identical; the ops a decode step runs (mesh, plain) where the counts "
                    f"differ: {moved}")
                if not res["max_abs_logit_diff"] <= MESH_TOL * max(scale, 1.0):
                    fail(f"{label}: the mesh's logits differ by more than phase 4's tolerance")
            if key == "b_in_scan":
                want = len(list(qleaves(p["units"]))) * cfg.pattern_units
                if per_step != want or meshed["launches"] != plain["launches"]:
                    fail(f"14b: masked_dequant through local_map launched {per_step} a step "
                         f"({meshed['launches']}), the plain in-scan steps {plain['launches']}; "
                         f"want {want} a step")
                log(f"  14b: masked_dequant launched through local_map {per_step} times a step "
                    f"({meshed['launches']['masked_dequant']} in all), as the plain in-scan steps")
            for k, v in list(meshed["launches"].items()) + list(graph_launches.items()):
                launches[k] = launches.get(k, 0) + v
            out[key] = res
            del p, plain, meshed
            gc.collect()
            torch.cuda.empty_cache()
        log(f"  14c: the sharded training step, {cfg.name} at full width and depth")
        out["c_train"] = mesh_training(cfg, params, mesh, np, torch, device)
    finally:
        torch.distributed.destroy_process_group()
    out["s"] = time.perf_counter() - t14
    log(f"  phase 14 took {out['s']:.1f} s")
    return out, launches


def main() -> None:
    t_script = time.perf_counter()
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from a "
             f"checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    # the plain versions' f32 products in full f32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.core.licensing import LicenseTier
    from repro_torch.kernels import masked_dequant as kernels_md
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as kernels_pa
    from repro_torch.kernels.build import load_extension
    from repro_torch.launch import roofline
    from repro_torch.models import init_params
    from repro_torch.serving import LicensedGateway

    # ---------------------------------------------------------- phase 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    kind = torch.cuda.get_device_name(0)
    if roofline.card_key(kind) is None:
        fail(f"no published peaks for {kind!r}; bounds cannot be derived")
    peaks = roofline.CARD_PEAKS[roofline.card_key(kind)]
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}")
    t0 = time.perf_counter()
    load_extension()
    log(f"phase 1: CUDA kernels built in {time.perf_counter() - t0:.1f} s")

    # ---------------------------------------------------------- phase 2
    log("phase 2: kernels vs their plain versions")
    rows = check_kernels(peaks, torch, ops, ref, kernels_pa, kernels_md)
    log("phase 2: prefill attention and int8 MLP products at qwen2.5-3b's shapes")
    prefill_rows, prefill_launches = check_prefill_mlp(peaks, torch, ops, ref)
    rows.update(prefill_rows)

    # ---------------------------------------------------------- phase 3
    log(f"phase 3: LicensedGateway, {ARCH} at full width and depth")
    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"  {n_params / 1e9:.3f} B parameters ({cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, d_ff {cfg.d_ff}, "
        f"vocab {cfg.padded_vocab}, {cfg.dtype_name}) in {time.perf_counter() - t0:.1f} s")
    tiers = {"free": LicenseTier(name="free", masks=FREE_TIER)}
    ops.reset_launches()
    # the float stream three times: telemetry off, on (the default, and
    # the run phase 4 reads), off again; each run keeps the same per-step
    # copy of its logits rows (record_rows), so the runs differ only in
    # what telemetry records
    off_runs = []

    def serve_off(n):
        gw_off = LicensedGateway(cfg, params, tiers=tiers, telemetry=False, **GEOMETRY)
        record_rows(gw_off)
        reqs, t = serve(f"float views, telemetry off ({n})", gw_off, cfg, np, torch)
        if len(gw_off.tracer.events) or gw_off.audit_events() or gw_off.h_decode.count:
            fail("telemetry=False recorded events, audit records or observations")
        off_runs.append((reqs, t))

    serve_off(1)
    gc.collect()
    gw = LicensedGateway(cfg, params, tiers=tiers, **GEOMETRY)
    kernel_rows = record_rows(gw)           # read in phase 4
    float_reqs, float_t = serve("float views", gw, cfg, np, torch)
    serve_off(2)
    gc.collect()
    if any([r.out_tokens for r in reqs] != [r.out_tokens for r in float_reqs]
           for reqs, _ in off_runs):
        fail("greedy tokens differ between telemetry on and off")
    off_ms = [1e3 * t["serve_s"] / (t["decode_steps"] + t["prefill_chunks"]) for _, t in off_runs]
    on_ms = 1e3 * float_t["serve_s"] / (float_t["decode_steps"] + float_t["prefill_chunks"])
    overhead = dict(on_ms_per_step=on_ms, off_ms_per_step=off_ms,
                    on_tokens_per_s=float_t["tokens"] / float_t["serve_s"],
                    off_tokens_per_s=[t["tokens"] / t["serve_s"] for _, t in off_runs],
                    overhead_pct=100 * (on_ms / (sum(off_ms) / 2) - 1))
    log(f"  telemetry on against off: {on_ms:.2f} against {off_ms[0]:.2f} / {off_ms[1]:.2f} ms "
        f"per step, {overhead['on_tokens_per_s']:.1f} against "
        f"{overhead['off_tokens_per_s'][0]:.1f} / {overhead['off_tokens_per_s'][1]:.1f} tokens/s: "
        f"overhead {overhead['overhead_pct']:+.2f}% of the mean off step (reported, not "
        f"gated); greedy tokens identical across the three runs")
    float_t["telemetry"] = telemetry_report("float views", gw)
    float_t["telemetry"]["on_off"] = overhead
    float_t["decode_profile"] = decode_profile(gw, cfg, np, torch)
    del gw, off_runs            # slot <-> gateway cycle: collect its views
    gc.collect()
    gw = LicensedGateway(cfg, params, tiers=tiers, quantized=True,
                         materialize_int8_views=True, **GEOMETRY)
    int8_reqs, int8_t = serve("int8 views", gw, cfg, np, torch)
    launches = dict(ops.LAUNCHES)
    log(f"  launches on the main path: {launches}")
    for name in ("paged_attention", "paged_decode_write", "masked_dequant"):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the serving path")
    store = gw._weights[gw.version]
    leaf = store["units"]["b0"]["ffn"]["w_up"]
    leaf = (leaf["codes"][0].clone(), leaf["scale"][0].reshape(-1).clone())
    del gw
    gc.collect()
    torch.cuda.empty_cache()
    rows["masked_dequant"]["cases"].update(
        view_cases(peaks, torch, ops, store, tiers["free"], cfg.dtype))
    del store
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(prefill_launches)
    rows["quant_matmul"]["store_leaf_rel_err"] = store_leaf_check(*leaf, torch, ops)
    del leaf

    # ---------------------------------------------------------- phase 3c
    log(f"phase 3c: the compiled decode step and the in-scan int8 dequant, {ARCH} at "
        f"full width and depth")
    # the in-scan stream must give the materialized int8 views' tokens
    want_streams = {"float": [r.out_tokens for r in float_reqs],
                    "in_scan": [r.out_tokens for r in int8_reqs]}
    compiled = compiled_phase(cfg, params, tiers, np, torch, want_streams)
    del int8_reqs

    # ---------------------------------------------------------- phase 3d
    log(f"phase 3d: long prompts through the compiled chunked prefill, {ARCH} at full "
        f"width and depth")
    long_prompts = long_prompt_phase(cfg, params, np, torch)

    # ---------------------------------------------------------- phase 3b
    log(f"phase 3b: the shared-prefix stream, {ARCH} at full width and depth")
    ops.reset_launches()
    prefix_runs = prefix_phase(cfg, params, tiers, np)
    prefix_launches = dict(ops.LAUNCHES)
    log(f"  launches on the shared-prefix path: {prefix_launches}")
    for name in ("paged_attention", "paged_decode_write", "masked_dequant"):
        if prefix_launches[name] <= 0:
            fail(f"kernel {name} was not launched on the shared-prefix path")
    fingerprint = leaf_sums(params, torch)      # phase 7 re-creates these weights

    # ---------------------------------------------------------- phase 4
    log("phase 4: kernel path vs plain path")
    gw = LicensedGateway(cfg, params, tiers=tiers, **GEOMETRY)
    err, scale, same, n_lanes, tier, flips = decode_logits_check(gw, cfg, np, torch)
    # bf16 tolerance: the kernel returns f32 attention cast once to bf16,
    # the plain path casts probabilities to bf16 before the value product;
    # 36 layers of bf16 residual rounding separate the two
    tol = 0.05 * max(scale, 1.0)
    log(f"  one decode step ({n_lanes} lanes, tier {tier}): max |logit diff| "
        f"{err:.4f} vs max |logit| {scale:.3f} (tol {tol:.4f}); "
        f"argmax agrees on {same}/{n_lanes} lanes")
    if not err <= tol:
        fail("decode logits of the kernel path and the plain path disagree")
    # a lane whose argmax differs is a near-tie when the plain path's two
    # best logits lie closer than the step's max |logit diff|; a wider gap
    # would take more than rounding to flip, so it is a fault
    for f in flips:
        log(f"  lane {f['lane']}: kernel token {f['kernel_token']}, plain token "
            f"{f['plain_token']}; plain top-2 gap {f['plain_top2_gap']:.4f} (to the kernel's "
            f"token {f['plain_gap_to_kernel_token']:.4f}), lane max |logit diff| "
            f"{f['lane_max_abs_diff']:.4f}, step max |logit diff| {err:.4f}")
    wide = [f["lane"] for f in flips if not f["plain_gap_to_kernel_token"] < err]
    if wide:
        fail(f"argmax flips on lanes {wide} with a plain-path gap of at least the max "
             f"|logit diff| {err:.4f}: not a near-tie")
    log(f"  argmax flips: {len(flips)}, every one a near-tie (gap below {err:.4f})")
    del gw
    gc.collect()
    gw = LicensedGateway(cfg, params, tiers=tiers, decode_kernels=False, **GEOMETRY)
    plain_rows = record_rows(gw)
    plain_reqs, plain_t = serve("float views, plain decode path", gw, cfg, np, torch)
    agree = sum(a == b for r1, r2 in zip(float_reqs, plain_reqs)
                for a, b in zip(r1.out_tokens, r2.out_tokens))
    total = sum(len(r.out_tokens) for r in float_reqs)
    parts = stream_parts(float_reqs, plain_reqs, kernel_rows, plain_rows, cfg.vocab_size)
    # phase 3's rows go to the host: phase 9d compares the fallbacks' streams with it
    float_rows = host_rows(kernel_rows)
    del kernel_rows, plain_rows
    log(f"  greedy tokens equal between kernel and plain decode: {agree}/{total}; "
        f"first differing step per request (None: identical): "
        f"{[p['step'] for p in parts]}")
    # where a request's tokens part, both paths had the same tokens before:
    # a near-tie is a plain-path gap below that lane's |logit diff|, and the
    # diff itself within the decode step's tolerance above; a gap as wide as
    # the diff, or a wider diff, takes more than rounding
    split = [p for p in parts if p["step"] is not None]
    for p in split:
        log(f"  request {p['request']} parts at step {p['step']}: kernel token "
            f"{p['kernel_token']}, plain token {p['plain_token']}; plain-path gap "
            f"{p['plain_gap']:.4f} (kernel-path gap {p['kernel_gap']:.4f}), lane max "
            f"|logit diff| {p['lane_max_abs_diff']:.4f} (tol {tol:.4f})")
    wide = [p["request"] for p in split
            if not (p["plain_gap"] < p["lane_max_abs_diff"] <= tol)]
    if wide:
        fail(f"requests {wide} part at a step whose plain-path gap reaches the lane's "
             f"|logit diff|, or whose diff exceeds {tol:.4f}: not a near-tie")
    log(f"  requests parting: {len(split)}, every one at a near-tie")

    del gw, params
    gc.collect()
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- phase 5
    log(f"phase 5: update path, {ARCH} at full width and depth")
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    upd = update_phase("float gateway", cfg, {}, torch, np,
                       ref_tokens=[r.out_tokens for r in float_reqs], profile_stage=True,
                       lease=True, parts_case=True)
    rows["delta_apply_inplace"]["cases"]["phase-5 stage step"] = upd["step_case"]
    upd["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    # the process's peak resident host memory so far (ru_maxrss is in KiB)
    upd["host_maxrss_gb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9
    log(f"  float gateway: in-flight tokens equal phase 3's update-free run; "
        f"max_memory_allocated {upd['max_memory_allocated_gb']:.1f} GB, "
        f"host peak RSS {upd['host_maxrss_gb']:.1f} GB")
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- phase 6
    log(f"phase 6: update path on an int8 gateway, {ARCH} at full width, 4 units")
    torch.cuda.reset_peak_memory_stats()
    cfg4 = cfg.replace(num_layers=4)
    upd8 = update_phase("int8 gateway", cfg4,
                        dict(quantized=True, materialize_int8_views=True), torch, np)
    upd8["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    upd_launches = dict(ops.LAUNCHES)
    log(f"  launches on the update path: {upd_launches}")
    for name in ("delta_apply", "delta_apply_inplace"):
        if upd_launches[name] <= 0:
            fail(f"kernel {name} was not launched on the update path")
        launches[name] = upd_launches[name]

    # ---------------------------------------------------------- phase 7
    log(f"phase 7: Algorithm 1 (calibrate_license) on phase 3's weights, {ARCH} at "
        f"full width and depth")
    params = init_params(cfg, seed=SEED, device="cuda")
    if leaf_sums(params, torch) != fingerprint:
        fail("7: init_params(seed) did not re-create phase 3's weights")
    ops.reset_launches()
    calib = calibration_phase(cfg, params, np, torch)
    calib_launches = dict(ops.LAUNCHES)
    log(f"  launches while serving the calibrated tier: {calib_launches}")
    for name in ("paged_attention", "paged_decode_write"):
        if calib_launches[name] <= 0:
            fail(f"kernel {name} was not launched serving the calibrated tier")

    # ---------------------------------------------------------- phase 7b
    log(f"phase 7b: FleetGateway, two slots of {ARCH} at full width and depth on "
        f"phase 3's weights")
    fleet = fleet_phase(cfg, params, tiers, np, torch, want_streams)
    gc.collect()
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- phase 8
    log("phase 8a: the quickstart (train, compress, fine-tune, publish, calibrate, pull, "
        "update) at the paper's size, TABLE1_A")
    t8 = time.perf_counter()
    lifecycle = {"quickstart": quickstart_phase(np, torch)}
    for name in ("delta_apply", "delta_apply_inplace"):
        launches[name] += lifecycle["quickstart"]["launches"][name]
    log(f"phase 8b: compress_pipeline on phase 3's weights, {ARCH} at full width and depth")
    lifecycle["compression"] = compression_phase(cfg, params, np, torch)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 8c: train_loop on phase 3's weights, {ARCH} at full width and depth; "
        f"then {CKPT['units']} units checkpointed")
    lifecycle["training"] = training_phase(cfg, params, np, torch)
    lifecycle["s"] = time.perf_counter() - t8
    log(f"  phase 8 took {lifecycle['s']:.1f} s")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- phase 9
    t9 = time.perf_counter()
    dense, dense_launches = dense_phase(np, torch)
    log(f"phase 9d: the gateway's fallbacks (gather/scatter decode, contiguous pool, bucket "
        f"prefill, a fleet with a contiguous slot), {ARCH} at full width and depth on phase "
        f"3's weights")
    params = init_params(cfg, seed=SEED, device="cuda")
    if leaf_sums(params, torch) != fingerprint:
        fail("9d: init_params(seed) did not re-create phase 3's weights")
    fallbacks, fallback_launches = fallback_phase(cfg, params, tiers, np, torch, float_reqs,
                                                  float_rows)
    del params, float_rows
    gc.collect()
    torch.cuda.empty_cache()
    phase9_launches = {k: dense_launches.get(k, 0) + fallback_launches.get(k, 0)
                       for k in set(dense_launches) | set(fallback_launches)}
    log(f"  launches on phase 9's paths: {phase9_launches}")
    for name in ("paged_attention", "paged_decode_write", "masked_dequant"):
        if phase9_launches.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched on phase 9's paths")
        launches[name] += phase9_launches[name]
    log(f"  phase 9 took {time.perf_counter() - t9:.1f} s")

    # ---------------------------------------------------------- phase 10
    t10 = time.perf_counter()
    moe, phase10_launches = moe_phase(np, torch)
    log(f"  launches on phase 10's paths: {phase10_launches}")
    for name in ("paged_attention", "paged_decode_write", "masked_dequant"):
        if phase10_launches.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched on phase 10's paths")
        launches[name] += phase10_launches[name]
    log(f"  phase 10 took {time.perf_counter() - t10:.1f} s")

    # ---------------------------------------------------------- phase 11
    recurrent, phase11_launches = recurrent_phase(peaks, np, torch)
    log(f"  launches on phase 11's paths: {phase11_launches}")
    if phase11_launches.get("masked_dequant", 0) <= 0:
        fail("kernel masked_dequant was not launched on phase 11's paths")
    for name, n in phase11_launches.items():
        launches[name] += n
    rows["masked_dequant"]["cases"]["tail/t0/mixer/w_r (rank 2)"] = \
        recurrent["recurrentgemma-2b"]["int8"]["rank2"]

    # ---------------------------------------------------------- phase 12
    frontend, phase12_launches = frontend_phase(peaks, np, torch)
    log(f"  launches on phase 12's paths: {phase12_launches}")
    for name in ("paged_attention", "paged_decode_write", "masked_dequant"):
        if phase12_launches.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched on phase 12's paths")
    for name, n in phase12_launches.items():
        launches[name] += n

    # ---------------------------------------------------------- phase 13
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    params = init_params(cfg, seed=SEED, device="cuda")
    alloc = torch.cuda.memory_allocated() - before
    if leaf_sums(params, torch) != fingerprint:
        fail("13: init_params(seed) did not re-create phase 3's weights")
    graph_step = next((r["decode_profile"]["unprofiled_ms_per_step"]
                       for r in compiled["float"]["runs"]
                       if r["path"] == "graph" and r.get("decode_profile")), None)
    engine, phase13_launches = engine_phase(cfg, params, np, torch, graph_step, alloc)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  launches on phase 13's paths: {phase13_launches}")
    for name in ("paged_attention", "paged_decode_write", "masked_dequant"):
        if phase13_launches.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched on phase 13's paths")
    for name, n in phase13_launches.items():
        launches[name] += n

    # ---------------------------------------------------------- phase 14
    host_mesh, phase14_launches = mesh_phase(cfg, params, np, torch)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  launches on phase 14's paths: {phase14_launches}")
    if phase14_launches.get("masked_dequant", 0) <= 0:
        fail("kernel masked_dequant was not launched on phase 14's paths")
    for name, n in phase14_launches.items():
        launches[name] += n

    # ---------------------------------------------------------- summary
    kernels = [dict(name=name, launches=launches[name], **row)
               for name, row in rows.items()]
    for u in (upd, upd8):
        u.pop("tokens")
    log(f"whole script {time.perf_counter() - t_script:.1f} s (kernel build included)")
    log(json.dumps({"gateway": {"float": float_t, "int8": int8_t,
                                "plain_decode": plain_t, "compiled": compiled,
                                "long_prompts": long_prompts,
                                "decode_logits_max_abs_err": err,
                                "decode_argmax_flips": flips, "stream_parts": parts},
                    "shared_prefix": {"runs": prefix_runs, "launches": prefix_launches},
                    "update": {"float_full_depth": upd, "int8_depth4": upd8},
                    "calibration": {**calib, "launches": calib_launches},
                    "fleet": fleet, "lifecycle": lifecycle,
                    "dense": dense, "fallbacks": fallbacks,
                    "phase9_launches": phase9_launches,
                    "moe_mla": moe, "phase10_launches": phase10_launches,
                    "recurrent": recurrent, "phase11_launches": phase11_launches,
                    "frontend": frontend, "phase12_launches": phase12_launches,
                    "engine": engine, "phase13_launches": phase13_launches,
                    "host_mesh": host_mesh, "phase14_launches": phase14_launches}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


def leaf_sums(tree, torch):
    """One integer per leaf: the sum of its bit patterns (a fingerprint
    of the weights that needs no host copy)."""
    return [int(t.view(torch.int16 if t.element_size() == 2 else torch.int32)
                .sum(dtype=torch.int64)) for t in _leaves(tree)]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    main()
