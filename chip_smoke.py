#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # needs one CUDA card (an H100)

Phases, each fatal on failure:

  1. build     compile the port's CUDA kernels from ``src/repro_torch/kernels/
               csrc`` with nvcc, one process per source, all at once; print
               the build time, the compiler's register/shared-memory report
               (and the register and spill lines of the bf16 tensor-core
               instantiations apart) and the card's name and power limit.
  2. kernels   hold each kernel against its plain PyTorch version on the
               card: the paged attention kernels at the serving path's
               shapes (hd 128, ps 16, Hq/Hkv 32/8 at tp=1 and one rank's
               16/4 at tp=2, lengths 1..2048 across page boundaries, K 1
               and 5 (the defaults pass's verify window, 20 query rows a kv
               head at tp=1), S in
               {1, 4}, window 0 and > 0, 512- and 256-query chunks with
               fresh rows beside resumed rows), at the dense registry's
               other head layouts (52/52 paper-30b, 13/13 its tp=4 rank,
               32/32 codeqwen1.5-7b, 64/8 qwen3-32b and paper-70b, and the
               MoE configs' 24/8 at hd 64 (granite) and 64/8 at hd 112
               (kimi): B1 at K 1 and 5, S 1 and 4; B3 on the 256-query ISO
               chunk) and at
               the CPU tests' shapes
               (hd 16, ps 8), fp32 and bf16, dead-page skip bit-identical;
               the bf16 paged-prefill tile loop's edges (hd 64/80/256 x ps
               8/16/32 x group 1/2/4/8, Sq 100, prefixes off the 64-key
               grid, windows that leave rows with no key, which must come
               back neutral, group 80, hd 20);
               the paged decode kernel's edges (hd 64/80/256/20/18, ps 32/64,
               query rows 1/12/32/33/40/48/64, 8192 and 3000 tokens on
               clustered grids, rows and batches with no key; every span
               partial with no key must come back neutral); at S > 1 the
               split-KV fold inside the decode launch EQUAL to the
               standalone reduce of the same partials, and the fold's
               arrival counters back at 0 after launches in a row and after
               CUDA-graph replays;
               the int8 quantize kernel over bf16/fp32 rows of width
               64..4096 (the 16-byte and the scalar path, an all-zero row,
               .5 ties) and on rows of 2^21 + 8, q and scales EQUAL to the
               plain version, and the int8 all-reduce's three kernels
               (shards quantize, rank sum and re-quantize, gathered
               dequantize) at tp 2 and 4 EQUAL to theirs, the two quantize
               kernels also on long rows (2^24 + 1184 elements, the
               abs-max in the ragged last segment) that their launch plan
               splits over many blocks (each call counted under its
               ``/split`` variant); the dense
               flash-prefill kernel at the CPU tests' shapes and at full
               width (Hq/Hkv 32/8, 16/4, hd 128), MHA, GQA and MQA, ragged
               Sq/Sk, causal or not, windows > 0, rows with no key (0),
               hd 16..256; RMSNorm and SwiGLU over fp32/bf16 rows up to
               (2048, 4096) and (2048, 12288), fp32 and bf16 gamma, widths
               and addresses that forbid 16-byte loads.
  3. serve     the tp=1 path: ``PagedEngine`` serving qwen3-8b at full width
               and depth in bf16 (random weights from a seed) on 6 greedy
               requests of 300-2000 prompt tokens, first on an eager engine
               (``cuda_graphs=False``), then on a graphed one (each decode
               step and each bucket-padded grant one CUDA-graph replay): a
               capture pass, then a timed pass of replays only.  Both
               graphed passes must give the eager tokens; the graph count
               must stay within the closure keys' bound; logits finite,
               every request complete and every page free after each pass;
               in the timed pass, counted through the replays, the paged
               decode and prefill kernels must have launched, every
               paged-prefill launch on the bf16 tensor-core instantiation,
               the decode kernel with the fold inside once a layer of every
               step at S > 1 (by the engine's record of S) and the
               standalone reduce never, and the fold's arrival counters
               must read 0 after it; the graphed decode dispatch share must
               be below the eager one.  Prints each engine's prefill tok/s,
               decode ms/step, dispatch shares and peak memory (allocated
               and reserved), the graph count, capture seconds and the
               reserved memory after each capture, and the device's idle
               share over ten graphed decode steps (a lower bound from CUDA
               events around each step's staging and replay, and the
               ``torch.profiler`` figure with CUDA activities, checked
               against those events) with the kernels that took the most
               device time.  That pass is the batch-1 baseline (one call a
               grant, no sharing, K=1).  A second pass serves the
               reference's defaults, packed grants and copy-on-write prefix
               sharing, with a spec_k=4 verify window, at a budget of 1024
               on the same lengths, three prompts opening with one
               1024-token system prompt and the third a copy of the first:
               an eager engine, then a graphed one (capture pass, timed
               pass), graphed tokens equal to eager; the timed pass must
               launch B3 on a pack of more than one row, B1 on the 5-token
               window once a layer of every verify step, and the page-copy
               graph, and share and copy pages; a plain engine (batch-1, no
               sharing, K=1) on the same prompts gives the peak pages
               beside the pass's, and its tokens must equal the pass's or
               first differ at a bf16 near-tie of the plain path (top-2 gap
               within 2e-2 + 2e-2 |top-1|) at which the pass's logits for
               the plain path's top-2 tokens each lie within that
               tolerance of the plain path's; printed: both paths' top-2
               logits there, how far the pass's logits moved from the plain
               path's at every position of a shared context, and the plain
               path's top-2 gaps over all its positions.  The same
               decisions run once more in fp32, qwen3-8b at full width cut
               to 2 layers, eager, against the plain engine under the same
               rule at the fp32 tolerance (1e-5 + 1e-5 rel), the top-2
               logits held within it at every shared-context position, so
               a wrong pack, window or page cannot hide in bf16 rounding.
               Prints
               prefill calls, pad rows and pack
               sizes, shared tokens and copies, peak pages, verify calls,
               tokens and accepted tokens a call, decode ms/step, prefill
               tok/s, graphs, capture seconds and peak memory.
               Then paper-30b, the paper's own 30b MHA model (52/52 heads,
               48 layers, d 6656), at full width and depth in bf16, once
               every qwen3-8b engine and weight is freed: the same defaults
               pass (eager, graphed, graphed tokens equal to eager, the
               kernels launched), its plain graphed engine the batch-1
               baseline of decode ms/step and prefill tok/s, the bf16 rule
               against it printed but not enforced (at 48 layers the two
               paths' logits drift apart past the kernels' tolerance), and
               the same decisions in fp32 at 2 layers, enforced; prints the
               peak allocated memory.
  4. parity    a tiny fp32 model served on ``cuda`` and on ``cpu`` from the
               same weights, each case with the reference's defaults
               (mixed traffic, forced 4-way split-KV decode, forced
               preemption, a 4-row pack, a shared two-page head with
               identical prompts, spec_k 2 and 4, and all three features
               under forced preemption): tokens and counters equal across
               the devices, and tokens equal to the same device's batch-1,
               no-sharing, K=1 engine.
  5. tp        this slice's path, tensor parallelism at tp=2, run as two
               rank processes sharing the one card over gloo (NCCL refuses
               two ranks on one device; gloo moves every collective through
               host memory, so the run proves the sharded model, the local
               head counts, the int8 reduce and the ISO issue order on CUDA
               tensors, and measures no overlap).  qwen3-8b at full width,
               its depth cut to 12 of 36 layers (the script's time limit),
               bf16, each rank holding half the weights, serves
               3 greedy requests of 300-1200 prompt tokens (a resumed grant,
               split-KV decode; the reference's default packed grants and
               prefix sharing) under the default batch-split schedule and
               the sequential one, each again with ``quantized_comm``, whose
               runs must launch the int8 reduce's three kernels once each a
               reduce, and B7 alone never; the host time spent inside
               the reduces is recorded, and one reduce is timed alone in the
               sequential and the batch-split issue order; then a tiny fp32
               model at tp=2 must give the tokens of tp=1 on the card under
               all three decode schedules, and granite-moe-3b-a800m at full
               width, 2 layers, fp32, 20 experts a rank, the tokens of the
               tp=1 engine on the same weights on both ranks.
  6. time      each kernel and its plain version at the main path's shapes
               (the decode kernel with its fold, and the walk alone, the
               fold's cost being the difference; also at one tp=2 rank's
               heads and at one request of 8192 tokens; the standalone
               reduce; the int8 kernel at both its decode and its prefill
               shapes; the int8 all-reduce's three kernels, and one
               reduce's local part against the composition of B7
               and PyTorch ops at the decode and prefill shapes; the paged
               prefill at a 512-query chunk and at the serving
               path's 256-query ISO chunk, both over a 1024-token prefix,
               and on a pack of four 128-query rows over prefixes 0, 700,
               1200 and 2000; the decode kernel on a K = 5 verify window;
               B1 at K 1 and 5 and B3 on the ISO chunk at paper-30b's
               52/52 heads; each paged case first held against its plain
               version),
               and where one PyTorch call computes the same function, that
               call (SDPA for the flash-prefill kernel, ``F.rms_norm``);
               then the per-launch floor (a trivial launch through the same
               graph replay) and each row's gap to max(bound, floor); and
               the h100 profile's measured rates (``perf/model.py``): a
               bf16 ``torch.matmul`` at paper-30b's ISO-chunk MLP shape,
               (512, 6656) @ (6656, 17920), and a 2 GiB device-to-device
               copy, beside the constants the profile holds.
  7. ops       the kernel entry point ``repro_torch.kernels.ops`` at
               qwen3-8b's widths in bf16: the ISO composition, a 2048-token
               prompt as two 1024-token chunks, flash(chunk 0) ++
               flash(chunk 1 | prefix) == flash(all 2048), at tp=1's heads
               (32/8, hd 128) and one tp=2 rank's (16/4); ``rms_norm`` at
               (2048, 4096) with an fp32 gamma; ``swiglu`` at (2048, 12288)
               and one rank's (2048, 6144); ``quantize_int8`` at (2048,
               4096).  Each call is held against its plain version; the four
               kernels must have launched.
  8. obs       observability and the measured cost model on qwen3-8b at
               full width and depth, bf16, tp=1, graphed, at the defaults
               pass's settings, run last in phase 3 (its profiler window
               leaves a host cost on later replays): (a)
               ``autotune(smoke=True)``, its table valid, its seconds and
               points printed; (b) the defaults pass with
               ``cost_table="auto"``, which must load the bundled
               ``perf/tables/h100_tp1.json`` with no warning, beside a
               static defaults engine made in this phase: decisions by
               point, verify calls, steps by S, decode ms/step and prefill
               tok/s, the bf16 tokens against the static pass's printed
               (the gate is phase 3's fp32 2-layer pass, where the modeled
               engine must give the static defaults engine's tokens); (c)
               on each graphed timed pass, replaying the trace must give
               the registry's counters and conserve the pool; the auto
               pass's Chrome trace is written under ``build/`` and must
               validate; the host time inside the ring's emit, and decode
               ms/step with the ring on and off in turns, tokens unchanged;
               (d) a short ``obs.torchprof``
               window: one host range named as the reference names it for
               each closure call, device kernels under every decode
               range, the step's ``engine/…`` phase ranges, and no
               device-side copy of a host range.  Phase 5 also holds the two ranks' traces equal once
               timings are removed.
  9. disagg    disaggregated serving, the ladder twin and the overlap probe,
               inside phases 3 and 5 (before the profilers): (a) a
               ``DisaggRouter`` serving the defaults pass's traffic,
               qwen3-8b at full width and depth, bf16, its prefill and
               decode engines sharing the one set of weights (data_ptr
               equal) and both graphed, a capture pass and a timed pass,
               the decode pool 1.5x the largest request so the router
               defers (printed with the deferrals): both pools pass
               ``check()`` and come back whole, B3 launches on the prefill
               engine and B1 on the decode engine (through the replays),
               tokens against the single engine's defaults pass under the
               bf16 near-tie rule, and the same decisions in fp32 at 2
               layers token-EQUAL to the single engine (the gate); printed:
               ``migration_stats()``, the KV bytes moved, the host
               migration_us a transfer and its GB/s, peak memory beside the
               single engine's, decode ms/step and prefill tok/s.  (b)
               ladder-qwen3-8b at full width and depth, bf16, tp=1, on the
               baseline traffic (the qwen3-8b weights, the twin's layout):
               eager, graphed ``ladder`` (capture, timed) and graphed
               ``ladder_seq``; graphed == eager tokens, ``ladder`` ==
               ``ladder_seq`` exactly, every prefill call one chunk, B1 and
               B3 launched; decode ms/step and prefill tok/s beside the
               standard baseline.  (c) ``measure_overlap_efficiency`` on the
               baseline's graphed engine at tp=1 and on phase 5's tp=2
               batch-split gloo engine: its dict printed, then the same
               requests served again with the same tokens and no graph
               captured.  No overlap claim (no collective at tp=1; gloo
               through host memory at tp=2).
 10. dense     the dense-cache ``Engine`` (``serving/engine.py``), bf16,
               full width and depth, each model first on an eager engine
               (``cuda_graphs=False``), then on a graphed one (each prefill
               bucket, the decode step and the verify window one CUDA-graph
               replay): a capture pass, then a timed pass that must capture
               nothing; graphed tokens equal the eager ones on both passes:
               (a) qwen3-8b (max_batch 4, max_len 2048, bucket 64) on phase
               3's six prompts, 32 greedy tokens each; prints prefill tok/s,
               decode ms/step, the dispatch shares, TTFT, the graph count,
               the capture seconds and the peak memory of both engines; (b)
               whisper-medium (24 + 24 layers; max_len 448, the decoder's
               ``n_text_ctx``) on 4 requests with seeded float32 frames of
               (1500, 1024) x 0.1 and prompts of 4-64 tokens; prints the
               encoder's ms a request and the same figures.  Every logits
               row finite, every request complete, and no hand-written
               kernel launched (dense caches attend in plain PyTorch, as
               the reference's in XLA).  The gates, graphed, in fp32 at 2
               (2 + 2) layers: the dense engine's tokens equal a plain
               ``PagedEngine``'s and a spec_k=4 dense engine's; whisper's
               equal the argmax of a teacher-forced prefill over prompt +
               generated.  (c) last of all, a ``torch.profiler`` window on
               each model's graphed engine after a capture pass of the same
               requests: one step that prefills four requests, then four
               decode steps; wall, device busy time, idle share and the
               kernels that took the most device time.
 11. moe       the MoE family, before phase 10 (c): (a) granite-moe-3b-a800m
               (hf:ibm-granite/granite-3.0-1b-a400m-base, 32 layers, 40
               experts top-8, capacity 1.25) at full width and depth, bf16,
               ``PagedEngine`` tp=1: the reference's defaults (packs,
               prefix sharing, spec_k 4) on the defaults pass's prompts,
               then phase 3's baseline on its six prompts, each on an eager
               engine and a graphed one (capture pass, timed pass), graphed
               tokens equal to eager; the timed passes must launch B1 and
               B3 (the defaults one B3 on a pack and B1 on the verify window
               once a layer), no page may leak; prints decode ms/step,
               prefill tok/s, the dispatch shares, peak memory and the
               launch counts.  (b) the same at 2 layers in fp32: graphed ==
               eager on both settings; the defaults pass against the plain
               engine under the fp32 rule on the no-drop twin (capacity
               factor E/k, so no expert overflows: the gate) and, printed
               beside it with the assignments dropped, at 1.25, where the
               capacity makes the function depend on batching.  (c)
               kimi-k2-1t-a32b at full width (64/8 heads at hd 112, 384
               experts and a shared one), 1 of its 61 layers (reduced:
               ~2 TB of bf16 in all), bf16: four prompts of 300-1000
               tokens, 16 new, eager then graphed, equal tokens; peak
               memory printed.  Last in the script, a ``torch.profiler``
               window over three graphed granite decode steps: wall,
               device busy time, idle share and the kernels by name.
 12. recurrent the recurrent families, after phase 11: (a) hymba-1.5b
               (arXiv:2411.13676: 32 ``hybrid`` layers, 25/5 heads at hd
               64, SSM inner 3200 x N 16, window 2048) at full width and
               depth, bf16, ``PagedEngine`` tp=1, on phase 3's six baseline
               prompts and then one 2600-token prompt at max_len 4096
               (B1's and B3's window masks cut on the path), each eager
               then graphed: graphed tokens equal to eager, B1 and B3
               launched (every B3 launch tensor-core), no page leaked;
               prints decode ms/step, prefill tok/s, peak allocated memory,
               the graph count and capture seconds (one closure a distinct
               grant length: a recurrent stack pads, packs, shares and
               speculates nothing), the launches and the dispatch shares.
               (b) xlstm-350m (arXiv:2405.04517: 18 mLSTM and 6 sLSTM
               layers, d 1024) at full width and depth, bf16, the same
               traffic, eager then graphed, equal tokens; it has no
               attention and must launch none of the hand-written kernels.
               (c) fp32 twins at full width (hymba 2 layers with its window
               cut to 64; xlstm one 4-layer period): graphed == eager, and
               ``PagedEngine`` == the graphed dense ``Engine`` (bucket 16)
               token for token on prompt lengths that are multiples of 16 (the
               dense engine's bucket pad would advance the state).  Phase 2
               holds B1 (S 1/4) and B3 (256 and 173 queries) at hymba's
               25/5 hd 64 with windows 0, 2048 and 300; phase 5 serves
               hymba's 2-layer fp32 twin at tp=2 (window 64), whose tokens
               must equal tp=1's on both ranks.  (e) Last in the script, a
               ``torch.profiler`` window over one graphed prefill step of
               four requests and three decode steps of each model: wall,
               device busy time, idle share and the kernels by name.
 13. vlm       the VLM family, after phase 12: (a) internvl2-2b
               (arXiv:2404.16821: 24 layers, d 2048, 16/8 heads at hd 128,
               vocab 92553; the vision encoder stubbed, a request carries
               256 patch embeddings) at full width and depth, bf16,
               ``PagedEngine`` tp=1, on phase 3's six baseline prompts at
               max_len 4096, four of them with 256 seeded patches and two
               text-only (the long one resumes: B3), eager then graphed:
               graphed tokens equal to eager, B1 and B3 launched (every B3
               tensor-core), a patch grant's closure keyed (n_text,
               n_patches, resumed); prints decode ms/step, prefill
               positions/s (patches counted), peak allocated memory, the
               graphs and capture seconds, then a ``torch.profiler`` window
               over one graphed prefill step and three decode steps.  (b)
               the dense ``Engine``, graphed, on the same requests.  (c) the
               fp32 2-layer twin at full width: graphed == eager, and
               ``PagedEngine`` == the dense ``Engine`` token for token.
               Phase 5 serves the twin at tp=2 (patches replicated), whose
               tokens must equal tp=1's on both ranks.
 14. train     the training path (``training/``), after phase 13: (a)
               internvl2-2b bf16 at full width and depth, tp=1 dp=1, remat,
               lr 3e-4 warmup 10, clip 1.0, 20 steps of the synthetic
               batches at 4 x 2048 positions (256 patches a row): every
               loss and gradient norm finite, the last five steps' mean
               loss below the first five's, no hand-written kernel
               launched; prints each step's loss and norm, ms a step and
               positions/s after the first two, peak allocated memory, and
               one more step under ``torch.profiler`` (idle share, kernels
               by name).  (b) the fp32 2-layer twin, 2 steps on the card
               and on the CPU from the same weights (an AdamW update
               between them): loss and norm within rtol 1e-4.  (c) dp=2, two ranks sharing the card over gloo:
               the fp32 twin under plain AdamW and ZeRO-1 (parameters
               within 1e-4 after 3 steps), the bf16 twin under the int8
               gradient mean (the three int8 kernels launched, counted as
               ``launches_train``; both quantize kernels on the split path
               at every launch), then those kernels on the embedding
               gradient's rows against their plain versions (bit-equal,
               the quantize pair split) with their times on rank 0 beside
               their bounds and their plain versions' times.  (d) the fp32 twin at tp=2 (two ranks on
               the card over gloo) against tp=1: equal losses, gradient
               norm twice tp=1's, as the reference's.
 15. runner    ``launch/runner`` and the dense ``Engine`` under TP, after
               phase 14: (a) qwen3-8b bf16 at full width and depth on the
               dense ``Engine`` at tp=2, two ranks sharing the card over
               gloo, phase 3's first three baseline prompts, 32 new each
               with bf16 reduces, then 8 new each with int8 reduces (one
               launch of each int8 reduce kernel a reduce, B7 none; ranks
               agree; decode ms/step, prefill tok/s, peak memory a rank,
               host time inside the reduces); (b) whisper-medium bf16 at
               full width and depth at tp=2, 3 requests (the encoder timed
               alone); (c) the fp32
               2-layer (2 + 2) twins of qwen3-8b, whisper-medium and
               internvl2-2b at tp=2 == tp=1 token for token, and whisper's
               twin trained 2 steps at tp=2 (tp=1's losses, twice its
               gradient norm); (d) ``attn_impl="blockwise"`` (key blocks of
               256) against dense attention on a 2-layer fp32 twin at
               qwen3-8b's widths, one 1024-token prompt, logits within 1e-4;
               (e) the dry run (``launch/dryrun.py``, meta tensors, the
               ``"fake"`` process-group backend) of qwen3-8b decode_32k and
               prefill_32k at 16 x 16: prefill's ISO hideable fraction
               above iso-off's, decode the same program with ISO on and off
               (the reference applies ISO to prefill only), and the
               quantized train_4k cell refused.
 16. disagg tp disaggregated serving under TP, after phase 15: one spawn
               of four ranks sharing the card over gloo, a prefill group
               (ranks 0-1) and a decode group (2-3) of tp=2, phase 3's
               baseline prompts with 16 new tokens each (the first longer
               than the 512-token budget: resumed grants) and a decode pool
               one and a half times the largest request's pages (the router
               defers).  (a) qwen3-8b bf16 at full width, 12 of 36 layers
               (cut, as phase 5's, for the script's time limit): a
               ``DisaggRouter`` across both groups, held under the bf16
               near-tie rule against the mixed tp=2 ``PagedEngine`` that the
               prefill group serves by itself first; every rank's tokens and
               router counters equal; B3 launched on the prefill ranks only
               and B1 on the decode ranks only, no closure of the other
               phase built; prefill tok/s of the prefill group, decode
               ms/step of the decode group, transfers, deferrals,
               bounce-backs, KV bytes moved, host ms a transfer (export +
               send + import), peak allocated a rank.  (b) the 2-layer fp32
               twin at full width: the router's tokens EQUAL the tp=1
               ``PagedEngine``'s on the card; with ``quantized_comm`` (the
               int8 reduce's three kernels on both roles, B7 none) they
               EQUAL the mixed tp=2 engine's with the same reduces, the int8
               reduces changing the numbers (tp=1's are printed beside).
 17. examples  the five ``examples/*_torch.py`` scripts, each loaded by path
               and run in this process through its ``main(argv)`` (a
               ``SystemExit`` or a return value other than 0 is fatal, as
               is a failed assert inside it), fp32 without TF32: (a)
               quickstart and iso_prefill_demo on ``cuda``, their fp32
               exactness asserts (ISO == one chunk within 1e-4); (b)
               serve_batch at its defaults (the tiny preset, the dense
               ``Engine``), then qwen3-4b at full width and depth in bf16
               (``--preset full``: 36 layers, d 2560, 32/8 heads, vocab
               151,936) on the dense ``Engine``, with ``--paged`` (B1 and
               B3 must launch: prompts of 48-95 tokens in two ISO chunks
               under the 64-token budget resume) and with ``--paged
               --iso-off`` (whole-prompt grants, B1 must launch), each
               run's prefill tok/s, decode ms/step and peak allocated
               (above what earlier phases still hold) printed; (c)
               speculative_demo on the graphed dense ``Engine``, its
               stream-identity assert; (d) train_small at
               its defaults with ``--ckpt`` under ``build/``, the
               checkpoint restored into the tiny model's leaves (names,
               shapes, dtypes, finite, moved from the initial weights),
               then qwen3-4b at full width, 3 steps of 4 x 128 (ms a step
               after the first from the launcher's tok/s, peak allocated).
 18. afmoe     the dropless MoE of Trinity-Mini (``bench/configs/
               trinity-mini.json`` through ``bench/port_afmoe.py``), after
               phase 17: (a) the grouped expert kernels
               (``kernels/moe_experts.py``) at its widths, 128 experts of
               2048 -> 1024 -> 2048, top 8, bf16, at 24 rows (the
               trinity-mini.mixed-chat cell's decode call) and 1024 (a full
               grant call), each on the decode pair and the grant pair and
               on one rank of a tp=2 split: within 2e-2 of the largest
               output of ``moe_experts_plain``, the expert counts equal,
               the call counted on the pair it picked, half the batch
               bit-equal to its rows of the whole and a graph replay
               bit-equal to the eager call; then the serving path's two
               calls (decode pair at 24 rows, grant pair at 1024) timed
               beside the plain path, ``torch._grouped_mm`` three times over
               the same sort, and their bound.  (b) Trinity-Mini at full
               width and depth, bf16, ``PagedEngine`` tp=1 at the cell's
               1024-token budget, on four prompts of 300-2600 tokens (past
               the 2048 window; a resumed grant), 16 new each, eager then
               graphed, graphed tokens equal to eager, B1 and B3 launched;
               in the timed pass the decode pair must run once a MoE layer
               of every decode step and the grant pair in whole MoE stacks.

``--phase N`` (repeatable) runs the build and the phases numbered N alone,
e.g. ``python3 chip_smoke.py --phase 18``; the kernel line then holds the
kernels those phases measured.

Every pass resets its engine's registry and trace ring together
(``reset_observability``), so a pass's trace replays into its registry.

Each launch count in the kernel line is read from the run of the path that
launches it, with the counts set to 0 just before: the attention kernels
from phase 3's defaults pass (its timed pass; the baseline pass's counts
are printed; ``decode_reduce``: the decode launches that ran its fold,
``native.VARIANTS["paged_decode/fold"]``; its times are the standalone
kernel's, which runs the same fold code), the int8 reduce's three kernels
from rank 0 of phase 5's quantized batch-split run, the flash-prefill,
RMSNorm, SwiGLU and int8 quantize kernels from phase 7 (the serving path
does not launch them); phase 10's dense path launches none of them (its
passes check that every count stays 0).  Each kernel's ``launches_moe`` is
read the same way from phase 11's granite defaults timed pass, its
``launches_hymba`` and ``launches_xlstm`` from phase 12's baseline timed
passes (xlstm's all 0, checked), its ``launches_vlm`` from phase 13's
graphed timed pass, its ``launches_train`` from rank 0 of phase 14's
int8 run (phase 14 (a) launches none, checked), its
``launches_runner`` from rank 0 of phase 15 (a)'s int8 pass and its
``launches_disagg_tp`` (``{"prefill": n, "decode": n}``) from group rank 0
of each role in phase 16: the attention kernels from (a), the int8
reduce's three from (b)'s quantized router run; its ``launches_examples``
is phase 17's, summed over its runs, each counted from 0.  The grouped
expert kernels' entry (``moe_experts``) is phase 18's: its ``launches``
from (b)'s timed pass (kernel launches, two a call, by pair), its error,
times and bound by call (``decode``, ``grant``) from (a).  It
imports nothing of JAX or of the JAX package.  The last line is
``{"ok": true, "device": {...}}``; the line before it is the card's name and
power limit from nvidia-smi, and before that a JSON line with each kernel's
launches, error, times and bound.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# tolerances of kernel vs plain version (both accumulate in fp32 over the
# same inputs; they differ only in summation order)
TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

SOURCES = {
    "paged_decode": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                     "src/repro/kernels/flash_decode.py:92"),
    "decode_reduce": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                      "src/repro/kernels/flash_decode.py:154"),
    "paged_prefill": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                      "src/repro/kernels/flash_prefill_paged.py:73"),
    "quantize_int8": ("src/repro_torch/kernels/csrc/int8_quant.cu",
                      "src/repro/kernels/int8_quant.py:18"),
    # the int8 all-reduce's local steps (B7 and the XLA ops around it in
    # the reference's quantized_psum)
    "quantize_int8_shards": ("src/repro_torch/kernels/csrc/int8_quant.cu",
                             "src/repro/core/quantized_collectives.py:65"),
    "dequant_sum_quantize_int8": (
        "src/repro_torch/kernels/csrc/int8_quant.cu",
        "src/repro/core/quantized_collectives.py:71"),
    "dequantize_int8_gathered": (
        "src/repro_torch/kernels/csrc/int8_quant.cu",
        "src/repro/core/quantized_collectives.py:78"),
    "flash_prefill": ("src/repro_torch/kernels/csrc/flash_prefill.cu",
                      "src/repro/kernels/flash_prefill.py:27"),
    "rms_norm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                 "src/repro/kernels/rmsnorm.py:11"),
    "swiglu": ("src/repro_torch/kernels/csrc/swiglu.cu",
               "src/repro/kernels/swiglu.py:12"),
}
# operations per element of the int8 quantize: |x|, max, x / s, rint, clamp
QUANT_OPS_PER_ELEMENT = 6
# of RMSNorm: square-add, times rsqrt, times gamma (the row's rsqrt apart)
RMS_OPS_PER_ELEMENT = 4
# of SwiGLU: negate, exp, add, divide, multiply
SWIGLU_OPS_PER_ELEMENT = 5
OPS_KERNELS = ("flash_prefill", "rms_norm", "swiglu")
INT8_REDUCE_KERNELS = ("quantize_int8_shards", "dequant_sum_quantize_int8",
                       "dequantize_int8_gathered")


# the serving path's attention kernels (B2 runs inside paged_decode's
# launches: the paged_decode/fold variant)
ATTENTION_KERNELS = ("paged_decode", "paged_prefill")
# (Hq, Hkv, hd) of the registry that qwen3-8b's 32/8 at hd 128 does not
# cover: group 1 (MHA), group 8, and the MoE configs' group 3 at hd 64 and
# group 8 at hd 112
REGISTRY_LAYOUTS = {"paper-30b": (52, 52, 128),
                    "paper-30b tp=4 rank": (13, 13, 128),
                    "codeqwen1.5-7b": (32, 32, 128),
                    "qwen3-32b, paper-70b": (64, 8, 128),
                    "granite-moe-3b-a800m": (24, 8, 64),
                    "kimi-k2-1t-a32b": (64, 8, 112)}
# hymba-1.5b's (Hq, Hkv, hd): group 5, which no other served layout has;
# its window (2048), none, and one that cuts into every long prefix; and
# decode lengths on both sides of the window
HYMBA_LAYOUT = (25, 5, 64)
HYMBA_WINDOWS = (0, 2048, 300)
HYMBA_LENGTHS = [1, 17, 1000, 2047, 2048, 2049, 2600, 3000]
# paper-30b's ISO-chunk MLP GEMM, (512, 6656) @ (6656, 17920): the shape
# that sets the h100 profile's matmul rate in perf/model.py
PROFILE_GEMM = (512, 6656, 17920)
# the device-to-device copy that sets its memory rate: 2 GiB of bf16
PROFILE_COPY_ELEMS = 1 << 30


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, replays: int = 7) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in a CUDA
    graph, the graph replayed between CUDA events, the median over
    ``replays`` replays divided by ``reps``.  Replaying a graph keeps the
    wrappers' host work (checks, allocation, ctypes) out of the measured
    time, which for the small reduce kernel is longer than the kernel."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    times.sort()
    return times[len(times) // 2]


def call_ms(fn, iters: int = 20) -> float:
    """Median per-call time between CUDA events around one eager call,
    host work of the wrapper included."""
    import torch
    fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def make_pool(gen, lengths, ps, hkv, hd, dtype, mb=0):
    """Random pool holding lengths[b] tokens per row (whole pages filled:
    keys past a row's length are poison the masks must hide) and its block
    tables of width ``mb`` (default: one page more than the longest row),
    in shuffled page order."""
    import torch
    B = len(lengths)
    mb = mb or -(-max(max(lengths), 1) // ps) + 1
    n_pages = sum(-(-L // ps) for L in lengths) + 3
    k = torch.randn((n_pages + 1, ps, hkv, hd), generator=gen,
                    device="cuda").to(dtype)
    v = torch.randn((n_pages + 1, ps, hkv, hd), generator=gen,
                    device="cuda").to(dtype)
    perm = torch.randperm(n_pages, generator=gen, device="cuda").tolist()
    bt = torch.full((B, mb), -1, dtype=torch.int32)
    for b, L in enumerate(lengths):
        for blk in range(-(-L // ps)):
            bt[b, blk] = perm.pop()
    return k, v, bt.cuda(), torch.tensor(lengths, dtype=torch.int32,
                                         device="cuda")


def max_err(got, want, tol) -> float:
    """Max |got - want|; raises if any element is outside atol + rtol*|want|
    or not finite."""
    import torch
    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        if not torch.isfinite(g).all():
            raise AssertionError("kernel output not finite")
        d = (g - w).abs()
        bad = d > tol["atol"] + tol["rtol"] * w.abs()
        if bad.any():
            raise AssertionError(f"{int(bad.sum())} elements out of "
                                 f"tolerance {tol}; max err {float(d.max())}")
        err = max(err, float(d.max()))
    return err


def decode_case(gen, errs, lengths, ps, hq, hkv, hd, K, S, window,
                dtype_name, mb=0) -> int:
    """B1 (and B2 at S > 1) against the plain versions on one random pool:
    the span partials within ``TOL``, the dead-page skip bit-identical to the
    full walk, every span partial of a row with no key in its span (past the
    row's length, or wholly outside the window) exactly neutral (0, NEG_INF,
    0), and the whole wrapper against the plain pipeline.  Returns how many
    such neutral (request, span, row) partials the case held."""
    import torch
    from repro_torch.kernels import flash_decode as fd
    dtype = getattr(torch, dtype_name)
    k, v, bt, lens = make_pool(gen, lengths, ps, hkv, hd, dtype, mb)
    B = len(lengths)
    q = torch.randn((B, K, hq, hd), generator=gen, device="cuda").to(dtype)
    group = hq // hkv
    gk = group * K
    qg = q.reshape(B, K, hkv, group, hd).permute(0, 2, 3, 1, 4).reshape(
        B, hkv, gk, hd)
    S = max(1, min(S, bt.shape[1]))
    got = fd.decode_partials(qg, k, v, bt, lens, k_tokens=K, window=window,
                             kv_splits=S)
    want = fd.decode_partials_plain(qg, k, v, bt, lens, k_tokens=K,
                                    window=window, kv_splits=S)
    tol = TOL[dtype_name]
    errs["paged_decode"] = max(errs["paged_decode"], max_err(got, want, tol))
    walked = fd.decode_partials(qg, k, v, bt, lens, k_tokens=K,
                                window=window, kv_splits=S,
                                guard_dead_pages=False)
    for a, b in zip(got, walked):
        if not torch.equal(a, b):
            raise AssertionError("dead-page skip is not bit-identical")
    # span s holds key positions [s * L, (s + 1) * L), L = pps * ps
    L = -(-bt.shape[1] // S) * ps
    pos = torch.arange(S * L, device="cuda").reshape(1, S, 1, L)
    ln = lens.long().reshape(B, 1, 1, 1)
    ok = pos < ln
    if window:
        qi = (torch.arange(gk, device="cuda") % K).reshape(1, 1, gk, 1)
        ok = ok & (pos > ln + qi - window)
    empty = (~ok.any(-1)).expand(B, S, gk)[:, None].expand(
        -1, hkv, -1, -1)                                      # (B,Hkv,S,gk)
    o, m, l = (t[empty] for t in got)
    if bool((o != 0).any()) or bool((l != 0).any()) or \
            bool((m != fd.NEG_INF).any()):
        raise AssertionError("a span partial with no key is not neutral")
    if S > 1:
        red = fd.decode_reduce(*got)
        red_plain = fd.decode_reduce_plain(*got)
        errs["decode_reduce"] = max(errs["decode_reduce"],
                                    max_err(red, red_plain, TOL["float32"]))
        # the fold inside the decode launch: the standalone reduce's bits,
        # whichever block of a tile arrived last
        folded = fd.decode_folded(qg, k, v, bt, lens, k_tokens=K,
                                  window=window, kv_splits=S)
        for a, b in zip(folded, red):
            if not torch.equal(a, b):
                raise AssertionError(
                    f"the fold in the decode launch differs from the "
                    f"standalone reduce (gk {gk}, S {S}, {dtype_name})")
    # the whole wrapper (the fold included) against the plain pipeline
    o = fd.flash_decode(q, k, v, bt, lens, window=window, kv_splits=S)
    po, pm, pl = fd.decode_partials_plain(qg, k, v, bt, lens, k_tokens=K,
                                          window=window, kv_splits=S)
    if S > 1:
        po, pm, pl = fd.decode_reduce_plain(po, pm, pl)
    else:
        po, pm, pl = po[:, :, 0], pm[:, :, 0], pl[:, :, 0]
    unrow = lambda t, last: t.reshape(B, hkv, group, K, last).permute(
        0, 3, 1, 2, 4).reshape(B, K, hq, last)
    max_err(o, (unrow(po, hd), unrow(pm, 1), unrow(pl, 1)), tol)
    return int(empty.sum()) // hkv


def check_decode_edges(gen, errs) -> tuple:
    """B1's edges, bf16 and fp32: head dims 64 and 256, 80 (six idle lanes
    of sixteen per key), 20 (bf16: the synchronous loads; fp32: a lane's
    second 16-byte piece past hd) and 18 (rows off the 16-byte grid: the
    synchronous loads in both); page sizes 32 and 64; query rows 1, 12 (a
    ragged 4-row tile), 32, and 33, 40, 48 and 64 (past the 8 row tiles the
    kernel took until the limit was lifted), one of them on clustered grids;
    one request of 8192 tokens (MB 512) at S = 1 and S = 4 (clusters of
    blocks a span); a batch in which every span of one row is dead; a batch
    whose lengths are all 0.  At S > 1 every case also holds the fold inside
    the decode launch bit-equal to the standalone reduce.  Returns (cases,
    neutral span partials held)."""
    n = neutral = 0
    short = [1, 15, 16, 17, 100, 300, 0]
    for dtype_name in ("bfloat16", "float32"):
        cases = []
        for hd in (64, 80, 256, 20, 18):
            cases += [(short, 16, 8, 2, hd, 1, 4, 0),
                      (short, 16, 8, 2, hd, 2, 1, 37)]
        for ps in (32, 64):
            for S, window in ((1, 0), (4, 100)):
                cases.append(([1, 31, 32, 33, 500, 2047, 0], ps, 32, 8, 128,
                               1, S, window))
        # gk 1, 12, 32, then 33 (group 11, K 3), 40 (group 8, K 5: a
        # group-8 model's spec_k = 4 window), 48 and 64
        for hq, hkv, K, S, window in ((2, 2, 1, 4, 0), (8, 2, 3, 2, 20),
                                      (16, 2, 4, 2, 12), (16, 2, 4, 1, 0),
                                      (22, 2, 3, 4, 0), (16, 2, 5, 4, 30),
                                      (24, 2, 4, 1, 0), (32, 2, 4, 7, 0)):
            cases.append(([3, 17, 64, 130, 0], 16, hq, hkv, 128, K, S,
                          window))
        # 40 rows on short grids (clusters of blocks a span): one request
        # of 3000 tokens at S 2 and 4
        for S in (2, 4):
            cases.append(([3000], 16, 16, 2, 128, 5, S, 0))
        for S in (1, 4):
            cases.append(([8192], 16, 32, 8, 128, 1, S, 0, 512))
        cases += [([700, 0, 2030], 16, 32, 8, 128, 1, 4, 0),
                  ([5, 2000], 16, 32, 8, 128, 1, 4, 0),
                  ([0, 0, 0], 16, 32, 8, 128, 1, 4, 0),
                  ([0, 0], 16, 32, 8, 128, 1, 1, 100)]
        for case in cases:
            lengths, ps, hq, hkv, hd, K, S, window = case[:8]
            neutral += decode_case(gen, errs, lengths, ps, hq, hkv, hd, K, S,
                                   window, dtype_name, *case[8:])
            n += 1
    return n, neutral


def check_kernels(report):
    import torch
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill_paged as fp
    from repro_torch.kernels import native
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {"paged_decode": 0.0, "decode_reduce": 0.0, "paged_prefill": 0.0}

    def prefill_case(prefix_lens, offsets, Sq, ps, hq, hkv, hd, window,
                     dtype_name):
        """Returns how many rows of a resumed request (prefix > 0) the
        window left with no key: those, and every fresh row (prefix 0),
        must come back exactly neutral (0, NEG_INF, 0)."""
        dtype = getattr(torch, dtype_name)
        k, v, bt, lens = make_pool(gen, prefix_lens, ps, hkv, hd, dtype)
        q = torch.randn((len(prefix_lens), hq, Sq, hd), generator=gen,
                        device="cuda").to(dtype)
        qs = lens + torch.tensor(offsets, dtype=torch.int32, device="cuda")
        got = fp.flash_prefill_paged(q, k, v, bt, lens, qs, window=window)
        want = fp.prefill_partial_plain(q, k, v, bt, lens, qs, window=window)
        errs["paged_prefill"] = max(errs["paged_prefill"],
                                    max_err(got, want, TOL[dtype_name]))
        # row i of request b attends no key iff its prefix is empty or the
        # window ends before it: q_start + i - window >= prefix_len - 1
        pos = qs.long()[:, None] + torch.arange(Sq, device="cuda")[None]
        empty = (lens.long()[:, None] == 0).expand(-1, Sq)
        if window:
            empty = empty | (pos - window >= lens.long()[:, None] - 1)
        o, m, l = (t[empty[:, None, :].expand(-1, hq, -1)] for t in got)
        if bool((o != 0).any()) or bool((l != 0).any()) or \
                bool((m != fd.NEG_INF).any()):
            raise AssertionError("a row with no key (fresh, or wholly "
                                 "outside the window) is not neutral")
        return int((empty & (lens.long()[:, None] > 0)).sum())

    main_lengths = [1, 15, 16, 17, 255, 256, 257, 1000, 2047, 2048]
    n = 0
    for dtype_name in ("bfloat16", "float32"):
        # (Hq, Hkv): qwen3-8b at tp=1, and one rank's heads at tp=2; K 1
        # and 5, the spec_k=4 verify window of phase 3's defaults pass
        # (gk 20 at 32/8, the shape of its B1 launches)
        for hq, hkv in ((32, 8), (16, 4)):
            for K in (1, 5):
                for S in (1, 4):
                    for window in (0, 100):
                        decode_case(gen, errs, main_lengths, 16, hq, hkv,
                                    128, K, S, window, dtype_name)
                        n += 1
        for K, S, window in ((1, 1, 0), (2, 4, 12), (4, 2, 0)):
            decode_case(gen, errs, [1, 7, 8, 9, 22, 37, 0], 8, 4, 2, 16, K,
                        S, window, dtype_name)
            n += 1
        for window in (0, 100):
            # a 512-token grant at tp=1; one rank's 256-token ISO chunk
            # of a grant at tp=2
            for Sq, hq, hkv in ((512, 32, 8), (256, 16, 4)):
                prefill_case([0, 700, 2000], [0, 0, 256], Sq, 16, hq, hkv,
                             128, window, dtype_name)
                n += 1
        for window in (0, 5):
            prefill_case([0, 11, 24, 15], [0, 3, 0, 5], 10, 8, 4, 2, 16,
                         window, dtype_name)
            n += 1
    # the dense registry's head layouts: B1 at K 1 and 5, S 1 and 4, and
    # B3 on the 256-query ISO chunk beside fresh and resumed rows
    n_layout = 0
    for dtype_name in ("bfloat16", "float32"):
        for hq, hkv, hd in REGISTRY_LAYOUTS.values():
            for K in (1, 5):
                for S in (1, 4):
                    decode_case(gen, errs, main_lengths, 16, hq, hkv, hd, K,
                                S, 0, dtype_name)
                    n_layout += 1
            prefill_case([0, 700, 2000], [0, 0, 256], 256, 16, hq, hkv, hd,
                         0, dtype_name)
            n_layout += 1
    # hymba-1.5b's 25/5 heads at hd 64 (group 5: B1's 5 query rows a kv
    # head, B3's 12 query rows a group member, 60 rows a block) with window
    # 0, its own 2048 and 300 (which cuts into every long prefix), B3 on
    # the unbucketed chunk lengths a recurrent stack serves (256 and 173
    # queries, a fresh row beside resumed ones past the window)
    n_hymba = 0
    for dtype_name in ("bfloat16", "float32"):
        for window in HYMBA_WINDOWS:
            for S in (1, 4):
                decode_case(gen, errs, HYMBA_LENGTHS, 16, *HYMBA_LAYOUT, 1,
                            S, window, dtype_name)
                n_hymba += 1
            for Sq in (256, 173):
                prefill_case([0, 700, 2600, 3000], [0, 0, 256, 37], Sq, 16,
                             *HYMBA_LAYOUT, window, dtype_name)
                n_hymba += 1
    # the bf16 tile loop's edges: hd 64/80/256 (a padded width at 80), page
    # sizes 8/16/32 (a 64-key tile from 8/4/2 pages), group 1/2/4/8 (64/32/
    # 16/8 query rows per head), Sq 100 (a ragged last query block),
    # prefixes that are not multiples of 64, a fresh row; then a window that
    # leaves rows of resumed requests with no key, group 80 (80 rows: two
    # row blocks), and hd 20 (the synchronous loads past cp.async)
    n_tc = 0
    for hd in (64, 80, 256):
        for ps in (8, 16, 32):
            for group in (1, 2, 4, 8):
                prefill_case([0, 37, 130, 200], [0, 3, 0, 50], 100, ps,
                             2 * group, 2, hd, 0, "bfloat16")
                n_tc += 1
    emptied = 0
    for hd, ps, group in ((128, 16, 4), (80, 8, 1), (64, 32, 8)):
        emptied += prefill_case([0, 37, 130, 200], [0, 3, 0, 50], 100, ps,
                                2 * group, 2, hd, 20, "bfloat16")
        n_tc += 1
    if emptied <= 0:
        raise AssertionError("no windowed row of a resumed request was left "
                             "with no key")
    prefill_case([0, 70, 129], [0, 0, 7], 10, 16, 80, 1, 64, 0, "bfloat16")
    prefill_case([0, 70, 129], [0, 0, 7], 37, 16, 8, 2, 20, 9, "bfloat16")
    n_tc += 2
    n_dec, neutral = check_decode_edges(gen, errs)
    torch.cuda.synchronize()
    log(f"[kernels] {n + n_layout + n_hymba + n_tc + n_dec} cases within "
        f"tolerance {TOL} ({n_layout} of them at the registry's head layouts "
        f"{REGISTRY_LAYOUTS} (Hq, Hkv, hd), B1 at K 1/5 and S 1/4 and B3 "
        f"on the 256-query ISO chunk, bf16 and fp32; {n_hymba} at "
        f"hymba-1.5b's {HYMBA_LAYOUT}, windows {HYMBA_WINDOWS}, B1 at S 1/4 "
        f"over lengths {HYMBA_LENGTHS}, B3 on 256- and 173-query chunks; "
        f"{n_tc} "
        f"of them the bf16 tile loop's edges: {emptied} rows of resumed "
        f"requests wholly outside the window, neutral; {n_dec} the decode "
        f"kernel's edges: hd 64/80/256/20/18, ps 32/64, gk 1/12/32/33/40/"
        f"48/64, 8192 and 3000 tokens on clustered grids, dead rows, all "
        f"lengths 0, {neutral} span partials with no key, neutral); "
        f"dead-page skip bit-identical; at S > 1 the fold in the decode "
        f"launch bit-equal to the standalone reduce; max abs err {errs}")
    check_fold_arrivals(gen)
    errs["quantize_int8"] = check_quantize(gen)
    errs.update(check_int8_reduce(gen))
    errs.update(check_ops_kernels(gen))
    report["errs"] = errs


def check_quantize(gen) -> float:
    """The int8 kernel against its plain version: q and scale must be equal
    (``torch.equal``), so the max abs error reported is 0."""
    import torch
    from repro_torch.kernels import int8_quant as q8
    from repro_torch.kernels import native
    n = 0
    split0 = native.VARIANTS["quantize_int8/split"]
    for dtype in (torch.bfloat16, torch.float32):
        # 2^21 + 8: a long row, split over blocks (no path launches B7 so)
        for d in (64, 96, 100, 256, 1024, 2048, 2056, 4096, 2 ** 21 + 8):
            for rows in (1, 37):
                x = (torch.randn((rows, d), generator=gen, device="cuda")
                     * 5).to(dtype)
                x[0] = 0                                 # floor scale
                # an element offset: no 16-byte loads, the scalar path
                shifted = torch.cat([x.reshape(-1), x.reshape(-1)[:1]])[1:]
                for xx in (x, shifted.view(rows, d)):
                    got = q8.quantize_int8(xx)
                    want = q8.quantize_int8_plain(xx)
                    for g, w in zip(got, want):
                        if not torch.equal(g, w):
                            raise AssertionError(
                                f"quantize_int8 {dtype} rows={rows} d={d}: "
                                f"kernel differs from the plain version")
                    n += 1
    ties = torch.zeros((3, 8), device="cuda")
    ties[0] = torch.tensor([127, 2.5, 3.5, -0.5, -1.5, 0.5, -126.5, 126.5])
    for dtype in (torch.bfloat16, torch.float32):
        q, s = q8.quantize_int8(ties.to(dtype))
        qp, sp = q8.quantize_int8_plain(ties.to(dtype))
        if not (torch.equal(q, qp) and torch.equal(s, sp)) or \
                q[0].tolist() != [127, 2, 4, 0, -2, 0, -126, 126]:
            raise AssertionError(f"quantize_int8 ties: {q[0].tolist()}")
        n += 1
    torch.cuda.synchronize()
    split = native.VARIANTS["quantize_int8/split"] - split0
    if split != 8:
        raise AssertionError(f"quantize_int8: {split} of the 8 calls on rows "
                             f"of 2^21 + 8 took the split path")
    log(f"[kernels] quantize_int8: {n} cases bit-equal to the plain version "
        f"(bf16/fp32, d 64..4096 and 2^21 + 8 (split over blocks, {split} "
        f"calls), vector and scalar paths, zero row, .5 ties round half to "
        f"even)")
    return 0.0


def check_fold_arrivals(gen) -> None:
    """The fold's arrival counters are back at 0 after three launches in a
    row on the stream (no wait between them) and after the replays of a
    CUDA graph that captured three more, and every launch gives the same
    bits: the counter of a tile is reset by the block that folds it."""
    import torch
    from repro_torch.kernels import flash_decode as fd
    k, v, bt, lens = make_pool(gen, [700, 1200, 1700, 2030], 16, 8, 128,
                               torch.bfloat16, mb=128)
    qg = torch.randn((4, 8, 40, 128), generator=gen, device="cuda").to(
        torch.bfloat16)
    run = lambda: fd.decode_folded(qg, k, v, bt, lens, k_tokens=5, window=0,
                                   kv_splits=4)
    want = run()
    outs = [run() for _ in range(3)]
    torch.cuda.synchronize()
    counters = fd._ARRIVALS[qg.device]
    if int(counters.abs().sum()) != 0:
        raise AssertionError("fold arrival counters not 0 after three "
                             "launches in a row")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = [run() for _ in range(3)]
    for _ in range(2):
        graph.replay()
    torch.cuda.synchronize()
    if int(fd._ARRIVALS[qg.device].abs().sum()) != 0:
        raise AssertionError("fold arrival counters not 0 after a CUDA-graph "
                             "replay")
    for got in outs + captured:
        for a, b in zip(got, want):
            if not torch.equal(a, b):
                raise AssertionError("a repeated fused decode launch gave "
                                     "other bits")
    log(f"[kernels] fold arrivals: {counters.numel()} counters at 0 after 3 "
        f"launches in a row and after 2 replays of a graph of 3 (gk 40, S 4, "
        f"32 tiles a launch); every launch the same bits")


def check_int8_reduce(gen) -> dict:
    """The int8 all-reduce's three kernels against their plain versions,
    EQUAL (``torch.equal``): the shards quantize over bf16/fp32 rows at tp
    2 and 4 (vector and scalar paths), the rank sum and re-quantize over
    random exchanges at tp 2 and 4 (d 2048, 256, 18, and an unaligned
    base), the gathered dequantize into bf16 and fp32.  Returns each one's
    max abs error (0)."""
    import torch
    from repro_torch.kernels import int8_quant as q8
    n = 0

    def equal(name, got, want):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            if g.shape != w.shape or not torch.equal(g, w):
                raise AssertionError(f"{name}: kernel differs from the plain "
                                     f"version at {tuple(w.shape)}")

    for tp in (2, 4):
        for dtype in (torch.bfloat16, torch.float32):
            for shape in ((4, 4096), (512, 4096), (2, 1, 4096), (3, 72),
                          (5, 4 * 18)):
                x = (torch.randn(shape, generator=gen, device="cuda")
                     * 5).to(dtype)
                x.reshape(-1, shape[-1])[0] = 0          # floor scales
                equal("quantize_int8_shards", q8.quantize_int8_shards(x, tp),
                      q8.quantize_int8_shards_plain(x, tp))
                n += 1
        for R, d in ((4, 2048), (512, 2048), (3, 256), (5, 18)):
            q = torch.randint(-127, 128, (tp, R, d), generator=gen,
                              device="cuda").to(torch.int8)
            s = torch.rand((tp, R, 1), generator=gen, device="cuda") + 1e-3
            q[:, 0] = 0                                   # an all-zero sum
            flat = torch.empty(q.numel() + 1, dtype=torch.int8,
                               device="cuda")
            flat[1:] = q.reshape(-1)
            shifted = flat[1:].view(q.shape)              # the scalar path
            for qq in (q, shifted):
                equal("dequant_sum_quantize_int8",
                      q8.dequant_sum_quantize_int8(qq, s),
                      q8.dequant_sum_quantize_int8_plain(qq, s))
                for dtype in (torch.bfloat16, torch.float32):
                    equal("dequantize_int8_gathered",
                          q8.dequantize_int8_gathered(qq, s, dtype),
                          q8.dequantize_int8_gathered_plain(qq, s, dtype))
                n += 3
    n_long = check_int8_reduce_long(gen, equal)
    torch.cuda.synchronize()
    log(f"[kernels] int8 reduce: quantize_int8_shards, "
        f"dequant_sum_quantize_int8, dequantize_int8_gathered: {n} cases "
        f"bit-equal to their plain versions (tp 2 and 4, bf16/fp32, vector "
        f"and scalar paths, zero rows), and {n_long} on long rows split over "
        f"blocks")
    return {k: 0.0 for k in INT8_REDUCE_KERNELS}


# a flattened row of at least 2^24 elements whose shards at tp 2 and 4 are
# whole vectors but not whole segments (native.row_plan)
INT8_LONG_ROW = 2 ** 24 + 4 * 8 * 37


def check_int8_reduce_long(gen, equal) -> int:
    """The int8 reduce's two quantize kernels on long rows, which their
    launch plan splits over many blocks, EQUAL to their plain versions:
    ``quantize_int8_shards`` at tp 2 and 4, bf16 and fp32, on a row of
    ``INT8_LONG_ROW`` (shard 0's abs-max in its ragged last segment, shard
    1 all zeros for the floor scale), at a 16-byte base and one element
    past it (the scalar path); ``dequant_sum_quantize_int8`` on a (tp, 1,
    d) exchange with its largest rank sum in the last segment, both paths.
    Each call must count under its ``/split`` variant.  Returns the cases
    checked."""
    import torch
    from repro_torch.kernels import int8_quant as q8
    from repro_torch.kernels import native

    def shifted(t):
        """t's values one element past its base: the scalar path."""
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device="cuda")
        flat[1:] = t.reshape(-1)
        return flat[1:].view(t.shape)

    def split_call(name, got, want):
        before = native.VARIANTS[f"{name}/split"]
        equal(name, got(), want)
        if native.VARIANTS[f"{name}/split"] != before + 1:
            raise AssertionError(f"{name}: a long row did not take the "
                                 f"split path")

    def tail_of(rows, d, elem, vec_bytes=16):
        """Where a split row's last (ragged) segment starts."""
        plan = native.row_plan(rows, d, elem, True, vec_bytes)
        if plan.mode != "split" or d % plan.seg_len == 0:
            raise AssertionError(f"long-row plan {plan} at d={d}")
        return (plan.segments - 1) * plan.seg_len

    n = 0
    for tp in (2, 4):
        d = INT8_LONG_ROW // tp
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn(INT8_LONG_ROW, generator=gen, device="cuda")
                 * 5).to(dtype)
            tail = tail_of(tp, d, x.element_size())
            x[tail + (d - tail) // 2] = -100.0       # shard 0's abs-max
            x[d:2 * d] = 0                             # shard 1: floor scale
            for xx in (x, shifted(x)):
                split_call("quantize_int8_shards",
                           lambda: q8.quantize_int8_shards(xx, tp),
                           q8.quantize_int8_shards_plain(xx, tp))
                n += 1
        q = torch.randint(-126, 127, (tp, 1, d), generator=gen,
                          device="cuda").to(torch.int8)
        s = torch.rand((tp, 1, 1), generator=gen, device="cuda") + 1e-3
        if d - 5 < tail_of(1, d, 1, vec_bytes=8):
            raise AssertionError("the planted rank sum is not in the last "
                                 "segment")
        q[:, 0, d - 5] = 127                           # the largest sum
        for qq in (q, shifted(q)):
            split_call("dequant_sum_quantize_int8",
                       lambda: q8.dequant_sum_quantize_int8(qq, s),
                       q8.dequant_sum_quantize_int8_plain(qq, s))
            n += 1
    return n


def check_ops_kernels(gen) -> dict:
    """The flash-prefill, RMSNorm and SwiGLU kernels against their plain
    versions; returns each one's max abs error."""
    import torch
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import rmsnorm, swiglu
    errs = {k: 0.0 for k in OPS_KERNELS}
    n = 0

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def shifted(x):
        """x's values one element past a 16-byte boundary: the scalar path."""
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")
        flat[1:] = x.reshape(-1)
        return flat[1:].view(x.shape)

    def flash_case(B, hq, hkv, Sq, Sk, hd, dtype, q_start, causal=True,
                   window=0, empty_from=None):
        q, k, v = (randn(s, dtype) for s in ((B, hq, Sq, hd), (B, hkv, Sk, hd),
                                              (B, hkv, Sk, hd)))
        got = fp.flash_attention(q, k, v, q_start=q_start, causal=causal,
                                 window=window)
        want = fp.flash_attention_plain(q, k, v, q_start=q_start,
                                        causal=causal, window=window)
        if got.dtype != dtype:
            raise AssertionError(f"flash_attention returned {got.dtype}")
        errs["flash_prefill"] = max(errs["flash_prefill"], max_err(
            [got.float()], [want.float()], TOL[str(dtype)[6:]]))
        if empty_from is not None and \
                float(got[:, :, empty_from:].abs().max()) != 0.0:
            raise AssertionError("flash_attention: a row with no key is not 0")

    for dtype in (torch.bfloat16, torch.float32):
        # the CPU tests' shapes: MHA, GQA with a prefix, MQA ragged
        for B, hq, hkv, Sq, Sk, hd in ((1, 2, 2, 16, 16, 32),
                                       (2, 4, 2, 48, 80, 64),
                                       (1, 8, 1, 33, 70, 128)):
            flash_case(B, hq, hkv, Sq, Sk, hd, dtype, Sk - Sq)
            n += 1
        for window, causal in ((8, True), (24, True), (24, False),
                               (0, False)):
            flash_case(1, 2, 2, 32, 64, 32, dtype, 32, causal, window)
            n += 1
        # rows 3.. of 8 attend no key (q_start + i >= Sk - 1 + window)
        flash_case(1, 4, 2, 8, 16, 16, dtype, 16, window=4, empty_from=3)
        # full width, tp=1 and one tp=2 rank: the second ISO chunk, the
        # whole prompt, ragged lengths with a window; head_dim limits
        for hq, hkv in ((32, 8), (16, 4)):
            flash_case(1, hq, hkv, 1024, 2048, 128, dtype, 1024)
            flash_case(1, hq, hkv, 2048, 2048, 128, dtype, 0)
            flash_case(2, hq, hkv, 1000, 1500, 128, dtype, 500, window=256)
            n += 3
        for hd in (80, 200, 256):
            flash_case(1, 4, 2, 100, 130, hd, dtype, 30)
            n += 1
        # hd 20: rows of no whole 16-byte chunk, the synchronous loads
        flash_case(2, 4, 2, 70, 90, 20, dtype, 20, window=33)
        n += 1

        for shape, gdt in (((5, 128), torch.float32),
                           ((2, 33, 256), torch.float32),
                           ((2048, 4096), torch.float32),
                           ((2048, 4096), torch.bfloat16),
                           ((3, 100), torch.bfloat16),
                           ((37, 4104), torch.float32)):
            x = randn(shape, dtype)
            gamma = randn(shape[-1:], gdt)
            for xx in (x, shifted(x)):
                got = rmsnorm.rms_norm(xx, gamma)
                want = rmsnorm.rms_norm_plain(xx, gamma)
                errs["rms_norm"] = max(errs["rms_norm"], max_err(
                    [got.float()], [want.float()], TOL[str(dtype)[6:]]))
                n += 1
        for shape in ((4, 512), (2, 17, 300), (2048, 12288), (2048, 6144),
                      (3, 77)):
            g, u = randn(shape, dtype), randn(shape, dtype)
            for gg, uu in ((g, u), (shifted(g), u)):
                got = swiglu.swiglu(gg, uu)
                want = swiglu.swiglu_plain(gg, uu)
                errs["swiglu"] = max(errs["swiglu"], max_err(
                    [got.float()], [want.float()], TOL[str(dtype)[6:]]))
                n += 1
    torch.cuda.synchronize()
    log(f"[kernels] flash_prefill / rms_norm / swiglu: {n} cases within "
        f"tolerance of their plain versions (bf16/fp32; full width and the "
        f"CPU tests' shapes; rows with no key 0; scalar paths); max abs err "
        f"{errs}")
    return errs


def time_kernels(report):
    """Time each kernel and its plain version at the shapes its path gives
    it: decode B=4 rows of 700/1200/1700/2030 resident tokens (MB=128) with
    S=4 spans, as the engine splits walks past 16 pages, folded in the
    launch as the serving path runs it (and at one tp=2 rank's heads, and
    one request of 8192 tokens, MB=512), and the walk alone into its span
    partials; the standalone reduce of those partials; a 512-token resumed
    chunk over a 1024-token prefix, and the serving path's 256-token ISO
    chunk over it; the int8 quantize at the tp=2 decode and prefill reduce
    shapes; the int8 all-reduce's three kernels, and its local part against
    B7 composed with PyTorch ops; the ops path's flash prefill, RMSNorm and
    SwiGLU (phase 7), each beside the one PyTorch call that computes the
    same function where there is one.  Then the per-launch floor, each
    row's gap to its bound and to max(bound, floor), what the fold adds to
    the decode launch, and the int8 reduce's local time against B7's with
    PyTorch ops."""
    import torch
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill_paged as fp
    gen = torch.Generator(device="cuda").manual_seed(1)
    dt = torch.bfloat16
    ps, hq, hkv, hd, S = 16, 32, 8, 128, 4
    paged = "no single PyTorch call computes paged attention over block tables"
    dec, dec_spans, (parts, red_bytes, red_ops, red_shape) = \
        decode_timing_case(gen, [700, 1200, 1700, 2030], hq, hkv, S, 128,
                           paged)
    red = lambda: fd.decode_reduce(*parts)
    red_plain = lambda: fd.decode_reduce_plain(*parts)
    prefix = 1024
    pools = {}

    def p_case(Sq, q_off, what, hq=hq, hkv=hkv):
        if hkv not in pools:
            pools[hkv] = make_pool(gen, [prefix], ps, hkv, hd, dt, mb=128)
        pk, pv, pbt, plens = pools[hkv]
        q = torch.randn((1, hq, Sq, hd), generator=gen, device="cuda").to(dt)
        qs = plens + q_off
        nbytes = (q.numel() * 2 + pbt.numel() * 4 + 8
                  + 2 * prefix * hkv * hd * 2 + hq * Sq * (hd + 2) * 4)
        return (lambda: fp.flash_prefill_paged(q, pk, pv, pbt, plens, qs),
                lambda: fp.prefill_partial_plain(q, pk, pv, pbt, plens, qs),
                nbytes, 4 * Sq * prefix * hq * hd, "bfloat16",
                f"B=1 Sq={Sq} prefix={prefix} Hq={hq} Hkv={hkv} hd={hd} "
                f"ps={ps} MB=128 bf16 ({what})", paged)

    # the int8 reduces of qwen3-8b at tp=2 (d = 4096 in 2 shards of 2048):
    # a decode half of 2 requests, (2, 1, 4096) bf16 -> (4, 2048) rows,
    # and its fp32 re-quantize, (2, 2048); a 256-token ISO chunk,
    # (1, 256, 4096) -> (512, 2048) bf16, and its (256, 2048) re-quantize
    from repro_torch.kernels import int8_quant as q8
    xq = {"decode": torch.randn((4, 2048), generator=gen,
                                device="cuda").to(dt),
          "decode_requant": torch.randn((2, 2048), generator=gen,
                                        device="cuda"),
          "prefill": torch.randn((512, 2048), generator=gen,
                                 device="cuda").to(dt),
          "prefill_requant": torch.randn((256, 2048), generator=gen,
                                         device="cuda")}

    def q_bytes(x):
        return x.numel() * x.element_size() + x.numel() + x.shape[0] * 4

    def q_case(key, what):
        x = xq[key]
        return (lambda: q8.quantize_int8(x), lambda: q8.quantize_int8_plain(x),
                q_bytes(x), QUANT_OPS_PER_ELEMENT * x.numel(), "float32",
                f"rows={x.shape[0]} d={x.shape[1]} "
                f"{str(x.dtype).replace('torch.', '')} ({what})",
                "no single PyTorch call computes per-row abs-max int8 with "
                "its scale")

    # the ops path's shapes (phase 7): the second 1024-token ISO chunk of a
    # 2048-token prompt over its whole prefix (and the whole prompt in one
    # call), RMSNorm (2048, 4096) with an fp32 gamma, SwiGLU (2048, 12288)
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_prefill import flash_attention_plain
    from repro_torch.kernels.rmsnorm import rms_norm_plain
    from repro_torch.kernels.swiglu import swiglu_plain
    fk = torch.randn((1, hkv, 2048, hd), generator=gen, device="cuda").to(dt)
    fv = torch.randn((1, hkv, 2048, hd), generator=gen, device="cuda").to(dt)
    fq = torch.randn((1, hq, 2048, hd), generator=gen, device="cuda").to(dt)

    def f_case(q0, what):
        q = fq[:, :, q0:].contiguous()
        Sq, Sk = q.shape[2], fk.shape[2]
        # the offset-causal mask; the pairs it keeps are this run's work
        mask = (torch.arange(Sk, device="cuda")[None, :]
                <= q0 + torch.arange(Sq, device="cuda")[:, None])
        pairs = int(mask.sum()) * hq
        nbytes = 2 * (q.numel() * 2 + fk.numel() + fv.numel())
        return (lambda: ops.flash_attention(q, fk, fv, q_start=q0),
                lambda: flash_attention_plain(q, fk, fv, q_start=q0),
                nbytes, 4 * hd * pairs, "bfloat16",
                f"B=1 Sq={Sq} Sk={Sk} q_start={q0} Hq={hq} Hkv={hkv} "
                f"hd={hd} bf16 ({what})",
                lambda: F.scaled_dot_product_attention(
                    q, fk, fv, attn_mask=mask, enable_gqa=True))

    xr = torch.randn((2048, 4096), generator=gen, device="cuda").to(dt)
    gr = torch.randn((4096,), generator=gen, device="cuda")
    gs = torch.randn((2048, 12288), generator=gen, device="cuda").to(dt)
    us = torch.randn((2048, 12288), generator=gen, device="cuda").to(dt)

    cases = {
        "flash_prefill": f_case(1024, "second ISO chunk over its prefix"),
        "flash_prefill/full": f_case(0, "the whole prompt in one call"),
        "rms_norm": (lambda: ops.rms_norm(xr, gr),
                     lambda: rms_norm_plain(xr, gr),
                     2 * xr.numel() * 2 + gr.numel() * 4,
                     RMS_OPS_PER_ELEMENT * xr.numel(), "float32",
                     "rows=2048 d=4096 bf16, fp32 gamma",
                     lambda: F.rms_norm(xr, (4096,), gr, 1e-6)),
        "swiglu": (lambda: ops.swiglu(gs, us), lambda: swiglu_plain(gs, us),
                   3 * gs.numel() * 2, SWIGLU_OPS_PER_ELEMENT * gs.numel(),
                   "float32", "rows=2048 F=12288 bf16",
                   "no single PyTorch call computes silu(gate) * up"),
        # the decode shape, which most launches take, is the kernel line's
        "quantize_int8": q_case("decode", "tp=2 decode half of 2 requests"),
        "quantize_int8/decode_requant": q_case(
            "decode_requant", "its re-quantize of the reduced slice"),
        "quantize_int8/prefill": q_case(
            "prefill", "tp=2 256-token ISO chunk of a prefill grant"),
        "quantize_int8/prefill_requant": q_case(
            "prefill_requant", "its re-quantize of the reduced slice"),
        # the earlier PRs' shape is the kernel line's, now with the spans
        # folded in the launch (the walk alone beside it); one request of
        # 8192 tokens (a short grid: 32 spans for 132 SMs); one tp=2 rank's
        # heads
        "paged_decode": dec,
        "paged_decode/spans": dec_spans,
        "paged_decode/long": decode_timing_case(gen, [8192], hq, hkv, S, 512,
                                                paged)[0],
        "paged_decode/tp2": decode_timing_case(
            gen, [700, 1200, 1700, 2030], hq // 2, hkv // 2, S, 128,
            paged)[0],
        # the spec_k=4 verify window of phase 3's defaults pass: K = 5, 20
        # query rows a kv head
        "paged_decode/k5": decode_timing_case(
            gen, [700, 1200, 1700, 2030], hq, hkv, S, 128, paged, K=5)[0],
        # B2 as a launch of its own, over the same walk's partials
        "decode_reduce": (red, red_plain, red_bytes, red_ops, "float32",
                          red_shape, paged),
        # the earlier PRs' shape, kept for continuity, is the kernel line's
        "paged_prefill": p_case(512, 512, "a 512-token resumed chunk"),
        "paged_prefill/iso_chunk": p_case(
            256, 256, "the second 256-token ISO chunk of a resumed 512-token "
            "grant, the serving path's shape"),
        "paged_prefill/packed": packed_case(gen, [0, 700, 1200, 2000], 128,
                                            paged),
        # paper-30b's MHA heads (52/52, group 1: one live row of B1's 4-row
        # tiles at K = 1), the same lengths, and its 5-token verify window
        "paged_decode/paper30b": decode_timing_case(
            gen, [700, 1200, 1700, 2030], 52, 52, S, 128, paged)[0],
        "paged_decode/paper30b_k5": decode_timing_case(
            gen, [700, 1200, 1700, 2030], 52, 52, S, 128, paged, K=5)[0],
        "paged_prefill/paper30b_iso_chunk": p_case(
            256, 256, "paper-30b's heads, the serving path's ISO chunk",
            hq=52, hkv=52),
    }
    cases.update(int8_reduce_cases(
        gen, "no single PyTorch call computes a step of the int8 "
        "all-reduce"))
    # the paged kernels' cases, the verify window's and the pack's among
    # them, against their plain versions on the timed inputs
    for name, (fn, plain, *_) in cases.items():
        if name.startswith(("paged_decode", "paged_prefill")):
            err = max_err(fn(), plain(), TOL["bfloat16"])
            log(f"[time] {name}: kernel against its plain version, max abs "
                f"err {err:.3e} (tolerance {TOL['bfloat16']})")
    # each case ends in its library call, or why there is none
    timing = {}
    for name, (fn, plain, nbytes, n_ops, kind, shape, library) \
            in cases.items():
        ms = time_ms(fn)
        plain_ms = None if plain is None else time_ms(plain, reps=5)
        library_ms = None if isinstance(library, str) \
            else time_ms(library, reps=5)
        eager_ms = call_ms(fn)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops / PEAK_FLOPS[kind] * 1e3
        timing[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                            bound_ms=max(t_bytes, t_ops),
                            bound_by="bytes" if t_bytes >= t_ops
                            else "operations", shape=shape,
                            bytes=nbytes, ops=n_ops, eager_ms=eager_ms)
        lib = (f"library_ms none: {library}" if library_ms is None else
               f"library {library_ms:.4f} ms, {ms / library_ms:.2f}x it")
        plain_txt = "none" if plain_ms is None else f"{plain_ms:.4f} ms"
        log(f"[time] {name}: {ms:.4f} ms on the device, {eager_ms:.4f} ms "
            f"per eager call with the wrapper's host work (plain "
            f"{plain_txt}, bound "
            f"{max(t_bytes, t_ops):.5f} ms by {timing[name]['bound_by']}, "
            f"{lib}) at {shape}")
    # the device time of one trivial launch through the same graph replay:
    # no kernel can take less, whatever its bound
    one = torch.zeros(1, device="cuda")
    floor_ms = time_ms(one.zero_)
    log(f"[time] per-launch floor (one zero_() of a 1-element tensor through "
        f"the same CUDA-graph replay; no kernel's time): {floor_ms:.5f} ms")
    for name, t in timing.items():
        log(f"[time] {name}: ms - bound {t['ms'] - t['bound_ms']:.5f}, ms - "
            f"max(bound, floor) {t['ms'] - max(t['bound_ms'], floor_ms):.5f}")
    # B5's plain version and F.rms_norm, each timed on its own again, to
    # more digits, and F.rms_norm once more with gamma in x's dtype (bf16)
    t = timing["rms_norm"]
    bf16_gamma = gr.to(dt)
    lib_bf16_ms = time_ms(lambda: F.rms_norm(xr, (4096,), bf16_gamma, 1e-6),
                          reps=5)
    log(f"[time] rms_norm, the plain and library columns apart: plain "
        f"{t['plain_ms']:.6f} ms, F.rms_norm (fp32 gamma) "
        f"{t['library_ms']:.6f} ms, F.rms_norm with a bf16 gamma "
        f"{lib_bf16_ms:.6f} ms; B5 {t['ms']:.6f} ms")
    fold_ms = timing["paged_decode"]["ms"] - timing["paged_decode/spans"]["ms"]
    log(f"[time] the fold inside the decode launch costs {fold_ms:.5f} ms "
        f"(paged_decode - paged_decode/spans); the two launches it replaces "
        f"took {timing['paged_decode/spans']['ms']:.5f} + "
        f"{timing['decode_reduce']['ms']:.5f} ms")
    for name in ("decode", "prefill"):
        new_ms = timing[f"int8_reduce/{name}"]["ms"]
        old_ms = timing[f"int8_reduce/{name}/b7_ops"]["ms"]
        log(f"[time] int8 reduce local part at the {name} shape: three "
            f"kernels {new_ms:.5f} ms, B7 with PyTorch ops in eleven launches "
            f"{old_ms:.5f} ms ({old_ms / new_ms:.2f}x)")
    report["timing"] = timing
    report["floor_ms"] = floor_ms
    report["h100_profile"] = measure_profile(gen)


def measure_profile(gen) -> dict:
    """The h100 profile's measured constants (``perf/model.HW_PROFILES``):
    the matmul rate of a bf16 ``torch.matmul`` at paper-30b's ISO-chunk MLP
    shape, and the memory rate of a device-to-device copy of 2 GiB (bytes
    read plus bytes written over its time), each through ``time_ms``;
    printed beside the constants the profile holds."""
    import torch
    from repro_torch.perf.model import HW_PROFILES
    m, k, n = PROFILE_GEMM
    a = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn((k, n), generator=gen, device="cuda").to(torch.bfloat16)
    gemm_ms = time_ms(lambda: torch.matmul(a, w))
    del a, w
    src = torch.empty(PROFILE_COPY_ELEMS, dtype=torch.bfloat16, device="cuda")
    dst = torch.empty_like(src)
    src.fill_(1.0)
    copy_ms = time_ms(lambda: dst.copy_(src), reps=10)
    nbytes = 2 * src.numel() * src.element_size()
    del src, dst
    torch.cuda.empty_cache()
    flops = 2 * m * k * n / (gemm_ms * 1e-3)
    hbm_bw = nbytes / (copy_ms * 1e-3)
    hw = HW_PROFILES["h100"]
    log(f"[time] h100 profile: bf16 matmul ({m}, {k}) @ ({k}, {n}) "
        f"{gemm_ms:.5f} ms = {flops:.6e} FLOP/s (the profile holds "
        f"{hw.flops:.6e}, {flops / hw.flops:.4f}x); a {nbytes / 2:.0f}-byte "
        f"device-to-device copy {copy_ms:.5f} ms = {hbm_bw:.6e} B/s read "
        f"plus written (the profile holds {hw.hbm_bw:.6e}, "
        f"{hbm_bw / hw.hbm_bw:.4f}x)")
    return dict(gemm_ms=gemm_ms, flops=flops, copy_ms=copy_ms, hbm_bw=hbm_bw)


def decode_timing_case(gen, lengths, hq, hkv, S, mb, paged, K=1):
    """B1's timing cases at ``lengths`` resident tokens (hd 128, ps 16, a
    ``K``-token window, bf16, table width ``mb``, ``S`` > 1 spans), each
    (fn, plain, bytes, ops,
    kind, shape, library): the serving path's form, the walk with its S span
    partials folded inside the launch; the walk alone into its S partials
    (the launch before the fold moved in); then (its partials, bytes, ops
    and shape of their reduce).  Bytes: q, the block tables, lengths, every
    resident page of K and V once, and the output (the folded state, or the
    partials); operations: 4 * hd per (query row, key)."""
    import torch
    from repro_torch.kernels import flash_decode as fd
    ps, hd, dt = 16, 128, torch.bfloat16
    gk = hq // hkv * K
    B = len(lengths)
    k, v, bt, lens = make_pool(gen, lengths, ps, hkv, hd, dt, mb=mb)
    qg = torch.randn((B, hkv, gk, hd), generator=gen, device="cuda").to(dt)
    kw = dict(k_tokens=K, window=0, kv_splits=S)
    dec = lambda: fd.decode_partials(qg, k, v, bt, lens, **kw)
    dec_plain = lambda: fd.decode_partials_plain(qg, k, v, bt, lens, **kw)
    fold = lambda: fd.decode_folded(qg, k, v, bt, lens, **kw)
    fold_plain = lambda: fd.decode_reduce_plain(*dec_plain())
    walked_pages = sum(-(-L // ps) for L in lengths)
    in_bytes = (qg.numel() * 2 + bt.numel() * 4 + B * 4
                + 2 * walked_pages * ps * hkv * hd * 2)
    part_bytes = B * hkv * S * gk * (hd + 2) * 4
    fold_bytes = B * hkv * gk * (hd + 2) * 4
    n_ops = 4 * sum(lengths) * hq * K * hd
    shape = (f"B={B} L={lengths} K={K} Hq={hq} Hkv={hkv} hd={hd} ps={ps} "
             f"MB={mb} S={S} bf16")
    return ((fold, fold_plain, in_bytes + fold_bytes, n_ops, "bfloat16",
             shape + ", spans folded in the launch", paged),
            (dec, dec_plain, in_bytes + part_bytes, n_ops, "bfloat16",
             shape + ", the S span partials", paged),
            (dec(), part_bytes + fold_bytes, 4 * B * hkv * S * gk * hd,
             f"B={B} Hkv={hkv} S={S} gk={gk} hd={hd} fp32"))


def packed_case(gen, prefixes, Sq, paged):
    """B3's timing case on a pack: one ``Sq``-query chunk a row, each right
    after its own prefix (a fresh row has prefix 0 and comes back neutral),
    hd 128, ps 16, Hq/Hkv 32/8, MB 128, bf16.  Bytes: q, the block tables,
    prefix_lens and q_starts, every prefix key and value once, the fp32
    output state; operations: 4 * hd per (query row, prefix key)."""
    import torch
    from repro_torch.kernels import flash_prefill_paged as fp
    ps, hq, hkv, hd, dt = 16, 32, 8, 128, torch.bfloat16
    B = len(prefixes)
    k, v, bt, lens = make_pool(gen, prefixes, ps, hkv, hd, dt, mb=128)
    q = torch.randn((B, hq, Sq, hd), generator=gen, device="cuda").to(dt)
    nbytes = (q.numel() * 2 + bt.numel() * 4 + 2 * B * 4
              + 2 * sum(prefixes) * hkv * hd * 2 + B * hq * Sq * (hd + 2) * 4)
    return (lambda: fp.flash_prefill_paged(q, k, v, bt, lens, lens),
            lambda: fp.prefill_partial_plain(q, k, v, bt, lens, lens),
            nbytes, 4 * Sq * sum(prefixes) * hq * hd, "bfloat16",
            f"B={B} Sq={Sq} prefixes={prefixes} Hq={hq} Hkv={hkv} hd={hd} "
            f"ps={ps} MB=128 bf16 (a pack of four rows, one fresh)", paged)


def int8_reduce_cases(gen, hint):
    """Timing cases of the int8 all-reduce's local part at qwen3-8b's tp=2
    shapes, each (fn, plain, bytes, ops, kind, shape, library): its three
    kernels at the decode shape, and at (4, 4096) (a decode batch) and
    (512, 4096) (a prefill grant) one reduce's local steps as this port
    runs them (three launches) and as the composition of B7 with PyTorch
    ops that they replace (eleven).  The all-to-all and the all-gather are
    left out: each rank's own shards stand in for what it would receive.
    Bytes: each step's inputs read once and outputs written once."""
    import torch
    from repro_torch.kernels import int8_quant as q8
    tp, dt = 2, torch.bfloat16

    def three(x):
        q, s = q8.quantize_int8_shards(x, tp)
        q8.dequant_sum_quantize_int8(q, s)
        return q8.dequantize_int8_gathered(q, s, x.dtype)

    def three_plain(x):
        q, s = q8.quantize_int8_shards_plain(x, tp)
        q8.dequant_sum_quantize_int8_plain(q, s)
        return q8.dequantize_int8_gathered_plain(q, s, x.dtype)

    def eleven(x):
        """The steps as B7 and PyTorch ops: B7 on the shards, two copies,
        dequantize (2) and sum, B7 again, dequantize (2), a copy back and
        the cast."""
        d = x.shape[-1] // tp
        q, s = q8.quantize_int8(x.reshape(*x.shape[:-1], tp, d))
        q, s = q.movedim(-2, 0).contiguous(), s.movedim(-2, 0).contiguous()
        part = q8.dequantize_int8(q, s).sum(dim=0)
        q8.quantize_int8(part)
        out = q8.dequantize_int8(q, s).movedim(0, -2)
        return out.reshape(x.shape).to(x.dtype)

    def step_bytes(R, D):
        d = D // tp
        shards = R * D * 2 + R * D + tp * R * 4
        rank_sum = R * D + tp * R * 4 + R * d + R * 4
        gathered = R * D + tp * R * 4 + R * D * 2
        return shards, rank_sum, gathered

    cases = {}
    xd = torch.randn((4, 4096), generator=gen, device="cuda").to(dt)
    qd, sd = q8.quantize_int8_shards(xd, tp)
    b = step_bytes(4, 4096)
    shape = "x (4, 4096) bf16 at tp=2"
    cases["quantize_int8_shards"] = (
        lambda: q8.quantize_int8_shards(xd, tp),
        lambda: q8.quantize_int8_shards_plain(xd, tp), b[0],
        QUANT_OPS_PER_ELEMENT * xd.numel(), "float32", shape, hint)
    cases["dequant_sum_quantize_int8"] = (
        lambda: q8.dequant_sum_quantize_int8(qd, sd),
        lambda: q8.dequant_sum_quantize_int8_plain(qd, sd), b[1],
        (2 * tp + QUANT_OPS_PER_ELEMENT) * xd.numel() // tp, "float32",
        "q (2, 4, 2048) int8, s (2, 4, 1) at tp=2", hint)
    cases["dequantize_int8_gathered"] = (
        lambda: q8.dequantize_int8_gathered(qd, sd, dt),
        lambda: q8.dequantize_int8_gathered_plain(qd, sd, dt), b[2],
        2 * xd.numel(), "float32", "q (2, 4, 2048) int8 -> (4, 4096) bf16",
        hint)
    for name, R in (("decode", 4), ("prefill", 512)):
        x = torch.randn((R, 4096), generator=gen, device="cuda").to(dt)
        n_ops = (QUANT_OPS_PER_ELEMENT + 2 * tp + QUANT_OPS_PER_ELEMENT / tp
                 + 2) * x.numel()
        cases[f"int8_reduce/{name}"] = (
            lambda x=x: three(x), lambda x=x: three_plain(x),
            sum(step_bytes(R, 4096)), int(n_ops), "float32",
            f"x ({R}, 4096) bf16 at tp=2, three kernels", hint)
        cases[f"int8_reduce/{name}/b7_ops"] = (
            lambda x=x: eleven(x), None, sum(step_bytes(R, 4096)),
            int(n_ops), "float32",
            f"x ({R}, 4096) bf16 at tp=2, eleven launches (B7 "
            f"twice, nine PyTorch ops)", hint)
    return cases


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------

def reset_observability(eng) -> None:
    """Zero ``eng``'s registry (every counter, every gauge and its peak,
    every histogram) and clear its trace ring, together, so that a pass's
    trace and registry cover that pass alone and the one replays into the
    other.  The package has no reset (nor has the reference's): this sets
    the instruments themselves."""
    snap = eng.registry.snapshot()
    for name in list(eng.metrics):
        eng.metrics[name] = 0
        if name + "_peak" in snap:
            eng.registry.gauge(name).peak = 0
    for h in eng.registry.histograms.values():
        h.counts = [0] * len(h.counts)
        h.n, h.sum, h.min, h.max = 0, 0.0, math.inf, -math.inf
    eng.trace.clear()


def serve_pass(eng, prompts, label: str, card: str, new: int = 32,
               kernels=ATTENTION_KERNELS, patches=None) -> dict:
    """Serve ``prompts`` (``new`` greedy tokens each; with ``patches``, a
    vlm model's per request, None for a text-only one) on ``eng`` from a
    zeroed registry, an empty trace ring and zeroed launch counts; check
    that every request completed, every page came back and the attention
    kernels launched (``kernels``; an empty tuple: a stack with no
    attention, which must launch no kernel at all); print the pass."""
    import torch
    from repro_torch.kernels import native
    from repro_torch.serving import Request
    from repro_torch.serving.requests import SamplingParams

    reset_observability(eng)
    eng.decode_splits = {}
    rids = [eng.add_request(Request(
        prompt=p.copy(), sampling=SamplingParams(max_new_tokens=new,
                                                 eos_id=-1),
        patches=None if patches is None else patches[i]))
        for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    native.reset_launches()
    t0 = time.perf_counter()
    outs = eng.run_until_complete()
    wall = time.perf_counter() - t0
    m = dict(eng.metrics)
    res = dict(tokens=[outs.get(r) for r in rids], rids=rids, m=m, wall=wall,
               launches=dict(native.LAUNCHES),
               variants=dict(native.VARIANTS),
               splits=dict(eng.decode_splits))
    if any(t is None or len(t) != new for t in res["tokens"]):
        raise AssertionError(f"{label}: not every request completed: {m}")
    if eng.alloc.free_pages != eng.alloc.num_pages:
        raise AssertionError(f"{label}: pages leaked")
    for name in kernels:
        if res["launches"][name] <= 0:
            raise AssertionError(f"{label}: kernel {name} never launched on "
                                 f"the main path: {res['launches']}")
    if not kernels and any(res["launches"].values()):
        raise AssertionError(f"{label}: a stack with no attention launched "
                             f"hand-written kernels: {res['launches']}")
    if m["resumed_grants"] <= 0:
        raise AssertionError(f"{label}: no resumed grant ran")
    log(f"[serve] {label}: prefill {m['prefill_tokens']} tok in "
        f"{m['prefill_s']:.3f}s = {m['prefill_tokens'] / m['prefill_s']:.0f} "
        f"tok/s ({m['prefill_calls']} calls, {m['resumed_grants']} resumed); "
        f"decode {1e3 * m['decode_s'] / m['decode_calls']:.2f} ms/step over "
        f"{m['decode_calls']} steps; host dispatch share (host time until the "
        f"calls return, of the fenced time): prefill "
        f"{m['prefill_dispatch_s'] / m['prefill_s']:.3f}, decode "
        f"{m['decode_dispatch_s'] / m['decode_s']:.3f}; host "
        f"{1e3 * m['decode_dispatch_s'] / m['decode_calls']:.3f} ms a decode "
        f"step; wall {wall:.1f}s; preemptions {m['preemptions']} [{card}]")
    return res


def device_activity(prof, skip: str = None) -> dict:
    """From a ``torch.profiler`` trace with CUDA activities: the device
    intervals (kernels, copies, fills) whose names do not start with
    ``skip``, the union of their time, the span from the first start to the
    last end, and the time by name (ms)."""
    from torch.autograd import DeviceType
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not (skip and e.name.startswith(skip))]
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs)
    busy, end = 0.0, -math.inf
    for a, b in spans:                        # union of the intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in evs:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    return dict(n=len(spans), busy_ms=busy / 1e3,
                span_ms=(end - spans[0][0]) / 1e3 if spans else 0.0,
                by_name=sorted(by_name.items(), key=lambda kv: -kv[1][1]))


def log_top(label: str, act: dict, per: int, card: str,
            top: int = 8) -> None:
    """The ``top`` names that took the most device time, per step."""
    total = sum(t for _, (_, t) in act["by_name"])
    log(f"[serve] {label}: {act['n'] / per:.0f} device intervals and "
        f"{total / per:.3f} ms of device time a step; by name, ms a step "
        f"(launches a step) [{card}]:")
    for name, (n, t) in act["by_name"][:top]:
        log(f"    {t / per:8.3f} ({n / per:5.0f})  {name[:90]}")


def decode_idle_share(eng, prompts, card: str) -> None:
    """The device's idle share over ten decode steps of ``eng`` (through the
    graphs the trace captured).  Four of the trace's requests are
    prefilled; then ten decode steps run with CUDA events from before each
    call's staging to after its replay, and ten more the same way under
    ``torch.profiler`` with CUDA activities.  Once those requests are done,
    four more are prefilled under the profiler (where the device time of a
    step with grants goes): the untraced steps run before any tracing.

    Untraced, the device can be busy only inside those windows or while it
    copies the logits back, so one minus (the windows' time plus the traced
    logits copies) over the wall is a lower bound on the idle share.  The
    gaps inside a graph show only in the trace, which may stretch the
    kernels too: one minus the traced device time (the union of the
    intervals) over the untraced wall is the idle share if tracing leaves
    the kernels' time alone.  It does not if the traced device time outside
    the logits copies exceeds the untraced windows' time, and the script
    prints which holds; beside them, the traced steps' own idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import Request, paged_engine
    from repro_torch.serving.requests import SamplingParams

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def prefill_four() -> int:
        """Add four requests and step until their prompts are resident;
        returns the steps taken."""
        for p in prompts[:4]:
            eng.add_request(Request(prompt=p.copy(), sampling=SamplingParams(
                max_new_tokens=32, eos_id=-1)))
        steps = 0
        while eng.scheduler.waiting or any(
                s is not None and s.prefilled < sum(s.chunk_plan)
                for s in eng.slots):
            eng.step()
            steps += 1
        return steps

    prefill_four()
    graphs = eng.graphs
    windows = []
    stage = paged_engine.StepClosure.stage
    call = paged_engine.StepClosure.__call__

    def timed_stage(self, **host):
        a = torch.cuda.Event(enable_timing=True)
        a.record()
        windows.append([a, None])
        stage(self, **host)

    def timed_call(self):
        out = call(self)
        b = torch.cuda.Event(enable_timing=True)
        b.record()
        windows[-1][1] = b
        return out

    def ten_steps():
        del windows[:]
        t0 = time.perf_counter()
        for _ in range(10):
            eng.step()
        wall = time.perf_counter() - t0
        if eng.graphs != graphs or len(windows) != 10:
            raise AssertionError(f"ten decode steps made {len(windows)} "
                                 f"calls and {eng.graphs - graphs} captures")
        return 1e3 * wall, sum(a.elapsed_time(b) for a, b in windows)

    paged_engine.StepClosure.stage = timed_stage
    paged_engine.StepClosure.__call__ = timed_call
    try:
        wall, inside = ten_steps()
        with profile(activities=acts) as prof:
            traced_wall, traced_inside = ten_steps()
    finally:
        paged_engine.StepClosure.stage = stage
        paged_engine.StepClosure.__call__ = call
    act = device_activity(prof)

    def drain():             # not run_until_complete, which serve_ab.py times
        while any(s is not None for s in eng.slots):
            eng.step()

    drain()
    grants = eng.metrics["prefill_calls"]
    with profile(activities=acts) as prefill_prof:
        steps = prefill_four()
    log_top(f"{steps} steps with {eng.metrics['prefill_calls'] - grants} "
            f"grants", device_activity(prefill_prof), steps, card)
    drain()
    log(f"[serve] ten graphed decode steps: {wall / 10:.3f} ms a step "
        f"untraced, {traced_wall / 10:.3f} traced; staging and replay "
        f"windows (CUDA events) {inside / 10:.3f} ms a step untraced, "
        f"{traced_inside / 10:.3f} traced [{card}]")
    if not act["n"]:
        log("[serve] torch.profiler saw no device activity: the idle share "
            "is not measured")
        return
    copies = act["busy_ms"] - device_activity(prof, "Memcpy DtoH")["busy_ms"]
    kernels = act["busy_ms"] - copies
    holds = kernels <= inside
    log(f"[serve] device idle share over ten graphed decode steps: at least "
        f"{1 - (inside + copies) / wall:.4f} (untraced windows "
        f"{inside:.3f} ms + traced logits copies {copies:.3f} ms over the "
        f"untraced wall {wall:.3f} ms); {1 - act['busy_ms'] / wall:.4f} if "
        f"tracing leaves the kernels' time alone (traced device time "
        f"{act['busy_ms']:.3f} ms over the untraced wall); the traced device "
        f"time outside the logits copies, {kernels:.3f} ms, "
        + ("fits within the untraced windows' time, as it must if so" if holds
           else f"exceeds the untraced windows' {inside:.3f} ms: tracing "
                f"stretched the kernels, and the second figure is low")
        + f"; the traced steps' own: {1 - act['busy_ms'] / act['span_ms']:.4f}"
        f" of a {act['span_ms']:.3f} ms span [{card}]")
    log_top("ten graphed decode steps", act, 10, card)


def baseline_prompts(cfg):
    """Phase 3's six greedy prompts of 300-2000 tokens (seed 0), the first
    at least 1500 tokens long (a resumed grant): (lengths, prompts)."""
    import numpy as np
    rng = np.random.default_rng(0)
    lengths = [int(n) for n in rng.integers(300, 2001, 6)]
    lengths[0] = max(lengths[0], 1500)           # at least one resumed grant
    return lengths, [rng.integers(2, cfg.vocab_size, n).astype(np.int32)
                     for n in lengths]


def serve_full(report, card: str):
    """Phase 3: the six requests on an eager engine (``cuda_graphs=False``),
    then on a graphed one, a capture pass and a timed pass; the graphed
    tokens must equal the eager ones."""
    import torch
    from repro_torch.config import Config, ISOConfig, ParallelConfig, \
        ServingConfig, get_model_config
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.launch.serve import FiniteRows
    from repro_torch.models import api
    from repro_torch.serving import PagedEngine, paged_engine

    cfg = get_model_config("qwen3-8b")           # full width and depth
    t0 = time.perf_counter()
    params = api.init_params(0, cfg, tp=1, dtype=torch.bfloat16,
                             device="cuda")
    torch.cuda.synchronize()
    log(f"[serve] qwen3-8b {cfg.num_layers}L d={cfg.d_model} "
        f"{cfg.param_count() / 1e9:.2f}B params bf16 made on the card in "
        f"{time.perf_counter() - t0:.1f}s")
    # the batch-1 baseline of earlier slices (one call a grant, no sharing,
    # K=1), kept for continuity: serve_defaults runs the reference's
    # defaults beside it
    sv = ServingConfig(page_size=16, max_batch=4, max_len=2048,
                       prefill_token_budget=512, prefix_sharing=False,
                       prefill_batching=False)
    config = Config(model=cfg, parallel=ParallelConfig(data=1, model=1),
                    iso=ISOConfig(), serving=sv)
    lengths, prompts = baseline_prompts(cfg)
    report["lengths"] = lengths

    # the defaults pass first: the idle share's torch.profiler, below,
    # leaves a host cost on every later graph replay; then phase 9 (a),
    # held against it
    serve_defaults(report, card, cfg, params, lengths)
    serve_defaults_fp32(report, card, lengths)
    serve_disagg(report, card, cfg, params, lengths)
    serve_disagg_fp32(report, card, lengths)
    # the card's reserved memory after each capture
    reserved = []
    capture = paged_engine.StepClosure.capture

    def noted_capture(self, side, pool):
        out = capture(self, side, pool)
        reserved.append(torch.cuda.memory_reserved() / 2**30)
        return out

    def peaks():
        return (torch.cuda.max_memory_allocated() / 2**30,
                torch.cuda.max_memory_reserved() / 2**30)

    paged_engine.StepClosure.capture = noted_capture
    with FiniteRows() as finite:
        try:
            torch.cuda.reset_peak_memory_stats()
            eng = PagedEngine(config, params, device="cuda",
                              cuda_graphs=False)
            eager = serve_pass(eng, prompts, "eager", card)
            eager_peak = peaks()
            del eng
            free_cuda()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_reserved() / 2**30
            eng = PagedEngine(config, params, device="cuda")
            first = serve_pass(eng, prompts, "graphed, capture pass", card)
            graphs, capture_s = eng.graphs, eng.capture_s
            res = serve_pass(eng, prompts, "graphed, timed pass", card)
            peak = peaks()
            m = res["m"]
            report["serve"] = dict(
                prefill_tok_s=m["prefill_tokens"] / m["prefill_s"],
                decode_ms_step=1e3 * m["decode_s"] / m["decode_calls"],
                peak_gib=peak[0])
            # phase 9 (c) and (b), before the idle share's profiler
            report["probe_tp1"] = probe_engine(eng, prompts, res,
                                               "qwen3-8b graphed tp=1", card)
            serve_ladder(report, card, params, prompts)
            decode_idle_share(eng, prompts, card)
        finally:
            paged_engine.StepClosure.capture = capture
    closures = (len(eng._prefill_fns) + len(eng._decode_fns)
                + len(eng._decode_fallback_fns))
    bound = eng.max_prefill_compiles() + len(eng._decode_fns) \
        + len(eng._decode_fallback_fns)
    log(f"[serve] {graphs} CUDA graphs captured in {capture_s:.2f}s (prefill "
        f"keys {sorted(eng._prefill_fns)}, decode keys "
        f"{sorted(eng._decode_fns)}; bound {bound}); the timed pass captured "
        f"{eng.graphs - graphs}; reserved memory {before:.3f} GiB before the "
        f"engine, after each capture "
        f"{[round(r, 3) for r in reserved[:graphs]]} GiB "
        f"[{card}]")
    if graphs != closures or graphs > bound or eng.graphs != graphs:
        raise AssertionError(f"{graphs} graphs for {closures} closures "
                             f"(bound {bound}), {eng.graphs - graphs} more "
                             f"in the timed pass")
    for label, r in (("capture pass", first), ("timed pass", res)):
        if r["tokens"] != eager["tokens"]:
            diff = [i for i, (a, b) in enumerate(zip(r["tokens"],
                                                     eager["tokens"]))
                    if a != b]
            raise AssertionError(f"graphed {label} tokens differ from the "
                                 f"eager tokens in requests {diff}")
    launches, m, splits = res["launches"], res["m"], res["splits"]
    folds = res["variants"]["paged_decode/fold"]
    # B2 runs inside the decode launch: one fused launch per layer of every
    # decode step at S > 1 (counted through the replays), and no reduce
    # launch of its own
    split_steps = sum(n for S, n in splits.items() if S > 1)
    if split_steps <= 0 or launches["decode_reduce"] != 0 or \
            folds != cfg.num_layers * split_steps or \
            sum(splits.values()) != m["decode_calls"]:
        raise AssertionError(
            f"decode steps at S > 1: {split_steps} of {m['decode_calls']} "
            f"({splits}); "
            f"paged_decode/fold launched {folds} times, want "
            f"{cfg.num_layers} a step; decode_reduce {launches['decode_reduce']}"
            f" times, want 0")
    variants = {k: v for k, v in res["variants"].items()
                if k.startswith("paged_prefill/")}
    if variants["paged_prefill/tc"] != launches["paged_prefill"]:
        raise AssertionError(f"bf16 serving launched paged_prefill "
                             f"{launches['paged_prefill']} times, "
                             f"{variants} by instantiation: not all on the "
                             f"tensor-core one")
    arrivals = fd._ARRIVALS[torch.device("cuda", 0)]
    if int(arrivals.abs().sum()) != 0:
        raise AssertionError("fold arrival counters not 0 after the replays")
    shares = {k: r["m"]["decode_dispatch_s"] / r["m"]["decode_s"]
              for k, r in (("eager", eager), ("graphed", res))}
    if not shares["graphed"] < shares["eager"]:
        raise AssertionError(f"decode dispatch share {shares}: graphed not "
                             f"below eager")
    log(f"[serve] {len(prompts)} requests, prompts {lengths}, 32 new tokens "
        f"each, {finite.rows} logits rows finite; graphed tokens == "
        f"eager tokens (both passes); timed pass launches {launches} (through "
        f"replays); paged_prefill by instantiation {variants}; {split_steps} "
        f"of {m['decode_calls']} decode steps at S > 1 (steps by S "
        f"{splits}), "
        f"paged_decode/fold {folds} = {cfg.num_layers} a step, decode_reduce "
        f"0; fold arrival counters 0")
    for label, r, pk in (("eager", eager, eager_peak),
                         ("graphed", res, peak)):
        rm = r["m"]
        tok_s = rm["prefill_tokens"] / rm["prefill_s"]
        ms_step = 1e3 * rm["decode_s"] / rm["decode_calls"]
        log(f"[serve] {label}: prefill {tok_s:.0f} tok/s, decode "
            f"{ms_step:.3f} ms/step, dispatch share prefill "
            f"{rm['prefill_dispatch_s'] / rm['prefill_s']:.3f} decode "
            f"{rm['decode_dispatch_s'] / rm['decode_s']:.3f}, peak memory "
            f"allocated {pk[0]:.3f} GiB, reserved {pk[1]:.3f} GiB [{card}]")
    # the kernel line counts the defaults pass (serve_defaults), the
    # reference's default serving; this baseline's counts are logged above
    del eng
    free_cuda()
    # phase 8 last: its torch.profiler window, like the idle share's, leaves
    # a host cost on later replays
    serve_observability(report, card, cfg, params, lengths)
    del params
    free_cuda()


def serve_paper30b(report, card: str):
    """Phase 3's paper-30b pass: the paper's own 30b MHA model (52/52 heads,
    group 1) at full width and depth, bf16, tp=1, page 16, max_batch 4,
    max_len 2048, once every qwen3-8b engine and weight is freed.  The
    ``serve_defaults`` passes on phase 3's lengths (the reference's defaults
    at spec_k 4, eager then graphed, graphed tokens equal to eager; the
    plain graphed engine beside it is the batch-1 baseline of decode ms/step
    and prefill tok/s; the bf16 rule against it printed, not enforced),
    then the same decisions in fp32 at full width cut to 2 layers against
    the plain engine (``serve_defaults_fp32``), which is enforced."""
    import torch
    from repro_torch.config import get_model_config
    from repro_torch.models import api

    cfg = get_model_config("paper-30b")
    log(f"[paper-30b] before the weights: "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated, "
        f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB reserved")
    t0 = time.perf_counter()
    params = api.init_params(0, cfg, tp=1, dtype=torch.bfloat16,
                             device="cuda")
    torch.cuda.synchronize()
    log(f"[paper-30b] {cfg.num_layers}L d={cfg.d_model} Hq/Hkv "
        f"{cfg.num_heads}/{cfg.num_kv_heads} hd {cfg.resolved_head_dim} "
        f"d_ff {cfg.d_ff} vocab {cfg.vocab_size}: "
        f"{cfg.param_count() / 1e9:.4f}B params bf16 made on the card in "
        f"{time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated [{card}]")
    # the bf16 rule against the plain engine is printed, not enforced: at
    # 48 layers the plain and the packed / verify-window paths' logits
    # drift apart by up to 8 bf16 steps (0.25 at 7) before any decision
    # differs, past the kernels' tolerance; the fp32 pass below is the gate
    serve_defaults(report, card, cfg, params, report["lengths"],
                   tag="paper-30b", enforce_plain=False)
    del params
    free_cuda()
    serve_defaults_fp32(report, card, report["lengths"], arch="paper-30b")
    r = report["paper-30b"]
    log(f"[paper-30b] graphed baseline (batch-1, no sharing, K=1): decode "
        f"{r['plain_decode_ms_step']:.3f} ms/step, prefill "
        f"{r['plain_prefill_tok_s']:.2f} tok/s; the reference's defaults at "
        f"spec_k 4, graphed: decode {r['decode_ms_step']:.3f} ms/step, "
        f"prefill {r['prefill_tok_s']:.2f} tok/s; peak allocated "
        f"{r['peak_gib']:.3f} GiB graphed, {r['eager_peak_gib']:.3f} eager "
        f"[{card}]")


def free_cuda() -> None:
    """Return the cached blocks of the engines just dropped (an engine's
    closures hold its params and pools, not the engine, so dropping it frees
    its pools and graphs at once)."""
    import torch
    torch.cuda.empty_cache()


def defaults_prompts(cfg, lengths):
    """The phase-3 lengths with shared heads: the three prompts longer than
    1024 tokens open with one 1024-token system prompt, and the third is a
    copy of the first (so its length is the first's), which shares the
    first's partial last page and copies it at its first write."""
    import numpy as np
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, n).astype(np.int32)
               for n in lengths]
    system = np.random.default_rng(7).integers(2, cfg.vocab_size,
                                               1024).astype(np.int32)
    for i in (0, 1):
        prompts[i] = np.concatenate([system, prompts[i][1024:]])
    prompts[2] = prompts[0].copy()
    return prompts


class LogitsRecorder:
    """While active, records the logits row (fp32, on the host, the vocab's
    columns) of every emitted token by (rid, index into the request's
    generated tokens), from the logits ``all_gather_last`` hands the
    engine: a prefill call's prompt-finishing rows in ``_commit_rows``, a
    decode step's rows (the rows of a verify window that were emitted), and
    whether every logit it saw was finite.  Adds a check and a copy to the
    host to every call, so it is kept off timed passes."""

    def __init__(self, vocab: int):
        self.vocab = vocab
        self.rec = {}
        self.finite = True
        self._last = None

    def __enter__(self):
        import torch
        from repro_torch.serving import paged_engine
        E = paged_engine.PagedEngine
        self.orig = (paged_engine.all_gather_last, E._decode_phase,
                     E._commit_rows)
        gather, decode_phase, commit = self.orig

        def rec_gather(x, ctx):
            out = gather(x, ctx)
            self.finite &= bool(torch.isfinite(out).all())
            self._last = out[..., :self.vocab].float()
            return out

        def rec_decode_phase(eng, events):
            before = [(st, len(st.generated), st.slot) for st in eng.slots
                      if st is not None]
            self._last = None
            decode_phase(eng, events)
            if self._last is None:
                return
            rows = self._last.cpu().numpy()                 # (B, K, V)
            for st, g0, slot in before:
                for qi in range(len(st.generated) - g0):
                    self.rec[(st.request.rid, g0 + qi)] = \
                        rows[slot, qi].copy()

        def rec_commit(eng, group, picks, events):
            # the gather of this prefill call, when a row samples
            if picks is not None:
                rows = self._last.cpu().numpy()             # (R, V)
                for r, (st, _, _, _, last) in enumerate(group):
                    if last:
                        self.rec[(st.request.rid, len(st.generated))] = \
                            rows[r].copy()
            return commit(eng, group, picks, events)

        paged_engine.all_gather_last = rec_gather
        E._decode_phase = rec_decode_phase
        E._commit_rows = rec_commit
        return self

    def __exit__(self, *exc):
        from repro_torch.serving import paged_engine
        E = paged_engine.PagedEngine
        paged_engine.all_gather_last, E._decode_phase, \
            E._commit_rows = self.orig
        self._last = None
        return False


def check_against_plain(label: str, tol: dict, plain: dict, new: dict,
                        rec_plain: LogitsRecorder, rec_new: LogitsRecorder,
                        card: str, every_position: bool = False,
                        enforce: bool = True) -> dict:
    """Hold a pass's tokens against the plain engine's on the same prompts.
    Up to a request's first differing token both paths saw the same
    context, so their logits there are comparable (the plain path's tokens
    forced on both).  At each such position, the drift of the new path's
    logits at the plain path's top-2 tokens is printed, as is the whole
    row's.  A request must be token-equal, or first differ at a near-tie of
    the plain path: its top-2 gap within ``tol`` of its top-1
    (atol + rtol |top-1|), and the new path's logits at the plain path's
    top-2 tokens each within ``tol`` of the plain path's.  Also prints the
    plain path's top-2 gaps over every recorded position, against each
    position's limit, so what the rule excuses shows.  With
    ``every_position``, the top-2 logits must also lie within ``tol`` at
    every position of a shared context, not only at the first difference.
    Raises on a request that fails (with ``enforce`` off, prints it
    instead); returns the figures printed."""
    import numpy as np
    atol, rtol = tol["atol"], tol["rtol"]

    def top2(row):
        ids = np.argsort(row)[-2:][::-1]
        return ids, row[ids]

    gaps, under = [], 0
    for row in rec_plain.rec.values():
        _, v = top2(row)
        gaps.append(float(v[0] - v[1]))
        under += gaps[-1] <= atol + rtol * abs(float(v[0]))
    q = np.quantile(gaps, [0.0, 0.1, 0.5, 0.9])
    log(f"[{label}] the plain path's top-2 gap over its {len(gaps)} "
        f"recorded positions: min {q[0]:.6f}, 10% {q[1]:.6f}, median "
        f"{q[2]:.6f}, 90% {q[3]:.6f}; {under} within the near-tie limit "
        f"atol + rtol |top-1| ({tol}) [{card}]")
    drift_top2 = drift_row = 0.0
    over, common, same, failed = 0, 0, 0, []
    for i, (a, b) in enumerate(zip(plain["tokens"], new["tokens"])):
        p = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        same += p is None
        for j in range(len(a) if p is None else p + 1):
            key_p, key_n = (plain["rids"][i], j), (new["rids"][i], j)
            if key_p not in rec_plain.rec or key_n not in rec_new.rec:
                raise AssertionError(f"[{label}] request {i}: logits of "
                                     f"generated token {j} not recorded")
            P, N = rec_plain.rec[key_p], rec_new.rec[key_n]
            pi, pv = top2(P)
            d = np.abs(N[pi] - pv)
            lim = atol + rtol * np.abs(pv)
            common += 1
            over += bool((d > lim).any())
            drift_top2 = max(drift_top2, float(d.max()))
            drift_row = max(drift_row, float(np.abs(N - P).max()))
        if p is None:
            continue
        P, N = rec_plain.rec[(plain["rids"][i], p)], \
            rec_new.rec[(new["rids"][i], p)]
        (pi, pv), (ni, nv) = top2(P), top2(N)
        gap = float(pv[0] - pv[1])
        limit = atol + rtol * abs(float(pv[0]))
        moved = np.abs(N[pi] - pv)
        moved_lim = atol + rtol * np.abs(pv)
        log(f"[{label}] request {i}: tokens differ from the plain path's "
            f"first at generated token {p}: plain top-2 ids "
            f"{[int(t) for t in pi]} logits {[float(v) for v in pv]}, this "
            f"pass's top-2 ids {[int(t) for t in ni]} logits "
            f"{[float(v) for v in nv]}, its logits at the plain top-2 ids "
            f"{[float(v) for v in N[pi]]}; plain top-2 gap {gap:.6f}, limit "
            f"{limit:.6f}; moved {[float(v) for v in moved]}, limits "
            f"{[float(v) for v in moved_lim]}")
        if gap > limit:
            failed.append(f"request {i}: not a near-tie: gap {gap} > {limit}")
        elif (moved > moved_lim).any():
            failed.append(f"request {i}: the plain top-2 logits moved "
                          f"{moved.tolist()} > {moved_lim.tolist()}")
    log(f"[{label}] over the {common} positions of a shared context (each "
        f"request up to its first differing token): the logits at the plain "
        f"path's top-2 tokens moved at most {drift_top2:.6f} ({over} "
        f"positions past the tolerance {tol}), the whole row at most "
        f"{drift_row:.6f}; {same} of {len(plain['tokens'])} requests "
        f"token-equal to the plain engine [{card}]")
    if every_position and over:
        failed.append(f"the plain top-2 logits moved past the tolerance at "
                      f"{over} positions of a shared context")
    if failed and enforce:
        raise AssertionError(f"[{label}] " + "; ".join(failed))
    if failed:
        log(f"[{label}] past the bf16 rule, not enforced here: "
            + "; ".join(failed))
    return dict(same=same, positions=common, drift_top2=drift_top2,
                drift_row=drift_row, over=over, gaps=len(gaps),
                near_ties=under, failed=len(failed))


def serve_defaults(report, card: str, cfg, params, lengths,
                   tag: str = "defaults", enforce_plain: bool = True):
    """Phase 3's second pass: the reference's default serving features,
    packed prefill grants and copy-on-write prefix sharing, with a spec_k=4
    verify window, on ``defaults_prompts``: an eager engine, then a graphed
    one (a capture pass, a timed pass); graphed tokens must equal eager
    tokens exactly.  The timed pass must launch B3 on a pack of more than
    one row, B1 on the 5-token window (20 query rows a kv head) once a
    layer of every verify step, and the page-copy closure; sharing and
    speculation must have happened.  Then a plain engine (batch-1, no
    sharing, K=1) serves the same prompts: its peak pages stand beside the
    pass's, and where its tokens differ from the pass's, the first
    differing position must be a bf16 near-tie of the plain path: a top-2
    gap within 2e-2 + 2e-2 |top-1|, the kernel phases' tolerance, at which
    this pass's logits for the plain path's top-2 tokens each lie within
    that tolerance of the plain path's (``check_against_plain``; with
    ``enforce_plain`` off that comparison is printed, not enforced).
    ``tag`` labels the lines and the report's entries; the kernel line's
    launch counts are the ``"defaults"`` pass's."""
    import dataclasses
    import torch
    from repro_torch.config import Config, ISOConfig, ParallelConfig, \
        ServingConfig
    from repro_torch.serving import PagedEngine, paged_engine

    # a budget of 1024 puts the first sharee's resumed tail and another
    # request's second ISO chunk in one pack (found by the same lengths on
    # a tiny model on the CPU); 512 grants one request a step here
    sv = ServingConfig(page_size=16, max_batch=4, max_len=2048,
                       prefill_token_budget=1024, spec_k=4)
    plain_sv = dataclasses.replace(sv, prefix_sharing=False,
                                   prefill_batching=False, spec_k=0)
    prompts = defaults_prompts(cfg, lengths)

    def config(s):
        return Config(model=cfg, parallel=ParallelConfig(data=1, model=1),
                      iso=ISOConfig(), serving=s)

    packs, verify_rows = [], [0]
    run_pack, spec_window = PagedEngine._run_pack, PagedEngine._spec_window

    def noted_pack(eng, group, padded, events):
        packs.append((len(group), padded))
        return run_pack(eng, group, padded, events)

    def noted_window(eng, active):
        # (request, verify call) pairs: accepted_per_call sums a call's
        # requests, so tokens a request a call is spec_tokens over these
        K = spec_window(eng, active)
        verify_rows[0] += len(active) if K > 1 else 0
        return K

    def peaks():
        return (torch.cuda.max_memory_allocated() / 2**30,
                torch.cuda.max_memory_reserved() / 2**30)

    PagedEngine._run_pack = noted_pack
    PagedEngine._spec_window = noted_window
    try:
        torch.cuda.reset_peak_memory_stats()
        eng = PagedEngine(config(sv), params, device="cuda",
                          cuda_graphs=False)
        with LogitsRecorder(cfg.vocab_size) as rec_new:
            eager = serve_pass(eng, prompts, f"{tag} eager", card)
        eager_peak = peaks()
        del eng
        free_cuda()
        torch.cuda.reset_peak_memory_stats()
        eng = PagedEngine(config(sv), params, device="cuda")
        first = serve_pass(eng, prompts, f"{tag} graphed, capture pass",
                           card)
        graphs, capture_s = eng.graphs, eng.capture_s
        del packs[:]
        verify_rows[0] = 0
        res = serve_pass(eng, prompts, f"{tag} graphed, timed pass", card)
        rows = verify_rows[0]
        peak = peaks()
        timed_packs = list(packs)
        closures = (len(eng._prefill_fns) + len(eng._decode_fns)
                    + len(eng._decode_fallback_fns)
                    + (eng._copy_page_fn is not None))
        bound = eng.max_prefill_compiles() + len(eng._decode_fns) \
            + len(eng._decode_fallback_fns) + 1
        keys = (sorted(eng._prefill_fns), sorted(eng._decode_fns))
        copy_graphed = eng._copy_page_fn is not None and \
            eng._copy_page_fn.graph is not None
        timed_graphs = eng.graphs - graphs
        del eng
        free_cuda()
        eng = PagedEngine(config(plain_sv), params, device="cuda")
        with LogitsRecorder(cfg.vocab_size) as rec_plain:
            plain = serve_pass(eng, prompts, f"{tag} plain (batch-1, no "
                               f"sharing, K=1) graphed, capture pass", card)
        plain_timed = serve_pass(eng, prompts, f"{tag} plain graphed, timed "
                                 f"pass", card)
        if plain_timed["tokens"] != plain["tokens"]:
            raise AssertionError(f"[{tag}] the plain engine's passes "
                                 f"differ")
        del eng
        free_cuda()
    finally:
        PagedEngine._run_pack = run_pack
        PagedEngine._spec_window = spec_window
    m, launches, variants = res["m"], res["launches"], res["variants"]
    log(f"[{tag}] prompts {[len(p) for p in prompts]} (three open with "
        f"one 1024-token system prompt; the third is a copy of the first), "
        f"32 new tokens each; page 16, max_batch 4, budget 1024, "
        f"prefix_sharing, prefill_batching, spec_k 4; {graphs} CUDA graphs "
        f"captured in {capture_s:.2f}s (prefill keys {keys[0]}, decode keys "
        f"{keys[1]}, the page copy {'captured' if copy_graphed else 'not'}; "
        f"bound {bound}), the timed pass captured {timed_graphs} [{card}]")
    if graphs != closures or graphs > bound or not copy_graphed or \
            timed_graphs:
        raise AssertionError(f"[{tag}] {graphs} graphs for {closures} "
                             f"closures (bound {bound}), page copy captured "
                             f"{copy_graphed}, {timed_graphs} more in the "
                             f"timed pass")
    if not (rec_new.finite and rec_plain.finite):
        raise AssertionError(f"[{tag}] non-finite logits")
    for label, r in (("capture pass", first), ("timed pass", res)):
        if r["tokens"] != eager["tokens"]:
            diff = [i for i, (a, b) in enumerate(zip(r["tokens"],
                                                     eager["tokens"]))
                    if a != b]
            raise AssertionError(f"[{tag}] graphed {label} tokens differ "
                                 f"from the eager tokens in requests {diff}")
    verify = variants["paged_decode/verify"]
    packed = variants["paged_prefill/packed"]
    if packed <= 0 or m["spec_calls"] <= 0 or \
            verify != cfg.num_layers * m["spec_calls"] or \
            m["cow_copies"] <= 0 or m["prefix_shared_tokens"] <= 0 or \
            variants["paged_prefill/tc"] != launches["paged_prefill"]:
        raise AssertionError(
            f"[{tag}] timed pass: B3 on packs {packed} times (want > 0), "
            f"B1 on the verify window {verify} "
            f"times (want {cfg.num_layers} x {m['spec_calls']} verify "
            f"steps), cow_copies {m['cow_copies']}, prefix_shared_tokens "
            f"{m['prefix_shared_tokens']}, variants {variants}")
    sizes = sorted({n for n, _ in timed_packs})
    log(f"[{tag}] timed pass: prefill_calls {m['prefill_calls']} for "
        f"{m['prefill_grants']} grants (the plain pass: "
        f"{plain['m']['prefill_calls']} calls), prefill_pad_rows "
        f"{m['prefill_pad_rows']}, packs (rows, padded) {timed_packs} (sizes "
        f"{sizes}); prefix_shared_tokens {m['prefix_shared_tokens']}, "
        f"cow_copies {m['cow_copies']}; peak_used_pages "
        f"{m['peak_used_pages']} (plain pass {plain['m']['peak_used_pages']}"
        f"); spec_calls {m['spec_calls']}, spec_tokens {m['spec_tokens']}, "
        f"accepted_per_call {m['spec_tokens'] / m['spec_calls']:.4f} (the "
        f"call's requests summed; {m['spec_tokens'] / rows:.4f} tokens a "
        f"request a verify call over {rows} request-calls), "
        f"decode_calls {m['decode_calls']}; launches {launches}; variants "
        f"{variants} [{card}]")
    for label, r, pk in (("eager (logits recorded)", eager, eager_peak),
                         ("graphed", res, peak),
                         ("plain graphed (timed pass)", plain_timed, None)):
        rm = r["m"]
        mem = "" if pk is None else (f", peak memory allocated {pk[0]:.3f} "
                                     f"GiB, reserved {pk[1]:.3f} GiB")
        log(f"[{tag}] {label}: prefill "
            f"{rm['prefill_tokens'] / rm['prefill_s']:.2f} tok/s, decode "
            f"{1e3 * rm['decode_s'] / rm['decode_calls']:.3f} ms/step, "
            f"{1e3 * rm['decode_s'] / rm['decode_tokens']:.3f} ms a decode "
            f"token ({rm['decode_tokens'] / rm['decode_calls']:.3f} tokens a "
            f"step), dispatch share prefill "
            f"{rm['prefill_dispatch_s'] / rm['prefill_s']:.3f} decode "
            f"{rm['decode_dispatch_s'] / rm['decode_s']:.3f}, host "
            f"{1e3 * rm['decode_dispatch_s'] / rm['decode_calls']:.3f} ms a "
            f"decode step{mem} [{card}]")
    # the bf16 rule: tokens equal to the plain path's, or diverging first
    # at a near-tie of the plain path that moved within the tolerance
    report[f"{tag}_vs_plain"] = check_against_plain(
        tag, TOL["bfloat16"], plain, eager, rec_plain, rec_new, card,
        enforce=enforce_plain)
    if enforce_plain:
        log(f"[{tag}] every difference from the plain engine starts at a "
            f"near-tie of the plain path; graphed == eager tokens (both "
            f"passes)")
    if tag == "defaults":
        # phase 9 (a) holds the disaggregated pass against this eager pass
        report["defaults_eager"] = (eager, rec_new)
        report["launches"].update(launches)
        # B2's kernel-line count: the launches in which its fold ran
        report["launches"]["decode_reduce"] = variants["paged_decode/fold"]
    pm = plain_timed["m"]
    report[tag] = dict(
        prefill_tok_s=m["prefill_tokens"] / m["prefill_s"],
        decode_ms_step=1e3 * m["decode_s"] / m["decode_calls"],
        peak_gib=peak[0], eager_peak_gib=eager_peak[0],
        plain_prefill_tok_s=pm["prefill_tokens"] / pm["prefill_s"],
        plain_decode_ms_step=1e3 * pm["decode_s"] / pm["decode_calls"])


def serve_defaults_fp32(report, card: str, lengths,
                        arch: str = "qwen3-8b"):
    """The defaults pass's decisions in fp32, where a wrong pack, window or
    shared page cannot hide in bf16 rounding: qwen3-8b at full width cut to
    2 layers (``arch``: qwen3-8b, or paper-30b for its pass), fp32 weights
    made on the card from seed 0, the defaults
    pass's prompts and settings (packs, copy-on-write sharing, a spec_k=4
    window) on an eager engine against a plain one (batch-1, no sharing,
    K=1).  The pass must pack, share, copy and verify as the bf16 pass
    does, its tokens must equal the plain engine's or first differ at an
    fp32 near-tie, and its logits at the plain path's top-2 tokens must lie
    within the fp32 tolerance at every position of a shared context
    (``check_against_plain`` with ``every_position``)."""
    import dataclasses
    import torch
    from repro_torch.config import Config, ISOConfig, ParallelConfig, \
        ServingConfig, get_model_config
    from repro_torch.models import api
    from repro_torch.serving import PagedEngine

    cfg = dataclasses.replace(get_model_config(arch), num_layers=2)
    tag = "defaults fp32" if arch == "qwen3-8b" else f"{arch} fp32"
    params = api.init_params(0, cfg, tp=1, dtype=torch.float32,
                             device="cuda")
    prompts = defaults_prompts(cfg, lengths)
    sv = ServingConfig(page_size=16, max_batch=4, max_len=2048,
                       prefill_token_budget=1024, spec_k=4)
    plain_sv = dataclasses.replace(sv, prefix_sharing=False,
                                   prefill_batching=False, spec_k=0)
    res = {}
    engines = [("defaults", sv), ("plain", plain_sv)]
    if arch == "qwen3-8b":
        # phase 8's gate: the measured cost model changes no token
        engines.append(("auto", dataclasses.replace(sv, cost_table="auto")))
    for name, s in engines:
        eng = PagedEngine(Config(model=cfg,
                                 parallel=ParallelConfig(data=1, model=1),
                                 iso=ISOConfig(), serving=s),
                          params, device="cuda", cuda_graphs=False)
        with LogitsRecorder(cfg.vocab_size) as rec:
            res[name] = serve_pass(eng, prompts, f"{tag} 2-layer {name} "
                                   f"eager", card)
        res[name]["rec"] = rec
        res[name]["decisions"] = sorted(
            {e.payload["point"] for e in eng.trace.events()
             if e.kind == "decision"})
        if not rec.finite:
            raise AssertionError(f"[{tag}] {name}: non-finite logits")
        if name == "auto" and (eng.cost_model is None or
                               res[name]["tokens"] !=
                               res["defaults"]["tokens"]):
            raise AssertionError(f"[{tag}] cost_table='auto' (model "
                                 f"{eng.cost_model}): tokens differ from "
                                 f"the static defaults pass's")
        del eng
    del params
    free_cuda()
    m, variants = res["defaults"]["m"], res["defaults"]["variants"]
    if variants["paged_prefill/packed"] <= 0 or m["spec_calls"] <= 0 or \
            variants["paged_decode/verify"] <= 0 or m["cow_copies"] <= 0 \
            or m["prefix_shared_tokens"] <= 0:
        raise AssertionError(f"[{tag}] the pass did not pack, "
                             f"verify, share and copy: {m}, {variants}")
    log(f"[{tag}] {arch} at full width, 2 layers, fp32: "
        f"prefill_calls {m['prefill_calls']} (plain "
        f"{res['plain']['m']['prefill_calls']}), prefix_shared_tokens "
        f"{m['prefix_shared_tokens']}, cow_copies {m['cow_copies']}, "
        f"spec_calls {m['spec_calls']}, spec_tokens {m['spec_tokens']}, "
        f"B3 on packs {variants['paged_prefill/packed']} times, B1 on the "
        f"verify window {variants['paged_decode/verify']} times [{card}]")
    if "auto" in res:
        am = res["auto"]["m"]
        log(f"[obs] (b) {tag} 2-layer with cost_table='auto': tokens == the "
            f"static defaults pass's on {len(prompts)} of {len(prompts)} "
            f"requests (decision points {res['auto']['decisions']}, verify "
            f"calls {am['spec_calls']} against {m['spec_calls']})")
    report[f"{tag}_vs_plain"] = check_against_plain(
        tag, TOL["float32"], res["plain"], res["defaults"],
        res["plain"]["rec"], res["defaults"]["rec"], card,
        every_position=True)


# ---------------------------------------------------------------------------
# phase 9: disaggregated serving, the ladder twin, the overlap probe
# ---------------------------------------------------------------------------

def router_pass(router, prompts, label: str, card: str) -> dict:
    """Serve ``prompts`` (32 greedy tokens each) through a ``DisaggRouter``
    from zeroed registries, trace rings, router counters and launch counts;
    check that every request completed, both pools pass ``check()`` and
    came back whole, no transfer is left pending, each engine kept to its
    phase (no decode closure on the prefill engine, no prefill closure on
    the decode engine, so B3's launches are the prefill engine's and B1's
    the decode engine's), and both attention kernels launched; print the
    pass."""
    import torch
    from repro_torch.kernels import native
    from repro_torch.serving import Request
    from repro_torch.serving.requests import SamplingParams

    engines = (router.prefill, router.decode)
    for eng in engines:
        reset_observability(eng)
    for k in router.stats:
        router.stats[k] = 0
    rids = [router.add_request(Request(
        prompt=p.copy(), sampling=SamplingParams(max_new_tokens=32,
                                                 eos_id=-1)))
        for p in prompts]
    torch.cuda.synchronize()
    native.reset_launches()
    t0 = time.perf_counter()
    outs = router.run_until_complete()
    wall = time.perf_counter() - t0
    pm, dm = dict(router.prefill.metrics), dict(router.decode.metrics)
    res = dict(tokens=[outs.get(r) for r in rids], rids=rids, pm=pm, dm=dm,
               stats=router.migration_stats(), wall=wall,
               launches=dict(native.LAUNCHES),
               variants=dict(native.VARIANTS),
               detach_us=[e.payload["us"] for e in
                          router.prefill.trace.events()
                          if e.kind == "migrate"])
    if any(t is None or len(t) != 32 for t in res["tokens"]):
        raise AssertionError(f"{label}: not every request completed")
    for eng in engines:
        eng.alloc.check()
        if eng.alloc.free_pages != eng.alloc.num_pages:
            raise AssertionError(f"{label}: {eng.phase} pages leaked")
    if router._pending or router.prefill._decode_fns or \
            router.decode._prefill_fns:
        raise AssertionError(f"{label}: a transfer pending, or an engine "
                             f"ran the other phase")
    for name in ATTENTION_KERNELS:
        if res["launches"][name] <= 0:
            raise AssertionError(f"{label}: kernel {name} never launched: "
                                 f"{res['launches']}")
    log(f"[disagg] {label}: prefill engine {pm['prefill_tokens']} tok in "
        f"{pm['prefill_s']:.3f}s = {pm['prefill_tokens'] / pm['prefill_s']:.2f}"
        f" tok/s ({pm['prefill_calls']} calls); decode engine "
        f"{1e3 * dm['decode_s'] / dm['decode_calls']:.3f} ms/step over "
        f"{dm['decode_calls']} steps ({dm['spec_calls']} verify); "
        f"migration {res['stats']}; wall {wall:.1f}s [{card}]")
    return res


def disagg_config(cfg, prompts):
    """The defaults pass's settings (page 16, max_batch 4, budget 1024,
    sharing, packing, spec_k 4) under ``disagg``, the decode pool one and a
    half times the largest request's pages (its prompt, 32 new tokens and a
    verify window): two of the long requests never fit it together, so the
    router defers."""
    from repro_torch.config import Config, ISOConfig, ParallelConfig, \
        ServingConfig
    from repro_torch.serving.kvcache import pages_for
    need = max(pages_for(len(p) + 32 + 5, 16) for p in prompts)
    sv = ServingConfig(page_size=16, max_batch=4, max_len=2048,
                       prefill_token_budget=1024, spec_k=4, disagg=True,
                       decode_pool_pages=need + need // 2)
    return Config(model=cfg, parallel=ParallelConfig(data=1, model=1),
                  iso=ISOConfig(), serving=sv)


def serve_disagg(report, card: str, cfg, params, lengths) -> None:
    """Phase 9 (a): disaggregated serving of the defaults pass's traffic,
    qwen3-8b at full width and depth, bf16: a ``DisaggRouter`` whose two
    engines share the one set of weights on the card and are both graphed,
    a capture pass (logits recorded), then a timed pass.  Both pools pass
    ``check()`` and come back whole after each pass, the router defers at
    least once, graphed passes agree, no graph is captured in the timed
    pass, and the tokens hold against the single engine's defaults pass
    (eager, phase 3) under the bf16 near-tie rule; the gate is
    ``serve_disagg_fp32``."""
    import torch
    from repro_torch.serving.disagg import DisaggRouter

    prompts = defaults_prompts(cfg, lengths)
    config = disagg_config(cfg, prompts)
    torch.cuda.reset_peak_memory_stats()
    router = DisaggRouter(config, params, prefill_device="cuda",
                          decode_device="cuda")
    leaves = [(router.prefill.params["embed"]["table"],
               router.decode.params["embed"]["table"]),
              (router.prefill.params["periods"][0][-1]["mlp"]["w_down"],
               router.decode.params["periods"][0][-1]["mlp"]["w_down"])]
    if any(a.data_ptr() != b.data_ptr() for a, b in leaves):
        raise AssertionError("[disagg] the two engines hold two copies of "
                             "the weights")
    with LogitsRecorder(cfg.vocab_size) as rec:
        first = router_pass(router, prompts, "graphed, capture pass", card)
    graphs = (router.prefill.graphs, router.decode.graphs)
    capture_s = router.prefill.capture_s + router.decode.capture_s
    res = router_pass(router, prompts, "graphed, timed pass", card)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if (router.prefill.graphs, router.decode.graphs) != graphs:
        raise AssertionError("[disagg] the timed pass captured graphs")
    if res["tokens"] != first["tokens"] or not rec.finite:
        raise AssertionError("[disagg] graphed passes differ, or non-finite "
                             "logits")
    st = res["stats"]
    if st["deferrals"] < 1 or st["migrated_requests"] < len(prompts):
        raise AssertionError(f"[disagg] no deferral, or not every request "
                             f"migrated: {st}")
    page_bytes = router.prefill.kv.page_bytes()
    moved = st["migrated_pages"] * page_bytes
    us = st["migration_us"]
    pm, dm = res["pm"], res["dm"]
    n_pf = len(router.prefill._prefill_fns)
    bound = router.prefill.max_prefill_compiles()
    log(f"[disagg] qwen3-8b {cfg.num_layers}L bf16, prompts "
        f"{[len(p) for p in prompts]}, 32 new tokens each, the defaults "
        f"pass's settings; decode_pool_pages "
        f"{config.serving.decode_pool_pages} (prefill pool "
        f"{router.prefill.alloc.num_pages}); one set of weights under both "
        f"engines (data_ptr equal); graphs prefill {graphs[0]} ({n_pf} "
        f"prefill keys, bound {bound}) and decode {graphs[1]} (keys "
        f"{sorted(router.decode._decode_fns)}) captured in {capture_s:.2f}s; "
        f"deferrals {st['deferrals']}, bounce_backs {st['bounce_backs']} "
        f"[{card}]")
    log(f"[disagg] timed pass: migration_stats {st}; KV moved "
        f"{moved} B ({st['migrated_pages']} pages of {page_bytes} B) to the "
        f"host and back; host migration_us {us:.1f} in all, "
        f"{us / st['migrations']:.1f} a transfer over {st['migrations']} "
        f"transfers (detach side {[round(x, 1) for x in res['detach_us']]}), "
        f"{moved / (us * 1e-6) / 1e9:.3f} GB/s of KV (bytes one way over the "
        f"export and import time); launches {res['launches']} (B3 on the "
        f"prefill engine, B1 on the decode engine, through the replays) "
        f"[{card}]")
    single = report["defaults"]
    log(f"[disagg] timed pass: prefill engine "
        f"{pm['prefill_tokens'] / pm['prefill_s']:.2f} tok/s, decode engine "
        f"{1e3 * dm['decode_s'] / dm['decode_calls']:.3f} ms/step "
        f"({dm['decode_tokens'] / dm['decode_calls']:.3f} tokens a step); "
        f"peak allocated {peak:.3f} GiB; the single engine's graphed "
        f"defaults pass: {single['prefill_tok_s']:.2f} tok/s, "
        f"{single['decode_ms_step']:.3f} ms/step, peak "
        f"{single['peak_gib']:.3f} GiB [{card}]")
    eager, rec_single = report.pop("defaults_eager")
    report["disagg_vs_single"] = check_against_plain(
        "disagg", TOL["bfloat16"], eager, first, rec_single, rec, card)
    report["disagg"] = dict(
        prefill_tok_s=pm["prefill_tokens"] / pm["prefill_s"],
        decode_ms_step=1e3 * dm["decode_s"] / dm["decode_calls"],
        peak_gib=peak, stats=st, moved=moved, launches=res["launches"])
    del router
    free_cuda()


def serve_disagg_fp32(report, card: str, lengths) -> None:
    """Phase 9 (a)'s gate: the same decisions in fp32, qwen3-8b at full
    width cut to 2 layers, eager: the router's tokens must EQUAL the single
    defaults engine's, the logits at its top-2 tokens within the fp32
    tolerance at every position, with at least one deferral."""
    import dataclasses
    import torch
    from repro_torch.config import get_model_config
    from repro_torch.models import api
    from repro_torch.serving import PagedEngine
    from repro_torch.serving.disagg import DisaggRouter

    cfg = dataclasses.replace(get_model_config("qwen3-8b"), num_layers=2)
    params = api.init_params(0, cfg, tp=1, dtype=torch.float32,
                             device="cuda")
    prompts = defaults_prompts(cfg, lengths)
    config = disagg_config(cfg, prompts)
    eng = PagedEngine(config, params, device="cuda", cuda_graphs=False)
    with LogitsRecorder(cfg.vocab_size) as rec_single:
        single = serve_pass(eng, prompts, "disagg fp32 2-layer single "
                            "engine eager", card)
    del eng
    router = DisaggRouter(config, params, prefill_device="cuda",
                          decode_device="cuda", cuda_graphs=False)
    with LogitsRecorder(cfg.vocab_size) as rec:
        res = router_pass(router, prompts, "fp32 2-layer eager", card)
    del router, params
    free_cuda()
    st = res["stats"]
    if res["tokens"] != single["tokens"] or st["deferrals"] < 1:
        raise AssertionError(f"[disagg fp32] tokens differ from the single "
                             f"engine's, or no deferral: {st}")
    report["disagg fp32_vs_single"] = check_against_plain(
        "disagg fp32", TOL["float32"], single, res, rec_single, rec, card,
        every_position=True)
    log(f"[disagg fp32] 2 layers: tokens == the single engine's on "
        f"{len(prompts)} of {len(prompts)} requests; deferrals "
        f"{st['deferrals']}, transfers {st['migrations']}")


def serve_ladder(report, card: str, params, prompts) -> None:
    """Phase 9 (b): ladder-qwen3-8b at full width and depth, bf16, tp=1, on
    phase 3's baseline traffic and settings, with the qwen3-8b weights (the
    twin's layout): an eager engine, a graphed one (capture pass, timed
    pass) on the deferred ``ladder`` schedule, and a graphed ``ladder_seq``
    one.  Graphed tokens must equal eager tokens, ``ladder`` tokens must
    equal ``ladder_seq`` tokens exactly (at tp=1 the same operations), and
    every prefill call must run as one chunk; B1 and B3 launch
    (``serve_pass``).  Prints decode ms/step and prefill tok/s beside phase
    3's standard-wired baseline: the twins do the same FLOPs, so the gap is
    what the wiring costs with no communication to hide."""
    import dataclasses
    from repro_torch.config import Config, ISOConfig, ParallelConfig, \
        ServingConfig, get_model_config
    from repro_torch.models import decoder
    from repro_torch.serving import PagedEngine

    cfg = get_model_config("ladder-qwen3-8b")
    sv = ServingConfig(page_size=16, max_batch=4, max_len=2048,
                       prefill_token_budget=512, prefix_sharing=False,
                       prefill_batching=False)

    def config(s):
        return Config(model=cfg, parallel=ParallelConfig(data=1, model=1),
                      iso=ISOConfig(), serving=s)

    chunks = []
    stack = decoder.run_stack_prefill

    def counted(params_periods, pattern, x_chunks, *args, **kw):
        chunks.append(len(x_chunks))
        return stack(params_periods, pattern, x_chunks, *args, **kw)

    decoder.run_stack_prefill = counted
    runs = {}
    try:
        for label, s, graphed in (
                ("eager", sv, False), ("ladder", sv, True),
                ("ladder_seq", dataclasses.replace(
                    sv, decode_schedule="ladder_seq"), True)):
            eng = PagedEngine(config(s), params, device="cuda",
                              cuda_graphs=graphed)
            want = "ladder_seq" if label == "ladder_seq" else "ladder"
            if eng._decode_schedule != want:
                raise AssertionError(f"[ladder] {label}: schedule "
                                     f"{eng._decode_schedule}")
            passes = [serve_pass(eng, prompts, f"ladder-qwen3-8b {label}"
                                 + (", capture pass" if graphed else ""),
                                 card)]
            if graphed:
                graphs = eng.graphs
                passes.append(serve_pass(eng, prompts, f"ladder-qwen3-8b "
                                         f"{label}, timed pass", card))
                if eng.graphs != graphs:
                    raise AssertionError(f"[ladder] {label}: the timed pass "
                                         f"captured graphs")
            runs[label] = passes
            del eng
            free_cuda()
    finally:
        decoder.run_stack_prefill = stack
    eager = runs["eager"][0]["tokens"]
    for label in ("ladder", "ladder_seq"):
        if any(r["tokens"] != eager for r in runs[label]):
            raise AssertionError(f"[ladder] graphed {label} tokens differ "
                                 f"from the eager tokens")
    if not chunks or set(chunks) != {1}:
        raise AssertionError(f"[ladder] prefill calls by chunk count "
                             f"{sorted(set(chunks))}: want one chunk each")
    base = report["serve"]
    lines = []
    for label in ("ladder", "ladder_seq"):
        m = runs[label][1]["m"]
        lines.append(f"{label} {1e3 * m['decode_s'] / m['decode_calls']:.3f}"
                     f" ms/step, {m['prefill_tokens'] / m['prefill_s']:.2f} "
                     f"tok/s")
        report.setdefault("ladder", {})[label] = dict(
            decode_ms_step=1e3 * m["decode_s"] / m["decode_calls"],
            prefill_tok_s=m["prefill_tokens"] / m["prefill_s"],
            launches=runs[label][1]["launches"])
    log(f"[ladder] ladder-qwen3-8b {cfg.num_layers}L bf16 tp=1, the baseline "
        f"traffic: graphed tokens == eager tokens, ladder == ladder_seq "
        f"tokens exactly; {len(chunks)} prefill calls, each one chunk; timed "
        f"passes: {'; '.join(lines)}; standard-wired qwen3-8b baseline "
        f"(phase 3): {base['decode_ms_step']:.3f} ms/step, "
        f"{base['prefill_tok_s']:.2f} tok/s; launches (ladder, timed) "
        f"{runs['ladder'][1]['launches']} [{card}]")


def probe_engine(eng, prompts, res, label: str, card: str) -> dict:
    """Phase 9 (c): the overlap probe on a served engine, then the same
    prompts again: the tokens of ``res`` and no graph captured."""
    graphs = eng.graphs
    t0 = time.perf_counter()
    probe = eng.measure_overlap_efficiency(iters=10, warmup=3)
    took = time.perf_counter() - t0
    again = serve_pass(eng, prompts, f"{label}, after the probe", card)
    if again["tokens"] != res["tokens"] or eng.graphs != graphs:
        raise AssertionError(f"[probe] {label}: the engine served other "
                             f"tokens, or captured {eng.graphs - graphs} "
                             f"graphs, after the probe")
    finite = [v for k, v in probe.items() if isinstance(v, float)] + \
        list(probe["schedules"].values())
    if not all(math.isfinite(v) for v in finite):
        raise AssertionError(f"[probe] {label}: {probe}")
    log(f"[probe] {label} ({took:.1f}s; tp={probe['tp']}, no collective to "
        f"hide: no overlap claim): {json.dumps(probe)}; graph count and next "
        f"tokens unchanged [{card}]")
    return probe


# ---------------------------------------------------------------------------
# phase 8: observability and the measured cost model
# ---------------------------------------------------------------------------

def trace_stream(events) -> list:
    """A trace as (kind, rid, slot, payload) with its timings removed (the
    ts and dur fields, and the ``us`` of a payload)."""
    return [(e.kind, e.rid, e.slot,
             {k: v for k, v in e.payload.items() if k != "us"})
            for e in events]


def check_replay(eng, label: str) -> dict:
    """Gate: replaying ``eng``'s trace (nothing dropped) gives its
    registry's replayable counters, and the allocator's narration conserves
    the pool.  Returns the replayed counters."""
    from repro_torch.obs import replay_counters
    from repro_torch.obs.replay import REPLAYABLE
    rc = replay_counters(eng.trace.events())
    diff = {k: (rc[k], eng.metrics[k]) for k in REPLAYABLE
            if rc[k] != eng.metrics[k]}
    if eng.trace.dropped or diff or \
            rc["pages_allocated"] - rc["pages_freed"] != eng.alloc.used_pages:
        raise AssertionError(f"[obs] {label}: replay != registry {diff}, "
                             f"dropped {eng.trace.dropped}, pages "
                             f"{rc['pages_allocated']} - {rc['pages_freed']} "
                             f"!= {eng.alloc.used_pages}")
    return rc


def profile_window(eng, prompts, card: str) -> None:
    """Phase 8 (d): a short ``obs.torchprof`` window over ``eng`` serving
    two requests for 4 tokens.  Gates: one host range a closure call, named
    as the reference names them, device kernels under every decode range
    (a replay's kernels carry the correlation id of the graph launch made
    inside the range), the step's ``engine/…`` phase ranges, and no
    device-side copy of any of them (they are host ops' ranges)."""
    import torch
    from repro_torch.obs import torchprof
    from repro_torch.serving import Request
    from repro_torch.serving.requests import SamplingParams

    reset_observability(eng)
    rids = [eng.add_request(Request(prompt=p.copy(), sampling=SamplingParams(
        max_new_tokens=4, eos_id=-1))) for p in prompts[:2]]
    torch.cuda.synchronize()
    torchprof.start(str(ROOT / "build" / "torchprof"))
    try:
        outs = eng.run_until_complete()
    finally:
        path = torchprof.stop()
    if any(len(outs.get(r, ())) != 4 for r in rids):
        raise AssertionError("[obs] profile window: requests incomplete")
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    ranges = [e for e in evs if e.get("cat") == "cpu_op"
              and e["name"].startswith(("decode/K=", "prefill/T="))]
    phases = {e["name"] for e in evs if e.get("cat") == "cpu_op"
              and e["name"].startswith("engine/")}
    calls = eng.metrics["prefill_calls"] + eng.metrics["decode_calls"]
    names = {}
    for e in ranges:
        names[e["name"]] = names.get(e["name"], 0) + 1
    if len(ranges) != calls or not any(n.startswith("decode/K=")
                                       for n in names) \
            or not {"engine/schedule", "engine/decode.launch",
                    "engine/sample"} <= phases:
        raise AssertionError(f"[obs] profile window: ranges {names} for "
                             f"{calls} closure calls, phases {phases}")
    launch = {e["args"]["correlation"]: e for e in evs
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    under = dict.fromkeys(range(len(ranges)), 0)
    for k in evs:
        if k.get("cat") != "kernel":
            continue
        r = launch.get(k["args"].get("correlation"))
        if r is None:
            continue
        for i, a in enumerate(ranges):
            if a["tid"] == r["tid"] and a["ts"] <= r["ts"] <= a["ts"] + a["dur"]:
                under[i] += 1
                break
    by_name = {}
    for i, a in enumerate(ranges):
        by_name.setdefault(a["name"], []).append(under[i])
    empty = [a["name"] for i, a in enumerate(ranges)
             if a["name"].startswith("decode/") and not under[i]]
    if empty:
        raise AssertionError(f"[obs] profile window: no kernels under "
                             f"{empty}")
    gpu = sum(1 for e in evs if e.get("cat") == "gpu_user_annotation")
    if gpu:
        raise AssertionError(f"[obs] profile window: {gpu} device-side "
                             f"copies of host ranges (gpu_user_annotation)")
    log(f"[obs] (d) torch.profiler window ({len(evs)} trace events): "
        f"{len(ranges)} ranges for {calls} closure calls, kernels under "
        f"each range by name {by_name}; phase ranges {sorted(phases)} "
        f"[{card}]")


def serve_observability(report, card: str, cfg, params, lengths) -> None:
    """Phase 8 on qwen3-8b at full width and depth, bf16, tp=1, graphed, at
    the defaults pass's settings: (a) ``autotune(smoke=True)`` and its
    table; (b) the defaults pass with ``cost_table="auto"`` (the bundled
    ``h100_tp1.json``) beside a static defaults engine in this phase,
    decisions by point, verify calls, decode ms/step and prefill tok/s (the
    tokens printed against the static pass's, not enforced: the fp32
    2-layer modeled pass is the gate); (c) on the graphed timed pass, trace
    replay == registry, the Chrome trace written under ``build/`` and
    validated, the host time inside the ring's emit, decode ms/step with
    the ring on and off in turns; (d) a ``torch.profiler`` window through
    ``obs.torchprof``."""
    import dataclasses
    from collections import Counter
    import torch
    from repro_torch.config import Config, ISOConfig, ParallelConfig, \
        ServingConfig
    from repro_torch.obs import validate_chrome_trace, write_chrome_trace
    from repro_torch.perf.costmodel import autotune, validate_table
    from repro_torch.serving import PagedEngine

    sv = ServingConfig(page_size=16, max_batch=4, max_len=2048,
                       prefill_token_budget=1024, spec_k=4)

    def config(s):
        return Config(model=cfg, parallel=ParallelConfig(data=1, model=1),
                      iso=ISOConfig(), serving=s)

    t0 = time.perf_counter()
    table = autotune(config(sv), params, smoke=True, device="cuda")
    tune_s = time.perf_counter() - t0
    problems = validate_table(table)
    free_cuda()
    if problems:
        raise AssertionError(f"[obs] (a) autotune table invalid: {problems}")
    log(f"[obs] (a) autotune(smoke=True), qwen3-8b {cfg.num_layers}L bf16 "
        f"at the defaults pass's settings: {tune_s:.2f}s, "
        f"{len(table['prefill_us'])} prefill + {len(table['decode_us'])} "
        f"decode points, alpha {table['alpha_beta']['alpha_s']:.3e} s, "
        f"beta {table['alpha_beta']['beta_s_per_byte']:.3e} s/B "
        f"({table['alpha_beta']['collective']}); prefill us "
        f"{ {k: round(v) for k, v in table['prefill_us'].items()} }; "
        f"decode us {  {k: round(v) for k, v in table['decode_us'].items()} }"
        f" [{card}]")

    prompts = defaults_prompts(cfg, lengths)
    passes = {}
    for name, s in (("static", sv),
                    ("auto", dataclasses.replace(sv, cost_table="auto"))):
        eng = PagedEngine(config(s), params, device="cuda")
        warns = [e.payload for e in eng.trace.events() if e.kind == "warning"
                 and e.payload["what"] == "cost_table"]
        if warns or (name == "auto") != (eng.cost_model is not None):
            raise AssertionError(f"[obs] (b) {name}: cost table warnings "
                                 f"{warns}, model {eng.cost_model}")
        serve_pass(eng, prompts, f"obs {name} graphed, capture pass", card)
        res = serve_pass(eng, prompts, f"obs {name} graphed, timed pass",
                         card)
        res["decisions"] = Counter(e.payload["point"]
                                   for e in eng.trace.events()
                                   if e.kind == "decision")
        res["events"] = len(eng.trace)
        res["rc"] = check_replay(eng, f"{name} timed pass")
        passes[name] = res
        if name == "static":
            del eng
            free_cuda()
    cm = eng.cost_model
    log(f"[obs] (b) cost_table='auto' loaded {cm.platform}/tp{cm.tp} "
        f"({len(cm.table['prefill_us'])} prefill + "
        f"{len(cm.table['decode_us'])} decode points, measured on "
        f"{cm.table.get('device')}, {cm.table.get('power_limit')}), no "
        f"warning")
    for name, r in passes.items():
        m = r["m"]
        log(f"[obs] (b) {name} defaults pass, timed: decisions by point "
            f"{dict(sorted(r['decisions'].items()))}; verify calls "
            f"{m['spec_calls']} of {m['decode_calls']} decode steps, steps "
            f"by S {r['splits']}; decode "
            f"{1e3 * m['decode_s'] / m['decode_calls']:.3f} ms/step, prefill "
            f"{m['prefill_tokens'] / m['prefill_s']:.2f} tok/s, "
            f"prefill_calls {m['prefill_calls']}, {r['events']} trace events "
            f"({r['events'] / m['decode_calls']:.2f} a decode step) [{card}]")
    same = [a == b for a, b in zip(passes["auto"]["tokens"],
                                   passes["static"]["tokens"])]
    log(f"[obs] (b) bf16 auto vs static tokens (printed, not enforced: "
        f"bf16 near-ties, the fp32 2-layer pass is the gate): "
        f"{sum(same)} of {len(same)} requests equal")

    # (c) the Chrome trace of the auto timed pass, then the ring off and on
    trace_path = ROOT / "build" / "phase8_trace.json"
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    n = write_chrome_trace(eng.trace.events(), str(trace_path))
    with open(trace_path) as f:
        problems = validate_chrome_trace(json.load(f))
    if problems:
        raise AssertionError(f"[obs] (c) Chrome trace invalid: "
                             f"{problems[:3]}")
    # the host time inside the ring's emit (every emitter shares the ring)
    emit, spent = eng.trace.emit, [0.0, 0]

    def timed_emit(*args, **kw):
        t = time.perf_counter()
        emit(*args, **kw)
        spent[0] += time.perf_counter() - t
        spent[1] += 1

    eng.trace.emit = timed_emit
    try:
        r = serve_pass(eng, prompts, "obs auto, emits timed", card)
    finally:
        del eng.trace.emit
    steps = r["m"]["decode_calls"] + r["m"]["prefill_calls"]
    emit_us = 1e6 * spent[0] / steps
    # the ring off and on in turns (the timed pass above was the first on)
    ms = {True: [1e3 * passes["auto"]["m"]["decode_s"]
                 / passes["auto"]["m"]["decode_calls"]], False: []}
    for on in (False, True, False, True):
        eng.trace.enabled = on
        label = "on" if on else "off"
        r = serve_pass(eng, prompts, f"obs auto, ring {label}", card)
        if r["tokens"] != passes["auto"]["tokens"]:
            raise AssertionError(f"[obs] (c) ring {label}: tokens changed")
        ms[on].append(1e3 * r["m"]["decode_s"] / r["m"]["decode_calls"])
        if on:
            check_replay(eng, "ring on again")
        elif len(eng.trace):
            raise AssertionError("[obs] (c) the disabled ring recorded")
    log(f"[obs] (c) replay == registry on every timed pass "
        f"({ {k: v for k, v in passes['auto']['rc'].items() if v} }); Chrome "
        f"trace of {n} events -> {trace_path.relative_to(ROOT)}, valid; "
        f"host time inside emit {emit_us:.2f} us a closure call "
        f"({spent[1]} events in {1e6 * spent[0]:.0f} us, "
        f"{1e6 * spent[0] / spent[1]:.3f} us an event); decode ms/step "
        f"with the ring on {[round(x, 3) for x in ms[True]]}, off "
        f"{[round(x, 3) for x in ms[False]]} (in turns: on, off, on, off, "
        f"on) [{card}]")
    profile_window(eng, prompts, card)
    pm, sm = passes["auto"]["m"], passes["static"]["m"]
    report["obs"] = dict(
        autotune_s=tune_s, decisions=dict(passes["auto"]["decisions"]),
        spec_calls=pm["spec_calls"], static_spec_calls=sm["spec_calls"],
        decode_ms_step=1e3 * pm["decode_s"] / pm["decode_calls"],
        static_decode_ms_step=1e3 * sm["decode_s"] / sm["decode_calls"],
        ring_on_ms=ms[True], ring_off_ms=ms[False], emit_us=emit_us)
    del eng
    free_cuda()


# ---------------------------------------------------------------------------
# phase 10: the dense-cache Engine, qwen3-8b and whisper-medium
# ---------------------------------------------------------------------------

def dense_pass(eng, prompts, label: str, card: str, frames=None,
               max_new: int = 32, patches=None) -> dict:
    """Serve ``prompts`` (greedy, ``max_new`` tokens each; with ``frames``
    for whisper, ``patches`` for a vlm) on a dense ``Engine`` from a zeroed
    registry and launch
    counts; check that every request completed, every sampled logits row was
    finite and no hand-written kernel launched (dense caches attend in plain
    PyTorch, as the reference's in XLA); print the pass."""
    import numpy as np
    import torch
    from repro_torch.kernels import native
    from repro_torch.serving import Request, engine
    from repro_torch.serving.requests import SamplingParams

    reset_observability(eng)
    rids = [eng.add_request(Request(
        prompt=p.copy(), frames=None if frames is None else frames[i],
        patches=None if patches is None else patches[i],
        sampling=SamplingParams(max_new_tokens=max_new, eos_id=-1)))
        for i, p in enumerate(prompts)]
    real_sample = engine.sample
    rows = [0]

    def finite_sample(logits, sp, step):
        if not np.isfinite(logits).all():
            raise AssertionError(f"{label}: non-finite logits")
        rows[0] += 1
        return real_sample(logits, sp, step)

    real_decode = eng._decode

    def finite_decode(toks, name):            # verify windows' rows too
        logits, dur, t0 = real_decode(toks, name)
        if not np.isfinite(logits).all():
            raise AssertionError(f"{label}: non-finite decode logits")
        return logits, dur, t0

    torch.cuda.synchronize()
    native.reset_launches()
    engine.sample = finite_sample
    eng._decode = finite_decode
    t0 = time.perf_counter()
    try:
        outs = eng.run_until_complete()
    finally:
        engine.sample = real_sample
        del eng._decode
    wall = time.perf_counter() - t0
    launches = dict(native.LAUNCHES)
    m = dict(eng.metrics)
    tokens = [outs.get(r) for r in rids]
    if any(t is None or len(t) != max_new for t in tokens) or \
            m["completed"] != len(prompts):
        raise AssertionError(f"{label}: not every request completed: {m}")
    if any(launches.values()):
        raise AssertionError(f"{label}: the dense path launched "
                             f"hand-written kernels: {launches}")
    log(f"[dense] {label}: prefill {m['prefill_tokens']} tok in "
        f"{m['prefill_s']:.3f}s = {m['prefill_tokens'] / m['prefill_s']:.1f} "
        f"tok/s ({m['prefill_calls']} calls); decode "
        f"{1e3 * m['decode_s'] / m['decode_calls']:.3f} ms/step over "
        f"{m['decode_calls']} steps ({m['spec_calls']} verify); host "
        f"dispatch share prefill "
        f"{m['prefill_dispatch_s'] / m['prefill_s']:.3f}, decode "
        f"{m['decode_dispatch_s'] / m['decode_s']:.3f}; TTFT mean "
        f"{1e3 * m['ttft_sum'] / m['ttft_n']:.1f} ms, max "
        f"{1e3 * eng.registry.histogram('ttft').max:.1f} ms; {rows[0]} "
        f"sampled logits rows finite (and every decode call's); wall "
        f"{wall:.1f}s; {eng.graphs} CUDA graphs captured so far "
        f"({eng.capture_s:.2f}s); launches of the hand-written kernels 0 "
        f"[{card}]")
    return dict(tokens=tokens, m=m, wall=wall, launches=launches,
                graphs=eng.graphs)


def dense_eager_then_graphed(config, params, prompts, label: str, card: str,
                             tag: str = "dense", frames=None, **kw) -> dict:
    """``prompts`` on an eager dense ``Engine`` (``cuda_graphs=False``),
    then on a graphed one (a capture pass, a timed pass of replays only),
    ``dense_pass`` each; ``kw`` are the engines' settings.  The graphed
    tokens must equal the eager ones on both passes and the timed pass must
    capture nothing.  Prints (under ``[tag]``) the timed pass beside the
    eager one, the graph count, the capture seconds and the peak allocated
    memory of each engine; returns the timed pass (``dense_pass``'s dict,
    with ``eager``, ``graphs``, ``capture_s``, the two peaks and the dense
    caches' GiB)."""
    import torch
    from repro_torch.serving import Engine

    held = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(config, params, device="cuda", cuda_graphs=False, **kw)
    eager = dense_pass(eng, prompts, f"{label} eager", card, frames=frames)
    eager_peak = torch.cuda.max_memory_allocated() / 2**30
    caches_gib = sum(t.numel() * t.element_size() for c in eng.caches
                     for t in c.values()) / 2**30
    del eng
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(config, params, device="cuda", **kw)
    first = dense_pass(eng, prompts, f"{label} graphed, capture pass", card,
                       frames=frames)
    graphs, capture_s = eng.graphs, eng.capture_s
    timed = dense_pass(eng, prompts, f"{label} graphed, timed pass", card,
                       frames=frames)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if eng.graphs != graphs or graphs == 0:
        raise AssertionError(f"[{tag}] {label}: {graphs} graphs captured by "
                             f"the capture pass, {eng.graphs - graphs} by "
                             f"the timed pass")
    keys = sorted(eng._prefill_fns), sorted(eng._decode_fns)
    del eng
    free_cuda()
    for name, r in (("capture pass", first), ("timed pass", timed)):
        if r["tokens"] != eager["tokens"]:
            diff = [i for i, (a, b) in enumerate(zip(r["tokens"],
                                                     eager["tokens"]))
                    if a != b]
            raise AssertionError(f"[{tag}] {label}: graphed {name} tokens "
                                 f"differ from the eager tokens in requests "
                                 f"{diff}")
    m, em = timed["m"], eager["m"]
    log(f"[{tag}] {label}: graphed == eager tokens (both passes); {graphs} "
        f"CUDA graphs (prefill keys {keys[0]}, decode windows {keys[1]}) "
        f"captured in {capture_s:.2f}s; timed pass: prefill "
        f"{m['prefill_tokens'] / m['prefill_s']:.1f} tok/s (eager "
        f"{em['prefill_tokens'] / em['prefill_s']:.1f}), decode "
        f"{1e3 * m['decode_s'] / m['decode_calls']:.3f} ms/step (eager "
        f"{1e3 * em['decode_s'] / em['decode_calls']:.3f}), decode dispatch "
        f"share {m['decode_dispatch_s'] / m['decode_s']:.4f} (eager "
        f"{em['decode_dispatch_s'] / em['decode_s']:.4f}), prefill dispatch "
        f"share {m['prefill_dispatch_s'] / m['prefill_s']:.4f} (eager "
        f"{em['prefill_dispatch_s'] / em['prefill_s']:.4f}); peak allocated "
        f"{eager_peak:.3f} GiB eager, {peak:.3f} GiB graphed ({held:.3f} GiB "
        f"allocated before the passes, weights included; dense caches "
        f"{caches_gib:.3f} GiB) [{card}]")
    return dict(timed, eager=eager, graphs=graphs, capture_s=capture_s,
                eager_peak=eager_peak, peak=peak, caches_gib=caches_gib)


def dense_figures(r) -> dict:
    """The report's figures of a ``dense_eager_then_graphed`` result."""
    out = {}
    for name, p in (("", r), ("eager_", r["eager"])):
        m = p["m"]
        out.update({f"{name}prefill_tok_s": m["prefill_tokens"] /
                    m["prefill_s"],
                    f"{name}decode_ms_step": 1e3 * m["decode_s"] /
                    m["decode_calls"],
                    f"{name}decode_dispatch_share": m["decode_dispatch_s"] /
                    m["decode_s"]})
    return dict(out, graphs=r["graphs"], capture_s=r["capture_s"],
                peak_gib=r["peak"], eager_peak_gib=r["eager_peak"])


def serve_dense(report, card: str):
    """Phase 10 (a): qwen3-8b at full width and depth, bf16, through the
    dense ``Engine`` (max_batch 4, max_len 2048, bucket 64) on phase 3's six
    prompts, eager and then graphed (``dense_eager_then_graphed``); then the
    gate in fp32 at full width cut to 2 layers, graphed: the dense engine's
    tokens equal a plain ``PagedEngine``'s (batch-1, no sharing, K=1,
    eager) and a spec_k=4 dense engine's."""
    import dataclasses
    import torch
    from repro_torch.config import Config, ISOConfig, ParallelConfig, \
        ServingConfig, get_model_config
    from repro_torch.models import api
    from repro_torch.serving import Engine, PagedEngine

    cfg = get_model_config("qwen3-8b")
    lengths, prompts = baseline_prompts(cfg)
    config = Config(model=cfg, parallel=ParallelConfig(data=1, model=1),
                    iso=ISOConfig())
    params = api.init_params(0, cfg, tp=1, dtype=torch.bfloat16,
                             device="cuda")
    torch.cuda.synchronize()
    r = dense_eager_then_graphed(config, params, prompts, "qwen3-8b bf16",
                                 card, max_batch=4, max_len=2048, bucket=64)
    report["dense_qwen3_8b"] = dense_figures(r)
    log(f"[dense] qwen3-8b bf16 {cfg.num_layers}L: prompts {lengths} "
        f"[{card}]")
    del params
    free_cuda()

    cfg2 = dataclasses.replace(cfg, num_layers=2)
    config2 = dataclasses.replace(config, model=cfg2)
    params = api.init_params(0, cfg2, tp=1, dtype=torch.float32,
                             device="cuda")
    out = {}
    for name, spec_k in (("dense", 0), ("dense spec_k=4", 4)):
        eng = Engine(config2, params, max_batch=4, max_len=2048, bucket=64,
                     spec_k=spec_k, device="cuda")
        out[name] = dense_pass(eng, prompts, f"qwen3-8b fp32 2-layer {name}",
                               card)
        del eng
    if out["dense spec_k=4"]["m"]["spec_calls"] <= 0:
        raise AssertionError("the spec_k=4 dense engine ran no verify step")
    if not all(out[name]["graphs"] for name in out):
        raise AssertionError("[dense] fp32 gate: an engine captured no graph")
    sv = ServingConfig(page_size=16, max_batch=4, max_len=2048,
                       prefill_token_budget=512, prefix_sharing=False,
                       prefill_batching=False)
    paged = PagedEngine(dataclasses.replace(config2, serving=sv), params,
                        device="cuda", cuda_graphs=False)
    out["paged"] = serve_pass(paged, prompts, "qwen3-8b fp32 2-layer paged "
                              "eager (the gate's reference)", card)
    del paged, params
    free_cuda()
    want = out["paged"]["tokens"]
    for name in ("dense", "dense spec_k=4"):
        got = out[name]["tokens"]
        if got != want:
            diff = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
            raise AssertionError(f"[dense] fp32 gate: the {name} engine's "
                                 f"tokens differ from PagedEngine's in "
                                 f"requests {diff}")
    log(f"[dense] gate: qwen3-8b fp32 2-layer, the graphed dense Engine's "
        f"tokens == PagedEngine's == the graphed spec_k=4 dense Engine's on "
        f"{len(prompts)} of {len(prompts)} requests "
        f"({out['dense spec_k=4']['m']['spec_calls']} verify steps, "
        f"{out['dense spec_k=4']['m']['spec_accepted']} drafts accepted) "
        f"[{card}]")


def serve_whisper(report, card: str):
    """Phase 10 (b): whisper-medium at full width and depth (24 + 24 layers),
    bf16, through the dense ``Engine`` (max_batch 4, max_len ``N_TEXT_CTX``
    448, bucket 64), eager and then graphed (``dense_eager_then_graphed``):
    4 requests with seeded frames of (1500, 1024) x 0.1 (float32, as the
    reference's launcher makes them) and prompts of 4-64 tokens, 32 new
    tokens each; the encoder timed alone on one request.  Then the gate in
    fp32 at 2 + 2 layers, graphed: the engine's tokens equal the argmax of
    a teacher-forced prefill over prompt + generated tokens."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.config import Config, ISOConfig, ParallelConfig, \
        get_model_config
    from repro_torch.configs.whisper_medium import N_TEXT_CTX
    from repro_torch.core.overlap import AxisCtx
    from repro_torch.models import api, whisper
    from repro_torch.serving import Engine

    cfg = get_model_config("whisper-medium")
    prompts, frames = whisper_traffic(cfg)
    config = Config(model=cfg, parallel=ParallelConfig(data=1, model=1),
                    iso=ISOConfig())
    params = api.init_params(0, cfg, tp=1, dtype=torch.bfloat16,
                             device="cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    f0 = torch.from_numpy(frames[0]).to("cuda")[None]
    enc_ms = []
    for _ in range(4):
        t0 = time.perf_counter()
        enc = whisper.encode(params, cfg, AxisCtx(), config.iso, f0)
        torch.cuda.synchronize()
        enc_ms.append(1e3 * (time.perf_counter() - t0))
    if not torch.isfinite(enc).all():
        raise AssertionError("[whisper] non-finite encoder output")
    del enc
    r = dense_eager_then_graphed(config, params, prompts,
                                 "whisper-medium bf16", card, frames=frames,
                                 max_batch=4, max_len=N_TEXT_CTX, bucket=64)
    report["dense_whisper"] = dict(dense_figures(r),
                                   encoder_ms=sorted(enc_ms[1:])[1])
    log(f"[whisper] whisper-medium {cfg.encoder_layers}+{cfg.num_layers}L "
        f"d={cfg.d_model}: {n_params / 1e9:.4f}B parameters (reference "
        f"count {cfg.param_count() / 1e9:.4f}B), prompts "
        f"{[len(p) for p in prompts]}: encoder ({cfg.encoder_frames} frames, "
        f"float32 "
        f"activations on bf16 weights) {[round(t, 2) for t in enc_ms]} ms a "
        f"request (the first with warm-up) [{card}]")
    del params, f0
    free_cuda()

    cfg2 = dataclasses.replace(cfg, num_layers=2, encoder_layers=2)
    config2 = dataclasses.replace(config, model=cfg2)
    params = api.init_params(0, cfg2, tp=1, dtype=torch.float32,
                             device="cuda")
    eng = Engine(config2, params, max_batch=4, max_len=N_TEXT_CTX, bucket=64,
                 device="cuda")
    gate = dense_pass(eng, prompts, "whisper-medium fp32 2+2-layer", card,
                      frames=frames)
    got = gate["tokens"]
    del eng
    if not gate["graphs"]:
        raise AssertionError("[whisper] fp32 gate: the engine captured no "
                             "graph")
    for i, (p, f) in enumerate(zip(prompts, frames)):
        seq = torch.from_numpy(np.concatenate([p, got[i]]).astype(
            np.int32)).to("cuda")[None]
        out = api.prefill(params, cfg2, AxisCtx(), config2.iso,
                          {"frames": torch.from_numpy(f).to("cuda")[None],
                           "tokens": seq})
        forced = out["logits_local"][0, len(p) - 1:-1, :cfg.vocab_size]
        if not torch.isfinite(forced).all() or \
                forced.argmax(-1).tolist() != got[i]:
            raise AssertionError(
                f"[whisper] fp32 gate: request {i}'s tokens differ from the "
                f"teacher-forced argmax {forced.argmax(-1).tolist()} vs "
                f"{got[i]}")
    del params
    free_cuda()
    log(f"[whisper] gate: whisper-medium fp32 2+2-layer, the graphed "
        f"engine's tokens "
        f"== the argmax of a teacher-forced prefill over prompt + generated "
        f"on {len(prompts)} of {len(prompts)} requests [{card}]")


def dense_profiles(report, card: str):
    """Phase 10 (c), last in the script (a ``torch.profiler`` window leaves
    a host cost on later work): where the graphed dense path's time goes.
    For qwen3-8b (phase 3's first four prompts) and whisper-medium (phase
    10 (b)'s traffic), bf16, full width and depth, on a graphed engine
    after a capture pass of the same requests: one engine step that
    prefills four requests (and decodes once), then four decode steps, each
    window under ``torch.profiler`` with CUDA activities and capturing no
    graph; printed: the wall time, the device's busy time (the union of its
    intervals) and idle share a step, and the names that took the most
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.config import Config, ISOConfig, ParallelConfig, \
        get_model_config
    from repro_torch.configs.whisper_medium import N_TEXT_CTX
    from repro_torch.models import api
    from repro_torch.serving import Engine, Request
    from repro_torch.serving.requests import SamplingParams

    for arch in ("qwen3-8b", "whisper-medium"):
        cfg = get_model_config(arch)
        if arch == "qwen3-8b":
            prompts = baseline_prompts(cfg)[1][:4]
            frames, max_len = [None] * 4, 2048
        else:
            prompts, frames = whisper_traffic(cfg)
            max_len = N_TEXT_CTX
        params = api.init_params(0, cfg, tp=1, dtype=torch.bfloat16,
                                 device="cuda")
        eng = Engine(Config(model=cfg, parallel=ParallelConfig(data=1,
                                                               model=1),
                            iso=ISOConfig()), params, max_batch=4,
                     max_len=max_len, bucket=64, device="cuda")

        def submit():
            for p, f in zip(prompts, frames):
                eng.add_request(Request(prompt=p.copy(), frames=f,
                                        sampling=SamplingParams(
                                            max_new_tokens=8, eos_id=-1)))

        submit()                                 # the capture pass
        eng.run_until_complete()
        graphs = eng.graphs
        submit()
        torch.cuda.synchronize()
        out = {}
        for window, steps in (("prefill step", 1), ("decode steps", 4)):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(steps):
                    eng.step()
                torch.cuda.synchronize()
                wall = 1e3 * (time.perf_counter() - t0) / steps
            act = device_activity(prof)
            busy = act["busy_ms"] / steps
            out[window] = dict(wall_ms=wall, busy_ms=busy,
                               idle_share=1 - busy / wall)
            log(f"[dense] {arch} bf16 graphed profile, {window} ({steps} "
                f"step(s), 4 requests, {graphs} graphs replayed): "
                f"{wall:.3f} ms of wall a step, device busy {busy:.3f} ms, "
                f"idle share {1 - busy / wall:.3f} [{card}]")
            log_top(f"{arch} dense {window}", act, steps, card)
        eng.run_until_complete()
        if eng.graphs != graphs:
            raise AssertionError(f"[dense] {arch} profile: the profiled "
                                 f"steps captured {eng.graphs - graphs} "
                                 f"graphs")
        report[f"dense_profile_{arch}"] = out
        del eng, params
        free_cuda()


def whisper_traffic(cfg):
    """Phase 10 (b)'s four requests: prompts of 4-64 tokens and seeded
    frames of (encoder_frames, d_model) x 0.1, float32 (seed 10)."""
    import numpy as np
    rng = np.random.default_rng(10)
    prompts = [rng.integers(2, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(4, 65, 4)]
    frames = [(rng.standard_normal((cfg.encoder_frames, cfg.d_model)) * 0.1
               ).astype(np.float32) for _ in prompts]
    return prompts, frames


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# phase 11: the MoE family, granite-moe-3b-a800m and kimi-k2-1t-a32b
# ---------------------------------------------------------------------------

# phase 3's baseline settings (batch-1 grants, no sharing, K=1) and the
# reference's defaults at spec_k 4 (packs, copy-on-write sharing), as in
# serve_full and serve_defaults
MOE_BASELINE = dict(page_size=16, max_batch=4, max_len=2048,
                    prefill_token_budget=512, prefix_sharing=False,
                    prefill_batching=False)
MOE_DEFAULTS = dict(page_size=16, max_batch=4, max_len=2048,
                    prefill_token_budget=1024, spec_k=4)
KIMI_LAYERS = 1          # of kimi-k2-1t-a32b's 61: one layer fits one card


def moe_config(cfg, sv: dict):
    from repro_torch.config import Config, ISOConfig, ParallelConfig, \
        ServingConfig
    return Config(model=cfg, parallel=ParallelConfig(data=1, model=1),
                  iso=ISOConfig(), serving=ServingConfig(**sv))


def eager_then_graphed(cfg, params, sv: dict, prompts, label: str, card: str,
                       new: int = 32, kernels=ATTENTION_KERNELS,
                       tag: str = "moe", keep: bool = False,
                       patches=None) -> dict:
    """``prompts`` on an eager engine, then on a graphed one (a capture
    pass, a timed pass of replays only), ``serve_pass`` each (``kernels``:
    those it must see launched); the graphed tokens must equal the eager
    ones on both passes and the timed pass must capture nothing.  Prints
    (under ``[tag]``) the timed pass beside the eager one, the peak
    allocated memory of each engine, the graph count and the capture
    seconds; returns the timed pass (``serve_pass``'s dict, with
    ``eager``, ``graphs``, ``capture_s`` and the two peaks, and with
    ``keep`` the graphed engine, ``engine``, left alive for a later
    profile)."""
    import torch
    from repro_torch.serving import PagedEngine

    config = moe_config(cfg, sv)
    held = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    eng = PagedEngine(config, params, device="cuda", cuda_graphs=False)
    eager = serve_pass(eng, prompts, f"{label} eager", card, new, kernels,
                       patches)
    eager_peak = torch.cuda.max_memory_allocated() / 2**30
    del eng
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    eng = PagedEngine(config, params, device="cuda")
    first = serve_pass(eng, prompts, f"{label} graphed, capture pass", card,
                       new, kernels, patches)
    graphs, capture_s = eng.graphs, eng.capture_s
    timed = serve_pass(eng, prompts, f"{label} graphed, timed pass", card,
                       new, kernels, patches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if eng.graphs != graphs:
        raise AssertionError(f"[{tag}] {label}: the timed pass captured "
                             f"{eng.graphs - graphs} graphs")
    kept = eng if keep else None
    del eng
    free_cuda()
    for name, r in (("capture pass", first), ("timed pass", timed)):
        if r["tokens"] != eager["tokens"]:
            diff = [i for i, (a, b) in enumerate(zip(r["tokens"],
                                                     eager["tokens"]))
                    if a != b]
            raise AssertionError(f"[{tag}] {label}: graphed {name} tokens "
                                 f"differ from the eager tokens in requests "
                                 f"{diff}")
    m = timed["m"]
    log(f"[{tag}] {label}: graphed == eager tokens (both passes); {graphs} "
        f"CUDA graphs captured in {capture_s:.2f}s; timed pass: prefill "
        f"{m['prefill_tokens'] / m['prefill_s']:.2f} tok/s, decode "
        f"{1e3 * m['decode_s'] / m['decode_calls']:.3f} ms/step, decode "
        f"dispatch share {m['decode_dispatch_s'] / m['decode_s']:.4f} (eager "
        f"{eager['m']['decode_dispatch_s'] / eager['m']['decode_s']:.4f}), "
        f"prefill dispatch share "
        f"{m['prefill_dispatch_s'] / m['prefill_s']:.4f} (eager "
        f"{eager['m']['prefill_dispatch_s'] / eager['m']['prefill_s']:.4f}),"
        f" launches {timed['launches']}, variants {timed['variants']}; peak "
        f"allocated {eager_peak:.3f} GiB eager, {peak:.3f} GiB graphed "
        f"({held:.3f} GiB allocated before the passes, weights included) "
        f"[{card}]")
    return dict(timed, eager=eager, graphs=graphs, capture_s=capture_s,
                eager_peak=eager_peak, peak=peak, engine=kept)


def serve_granite(report, card: str):
    """Phase 11 (a): granite-moe-3b-a800m at full width and depth (32
    layers, 40 experts top-8, 24/8 heads at hd 64), bf16, tp=1, on phase 3's
    six prompts: the reference's defaults at spec_k 4 on
    ``defaults_prompts`` (packs, prefix sharing, a verify window), then the
    batch-1 baseline, each eager then graphed, graphed tokens equal to
    eager.  The defaults timed pass must run B3 on a pack, B1 on the
    5-token window once a layer of every verify step, and share and copy
    pages; both timed passes must launch B1 and B3 (``serve_pass``)."""
    import torch
    from repro_torch.config import get_model_config
    from repro_torch.models import api

    cfg = get_model_config("granite-moe-3b-a800m")
    t0 = time.perf_counter()
    params = api.init_params(0, cfg, tp=1, dtype=torch.bfloat16,
                             device="cuda")
    torch.cuda.synchronize()
    log(f"[moe] granite-moe-3b-a800m {cfg.num_layers}L d={cfg.d_model} Hq/"
        f"Hkv {cfg.num_heads}/{cfg.num_kv_heads} hd {cfg.resolved_head_dim}, "
        f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k} d_ff "
        f"{cfg.moe.d_ff_expert} capacity {cfg.moe.capacity_factor}: "
        f"{cfg.param_count() / 1e9:.4f}B params "
        f"({cfg.param_count(active_only=True) / 1e9:.4f}B active a token) "
        f"bf16 made on the card in {time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated [{card}]")
    lengths = report["lengths"]
    _, prompts = baseline_prompts(cfg)
    d = eager_then_graphed(cfg, params, MOE_DEFAULTS,
                           defaults_prompts(cfg, lengths),
                           "granite defaults (packs, sharing, spec_k 4)",
                           card)
    m, v = d["m"], d["variants"]
    if v["paged_prefill/packed"] <= 0 or m["spec_calls"] <= 0 or \
            v["paged_decode/verify"] != cfg.num_layers * m["spec_calls"] or \
            m["cow_copies"] <= 0 or m["prefix_shared_tokens"] <= 0:
        raise AssertionError(f"[moe] granite defaults timed pass did not "
                             f"pack, verify once a layer, share and copy: "
                             f"{m}, {v}")
    log(f"[moe] granite defaults timed pass: prefill_calls "
        f"{m['prefill_calls']} for {m['prefill_grants']} grants, B3 on packs "
        f"{v['paged_prefill/packed']} times, prefix_shared_tokens "
        f"{m['prefix_shared_tokens']}, cow_copies {m['cow_copies']}, "
        f"spec_calls {m['spec_calls']}, spec_tokens {m['spec_tokens']}, B1 "
        f"on the verify window {v['paged_decode/verify']} times "
        f"({cfg.num_layers} a verify step) [{card}]")
    eager_then_graphed(cfg, params, MOE_BASELINE, prompts,
                       "granite baseline (batch-1, no sharing, K=1)", card)
    # the kernel line's phase 11 counts; B2's: the launches its fold ran in
    report["launches_moe"] = dict(d["launches"],
                                  decode_reduce=v["paged_decode/fold"])
    del params
    free_cuda()


def moe_no_drop(cfg):
    """``cfg`` at capacity factor E_pad / top_k, where C = T: an expert can
    take every token of a call, so nothing drops and the output no longer
    depends on how tokens are batched."""
    import dataclasses
    m = cfg.moe
    return dataclasses.replace(cfg, name=f"{cfg.name} no-drop twin",
                               moe=dataclasses.replace(
                                   m, capacity_factor=m.padded_experts(1) /
                                   m.top_k))


class DropCounter:
    """While active, counts on the host the assignments the MoE layers drop
    (past the capacity) and those they route: eager engines only, since it
    reads the routing back."""

    def __enter__(self):
        import torch
        from repro_torch.layers import moe
        self.dropped = self.routed = 0
        self.real = moe.route

        def route(router_w, x, mcfg, e_pad):
            w, idx, aux = self.real(router_w, x, mcfg, e_pad)
            load = torch.bincount(idx.reshape(-1), minlength=e_pad)
            C = moe.capacity(x.shape[0], mcfg, e_pad)
            self.dropped += int(torch.clamp_min(load - C, 0).sum())
            self.routed += idx.numel()
            return w, idx, aux

        moe.route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.layers import moe
        moe.route = self.real
        return False


def serve_granite_fp32(report, card: str):
    """Phase 11 (b): granite at full width cut to 2 layers, fp32 weights
    from seed 0.  At the config's capacity factor (1.25): the baseline and
    the defaults settings each eager then graphed, graphed tokens equal to
    eager on both passes.  Then the defaults pass against the plain engine
    (batch-1, no sharing, K=1), eager, under the fp32 rule
    (``check_against_plain``, every shared-context position within 1e-5 +
    1e-5 rel): enforced on the no-drop twin only (capacity factor E / k, so
    C = T), since where capacity drops an assignment the output depends on
    how tokens are batched; the capacity-1.25 run is printed beside it with
    the assignments it dropped, and not enforced."""
    import dataclasses
    import torch
    from repro_torch.config import get_model_config
    from repro_torch.models import api
    from repro_torch.serving import PagedEngine

    cfg = dataclasses.replace(get_model_config("granite-moe-3b-a800m"),
                              num_layers=2)
    params = api.init_params(0, cfg, tp=1, dtype=torch.float32,
                             device="cuda")
    lengths = report["lengths"]
    _, prompts = baseline_prompts(cfg)
    dprompts = defaults_prompts(cfg, lengths)
    eager_then_graphed(cfg, params, MOE_BASELINE, prompts,
                       "granite fp32 2-layer baseline", card)
    eager_then_graphed(cfg, params, MOE_DEFAULTS, dprompts,
                       "granite fp32 2-layer defaults", card)
    plain_sv = dict(MOE_DEFAULTS, prefix_sharing=False,
                    prefill_batching=False, spec_k=0)
    for twin in (moe_no_drop(cfg), cfg):
        res = {}
        for name, sv in (("defaults", MOE_DEFAULTS), ("plain", plain_sv)):
            eng = PagedEngine(moe_config(twin, sv), params, device="cuda",
                              cuda_graphs=False)
            with LogitsRecorder(cfg.vocab_size) as rec, DropCounter() as dc:
                res[name] = serve_pass(eng, dprompts, f"granite fp32 "
                                       f"2-layer {twin.name} {name} eager",
                                       card)
            res[name].update(rec=rec, dropped=dc.dropped, routed=dc.routed)
            if not rec.finite:
                raise AssertionError(f"[moe] {twin.name} {name}: "
                                     f"non-finite logits")
            del eng
        gate = twin is not cfg
        log(f"[moe] {twin.name} (capacity factor "
            f"{twin.moe.capacity_factor}): assignments dropped by capacity "
            f"{res['defaults']['dropped']} of {res['defaults']['routed']} "
            f"(defaults), {res['plain']['dropped']} of "
            f"{res['plain']['routed']} (plain); defaults against plain "
            + ("(the gate):" if gate else "(printed, not a gate: capacity "
               "drops, so batching changes the function):"))
        if gate and (res["defaults"]["dropped"] or res["plain"]["dropped"]):
            raise AssertionError("[moe] the no-drop twin dropped "
                                 "assignments")
        check_against_plain(
            f"moe fp32 {twin.name}", TOL["float32"], res["plain"],
            res["defaults"], res["plain"]["rec"], res["defaults"]["rec"],
            card, every_position=True, enforce=gate)
    del params
    free_cuda()


def serve_kimi(card: str):
    """Phase 11 (c): kimi-k2-1t-a32b at full width (d 7168, 64/8 heads at
    hd 112, 384 experts top-8 with a shared expert, vocab 163840), cut to
    ``KIMI_LAYERS`` of its 61 layers (reduced: the whole model is ~2 TB of
    bf16), bf16, tp=1: four prompts of 300-1000 tokens, 16 new each, eager
    then graphed, graphed tokens equal to eager; peak memory printed."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.config import get_model_config
    from repro_torch.models import api

    full = get_model_config("kimi-k2-1t-a32b")
    cfg = dataclasses.replace(full, num_layers=KIMI_LAYERS)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = api.init_params(0, cfg, tp=1, dtype=torch.bfloat16,
                             device="cuda")
    torch.cuda.synchronize()
    log(f"[moe] kimi-k2-1t-a32b at full width, {KIMI_LAYERS} of "
        f"{full.num_layers} layers (reduced: depth), d={cfg.d_model} Hq/Hkv "
        f"{cfg.num_heads}/{cfg.num_kv_heads} hd {cfg.resolved_head_dim}, "
        f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k} d_ff "
        f"{cfg.moe.d_ff_expert} + a shared expert of "
        f"{cfg.moe.shared_expert_d_ff}: {cfg.param_count() / 1e9:.4f}B "
        f"params bf16 made on the card in {time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB while made "
        f"(the whole model: {full.param_count() / 1e12:.4f}T params) "
        f"[{card}]")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(2, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(300, 1001, 4)]
    eager_then_graphed(cfg, params, MOE_BASELINE, prompts,
                       f"kimi-k2-1t-a32b {KIMI_LAYERS}-layer (prompts "
                       f"{[len(p) for p in prompts]})", card, new=16)
    del params
    free_cuda()


def profile_graphed(eng, prompts, label: str, card: str, tag: str,
                    prefill_steps: int = 0, patches=None) -> None:
    """Where a graphed engine's steps go: four of ``prompts`` prefilled
    on ``eng`` (their grants' graphs captured first, on the same prompts;
    with ``prefill_steps`` only that many of the prefilling steps are in
    the window, the rest run after it), then three decode steps, each
    window under ``torch.profiler`` with CUDA activities; printed: the wall
    and device time a step, the idle share, and the device kernels that
    took the most time, by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import Request
    from repro_torch.serving.requests import SamplingParams

    def submit_four() -> None:
        for i, p in enumerate(prompts[:4]):
            eng.add_request(Request(prompt=p.copy(), sampling=SamplingParams(
                max_new_tokens=32, eos_id=-1),
                patches=None if patches is None else patches[i]))

    def prefill(limit: int = 0) -> int:
        steps = 0
        while (eng.scheduler.waiting or any(
                s is not None and s.prefilled < sum(s.chunk_plan)
                for s in eng.slots)) and (not limit or steps < limit):
            eng.step()
            steps += 1
        return steps

    def prefill_four() -> int:
        submit_four()
        return prefill()

    def window(what, run):
        graphs = eng.graphs
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            steps = run()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0) / steps
        if eng.graphs != graphs:
            raise AssertionError(f"[{tag}] the profiled {what} captured")
        act = device_activity(prof)
        busy = act["busy_ms"] / steps
        log(f"[{tag}] {label} graphed {what} under torch.profiler ({steps} "
            f"steps): {wall:.3f} ms of wall a step, device busy {busy:.3f} "
            f"ms, idle share {1 - busy / wall:.4f} [{card}]")
        log_top(f"{label} graphed {what}", act, steps, card, top=12)

    def three_decode_steps() -> int:
        for _ in range(3):
            eng.step()
        return 3

    prefill_four()                            # every graph captured
    eng.run_until_complete()
    if prefill_steps:
        submit_four()
        window(f"first {prefill_steps} of the steps prefilling four "
               f"requests", lambda: prefill(prefill_steps))
        prefill()                             # the rest, outside
    else:
        window("steps prefilling four requests", prefill_four)
    eng.step()
    window("decode steps (4 requests)", three_decode_steps)
    eng.run_until_complete()


def moe_profile(card: str):
    """Phase 11, near the end of the script (a ``torch.profiler`` window
    leaves a host cost on later replays): where granite's graphed steps go,
    at full width and depth, bf16, baseline settings (``profile_graphed``)."""
    import torch
    from repro_torch.config import get_model_config
    from repro_torch.models import api

    from repro_torch.serving import PagedEngine

    cfg = get_model_config("granite-moe-3b-a800m")
    params = api.init_params(0, cfg, tp=1, dtype=torch.bfloat16,
                             device="cuda")
    _, prompts = baseline_prompts(cfg)
    eng = PagedEngine(moe_config(cfg, MOE_BASELINE), params, device="cuda")
    profile_graphed(eng, prompts, "granite", card, "moe")
    del eng, params
    free_cuda()


def serve_moe(report, card: str):
    """Phase 11 (a)-(c): granite and its fp32 gates, then kimi's layer;
    each model freed before the next."""
    serve_granite(report, card)
    serve_granite_fp32(report, card)
    serve_kimi(card)


# ---------------------------------------------------------------------------
# phase 12: the recurrent families, hymba-1.5b and xlstm-350m
# ---------------------------------------------------------------------------

# phase 3's baseline settings; a recurrent stack runs them whatever it is
# asked (the engine's gates: no buckets, packs, sharing or spec)
RECURRENT_SV = dict(page_size=16, max_batch=4, max_len=2048,
                    prefill_token_budget=512)
# one prompt past hymba's 2048-token window, at max_len 4096
HYMBA_LONG_PROMPT = 2600
HYMBA_LONG_SV = dict(RECURRENT_SV, max_len=4096)


def recurrent_model(name: str, layers: int = 0, window: int = 0,
                    dtype: str = "bfloat16"):
    """(cfg, params made on the card from seed 0, seconds): ``name`` at
    full width, its depth cut to ``layers`` and its window to ``window``
    when given."""
    import dataclasses
    import torch
    from repro_torch.config import get_model_config
    from repro_torch.models import api

    cfg = get_model_config(name)
    cut = {}
    if layers:
        cut["num_layers"] = layers
    if window:
        cut["sliding_window"] = window
    if cut:
        cfg = dataclasses.replace(cfg, name=f"{name} cut {cut}", **cut)
    t0 = time.perf_counter()
    params = api.init_params(0, cfg, tp=1, dtype=getattr(torch, dtype),
                             device="cuda")
    torch.cuda.synchronize()
    return cfg, params, time.perf_counter() - t0


def _recurrent_weights_line(cfg, params, made_s, card):
    import torch
    n = sum(t.numel() for t in _leaves(params))
    log(f"[recurrent] {cfg.name} {cfg.num_layers}L d={cfg.d_model} Hq/Hkv "
        f"{cfg.num_heads}/{cfg.num_kv_heads} hd {cfg.resolved_head_dim} "
        f"pattern {cfg.block_pattern} window {cfg.sliding_window}: "
        f"{n / 1e9:.4f}B parameters in the tensors (param_count "
        f"{cfg.param_count() / 1e9:.4f}B), made on the card in "
        f"{made_s:.1f}s, {torch.cuda.memory_allocated() / 2**30:.3f} GiB "
        f"allocated [{card}]")


def serve_hymba(report, card: str):
    """Phase 12 (a): hymba-1.5b at full width and depth (32 layers, 25/5
    heads at hd 64, SSM inner 3200 x N 16, window 2048), bf16,
    ``PagedEngine`` tp=1: phase 3's six baseline prompts, then one of
    ``HYMBA_LONG_PROMPT`` tokens at max_len 4096 (B3's and B1's window
    masks cut on the path), each eager then graphed, graphed tokens equal
    to eager; B1 and B3 launched, every B3 launch on the tensor-core
    instantiation."""
    import numpy as np
    cfg, params, made_s = recurrent_model("hymba-1.5b")
    _recurrent_weights_line(cfg, params, made_s, card)
    _, prompts = baseline_prompts(cfg)
    base = eager_then_graphed(cfg, params, RECURRENT_SV, prompts,
                              "hymba-1.5b baseline", card, tag="recurrent",
                              keep=True)
    v = base["variants"]
    if v["paged_prefill/tc"] != base["launches"]["paged_prefill"]:
        raise AssertionError(f"[recurrent] hymba: a B3 launch missed the "
                             f"tensor-core instantiation: {v}")
    long_prompt = [np.random.default_rng(7).integers(
        2, cfg.vocab_size, HYMBA_LONG_PROMPT).astype(np.int32)]
    long = eager_then_graphed(cfg, params, HYMBA_LONG_SV, long_prompt,
                              f"hymba-1.5b one {HYMBA_LONG_PROMPT}-token "
                              f"prompt past the window", card,
                              tag="recurrent")
    report["launches_hymba"] = dict(base["launches"],
                                    decode_reduce=v["paged_decode/fold"])
    report["recurrent"] = {"hymba-1.5b": _recurrent_summary(base),
                           "hymba-1.5b long": _recurrent_summary(long)}
    # the baseline's graphed engine (and through it the weights) stays for
    # the profile at the end of the script
    report["recurrent_engines"] = {"hymba-1.5b": (base["engine"], prompts)}
    del params, base
    free_cuda()


def _recurrent_summary(r) -> dict:
    m = r["m"]
    return dict(prefill_tok_s=m["prefill_tokens"] / m["prefill_s"],
                decode_ms_step=1e3 * m["decode_s"] / m["decode_calls"],
                eager_prefill_tok_s=r["eager"]["m"]["prefill_tokens"]
                / r["eager"]["m"]["prefill_s"],
                eager_decode_ms_step=1e3 * r["eager"]["m"]["decode_s"]
                / r["eager"]["m"]["decode_calls"],
                graphs=r["graphs"], capture_s=r["capture_s"],
                peak_gib=r["peak"], eager_peak_gib=r["eager_peak"],
                launches=r["launches"])


def serve_xlstm(report, card: str):
    """Phase 12 (b): xlstm-350m at full width and depth (24 layers: 18
    mLSTM, 6 sLSTM; d 1024, 4 heads at hd 256), bf16, ``PagedEngine`` tp=1
    on phase 3's six baseline prompts, eager then graphed, graphed tokens
    equal to eager.  It has no attention: it launches none of the seven
    hand-written kernels (checked)."""
    cfg, params, made_s = recurrent_model("xlstm-350m")
    _recurrent_weights_line(cfg, params, made_s, card)
    _, prompts = baseline_prompts(cfg)
    r = eager_then_graphed(cfg, params, RECURRENT_SV, prompts,
                           "xlstm-350m baseline", card, kernels=(),
                           tag="recurrent", keep=True)
    report["recurrent"]["xlstm-350m"] = _recurrent_summary(r)
    report["recurrent_engines"]["xlstm-350m"] = (r["engine"], prompts)
    del params, r
    free_cuda()


def recurrent_gates(report, card: str):
    """Phase 12 (c): fp32 twins at full width, hymba cut to 2 layers with
    its window cut to 64, xlstm to one 4-layer period: graphed tokens ==
    eager (``eager_then_graphed``); then ``PagedEngine`` == the dense
    ``Engine`` (bucket 16, max_len 2048), token for token, on prompts whose
    lengths are multiples of 16, where the dense engine pads nothing (its
    bucket pad would advance the recurrent state)."""
    import numpy as np
    from repro_torch.config import Config, ISOConfig, ParallelConfig
    from repro_torch.serving import Engine, PagedEngine

    rng = np.random.default_rng(8)
    lengths = [16 * int(n) for n in rng.integers(20, 126, 4)]
    lengths[0] = max(lengths[0], 1200)            # resumed grants
    for name, layers, window in (("hymba-1.5b", 2, 64), ("xlstm-350m", 4, 0)):
        cfg, params, _ = recurrent_model(name, layers, window, "float32")
        prompts = [rng.integers(2, cfg.vocab_size, n).astype(np.int32)
                   for n in lengths]
        kernels = ATTENTION_KERNELS if name.startswith("hymba") else ()
        r = eager_then_graphed(cfg, params, RECURRENT_SV, prompts,
                               f"{cfg.name} fp32", card, kernels=kernels,
                               tag="recurrent")
        eng = Engine(Config(model=cfg, parallel=ParallelConfig(data=1,
                                                               model=1),
                            iso=ISOConfig()), params, max_batch=4,
                     max_len=2048, bucket=16, device="cuda")
        dense = dense_pass(eng, prompts, f"{cfg.name} fp32 dense Engine",
                           card)
        del eng
        if dense["tokens"] != r["tokens"]:
            diff = [i for i, (a, b) in enumerate(zip(dense["tokens"],
                                                     r["tokens"])) if a != b]
            raise AssertionError(f"[recurrent] {cfg.name} fp32: paged tokens "
                                 f"differ from the dense Engine's in "
                                 f"requests {diff}")
        log(f"[recurrent] {cfg.name} fp32, prompts {lengths} (multiples of "
            f"the dense bucket 16): PagedEngine (graphed and eager) == dense "
            f"Engine, token for token [{card}]")
        del params
        free_cuda()


def recurrent_profile(report, card: str):
    """Phase 12 (e), last in the script: ``profile_graphed`` on each model's
    graphed baseline engine of (a) and (b) (full width and depth, bf16),
    over one prefill step of four requests and three decode steps: the
    split between the SSM's elementwise work, the sLSTM's sequential steps
    and the GEMMs.  The engines are freed after."""
    engines = report.pop("recurrent_engines")
    for name, (eng, prompts) in list(engines.items()):
        profile_graphed(eng, prompts, name, card, "recurrent",
                        prefill_steps=1)
        del engines[name], eng
        free_cuda()


def serve_recurrent(report, card: str):
    """Phase 12 (a)-(c): hymba, xLSTM, the fp32 gates; each model freed
    before the next."""
    serve_hymba(report, card)
    serve_xlstm(report, card)
    recurrent_gates(report, card)


# ---------------------------------------------------------------------------
# phase 13: the VLM family, internvl2-2b
# ---------------------------------------------------------------------------

# phase 3's baseline settings at max_len 4096: a request's 256 patches sit
# in its stream ahead of up to 2000 text tokens
VLM_SV = dict(page_size=16, max_batch=4, max_len=4096,
              prefill_token_budget=512)
# the baseline requests that carry no patches (text alone, so they resume
# across grants: B3's path); request 0 is the >= 1500-token one
VLM_TEXT_ONLY = (0, 3)


def vlm_traffic(cfg, n: int = 6):
    """Phase 3's baseline prompts (seed 0), each with ``num_patches`` seeded
    patches, N(0, 1) x 0.1 (seed 13), but ``VLM_TEXT_ONLY``: (lengths,
    prompts, patches)."""
    import numpy as np
    lengths, prompts = baseline_prompts(cfg)
    rng = np.random.default_rng(13)
    patches = [None if i in VLM_TEXT_ONLY else
               (rng.standard_normal((cfg.num_patches, cfg.d_model)) * 0.1
                ).astype(np.float32) for i in range(len(prompts))]
    return lengths[:n], prompts[:n], patches[:n]


def serve_vlm(report, card: str):
    """Phase 13 (a)-(c): internvl2-2b at full width and depth, bf16, on the
    paged engine eager then graphed and on the dense ``Engine``; the fp32
    2-layer gates."""
    import torch
    from repro_torch.config import Config, ISOConfig, ParallelConfig
    from repro_torch.serving import Engine

    cfg, params, made_s = recurrent_model("internvl2-2b")
    _recurrent_weights_line(cfg, params, made_s, card)
    lengths, prompts, patches = vlm_traffic(cfg)
    r = eager_then_graphed(cfg, params, VLM_SV, prompts,
                           "internvl2-2b baseline", card, tag="vlm",
                           keep=True, patches=patches)
    v = r["variants"]
    if v["paged_prefill/tc"] != r["launches"]["paged_prefill"]:
        raise AssertionError(f"[vlm] a B3 launch missed the tensor-core "
                             f"instantiation: {v}")
    eng = r.pop("engine")
    keys = sorted(eng._prefill_fns, key=str)
    if not any(len(k) == 3 for k in keys):
        raise AssertionError(f"[vlm] no patch grant ran: {keys}")
    report["launches_vlm"] = dict(r["launches"],
                                  decode_reduce=v["paged_decode/fold"])
    m = r["m"]
    log(f"[vlm] internvl2-2b prompts {lengths} (text; requests "
        f"{list(VLM_TEXT_ONLY)} text-only, the others with "
        f"{cfg.num_patches} patches): prefill {m['prefill_tokens']} "
        f"positions (patches counted), prefill closures {keys}, graphs "
        f"{r['graphs']} in {r['capture_s']:.2f}s [{card}]")
    report["vlm"] = _recurrent_summary(r)
    profile_graphed(eng, prompts, "internvl2-2b", card, "vlm",
                    prefill_steps=1, patches=patches)
    del eng, r
    free_cuda()
    # (b) the dense Engine, graphed, on the same requests
    torch.cuda.reset_peak_memory_stats()
    dense = Engine(Config(model=cfg, parallel=ParallelConfig(data=1, model=1),
                          iso=ISOConfig()), params, max_batch=4,
                   max_len=VLM_SV["max_len"], bucket=32, device="cuda")
    d = dense_pass(dense, prompts, "internvl2-2b dense Engine, graphed", card,
                   patches=patches)
    del dense
    dm = d["m"]
    report["vlm"].update(
        dense_decode_ms_step=1e3 * dm["decode_s"] / dm["decode_calls"],
        dense_prefill_tok_s=dm["prefill_tokens"] / dm["prefill_s"],
        dense_peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"[vlm] internvl2-2b dense Engine: peak allocated "
        f"{report['vlm']['dense_peak_gib']:.3f} GiB; prefill_tokens counts "
        f"text only, as the reference's dense engine [{card}]")
    del params
    free_cuda()
    vlm_gates(card)


def vlm_gates(card: str):
    """Phase 13 (c): internvl2-2b at full width, 2 layers, fp32, on the
    baseline traffic with 16 new tokens: graphed == eager
    (``eager_then_graphed``), then ``PagedEngine`` == the dense ``Engine``
    (bucket 16; its pad tail sits after the prompt and is scrubbed), token
    for token: the reference's ``test_paged_vlm_matches_dense``."""
    import torch
    from repro_torch.config import Config, ISOConfig, ParallelConfig
    from repro_torch.serving import Engine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params, _ = recurrent_model("internvl2-2b", 2, dtype="float32")
    lengths, prompts, patches = vlm_traffic(cfg)
    r = eager_then_graphed(cfg, params, VLM_SV, prompts,
                           f"{cfg.name} fp32", card, new=16, tag="vlm",
                           patches=patches)
    eng = Engine(Config(model=cfg, parallel=ParallelConfig(data=1, model=1),
                        iso=ISOConfig()), params, max_batch=4,
                 max_len=VLM_SV["max_len"], bucket=16, device="cuda")
    dense = dense_pass(eng, prompts, f"{cfg.name} fp32 dense Engine", card,
                       max_new=16, patches=patches)
    del eng, params
    free_cuda()
    if dense["tokens"] != r["tokens"]:
        diff = [i for i, (a, b) in enumerate(zip(dense["tokens"],
                                                 r["tokens"])) if a != b]
        raise AssertionError(f"[vlm] {cfg.name} fp32: paged tokens differ "
                             f"from the dense Engine's in requests {diff}")
    log(f"[vlm] {cfg.name} fp32, prompts {lengths}: PagedEngine (graphed "
        f"and eager) == dense Engine, token for token [{card}]")


def vlm_tp_case():
    """Phase 5's VLM pass at tp=1: internvl2-2b at full width cut to 2
    layers, fp32, ``VLM_SV``, three requests of 300-1200 tokens (seed 6),
    the first text-only, the others with 256 patches, 16 new each.  Seed 0
    makes the same function at tp 1 and 2 (16/8 heads and the 92672-row
    padded vocab split evenly)."""
    import dataclasses
    import numpy as np
    from repro_torch.config import Config, ISOConfig, ParallelConfig, \
        ServingConfig, get_model_config
    cfg = dataclasses.replace(get_model_config("internvl2-2b"), num_layers=2)
    rng = np.random.default_rng(6)
    lengths = [int(n) for n in rng.integers(300, 1201, 3)]
    lengths[0] = max(lengths[0], 900)            # at least one resumed grant
    prompts = [rng.integers(2, cfg.vocab_size, n).astype(np.int32)
               for n in lengths]
    patches = [None] + [(rng.standard_normal((cfg.num_patches, cfg.d_model))
                         * 0.1).astype(np.float32) for _ in lengths[1:]]
    config = Config(model=cfg, parallel=ParallelConfig(data=1, model=1),
                    iso=ISOConfig(), serving=ServingConfig(**VLM_SV))
    return config, [dict(prompts=prompts, patches=patches,
                         max_new=TP_NEW_TOKENS)]


# ---------------------------------------------------------------------------
# phase 14: training
# ---------------------------------------------------------------------------

# the full-size run: the reference launcher's learning rate, warmup 10,
# grad_clip 1.0 (the default), remat on; batch 4 x 2048 positions (256 of
# them patches)
TRAIN_STEPS = 20
TRAIN_BATCH, TRAIN_SEQ = 4, 2048
# the 2-layer twins' runs: steps and batch (card == CPU; dp=2; tp=2); 2
# steps of card == CPU keep an update between them and cut the CPU side's
# ~40 s by half for the script's time limit
TWIN_STEPS, TWIN_BATCH, TWIN_SEQ = 2, 2, 64
DP_STEPS, DP_BATCH, DP_SEQ = 3, 4, 256


def train_config(cfg, steps: int, batch: int, seq: int, **rt):
    from repro_torch.config import Config, ISOConfig, ParallelConfig, \
        RuntimeConfig
    par = rt.pop("parallel", (1, 1))
    return Config(model=cfg, parallel=ParallelConfig(data=par[0],
                                                     model=par[1]),
                  iso=ISOConfig(num_chunks=2, min_chunk_tokens=32,
                                chunk_align=16),
                  runtime=RuntimeConfig(**dict(dict(
                      mode="train", seq_len=seq, global_batch=batch,
                      learning_rate=3e-4, max_steps=steps, warmup_steps=10,
                      remat=True), **rt)))


def train_twin(dtype: str = "float32"):
    import dataclasses
    from repro_torch.config import get_model_config
    return dataclasses.replace(get_model_config("internvl2-2b"),
                               num_layers=2,
                               name=f"internvl2-2b 2L {dtype}")


def run_steps(config, params, opt, steps: int, group=None) -> list:
    """``steps`` train steps in place; [(loss, gnorm)]."""
    from repro_torch.training.data import make_training_batch
    from repro_torch.training.trainer import make_train_step
    rt = config.runtime
    step_fn = make_train_step(config, group)
    out = []
    for s in range(steps):
        b = make_training_batch(config.model, rt.seq_len, rt.global_batch, s)
        loss, gn = step_fn(params, opt, b, s)
        out.append((float(loss), float(gn)))
    return out


def train_full(report, card: str):
    """Phase 14 (a): internvl2-2b at full width and depth, bf16, tp=1 dp=1,
    ``TRAIN_STEPS`` steps of ``make_training_batch`` at ``TRAIN_BATCH`` x
    ``TRAIN_SEQ``; every loss and gradient norm finite and the last five
    steps' mean loss below the first five's; ms a step and tokens/s after
    the first two steps, each step fenced; peak memory; then one more step
    under ``torch.profiler``."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.config import get_model_config
    from repro_torch.kernels import native
    from repro_torch.training.data import make_training_batch
    from repro_torch.training.trainer import init_train_state, \
        make_train_step

    cfg = get_model_config("internvl2-2b")
    config = train_config(cfg, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt = init_train_state(config, 0, device="cuda")
    torch.cuda.synchronize()
    state_gib = torch.cuda.memory_allocated() / 2**30
    log(f"[train] internvl2-2b {cfg.num_layers}L d={cfg.d_model} bf16: "
        f"weights and fp32 moments made in {time.perf_counter() - t0:.1f}s, "
        f"{state_gib:.3f} GiB allocated [{card}]")
    step_fn = make_train_step(config)
    batches = [make_training_batch(cfg, TRAIN_SEQ, TRAIN_BATCH, s)
               for s in range(TRAIN_STEPS + 1)]
    n_p = batches[0]["patches"].shape[1]
    native.reset_launches()
    log_rows, times = [], []
    for s in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, gn = step_fn(params, opt, batches[s], s)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        log_rows.append((float(loss), float(gn)))
        log(f"[train] step {s:2d} loss {log_rows[-1][0]:.6f} gnorm "
            f"{log_rows[-1][1]:.6f} {1e3 * times[-1]:.1f} ms")
    launches = dict(native.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = np.array(log_rows)
    if not np.isfinite(losses).all():
        raise AssertionError(f"[train] non-finite loss or gnorm: {log_rows}")
    first, last = losses[:5, 0].mean(), losses[-5:, 0].mean()
    if not last < first:
        raise AssertionError(f"[train] the loss did not fall: first five "
                             f"{first:.6f}, last five {last:.6f}")
    if any(launches.values()):
        raise AssertionError(f"[train] the tp=1 dp=1 step launched "
                             f"hand-written kernels: {launches}")
    ms = 1e3 * float(np.mean(times[2:]))
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (ms / 1e3)
    log(f"[train] internvl2-2b full size, {TRAIN_STEPS} steps of "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} positions ({n_p} patches + "
        f"{TRAIN_SEQ - n_p} text a row), remat, lr 3e-4 warmup 10, clip "
        f"1.0: mean loss {first:.4f} over the first five steps, {last:.4f} "
        f"over the last five; {ms:.1f} ms a step ({tok_s:.0f} positions/s) "
        f"after the first two; peak allocated {peak:.3f} GiB; no "
        f"hand-written kernel on this path [{card}]")
    report["train"] = dict(losses=log_rows, ms_step=ms, tok_s=tok_s,
                           peak_gib=peak, state_gib=state_gib)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step_fn(params, opt, batches[TRAIN_STEPS], TRAIN_STEPS)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t)
    act = device_activity(prof)
    log(f"[train] one step under torch.profiler: {wall:.1f} ms of wall, "
        f"device busy {act['busy_ms']:.1f} ms, idle share "
        f"{1 - act['busy_ms'] / wall:.4f} [{card}]")
    log_top("internvl2-2b train step", act, 1, card, top=15)
    del params, opt, step_fn, prof
    free_cuda()


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device)


def train_card_vs_cpu(card: str):
    """Phase 14 (b): the fp32 2-layer twin, ``TWIN_STEPS`` steps on the
    card and the same steps on the CPU in this process from the same
    weights (made on the CPU): loss and gradient norm within rtol 1e-4."""
    import numpy as np
    import torch
    from repro_torch.models import api
    from repro_torch.training.trainer import init_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = train_twin()
    config = train_config(cfg, TWIN_STEPS, TWIN_BATCH, TWIN_SEQ)
    cpu = api.init_params(0, cfg, dtype=torch.float32, device="cpu")
    runs = {}
    for dev in ("cuda", "cpu"):
        t = time.perf_counter()
        params, opt = init_train_state(config, params=_to(cpu, dev))
        runs[dev] = run_steps(config, params, opt, TWIN_STEPS)
        log(f"[train] {cfg.name} on {dev}: {runs[dev]} "
            f"({time.perf_counter() - t:.1f}s)")
        del params, opt
    del cpu
    free_cuda()
    np.testing.assert_allclose(np.array(runs["cuda"]), np.array(runs["cpu"]),
                               rtol=1e-4)
    log(f"[train] {cfg.name}, {TWIN_STEPS} steps of {TWIN_BATCH} x "
        f"{TWIN_SEQ}: card == CPU, loss and gnorm within rtol 1e-4 [{card}]")


def train_dp_rank(group, cfg32, cfg16):
    """Body of each rank of phase 14 (c) (module level: the spawned ranks
    import it): dp=2 sharing the card over gloo.  The fp32 twin, plain
    AdamW and then ZeRO-1 from the same weights; the bf16 twin under the
    int8 gradient mean, its kernel launches and split-path variants
    counted; then the three int8 kernels on this rank's actual gradient
    rows (the embedding table's, split in dp shards) against their plain
    versions, and, on rank 0 once both ranks are past that, their times:
    device ms (a CUDA graph of 10 calls), eager ms, plain ms."""
    import torch
    from repro_torch.kernels import int8_quant as q8
    from repro_torch.kernels import native
    from repro_torch.models import api
    from repro_torch.training.data import make_training_batch
    from repro_torch.training.trainer import init_train_state, \
        make_train_step, param_leaves

    out, kept = {}, None
    for name, rt in (("plain", {}), ("zero1", dict(zero1=True))):
        config = train_config(cfg32, DP_STEPS, DP_BATCH, DP_SEQ,
                              parallel=(2, 1), **rt)
        params = api.init_params(0, cfg32, dtype=torch.float32,
                                 device=group.device)
        params, opt = init_train_state(config, group=group, params=params)
        t0 = time.perf_counter()
        out[name] = run_steps(config, params, opt, DP_STEPS, group)
        out[name + "_s"] = time.perf_counter() - t0
        flat = [x for leaf in param_leaves(params) for x in leaf.tensors]
        if kept is None:
            kept = flat
        else:
            out["zero1_vs_plain"] = max(float((a - b).abs().max())
                                        for a, b in zip(flat, kept))
        del params, opt, flat
    del kept
    torch.cuda.empty_cache()
    config = train_config(cfg16, DP_STEPS, DP_BATCH, DP_SEQ,
                          parallel=(2, 1), grad_comm_int8=True)
    params = api.init_params(0, cfg16, dtype=torch.bfloat16,
                             device=group.device)
    params, opt = init_train_state(config, group=group, params=params)
    torch.cuda.synchronize()
    native.reset_launches()
    t = time.perf_counter()
    out["int8"] = run_steps(config, params, opt, DP_STEPS, group)
    torch.cuda.synchronize()
    out["int8_s"] = time.perf_counter() - t
    out["launches"] = dict(native.LAUNCHES)
    out["variants"] = dict(native.VARIANTS)
    # the kernels on this rank's gradient rows: the embedding table's
    step_fn = make_train_step(config, group)
    _, leaves, grads = step_fn.grads(params, make_training_batch(
        cfg16, DP_SEQ, DP_BATCH, DP_STEPS))
    i = [leaf.name for leaf in leaves].index("['embed']['table']")
    flat = grads[i][0].reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % 2))
    del grads, step_fn, params, opt
    native.reset_launches()
    q, s = q8.quantize_int8_shards(flat, 2)
    qp, sp = q8.quantize_int8_shards_plain(flat, 2)
    q2, s2 = q8.dequant_sum_quantize_int8(q, s)
    q2p, s2p = q8.dequant_sum_quantize_int8_plain(q, s)
    qg, sg = torch.stack([q2, q2]), torch.stack([s2, s2])
    o = q8.dequantize_int8_gathered(qg, sg, flat.dtype)
    op = q8.dequantize_int8_gathered_plain(qg, sg, flat.dtype)
    n, d = flat.numel(), flat.numel() // 2
    out["rows"] = dict(
        elements=n, dtype=str(flat.dtype),
        equal=[bool(torch.equal(q, qp)), bool(torch.equal(s, sp)),
               bool(torch.equal(q2, q2p)), bool(torch.equal(s2, s2p)),
               bool(torch.equal(o, op))],
        split={k: native.VARIANTS[f"{k}/split"]
               for k in INT8_REDUCE_KERNELS[:2]},
        # each input read once, each output written once
        bytes={"quantize_int8_shards": n * flat.element_size() + n + 2 * 4,
               "dequant_sum_quantize_int8": n + 2 * 4 + d + 4,
               "dequantize_int8_gathered": n + 2 * 4
               + n * flat.element_size()})
    # timed on rank 0 alone, once both ranks are past their checks (they
    # share the card)
    torch.distributed.barrier(group=group.dp_group)
    if group.dp_rank != 0:
        return out
    calls = {"quantize_int8_shards": (
                 lambda: q8.quantize_int8_shards(flat, 2),
                 lambda: q8.quantize_int8_shards_plain(flat, 2)),
             "dequant_sum_quantize_int8": (
                 lambda: q8.dequant_sum_quantize_int8(q, s),
                 lambda: q8.dequant_sum_quantize_int8_plain(q, s)),
             "dequantize_int8_gathered": (
                 lambda: q8.dequantize_int8_gathered(qg, sg, flat.dtype),
                 lambda: q8.dequantize_int8_gathered_plain(qg, sg,
                                                           flat.dtype))}
    out["rows"].update(
        ms={k: time_ms(fn, reps=10) for k, (fn, _) in calls.items()},
        eager_ms={k: call_ms(fn, 5) for k, (fn, _) in calls.items()},
        plain_ms={k: call_ms(plain, 5) for k, (_, plain) in calls.items()})
    return out


def train_dp(report, card: str):
    """Phase 14 (c): ``train_dp_rank`` on two ranks sharing cuda:0 over
    gloo.  Gates: ZeRO-1's parameters after ``DP_STEPS`` steps equal plain
    AdamW's within 1e-4 (fp32; the reference's tests/test_zero1.py bound),
    both ranks' losses and norms agree, the three int8 kernels launched in
    the int8 run (no standalone B7), the quantize pair on the split path at
    every launch there, and all three equal their plain versions on the
    gradient rows, where the pair splits too.  Logs the int8 run's seconds
    and each kernel's ms on the rows beside its bound and plain ms."""
    from repro_torch.launch.mesh import spawn
    cfg32, cfg16 = train_twin(), train_twin("bfloat16")
    t0 = time.perf_counter()
    ranks = spawn(train_dp_rank, 1, args=(cfg32, cfg16), device="cuda:0",
                  backend="gloo", data=2, timeout_s=900)
    log(f"[train] dp=2 (two ranks on cuda:0 over gloo), "
        f"{time.perf_counter() - t0:.1f}s with start-up")
    r0 = ranks[0]
    for name in ("plain", "zero1", "int8"):
        if ranks[1][name] != r0[name]:
            raise AssertionError(f"[train] dp=2 {name}: the ranks disagree: "
                                 f"{r0[name]} vs {ranks[1][name]}")
        log(f"[train] dp=2 {name} ({'bf16' if name == 'int8' else 'fp32'} "
            f"2-layer twin, {DP_STEPS} steps of {DP_BATCH} x {DP_SEQ}, "
            f"{r0[name + '_s']:.1f}s over gloo): (loss, gnorm) {r0[name]}")
    d = max(r["zero1_vs_plain"] for r in ranks)
    if not d < 1e-4:
        raise AssertionError(f"[train] ZeRO-1 params differ from plain "
                             f"AdamW's by {d}")
    launches, variants = r0["launches"], r0["variants"]
    if any(launches[k] <= 0 for k in INT8_REDUCE_KERNELS) or \
            launches["quantize_int8"] != 0:
        raise AssertionError(f"[train] int8 gradient mean launches: "
                             f"{launches}")
    # every int8 leaf is a long row at dp=2: both quantize kernels split
    for k in INT8_REDUCE_KERNELS[:2]:
        if variants[f"{k}/split"] != launches[k]:
            raise AssertionError(f"[train] {k}: {variants[f'{k}/split']} of "
                                 f"{launches[k]} launches took the split "
                                 f"path in the int8 run")
    rows = r0["rows"]
    if not all(rows["equal"]) or any(
            r["rows"]["split"][k] != 1 for r in ranks
            for k in INT8_REDUCE_KERNELS[:2]):
        raise AssertionError(f"[train] int8 kernels differ from their plain "
                             f"versions on the gradient rows, or did not "
                             f"split them: {rows}")
    report["launches_train"] = launches
    report["train_rows"] = rows
    log(f"[train] ZeRO-1 == plain AdamW, max |diff| {d:.3e} over the params "
        f"(fp32); int8 run launches per rank {launches}, split "
        + ", ".join(f"{k} {variants[k + '/split']}"
                    for k in INT8_REDUCE_KERNELS[:2]))
    log(f"[train] dp=2 int8 run: {r0['int8_s']:.3f} s for {DP_STEPS} steps "
        f"(rank 0, gloo on one card) [{card}]")
    bound = {k: rows["bytes"][k] / HBM_BYTES_PER_S * 1e3
             for k in INT8_REDUCE_KERNELS}
    rows["bound_ms"] = bound
    log(f"[train] int8 kernels on rank 0's embedding-table gradient "
        f"({rows['elements']} {rows['dtype']} elements, 2 shard rows): "
        f"bit-equal to their plain versions, both quantize kernels split; "
        f"device ms (eager ms, plain ms, bound ms by bytes) "
        + ", ".join(f"{k} {rows['ms'][k]:.4f} ({rows['eager_ms'][k]:.4f}, "
                    f"{rows['plain_ms'][k]:.3f}, {bound[k]:.4f})"
                    for k in INT8_REDUCE_KERNELS) + f" [{card}]")


def train_tp_rank(group, cfg):
    """Body of each rank of phase 14 (d): this rank's shard of the tp=2
    fp32 twin, ``DP_STEPS`` steps; [(loss, gnorm)]."""
    import torch
    from repro_torch.models import api
    from repro_torch.training.trainer import init_train_state
    config = train_config(cfg, DP_STEPS, TWIN_BATCH, DP_SEQ,
                          parallel=(1, 2))
    params = api.init_params(0, cfg, tp=2, dtype=torch.float32,
                             device=group.device, rank=group.rank)
    params, opt = init_train_state(config, group=group, params=params)
    return run_steps(config, params, opt, DP_STEPS, group)


def train_tp(report, card: str):
    """Phase 14 (d): the fp32 twin at tp=2 (two ranks on cuda:0 over gloo)
    against tp=1 on the same weights: the losses agree, and the gradient
    norm is twice tp=1's, as the reference's (its ``lax.psum`` transposes to
    ``psum`` under ``shard_map(check_vma=False)``)."""
    import numpy as np
    import torch
    from repro_torch.launch.mesh import spawn
    from repro_torch.models import api
    from repro_torch.training.trainer import init_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = train_twin()
    config = train_config(cfg, DP_STEPS, TWIN_BATCH, DP_SEQ)
    params = api.init_params(0, cfg, tp=2, dtype=torch.float32,
                             device="cuda")
    params, opt = init_train_state(config, params=params)
    tp1 = np.array(run_steps(config, params, opt, DP_STEPS))
    del params, opt
    free_cuda()
    ranks = spawn(train_tp_rank, 2, args=(cfg,), device="cuda:0",
                  backend="gloo", timeout_s=600)
    tp2 = np.array(ranks[0])
    if ranks[1] != ranks[0]:
        raise AssertionError(f"[train] tp=2 ranks disagree: {ranks}")
    np.testing.assert_allclose(tp2[0], [tp1[0, 0], 2 * tp1[0, 1]],
                               rtol=1e-4)
    np.testing.assert_allclose(tp2[:, 0], tp1[:, 0], rtol=1e-3)
    np.testing.assert_allclose(tp2[:, 1], 2 * tp1[:, 1], rtol=1e-3)
    report["train_tp"] = dict(tp1=tp1.tolist(), tp2=tp2.tolist())
    log(f"[train] {cfg.name} tp=2 (gloo on the card) vs tp=1: (loss, gnorm) "
        f"{tp2.tolist()} vs {tp1.tolist()}: gnorm ratio "
        f"{(tp2[:, 1] / tp1[:, 1]).tolist()} (2 = the reference's psum "
        f"transpose) [{card}]")


def train_all(report, card: str):
    """Phase 14 (a)-(d)."""
    train_full(report, card)
    train_card_vs_cpu(card)
    train_dp(report, card)
    train_tp(report, card)


# ---------------------------------------------------------------------------
# phase 15: launch/runner and the dense Engine under TP, blockwise attention,
# the dry run
# ---------------------------------------------------------------------------

RUNNER_NEW = 32          # new tokens a request in (a) and (b)
RUNNER_INT8_NEW = 8      # in (a)'s int8 pass: its launch counts need only a
                         # few reduces, and gloo's int8 pairs are the slowest
RUNNER_TWIN_NEW = 16     # in (c)
RUNNER_TRAIN_STEPS = 2   # (c)'s whisper training steps
RUNNER_REQUESTS = 3
BLOCKWISE_PROMPT, BLOCKWISE_BLOCK = 1024, 256
DRYRUN_SHAPES = ("decode_32k", "prefill_32k")


def runner_serve(eng, reqs, max_new: int) -> dict:
    """Serve ``reqs`` (dicts of ``Request`` fields) greedily on a dense
    ``Engine`` from a zeroed registry and launch counts, the host time in
    the TP reduces recorded (``PsumTimers``) and the peak memory from a
    reset: tokens, metrics, launches, reduces, wall, peak GiB.  Every
    sampled logits row must be finite and every request complete."""
    import numpy as np
    import torch
    from repro_torch.kernels import native
    from repro_torch.serving import Request, engine
    from repro_torch.serving.requests import SamplingParams

    reset_observability(eng)
    rids = [eng.add_request(Request(sampling=SamplingParams(
        max_new_tokens=max_new, eos_id=-1), **r)) for r in reqs]
    real_sample = engine.sample

    def finite_sample(logits, sp, step):
        if not np.isfinite(logits).all():
            raise AssertionError("non-finite logits row")
        return real_sample(logits, sp, step)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    native.reset_launches()
    timers = PsumTimers()
    engine.sample = finite_sample
    t0 = time.perf_counter()
    try:
        done = eng.run_until_complete()
    finally:
        engine.sample = real_sample
        timers.restore()
    wall = time.perf_counter() - t0
    tokens = [done.get(r) for r in rids]
    m = dict(eng.metrics)
    if any(t is None or len(t) != max_new for t in tokens) or \
            m["completed"] != len(reqs):
        raise AssertionError(f"not every request completed: {m}")
    return dict(tokens=tokens, m=m, launches=dict(native.LAUNCHES),
                psum=dict(timers.acc), wall=wall,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def runner_traffic(name: str, cfg) -> list:
    """Phase 15's requests of ``name``: phase 3's first three baseline
    prompts (qwen3-8b), phase 10's first three whisper requests with their
    frames, or phase 13's first three VLM requests (one text-only)."""
    if name == "whisper":
        prompts, frames = whisper_traffic(cfg)
        return [dict(prompt=p, frames=f) for p, f in
                zip(prompts[:RUNNER_REQUESTS], frames)]
    if name == "vlm":
        _, prompts, patches = vlm_traffic(cfg, RUNNER_REQUESTS)
        return [dict(prompt=p, patches=pt) for p, pt in zip(prompts, patches)]
    return [dict(prompt=p) for p in
            baseline_prompts(cfg)[1][:RUNNER_REQUESTS]]


def runner_models(twin: bool) -> dict:
    """name -> (config, engine kwargs): qwen3-8b and whisper-medium at full
    width and depth in bf16 (``twin`` False), or the 2-layer (2 + 2) fp32
    twins at full width of qwen3-8b, whisper-medium and internvl2-2b."""
    import dataclasses
    from repro_torch.config import get_model_config
    from repro_torch.configs.whisper_medium import N_TEXT_CTX
    out = {}
    for name, arch in (("qwen3-8b", "qwen3-8b"), ("whisper", "whisper-medium"),
                       ("vlm", "internvl2-2b")):
        if name == "vlm" and not twin:
            continue
        cfg = get_model_config(arch)
        if twin:
            cfg = dataclasses.replace(cfg, num_layers=2, **(
                dict(encoder_layers=2) if cfg.encoder_layers else {}))
        out[name] = (cfg, dict(max_batch=RUNNER_REQUESTS,
                               max_len=N_TEXT_CTX if name == "whisper"
                               else 2048, bucket=64))
    return out


def runner_config(cfg, tp: int, quantized: bool = False):
    from repro_torch.config import Config, ISOConfig, ParallelConfig
    return Config(model=cfg, parallel=ParallelConfig(data=1, model=tp),
                  iso=ISOConfig(quantized_comm=quantized))


def runner_rank(group):
    """Body of each rank of phase 15 (a)-(c) (module level: the spawned
    ranks import it): qwen3-8b bf16 plain then quantized, whisper-medium
    bf16 (its encoder timed alone first), the fp32 twins, and whisper's
    2-layer twin trained at tp=2."""
    import torch
    from repro_torch.models import api, whisper
    from repro_torch.serving import Engine
    from repro_torch.training.trainer import init_train_state

    out = {}
    for name, (cfg, kw) in runner_models(twin=False).items():
        params = api.init_params(0, cfg, tp=2, dtype=torch.bfloat16,
                                 device=group.device, rank=group.rank)
        reqs = runner_traffic(name, cfg)
        if name == "whisper":
            config = runner_config(cfg, 2)
            f0 = torch.from_numpy(reqs[0]["frames"]).to(group.device)[None]
            enc_ms = []
            for _ in range(4):
                t0 = time.perf_counter()
                enc = whisper.encode(params, cfg, group.axis_ctx(),
                                     config.iso, f0)
                torch.cuda.synchronize()
                enc_ms.append(1e3 * (time.perf_counter() - t0))
            if not torch.isfinite(enc).all():
                raise AssertionError("non-finite encoder output")
            del enc, f0
            out["whisper encoder ms"] = enc_ms
        for q in ((False, True) if name == "qwen3-8b" else (False,)):
            eng = Engine(runner_config(cfg, 2, q), params, mesh=group, **kw)
            out[f"{name}{' quantized' if q else ''}"] = runner_serve(
                eng, reqs, RUNNER_INT8_NEW if q else RUNNER_NEW)
            del eng
            free_cuda()
        del params
        free_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, (cfg, kw) in runner_models(twin=True).items():
        params = api.init_params(0, cfg, tp=2, dtype=torch.float32,
                                 device=group.device, rank=group.rank)
        eng = Engine(runner_config(cfg, 2), params, mesh=group, **kw)
        out[f"{name} twin"] = runner_serve(eng, runner_traffic(name, cfg),
                                           RUNNER_TWIN_NEW)
        del eng, params
        free_cuda()
    cfg = runner_models(twin=True)["whisper"][0]
    config = train_config(cfg, RUNNER_TRAIN_STEPS, TWIN_BATCH, TWIN_SEQ,
                          parallel=(1, 2))
    params = api.init_params(0, cfg, tp=2, dtype=torch.float32,
                             device=group.device, rank=group.rank)
    params, opt = init_train_state(config, group=group, params=params)
    out["whisper train"] = run_steps(config, params, opt, RUNNER_TRAIN_STEPS,
                                     group)
    return out


def runner_check_ranks(label: str, ranks) -> dict:
    """Rank 0's run of ``label``, once every rank gave its tokens."""
    runs = [r[label] for r in ranks]
    if any(r["tokens"] != runs[0]["tokens"] for r in runs):
        raise AssertionError(f"[runner] {label}: ranks emitted different "
                             f"tokens")
    return runs[0]


def runner_tp(report, card: str):
    """Phase 15 (a)-(c): the fp32 twins' tp=1 tokens and whisper's tp=1
    training on the card first, then one spawn of two ranks on cuda:0
    over gloo, and the checks."""
    import numpy as np
    import torch
    from repro_torch.launch.mesh import spawn
    from repro_torch.models import api
    from repro_torch.serving import Engine
    from repro_torch.training.trainer import init_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    want = {}
    for name, (cfg, kw) in runner_models(twin=True).items():
        # built at tp=2, whole: the tp=1 engine runs the same function (no
        # head, vocab or expert pad differs between tp 1 and 2 here)
        params = api.init_params(0, cfg, tp=2, dtype=torch.float32,
                                 device="cuda")
        eng = Engine(runner_config(cfg, 1), params, device="cuda", **kw)
        want[name] = runner_serve(eng, runner_traffic(name, cfg),
                                  RUNNER_TWIN_NEW)["tokens"]
        del eng, params
        free_cuda()
    cfg = runner_models(twin=True)["whisper"][0]
    config = train_config(cfg, RUNNER_TRAIN_STEPS, TWIN_BATCH, TWIN_SEQ)
    params = api.init_params(0, cfg, tp=2, dtype=torch.float32, device="cuda")
    params, opt = init_train_state(config, params=params)
    tp1 = np.array(run_steps(config, params, opt, RUNNER_TRAIN_STEPS))
    del params, opt
    free_cuda()

    t0 = time.perf_counter()
    ranks = spawn(runner_rank, 2, device="cuda:0", backend="gloo",
                  timeout_s=900)
    log(f"[runner] 2 ranks on cuda:0 over gloo, "
        f"{time.perf_counter() - t0:.1f}s with start-up and weights")
    full = runner_models(twin=False)
    for label in ("qwen3-8b", "qwen3-8b quantized", "whisper"):
        run = runner_check_ranks(label, ranks)
        m, launches = run["m"], run["launches"]
        n_reduces = sum(n for k, (_, n) in run["psum"].items()
                        if k.endswith("psum_start"))
        int8 = {k: launches[k] for k in INT8_REDUCE_KERNELS}
        want_int8 = n_reduces if label.endswith("quantized") else 0
        others = {k: n for k, n in launches.items()
                  if k not in INT8_REDUCE_KERNELS and n}
        if n_reduces <= 0 or others or \
                any(n != want_int8 for n in int8.values()):
            raise AssertionError(f"[runner] {label}: {n_reduces} reduces, "
                                 f"int8 launches {int8}, others {others}: "
                                 f"want {want_int8} of each int8 kernel and "
                                 f"no other")
        steps = m["decode_calls"]
        inside = {k: (1e3 * t / steps if k.startswith("decode")
                      else 1e3 * t, n)
                  for k, (t, n) in sorted(run["psum"].items())}
        cfg = full[label.split()[0]][0]
        peaks = [r[label]["peak_gib"] for r in ranks]
        log(f"[runner] {cfg.name} {cfg.num_layers}L bf16 dense Engine tp=2 "
            f"{'int8 reduces' if want_int8 else 'bf16 reduces'} ({TP_LABEL}):"
            f" {len(run['tokens'])} requests, prompts "
            f"{[len(r['prompt']) for r in runner_traffic(label.split()[0], cfg)]}"
            f", {len(run['tokens'][0])} new each, ranks agree; prefill "
            f"{m['prefill_tokens']} tok in {m['prefill_s']:.3f}s = "
            f"{m['prefill_tokens'] / m['prefill_s']:.1f} tok/s; decode "
            f"{1e3 * m['decode_s'] / steps:.3f} ms/step over {steps} steps; "
            f"peak allocated per rank {[round(p, 3) for p in peaks]} GiB; "
            f"wall {run['wall']:.1f}s [{card}]")
        log(f"[runner] {label} rank 0 host time inside the reduces (decode: "
            f"ms per step; prefill: ms in all; calls in all): "
            + ", ".join(f"{k} {v:.2f} ({n})" for k, (v, n) in inside.items()))
        log(f"[runner] {label}: {n_reduces} reduces, int8 kernel launches "
            f"{int8}, quantize_int8 {launches['quantize_int8']}")
        report.setdefault("runner", {})[label] = dict(
            prefill_tok_s=m["prefill_tokens"] / m["prefill_s"],
            decode_ms_step=1e3 * m["decode_s"] / steps, peak_gib=peaks,
            reduces=n_reduces, psum_host=inside)
    report["launches_runner"] = {
        k: ranks[0]["qwen3-8b quantized"]["launches"][k]
        for k in INT8_REDUCE_KERNELS}
    enc = ranks[0]["whisper encoder ms"]
    report["runner"]["whisper"]["encoder_ms"] = sorted(enc[1:])[1]
    log(f"[runner] whisper-medium tp=2 encoder ({TP_LABEL}), rank 0, ms a "
        f"request: {[round(t, 2) for t in enc]} (the first with warm-up) "
        f"[{card}]")
    for name in want:
        run = runner_check_ranks(f"{name} twin", ranks)
        if run["tokens"] != want[name]:
            diff = [i for i, (a, b) in enumerate(zip(run["tokens"],
                                                     want[name])) if a != b]
            raise AssertionError(f"[runner] {name} fp32 twin: tp=2 tokens "
                                 f"differ from tp=1's in requests {diff}")
    log(f"[runner] fp32 twins at full width, 2 (2 + 2) layers: the dense "
        f"Engine at tp=2 == tp=1 token for token on both ranks for "
        f"{sorted(want)} ({RUNNER_REQUESTS} requests, {RUNNER_TWIN_NEW} new "
        f"each) [{card}]")
    tp2 = np.array(ranks[0]["whisper train"])
    if ranks[1]["whisper train"] != ranks[0]["whisper train"]:
        raise AssertionError(f"[runner] whisper tp=2 training: ranks "
                             f"disagree: {[r['whisper train'] for r in ranks]}")
    np.testing.assert_allclose(tp2[:, 0], tp1[:, 0], rtol=1e-4)
    np.testing.assert_allclose(tp2[:, 1], 2 * tp1[:, 1], rtol=1e-4)
    report["runner"]["whisper_train"] = dict(tp1=tp1.tolist(),
                                             tp2=tp2.tolist())
    log(f"[runner] whisper-medium 2+2-layer fp32 trained at tp=2 (gloo on "
        f"the card) vs tp=1: (loss, gnorm) {tp2.tolist()} vs {tp1.tolist()};"
        f" gnorm ratio {(tp2[:, 1] / tp1[:, 1]).tolist()} (2 = the "
        f"reference's psum transpose) [{card}]")


def runner_blockwise(report, card: str):
    """Phase 15 (d): ``attn_impl="blockwise"`` (key blocks of 256) against
    ``"dense"`` on a 2-layer fp32 twin at qwen3-8b's widths, one
    1024-token prompt, prefill logits within 1e-4."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.config import ISOConfig, get_model_config
    from repro_torch.core.overlap import AxisCtx
    from repro_torch.models import api

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_model_config("qwen3-8b"), num_layers=2)
    params = api.init_params(0, cfg, dtype=torch.float32, device="cuda")
    toks = torch.from_numpy(np.random.default_rng(15).integers(
        2, cfg.vocab_size, (1, BLOCKWISE_PROMPT)).astype(np.int32)).cuda()
    out, ms = {}, {}
    for impl in ("dense", "blockwise"):
        c = dataclasses.replace(cfg, attn_impl=impl,
                                attn_block_k=BLOCKWISE_BLOCK)
        for _ in range(2):                     # the second call timed
            t0 = time.perf_counter()
            out[impl] = api.prefill(params, c, AxisCtx(), ISOConfig(),
                                    {"tokens": toks},
                                    logits_mode="all")["logits_local"]
            torch.cuda.synchronize()
            ms[impl] = 1e3 * (time.perf_counter() - t0)
    err = (out["blockwise"] - out["dense"]).abs().max().item()
    if not torch.isfinite(out["blockwise"]).all() or err > 1e-4:
        raise AssertionError(f"[runner] blockwise prefill logits differ "
                             f"from dense by {err}")
    report["blockwise"] = dict(max_abs_err=err, ms=ms)
    log(f"[runner] attn_impl=blockwise (block_k {BLOCKWISE_BLOCK}) vs dense, "
        f"qwen3-8b widths, 2 layers, fp32, {BLOCKWISE_PROMPT}-token prompt "
        f"(2 ISO chunks): logits max abs err {err:.3e} (limit 1e-4); "
        f"prefill ms {ms['blockwise']:.2f} vs {ms['dense']:.2f} [{card}]")
    del params, out
    free_cuda()


def runner_dryrun(report, card: str):
    """Phase 15 (e): the dry run on this machine's PyTorch (the ``"fake"``
    process-group backend, meta tensors, no device): qwen3-8b x
    ``DRYRUN_SHAPES`` at 16 x 16, ISO on and off; prefill's ISO
    ``hideable_fraction`` must exceed iso-off's, and decode's collectives,
    wire bytes and fraction must be the same with ISO on and off (the
    reference's dry run applies ISO to prefill only); the quantized
    train_4k cell must be reported as refused."""
    import tempfile
    from repro_torch.core.analysis import overlap_metric
    from repro_torch.launch import dryrun

    out = {}
    for shape in DRYRUN_SHAPES:
        frac = {}
        for iso_on in (True, False):
            rep, tr = dryrun.trace_shape("qwen3-8b", shape, iso_on=iso_on,
                                         verbose=False)
            ov = overlap_metric(tr)
            r = rep["roofline"]
            frac[iso_on] = ov["hideable_fraction"]
            out[f"{shape} iso={'on' if iso_on else 'off'}"] = dict(
                collectives=rep["collective_counts"],
                wire_bytes=rep["collective_wire_bytes_per_device"],
                roofline={k: r[k] for k in ("compute_s", "memory_s",
                                            "collective_s", "bottleneck")},
                hideable_fraction=ov["hideable_fraction"],
                trace_s=rep["compile_s"])
            log(f"[dryrun] qwen3-8b x {shape} [16x16] iso="
                f"{'on' if iso_on else 'off'}: collectives "
                f"{rep['collective_counts']}, wire "
                f"{rep['collective_wire_bytes_per_device']:.4e} B/device; "
                f"roofline compute {r['compute_s']:.3e}s memory "
                f"{r['memory_s']:.3e}s collective {r['collective_s']:.3e}s "
                f"-> {r['bottleneck']} ('h100' profile; link_bw the data "
                f"sheet's); hideable_fraction {ov['hideable_fraction']:.4f} "
                f"({ov['avg_hideable_dots']:.2f} of {ov['total_dots']} dots "
                f"over {ov['collectives']} collectives); traced in "
                f"{rep['compile_s']}s")
        on, off = (out[f"{shape} iso={s}"] for s in ("on", "off"))
        if shape.startswith("prefill") and not frac[True] > frac[False]:
            raise AssertionError(f"[dryrun] {shape}: ISO's hideable fraction"
                                 f" {frac[True]} is not above iso-off's "
                                 f"{frac[False]}")
        if not shape.startswith("prefill") and any(
                on[k] != off[k] for k in ("collectives", "wire_bytes",
                                          "hideable_fraction")):
            raise AssertionError(f"[dryrun] {shape}: ISO on {on} differs "
                                 f"from ISO off {off}")
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/q.json"
        rc = dryrun.main(["--arch", "qwen3-8b", "--shape", "train_4k",
                          "--quantized", "--out", path])
        with open(path) as f:
            data = json.load(f)
    fails = data["failures"]
    if rc != 1 or data["reports"] or len(fails) != 1 or \
            "int8 TP reduces under autograd" not in fails[0][3]:
        raise AssertionError(f"[dryrun] --quantized train_4k: rc {rc}, "
                             f"{data}")
    out["quantized train_4k"] = fails[0][3]
    report["dryrun"] = out
    log(f"[dryrun] --quantized train_4k reported as refused: {fails[0][3]}")


def runner_all(report, card: str):
    """Phase 15 (a)-(e)."""
    runner_tp(report, card)
    runner_blockwise(report, card)
    runner_dryrun(report, card)


# ---------------------------------------------------------------------------
# phase 16: disaggregated serving under TP, two tp=2 rank groups on the one
# card over gloo
# ---------------------------------------------------------------------------

DISAGG_TP_LAYERS = 12              # qwen3-8b's depth in (a): 12 of 36, as
                                   # phase 5's (gloo sets every tp=2 number)
DISAGG_TP_NEW = 16                 # new tokens a request, (a) and (b)
DISAGG_TP_RID = 1000               # explicit request ids: every rank of both
                                   # groups must name a request alike


def disagg_tp_config(cfg, prompts, quantized: bool = False,
                     disagg: bool = True):
    """Phase 5's serving settings at tp=2 (page 16, max_batch 4, max_len
    2048, budget 512, the reference's defaults: sharing and packing), under
    ``disagg`` with a decode pool one and a half times the largest
    request's pages, so two of the long requests never fit it together and
    the router defers; ``quantized_comm`` with ``quantized``."""
    from repro_torch.config import Config, ISOConfig, ParallelConfig, \
        ServingConfig
    from repro_torch.serving.kvcache import pages_for
    need = max(pages_for(len(p) + DISAGG_TP_NEW, 16) for p in prompts)
    sv = ServingConfig(page_size=16, max_batch=4, max_len=2048,
                       prefill_token_budget=512, disagg=disagg,
                       decode_pool_pages=need + need // 2 if disagg else 0)
    return Config(model=cfg, parallel=ParallelConfig(data=1, model=2),
                  iso=ISOConfig(quantized_comm=quantized), serving=sv)


def disagg_tp_models() -> dict:
    """(a) qwen3-8b at full width cut to DISAGG_TP_LAYERS layers, bf16;
    (b) its 2-layer fp32 twin at full width: name -> (config, dtype)."""
    import dataclasses
    from repro_torch.config import get_model_config
    cfg = get_model_config("qwen3-8b")
    return {"bf16": (dataclasses.replace(cfg, num_layers=DISAGG_TP_LAYERS),
                     "bfloat16"),
            "fp32": (dataclasses.replace(cfg, num_layers=2), "float32")}


def disagg_tp_serve(eng, prompts, rid0: int, record: bool) -> dict:
    """Serve ``prompts`` greedily (DISAGG_TP_NEW each, request ids from
    ``rid0``) on a ``DisaggRouter`` rank or a mixed TP engine, from zeroed
    launch counts and peak memory; with ``record``, under a
    ``LogitsRecorder``: tokens, rids, this rank's engine's metrics and
    closure keys, launches, the router's counters and wire, wall, peak GiB
    and the recorded rows."""
    import torch
    from repro_torch.kernels import native
    from repro_torch.serving import Request
    from repro_torch.serving.disagg import DisaggRouter
    from repro_torch.serving.requests import SamplingParams

    router = eng if isinstance(eng, DisaggRouter) else None
    rank_eng = eng if router is None else (router.prefill or router.decode)
    rids = [eng.add_request(Request(
        prompt=p.copy(), rid=rid0 + i, sampling=SamplingParams(
            max_new_tokens=DISAGG_TP_NEW, eos_id=-1)))
        for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    native.reset_launches()
    rec = LogitsRecorder(rank_eng.cfg.vocab_size) if record else None
    t0 = time.perf_counter()
    if rec is not None:
        with rec:
            outs = eng.run_until_complete()
    else:
        outs = eng.run_until_complete()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tokens = [outs.get(r) for r in rids]
    if any(t is None or len(t) != DISAGG_TP_NEW for t in tokens):
        raise AssertionError(f"not every request completed: {tokens}")
    rank_eng.alloc.check()
    if rank_eng.alloc.free_pages != rank_eng.alloc.num_pages:
        raise AssertionError(f"{rank_eng.phase} pages leaked")
    return dict(tokens=tokens, rids=rids, m=dict(rank_eng.metrics),
                phase=rank_eng.phase, page_bytes=rank_eng.kv.page_bytes(),
                prefill_keys=len(rank_eng._prefill_fns),
                decode_keys=sorted(rank_eng._decode_fns),
                schedule_steps=dict(rank_eng.decode_schedule_steps),
                launches=dict(native.LAUNCHES),
                variants=dict(native.VARIANTS), wall=wall,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                stats=router.migration_stats() if router else None,
                pending=len(router._pending) if router else 0,
                wire=dict(router.wire) if router else None,
                finite=rec.finite if rec else True,
                rec=rec.rec if rec else None)


def disagg_tp_rank(dg, prompts):
    """Body of each of phase 16's four ranks (module level: the spawned
    ranks import it).  For (a) and (b) in turn: this rank's shard of the
    weights; on the prefill group alone, the mixed tp=2 ``PagedEngine``
    the router is held against ((a) bf16 and (b) with ``quantized_comm``;
    (b) plain is held against tp=1 in the parent); then the
    ``DisaggRouter`` across both groups.  Logits rows come back from group
    rank 0 of each."""
    import torch
    import torch.distributed as dist
    from repro_torch.models import api
    from repro_torch.serving import PagedEngine
    from repro_torch.serving.disagg import DisaggRouter

    out = {"role": dg.role, "rank": dg.tp_group.rank}
    lead = dg.tp_group.rank == 0
    rid = DISAGG_TP_RID
    for name, (cfg, dtype) in disagg_tp_models().items():
        params = api.init_params(0, cfg, tp=2, dtype=getattr(torch, dtype),
                                 device=dg.device, rank=dg.tp_group.rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        passes = (("", False),) if name == "bf16" else \
            (("", False), (" quantized", True))
        for suffix, q in passes:
            label = name + suffix
            if dg.role == "prefill" and (name == "bf16" or q):
                eng = PagedEngine(disagg_tp_config(cfg, prompts, q, False),
                                  params, mesh=dg.tp_group)
                out[f"{label} mixed"] = disagg_tp_serve(
                    eng, prompts, rid, record=lead and name == "bf16")
                del eng
                free_cuda()
            rid += len(prompts)
            dist.barrier(group=dg.world)
            router = DisaggRouter(disagg_tp_config(cfg, prompts, q), params,
                                  mesh=dg)
            out[label] = disagg_tp_serve(router, prompts, rid,
                                         record=lead and name == "bf16")
            rid += len(prompts)
            del router
            free_cuda()
        del params
        free_cuda()
    return out


def disagg_tp_check(label: str, ranks, n_req: int) -> list:
    """Each rank's run of ``label``, once every rank gave the same tokens
    and router counters, each role kept to its phase (no decode closure on
    a prefill rank, no prefill closure on a decode rank, so B3 launched on
    the prefill ranks alone and B1 on the decode ranks alone), nothing is
    left pending and every logit seen was finite."""
    runs = [r[label] for r in ranks]
    for r, run in enumerate(runs):
        if run["tokens"] != runs[0]["tokens"] or \
                run["stats"] != runs[0]["stats"]:
            raise AssertionError(f"[disagg tp] {label}: rank {r} disagrees: "
                                 f"{run['stats']} vs {runs[0]['stats']}")
        if run["pending"] or not run["finite"]:
            raise AssertionError(f"[disagg tp] {label}: a transfer pending "
                                 f"or non-finite logits on rank {r}")
        b1, b3 = run["launches"]["paged_decode"], \
            run["launches"]["paged_prefill"]
        if run["phase"] == "prefill":
            ok = run["decode_keys"] == [] and b1 == 0 and b3 > 0 and \
                run["m"]["resumed_grants"] > 0
        else:
            ok = run["prefill_keys"] == 0 and b3 == 0 and b1 > 0
        if not ok:
            raise AssertionError(
                f"[disagg tp] {label}: rank {r} ({run['phase']}) ran the "
                f"other phase or missed its kernel: closures "
                f"{run['prefill_keys']} prefill / {run['decode_keys']} "
                f"decode, B1 {b1}, B3 {b3}, resumed "
                f"{run['m']['resumed_grants']}")
    st = runs[0]["stats"]
    if st["deferrals"] < 1 or st["migrated_requests"] < n_req:
        raise AssertionError(f"[disagg tp] {label}: no deferral, or not "
                             f"every request migrated: {st}")
    return runs


def disagg_tp(report, card: str):
    """Phase 16: disaggregated serving at tp=2, the prefill group (ranks 0
    and 1) and the decode group (2 and 3) sharing the card over gloo, on
    phase 3's baseline prompts (the first longer than the 512-token
    budget: resumed grants, B3 on the prefill ranks).  (a) qwen3-8b bf16 at
    full width, 12 of 36 layers, held against the mixed tp=2 engine under
    the bf16 near-tie rule; (b) the 2-layer fp32 twin: the router's tokens
    EQUAL the tp=1 ``PagedEngine``'s on the card, and with
    ``quantized_comm`` EQUAL the mixed tp=2 engine's with the same int8
    reduces (which change the numbers: tp=1 is printed beside it)."""
    import torch
    from repro_torch.launch.mesh import spawn
    from repro_torch.models import api
    from repro_torch.serving import PagedEngine

    models = disagg_tp_models()
    lengths, prompts = baseline_prompts(models["bf16"][0])
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = models["fp32"][0]
    # built at tp=2, whole: the tp=1 engine runs the same function
    params = api.init_params(0, cfg32, tp=2, dtype=torch.float32,
                             device="cuda")
    config = disagg_tp_config(cfg32, prompts, disagg=False)
    import dataclasses
    from repro_torch.config import ParallelConfig
    eng = PagedEngine(dataclasses.replace(config, parallel=ParallelConfig()),
                      params, device="cuda", cuda_graphs=False)
    want = disagg_tp_serve(eng, prompts, 0, record=False)["tokens"]
    del eng, params
    free_cuda()

    t0 = time.perf_counter()
    ranks = spawn(disagg_tp_rank, 2, args=(prompts,), device="cuda:0",
                  backend="gloo", timeout_s=900, disagg=True)
    log(f"[disagg tp] 4 ranks on cuda:0 over gloo (prefill 0-1, decode "
        f"2-3), {time.perf_counter() - t0:.1f}s with start-up and weights")
    roles = [(r["role"], r["rank"]) for r in ranks]
    if roles != [("prefill", 0), ("prefill", 1), ("decode", 0),
                 ("decode", 1)]:
        raise AssertionError(f"[disagg tp] rank roles {roles}")
    pre, dec = ranks[0], ranks[2]

    # (a) bf16 at 12 layers
    cfg = models["bf16"][0]
    runs = disagg_tp_check("bf16", ranks, len(prompts))
    mixed = pre["bf16 mixed"]
    rec_mixed, rec_router = LogitsRecorder(cfg.vocab_size), \
        LogitsRecorder(cfg.vocab_size)
    rec_mixed.rec = mixed["rec"]
    rec_router.rec = {**pre["bf16"]["rec"], **dec["bf16"]["rec"]}
    report["disagg_tp_vs_mixed"] = check_against_plain(
        "disagg tp", TOL["bfloat16"], mixed, pre["bf16"], rec_mixed,
        rec_router, card)
    pm, dm = pre["bf16"]["m"], dec["bf16"]["m"]
    st = pre["bf16"]["stats"]
    wire_p, wire_d = pre["bf16"]["wire"], dec["bf16"]["wire"]
    page_bytes = pre["bf16"]["page_bytes"]
    moved = st["migrated_pages"] * page_bytes
    n_tr = max(wire_d["transfers"], 1)
    peaks = [round(r["bf16"]["peak_gib"], 3) for r in ranks]
    pool = disagg_tp_config(cfg, prompts).serving.decode_pool_pages
    log(f"[disagg tp] qwen3-8b {cfg.num_layers} of 36 layers (cut for the "
        f"script's time limit) bf16 tp=2 x 2 groups ({TP_LABEL}): prompts "
        f"{lengths}, {DISAGG_TP_NEW} new each, budget 512, decode pool "
        f"{pool} pages; all four ranks agree; migration_stats {st} "
        f"[{card}]")
    log(f"[disagg tp] prefill group {pm['prefill_tokens']} tok in "
        f"{pm['prefill_s']:.3f}s = {pm['prefill_tokens'] / pm['prefill_s']:.1f}"
        f" tok/s ({pm['prefill_calls']} calls, {pm['resumed_grants']} "
        f"resumed); decode group {1e3 * dm['decode_s'] / dm['decode_calls']:.3f}"
        f" ms/step over {dm['decode_calls']} steps "
        f"{dec['bf16']['schedule_steps']}, {dm['decode_tokens']} tokens; "
        f"the mixed tp=2 engine: "
        f"{mixed['m']['prefill_tokens'] / mixed['m']['prefill_s']:.1f} tok/s,"
        f" {1e3 * mixed['m']['decode_s'] / mixed['m']['decode_calls']:.3f} "
        f"ms/step over {mixed['m']['decode_calls']} steps "
        f"{mixed['schedule_steps']}, {mixed['m']['decode_tokens']} tokens; "
        f"wall router {pre['bf16']['wall']:.1f}s, mixed "
        f"{mixed['wall']:.1f}s; peak allocated a rank {peaks} GiB [{card}]")
    log(f"[disagg tp] transfers {wire_d['transfers']}: KV moved {moved} B a "
        f"rank ({st['migrated_pages']} pages of {page_bytes} B, one kv-head "
        f"shard), payload {wire_p['bytes']} B sent by prefill rank 0; host "
        f"ms a transfer (export + send + import, decode rank 0 from the "
        f"decision to the end of its import) "
        f"{1e3 * wire_d['s'] / n_tr:.1f}, the prefill side's (export + send) "
        f"{1e3 * wire_p['s'] / n_tr:.1f}; engines' migration_us "
        f"{st['migration_us']:.0f} [{card}]")
    launches = {}
    for role, run in (("prefill", runs[0]), ("decode", runs[2])):
        launches[role] = dict(run["launches"], decode_reduce=run[
            "variants"].get("paged_decode/fold", 0))
    # (b) the fp32 twin: plain against tp=1, quantized against the mixed
    # tp=2 engine with the same int8 reduces
    plain = disagg_tp_check("fp32", ranks, len(prompts))[0]
    quant = disagg_tp_check("fp32 quantized", ranks, len(prompts))
    qmixed = pre["fp32 quantized mixed"]
    if plain["tokens"] != want:
        diff = [i for i, (a, b) in enumerate(zip(plain["tokens"], want))
                if a != b]
        raise AssertionError(f"[disagg tp] fp32 twin: tp=2 router tokens "
                             f"differ from tp=1's in requests {diff}")
    if quant[0]["tokens"] != qmixed["tokens"]:
        raise AssertionError("[disagg tp] fp32 twin with quantized_comm: the "
                             "router's tokens differ from the mixed tp=2 "
                             "engine's")
    same_tp1 = sum(a == b for a, b in zip(quant[0]["tokens"], want))
    for role, run in (("prefill", quant[0]), ("decode", quant[2])):
        int8 = {k: run["launches"][k] for k in INT8_REDUCE_KERNELS}
        if len(set(int8.values())) != 1 or not all(int8.values()) or \
                run["launches"]["quantize_int8"]:
            raise AssertionError(f"[disagg tp] quantized {role} rank 0: int8 "
                                 f"launches {int8}, quantize_int8 "
                                 f"{run['launches']['quantize_int8']}")
        for k in INT8_REDUCE_KERNELS:
            launches[role][k] = int8[k]
        plain_int8 = [r["fp32"]["launches"][k] for r in ranks
                      for k in INT8_REDUCE_KERNELS]
        if any(plain_int8):
            raise AssertionError("[disagg tp] the plain fp32 run launched "
                                 "int8 kernels")
    log(f"[disagg tp] fp32 2-layer twin at full width, tp=2 x 2 groups: "
        f"router == the tp=1 PagedEngine on the card token for token on "
        f"{len(want)} of {len(want)} requests (migration "
        f"{plain['stats']}); with quantized_comm == the mixed tp=2 engine "
        f"with the same int8 reduces on {len(want)} of {len(want)} "
        f"({same_tp1} of {len(want)} equal to the tp=1 engine's: the int8 "
        f"reduces change the numbers) [{card}]")
    log(f"[disagg tp] launches a rank by role (B1/B3 from (a), the int8 "
        f"three from (b) quantized): {launches}")
    report["launches_disagg_tp"] = launches
    report["disagg_tp"] = dict(
        prefill_tok_s=pm["prefill_tokens"] / pm["prefill_s"],
        decode_ms_step=1e3 * dm["decode_s"] / dm["decode_calls"],
        peak_gib=peaks, stats=st, moved=moved,
        transfer_ms=1e3 * wire_d["s"] / n_tr)


# ---------------------------------------------------------------------------
# phase 4: kernel path against plain path
# ---------------------------------------------------------------------------

def parity_tiny():
    import numpy as np
    import torch
    from repro_torch.config import Config, ISOConfig, ModelConfig, \
        ParallelConfig, ServingConfig
    from repro_torch.models import api
    from repro_torch.serving import PagedEngine, Request
    from repro_torch.serving.requests import SamplingParams

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ModelConfig(name="t-dense", family="dense", num_layers=2,
                      d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                      vocab_size=64, qk_norm=True)
    iso = ISOConfig(enabled=True, num_chunks=2, min_chunk_tokens=8,
                    chunk_align=8)
    cpu_params = api.init_params(0, cfg, dtype=torch.float32, device="cpu")

    def to_cuda(tree):
        if isinstance(tree, dict):
            return {k: to_cuda(v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(to_cuda(v) for v in tree)
        return tree.cuda()

    cuda_params = to_cuda(cpu_params)
    rng = np.random.default_rng(5)
    head = rng.integers(2, 64, 16).astype(np.int32)           # two pages
    twin = np.concatenate([head, rng.integers(2, 64, 21)]).astype(np.int32)
    shared = [np.concatenate([head, rng.integers(2, 64, n)]).astype(np.int32)
              for n in (9, 13)] + [twin, twin.copy()]

    def rand(lens, seed):
        r = np.random.default_rng(seed)
        return [r.integers(2, 64, n).astype(np.int32) for n in lens]

    def rep(lens, seed):
        r = np.random.default_rng(seed)
        return [np.tile(r.integers(2, 64, 6), 12)[:n].astype(np.int32)
                for n in lens]

    # (name, prompts, new tokens, serving over page 8, max_batch 2); each
    # runs with the reference's defaults (packed grants, prefix sharing)
    cases = [("mixed", rand((70, 12, 33, 7), 3), 5,
              dict(prefill_token_budget=16, max_len=160)),
             ("splits4", rand((70, 12, 33, 7), 3), 5,
              dict(prefill_token_budget=16, max_len=160, decode_kv_splits=4)),
             ("preempt", rand((40, 40), 6), 8,
              dict(prefill_token_budget=64, max_len=64, num_pages=8)),
             # four same-bucket grants in one tick: one 4-row pack
             ("packed", rand((32, 30, 27, 20), 7), 5,
              dict(prefill_token_budget=256, max_len=96, max_batch=4)),
             # a two-page common head, and two identical prompts that share
             # a partial page and copy it on write
             ("shared", shared, 6,
              dict(prefill_token_budget=64, max_len=96, max_batch=4)),
             ("spec2", rep((30, 24, 33), 8), 10,
              dict(prefill_token_budget=64, max_len=96, spec_k=2)),
             ("spec4", rep((30, 24, 33), 8), 10,
              dict(prefill_token_budget=64, max_len=96, spec_k=4)),
             ("all_preempt", shared[2:] + rep((40,), 9), 8,
              dict(prefill_token_budget=64, max_len=64, num_pages=10,
                   max_batch=3, spec_k=2))]
    counters = ("prefill_calls", "prefill_pad_rows", "prefix_shared_tokens",
                "cow_copies", "spec_calls", "spec_tokens", "preemptions",
                "peak_used_pages")

    def run(dev, params, prompts, new, kw):
        sv = ServingConfig(page_size=8, **{"max_batch": 2, **kw})
        eng = PagedEngine(Config(model=cfg,
                                 parallel=ParallelConfig(data=1, model=1),
                                 iso=iso, serving=sv), params, device=dev)
        rids = [eng.add_request(Request(
            prompt=p.copy(),
            sampling=SamplingParams(max_new_tokens=new, eos_id=-1)))
            for p in prompts]
        res = eng.run_until_complete()
        if eng.alloc.free_pages != eng.alloc.num_pages:
            raise AssertionError("pages leaked")
        return [res[r] for r in rids], {k: eng.metrics[k] for k in counters}

    for name, prompts, new, kw in cases:
        # the same prompts on the batch-1, no-sharing, K=1 engine: the
        # reference's own differential invariant
        plain_kw = dict(kw, prefix_sharing=False, prefill_batching=False,
                        spec_k=0)
        outs = {dev: run(dev, params, prompts, new, kw)
                for dev, params in (("cuda", cuda_params),
                                    ("cpu", cpu_params))}
        plain = {dev: run(dev, params, prompts, new, plain_kw)[0]
                 for dev, params in (("cuda", cuda_params),
                                     ("cpu", cpu_params))}
        if outs["cuda"] != outs["cpu"]:
            raise AssertionError(f"{name}: cuda {outs['cuda']} != cpu "
                                 f"{outs['cpu']}")
        for dev in ("cuda", "cpu"):
            if outs[dev][0] != plain[dev]:
                raise AssertionError(f"{name}: {dev} tokens {outs[dev][0]} "
                                     f"!= the plain engine's {plain[dev]}")
        m = outs["cuda"][1]
        want = {"preempt": ("preemptions",), "packed": ("prefill_calls",),
                "shared": ("prefix_shared_tokens", "cow_copies"),
                "spec2": ("spec_calls",), "spec4": ("spec_calls",),
                "all_preempt": ("preemptions", "prefix_shared_tokens",
                                "spec_calls")}.get(name, ())
        if any(m[k] <= 0 for k in want) or \
                (name == "packed" and m["prefill_calls"] >= len(prompts)):
            raise AssertionError(f"{name}: counters {m} (want {want} > 0)")
        log(f"[parity] {name}: cuda == cpu == the plain engine's greedy "
            f"tokens; counters equal on both devices: {m}")


# ---------------------------------------------------------------------------
# phase 5: tensor parallelism at tp=2, two ranks on the one card over gloo
# ---------------------------------------------------------------------------

TP_NEW_TOKENS = 16
TP_BIG_LAYERS = 12       # qwen3-8b's depth here, cut from 36 to keep the
                         # script inside its time limit (gloo varies most)
PROFILE_NEW = 4          # new tokens of the profiled quantized run
# (reduce, decode schedule) of each full-width run; "auto" is batch_split
TP_BIG_VARIANTS = (("default", "auto"), ("default", "sequential"),
                   ("quantized_comm", "auto"),
                   ("quantized_comm", "sequential"))
TP_LABEL = "gloo, one card: no overlap measured"


COLLECTIVE_PATTERNS = ("sync", "pipelined", "sync+ops", "pipelined+ops")
STAGE_OPS = 40           # small launches between two reduces of a decode step


def collective_ms(group, shape, quantized: bool, pattern: str,
                  n: int = 20) -> float:
    """Host ms per bf16 all-reduce (int8 ``quantized_psum`` when
    ``quantized``) of ``shape`` over the group, after a warm-up.  Patterns:
    ``sync`` reduces one after another with ``psum_now``; ``pipelined``
    issues them in the batch-split decode order, each started with
    ``psum_start`` before the previous one is completed with ``psum_wait``,
    so one is in flight while the other finishes; ``+ops`` enqueues
    ``STAGE_OPS`` small elementwise launches after each issue, standing for
    the dispatch of one half's stage between two reduces."""
    import torch
    from repro_torch.core.overlap import psum_now, psum_start, psum_wait
    ctx = group.axis_ctx(quantized)
    x = torch.ones(shape, dtype=torch.bfloat16, device=group.device)
    y = torch.ones(shape, dtype=torch.bfloat16, device=group.device)

    def ops():
        if pattern.endswith("+ops"):
            z = y
            for _ in range(STAGE_OPS):
                z = z * 0.5 + y

    def run(k):
        if pattern.startswith("sync"):
            for _ in range(k):
                psum_now(x.clone(), ctx)
                ops()
            return
        pend = psum_start(x.clone(), ctx)
        ops()
        for _ in range(k - 1):
            nxt = psum_start(x.clone(), ctx)
            ops()
            psum_wait(pend)
            pend = nxt
        psum_wait(pend)

    run(3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(n)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


class PsumTimers:
    """Host seconds spent inside ``psum_start`` and ``psum_wait`` (and so
    ``psum_now``) while serving, split by phase: a partial whose sequence
    dim is 1 is a decode reduce, any other a prefill one.  Wraps the names
    that ``core/iso.py`` and ``core/overlap.py`` call; ``restore`` puts the
    originals back."""

    def __init__(self):
        from repro_torch.core import iso, overlap
        self.mods = (iso, overlap)
        self.orig = {n: getattr(overlap, n) for n in ("psum_start",
                                                      "psum_wait")}
        self.acc = {}
        for mod in self.mods:
            for name, fn in self.orig.items():
                setattr(mod, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def timed(*args, **kw):
            part = args[0].partial if name == "psum_wait" else args[0]
            phase = "decode" if part.shape[-2] == 1 else "prefill"
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            key = f"{phase} {name}"
            s, n = self.acc.get(key, (0.0, 0))
            self.acc[key] = (s + time.perf_counter() - t0, n + 1)
            return out
        return timed

    def restore(self):
        for mod in self.mods:
            for name, fn in self.orig.items():
                setattr(mod, name, fn)


def tp_rank(group, big, tiny, moe, hymba, vlm):
    """Body of each rank (module level: the spawned ranks import it):
    time one reduce at the decode and prefill shapes in each pattern, serve
    the full-width variants one at a time with the host time inside the
    reduces recorded, freeing the weights after each, a short quantized
    batch-split run under the host profiler, then the tiny ones, the MoE
    ones, the hymba ones and the VLM one.  ``big``/``tiny``/``moe``/
    ``hymba``/``vlm`` are ``serve_rank`` arguments after the group."""
    import torch
    from repro_torch.launch.serve import serve_rank
    d = big[0].model.d_model
    shapes = {"decode half (2, 1, d)": (2, 1, d),
              "prefill chunk (1, 256, d)": (1, 256, d)}
    out = {"collective_ms": {
        f"{name} {'int8' if q else 'bf16'} {pattern}":
            collective_ms(group, shape, q, pattern)
        for name, shape in shapes.items() for q in (False, True)
        for pattern in COLLECTIVE_PATTERNS}}
    config, variants, npz, seed, dtype = big
    out["big"] = []
    timers = PsumTimers()
    try:
        for v in variants:
            timers.acc = {}
            res = serve_rank(group, config, [v], npz, seed, dtype)[0]
            res["psum_host_s"] = timers.acc
            out["big"].append(res)
            free_cuda()
    finally:
        timers.restore()
    # the quantized batch-split run again, short, under the host profiler:
    # which calls the host waits in
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        serve_rank(group, config, [dict(variants[2], max_new=PROFILE_NEW)],
                   npz, seed, dtype)
    out["profile"] = prof.key_averages().table(
        sort_by="self_cpu_time_total", row_limit=12, max_name_column_width=48)
    free_cuda()
    # phase 9 (c): the overlap probe on the tp=2 engine of the default
    # batch-split run; serve_rank serves the requests again after it and
    # requires the same tokens
    t0 = time.perf_counter()
    probed = serve_rank(group, config, [dict(
        variants[0], max_new=PROFILE_NEW, probe=dict(iters=3, warmup=1))],
        npz, seed, dtype)[0]
    out["probe"] = dict(probe=probed["probe"], tokens=probed["tokens"],
                        s=time.perf_counter() - t0)
    free_cuda()
    out["tiny"] = serve_rank(group, *tiny)
    out["moe"] = serve_rank(group, *moe)
    free_cuda()
    out["hymba"] = serve_rank(group, *hymba)
    free_cuda()
    out["vlm"] = serve_rank(group, *vlm)
    return out


def granite_tp_case():
    """Phase 5's MoE pass at tp=1: granite-moe-3b-a800m at full width cut
    to 2 layers (fp32), page 16, max_batch 4, budget 512, and three
    requests of 300-1200 tokens (seed 4), 16 new each: (config, variants)."""
    import dataclasses
    import numpy as np
    from repro_torch.config import Config, ISOConfig, ParallelConfig, \
        ServingConfig, get_model_config
    cfg = dataclasses.replace(get_model_config("granite-moe-3b-a800m"),
                              num_layers=2)
    rng = np.random.default_rng(4)
    lengths = [int(n) for n in rng.integers(300, 1201, 3)]
    lengths[0] = max(lengths[0], 900)            # at least one resumed grant
    prompts = [rng.integers(2, cfg.vocab_size, n).astype(np.int32)
               for n in lengths]
    config = Config(model=cfg, parallel=ParallelConfig(data=1, model=1),
                    iso=ISOConfig(),
                    serving=ServingConfig(page_size=16, max_batch=4,
                                          max_len=2048,
                                          prefill_token_budget=512))
    return config, [dict(prompts=prompts, max_new=TP_NEW_TOKENS)]


def hymba_tp_case():
    """Phase 5's recurrent pass at tp=1: hymba-1.5b at full width cut to 2
    layers with its window cut to 64, fp32, page 16, max_batch 4, budget
    512, three requests of 300-1200 tokens (seed 5), 16 new each, under the
    default (batch-split at tp=2) and the sequential decode schedule.  Seed
    0 makes the same function at tp 1 and 2: the heads the tp=2 layout pads
    (25/5 -> 30/6) are zero, the vocab pads to 32768 and the SSM's inner
    dim to 3200 at both."""
    import dataclasses
    import numpy as np
    from repro_torch.config import Config, ISOConfig, ParallelConfig, \
        ServingConfig, get_model_config
    cfg = dataclasses.replace(get_model_config("hymba-1.5b"), num_layers=2,
                              sliding_window=64)
    rng = np.random.default_rng(5)
    lengths = [int(n) for n in rng.integers(300, 1201, 3)]
    lengths[0] = max(lengths[0], 900)            # at least one resumed grant
    prompts = [rng.integers(2, cfg.vocab_size, n).astype(np.int32)
               for n in lengths]
    config = Config(model=cfg, parallel=ParallelConfig(data=1, model=1),
                    iso=ISOConfig(),
                    serving=ServingConfig(**RECURRENT_SV))
    return config, [dict(prompts=prompts, max_new=TP_NEW_TOKENS,
                         serving=dict(decode_schedule=sched))
                    for sched in ("auto", "sequential")]


def tiny_config(tp: int):
    from repro_torch.config import Config, ISOConfig, ModelConfig, \
        ParallelConfig, ServingConfig
    cfg = ModelConfig(name="t-dense", family="dense", num_layers=2,
                      d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                      vocab_size=64, qk_norm=True)
    return Config(model=cfg, parallel=ParallelConfig(data=1, model=tp),
                  iso=ISOConfig(enabled=True, num_chunks=2,
                                min_chunk_tokens=8, chunk_align=8),
                  serving=ServingConfig(page_size=8, max_batch=2,
                                        max_len=160))


def serve_tp(report, card: str):
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.config import Config, ISOConfig, ParallelConfig, \
        ServingConfig, get_model_config
    from repro_torch.launch.mesh import spawn
    from repro_torch.launch.serve import serve_rank

    cfg = dataclasses.replace(get_model_config("qwen3-8b"),  # full width
                              num_layers=TP_BIG_LAYERS)
    rng = np.random.default_rng(1)
    lengths = [int(n) for n in rng.integers(300, 1201, 3)]
    lengths[0] = max(lengths[0], 900)            # at least one resumed grant
    prompts = [rng.integers(2, cfg.vocab_size, n).astype(np.int32)
               for n in lengths]
    sv = ServingConfig(page_size=16, max_batch=4, max_len=2048,
                       prefill_token_budget=512)
    big_cfg = Config(model=cfg, parallel=ParallelConfig(data=1, model=2),
                     iso=ISOConfig(), serving=sv)
    big = (big_cfg, [dict(prompts=prompts, max_new=TP_NEW_TOKENS,
                          serving=dict(decode_schedule=sched),
                          iso=dict(quantized_comm=label == "quantized_comm"))
                     for label, sched in TP_BIG_VARIANTS],
           None, 0, "bfloat16")
    rng = np.random.default_rng(3)
    tiny_prompts = [rng.integers(2, 64, n).astype(np.int32)
                    for n in (70, 12, 33, 7)]
    tiny_cases = {"mixed": dict(prefill_token_budget=16),
                  "splits4": dict(prefill_token_budget=64,
                                  decode_kv_splits=4)}
    tiny_keys = [(c, sched) for c in tiny_cases
                 for sched in ("sequential", "batch_split", "cross_block")]
    tiny = (tiny_config(2),
            [dict(prompts=tiny_prompts, max_new=5,
                  serving=dict(tiny_cases[c], decode_schedule=sched))
             for c, sched in tiny_keys], None, 0, "float32")
    torch.backends.cuda.matmul.allow_tf32 = False
    want = {c: serve_rank(None, tiny_config(1),
                          [dict(prompts=tiny_prompts, max_new=5,
                                serving=tiny_cases[c])], None, 0, "float32",
                          device="cuda")[0]["tokens"] for c in tiny_cases}
    free_cuda()
    # expert parallelism: granite at full width, 2 layers, fp32, 20 of its
    # 40 experts a rank, against the tp=1 engine on the same weights (seed
    # 0 makes the same tensors at tp 1 and 2: no expert, head or vocab pad)
    moe_cfg, moe_v = granite_tp_case()
    moe = (dataclasses.replace(moe_cfg, parallel=ParallelConfig(data=1,
                                                                model=2)),
           moe_v, None, 0, "float32")
    moe_want = serve_rank(None, moe_cfg, moe_v, None, 0, "float32",
                          device="cuda")
    free_cuda()
    # the recurrent family: hymba's 2-layer fp32 twin, the SSM's inner dim
    # split 1600 a rank with its state, against tp=1 on the same weights
    hyb_cfg, hyb_v = hymba_tp_case()
    hymba = (dataclasses.replace(hyb_cfg, parallel=ParallelConfig(data=1,
                                                                  model=2)),
             hyb_v, None, 0, "float32")
    hymba_want = serve_rank(None, hyb_cfg, hyb_v[:1], None, 0, "float32",
                            device="cuda")[0]
    free_cuda()
    # the VLM family: internvl2-2b's 2-layer fp32 twin, patch requests and
    # a text-only one, against tp=1 on the same weights
    vlm_cfg, vlm_v = vlm_tp_case()
    vlm = (dataclasses.replace(vlm_cfg, parallel=ParallelConfig(data=1,
                                                                model=2)),
           vlm_v, None, 0, "float32")
    vlm_want = serve_rank(None, vlm_cfg, vlm_v, None, 0, "float32",
                          device="cuda")[0]
    free_cuda()

    t0 = time.perf_counter()
    ranks = spawn(tp_rank, 2, args=(big, tiny, moe, hymba, vlm),
                  device="cuda:0", backend="gloo", timeout_s=900)
    log(f"[tp] 2 ranks on cuda:0 over gloo, {time.perf_counter() - t0:.1f}s "
        f"with start-up and weights")
    coll = ranks[0]["collective_ms"]
    log(f"[tp] one reduce, host ms per reduce ({TP_LABEL}; patterns: sync = "
        f"one after another, pipelined = batch-split order with one in "
        f"flight, +ops = {STAGE_OPS} small launches between reduces):")
    for k, v in coll.items():
        log(f"[tp]   {k}: {v:.3f}")
    log(f"[tp]   [{card}]")

    for i, (label, sched) in enumerate(TP_BIG_VARIANTS):
        runs = [r["big"][i] for r in ranks]
        run = runs[0]
        m, launches = run["metrics"], run["launches"]
        name = f"{label}/{run['decode_schedule']}"
        if any(r["tokens"] != run["tokens"] for r in runs):
            raise AssertionError(f"[tp] {name}: ranks emitted different "
                                 f"tokens")
        if any(trace_stream(r["trace"]) != trace_stream(run["trace"])
               for r in runs) or not run["trace"]:
            raise AssertionError(f"[tp] {name}: the ranks' traces differ "
                                 f"once timings are removed")
        if len(run["tokens"]) != len(prompts) or \
                any(len(t) != TP_NEW_TOKENS for t in run["tokens"]):
            raise AssertionError(f"[tp] {name}: not every request "
                                 f"completed: {m}")
        want_sched = "batch_split" if sched == "auto" else sched
        if run["decode_schedule"] != want_sched or \
                run["schedule_steps"].get(want_sched, 0) <= 0:
            raise AssertionError(f"[tp] {name}: {want_sched} decode did not "
                                 f"run: {run['schedule_steps']}")
        if m["resumed_grants"] <= 0:
            raise AssertionError(f"[tp] {name}: no resumed grant ran")
        for kname in ATTENTION_KERNELS:
            if launches[kname] <= 0:
                raise AssertionError(f"[tp] {name}: {kname} never launched: "
                                     f"{launches}")
        steps = m["decode_calls"]
        step_ms = 1e3 * m["decode_s"] / steps
        ph = run["psum_host_s"]
        # every int8 reduce is three kernel launches, one of each, and no
        # standalone B7; a bf16 run launches none of them
        n_reduces = sum(n for k, (_, n) in ph.items()
                        if k.endswith("psum_start"))
        int8 = {k: launches[k] for k in INT8_REDUCE_KERNELS}
        want_int8 = n_reduces if label == "quantized_comm" else 0
        if n_reduces <= 0 or launches["quantize_int8"] != 0 or \
                any(n != want_int8 for n in int8.values()):
            raise AssertionError(f"[tp] {name}: {n_reduces} reduces, int8 "
                                 f"launches {int8}, quantize_int8 "
                                 f"{launches['quantize_int8']}: want "
                                 f"{want_int8} of each and 0")
        inside = {k: (1e3 * t / steps if k.startswith("decode")
                      else 1e3 * t, n)
                  for k, (t, n) in sorted(ph.items())}
        log(f"[tp] qwen3-8b {cfg.num_layers}L tp=2 bf16 {name}: "
            f"{len(prompts)} requests, prompts {lengths}, "
            f"{TP_NEW_TOKENS} new tokens each, ranks agree, "
            f"{run['rows_checked']} logits rows finite, schedule steps "
            f"{run['schedule_steps']}, launches per rank {launches}")
        log(f"[tp] {name} ({TP_LABEL}): prefill {m['prefill_tokens']} tok "
            f"in {m['prefill_s']:.3f}s = "
            f"{m['prefill_tokens'] / m['prefill_s']:.0f} tok/s "
            f"({m['prefill_calls']} calls, {m['resumed_grants']} resumed); "
            f"decode {step_ms:.2f} ms/step over {steps} steps; host "
            f"dispatch share prefill "
            f"{m['prefill_dispatch_s'] / m['prefill_s']:.3f}, decode "
            f"{m['decode_dispatch_s'] / m['decode_s']:.3f} [{card}]")
        log(f"[tp] {name} rank 0 host time inside the reduces (decode: ms "
            f"per step; prefill: ms in all; calls in all): "
            + ", ".join(f"{k} {v:.2f} ({n})" for k, (v, n) in inside.items()))
        log(f"[tp] {name}: {n_reduces} reduces, int8 kernel launches {int8}"
            f" ({sum(int8.values()) / n_reduces:.0f} a reduce)")
        report.setdefault("tp", {})[name] = dict(
            prefill_tok_s=m["prefill_tokens"] / m["prefill_s"],
            decode_ms_step=step_ms, launches=launches,
            schedule_steps=run["schedule_steps"], psum_host=inside)
    for r, rank in enumerate(ranks):
        pr = rank["probe"]["probe"]
        if pr["tp"] != 2 or set(pr["schedules"]) != {
                "sequential", "batch_split", "ladder", "cross_block"} or \
                rank["probe"]["tokens"] != ranks[0]["probe"]["tokens"] or \
                not all(math.isfinite(t) for t in pr["schedules"].values()):
            raise AssertionError(f"[probe] tp=2 rank {r}: {pr}")
    log(f"[probe] qwen3-8b tp=2 batch_split ({TP_LABEL}; "
        f"{ranks[0]['probe']['s']:.1f}s with its serving runs; the engine "
        f"served the same tokens after it on both ranks) rank 0: "
        f"{json.dumps(ranks[0]['probe']['probe'])} [{card}]")
    report["probe_tp2"] = ranks[0]["probe"]["probe"]
    log(f"[tp] rank 0 host profile of a quantized_comm/batch_split run "
        f"({PROFILE_NEW} new tokens, {TP_LABEL}), by self CPU time:")
    for line in ranks[0]["profile"].splitlines():
        log("[tp]   " + line)
    # the kernel line's counts: the default quantized run (batch-split)
    for k in INT8_REDUCE_KERNELS:
        report["launches"][k] = ranks[0]["big"][2]["launches"][k]

    for i, (case, sched) in enumerate(tiny_keys):
        for r, rank in enumerate(ranks):
            got = rank["tiny"][i]["tokens"]
            if got != want[case]:
                raise AssertionError(f"[tp] tiny {case}/{sched} rank {r}: "
                                     f"tp=2 {got} != tp=1 {want[case]}")
            if trace_stream(rank["tiny"][i]["trace"]) != \
                    trace_stream(ranks[0]["tiny"][i]["trace"]):
                raise AssertionError(f"[tp] tiny {case}/{sched}: the ranks' "
                                     f"traces differ")
    n_ev = [len(r["trace"]) for r in ranks[0]["big"] + ranks[0]["tiny"]]
    log(f"[tp] tiny fp32 model: tp=2 on cuda:0 == tp=1 on the card, greedy "
        f"tokens on every rank, cases {tiny_keys}; every run's trace equal "
        f"on both ranks once timings are removed ({n_ev} events)")
    cfg = moe_cfg.model
    for i, v in enumerate(moe_v):
        for r, rank in enumerate(ranks):
            run = rank["moe"][i]
            if run["tokens"] != moe_want[i]["tokens"]:
                raise AssertionError(f"[tp] granite tp=2 rank {r}: tokens "
                                     f"differ from tp=1's")
            for kname in ATTENTION_KERNELS:
                if run["launches"][kname] <= 0:
                    raise AssertionError(f"[tp] granite tp=2: {kname} never "
                                         f"launched: {run['launches']}")
        m = ranks[0]["moe"][i]["metrics"]
        log(f"[tp] granite-moe-3b-a800m full width, {cfg.num_layers} layers, "
            f"fp32, tp=2 ({cfg.moe.padded_experts(2) // 2} experts and 12/4 "
            f"heads a rank), {ranks[0]['moe'][i]['decode_schedule']} "
            f"decode, prompts {[len(p) for p in v['prompts']]}: tokens on "
            f"both ranks == the tp=1 engine's on the same weights; "
            f"{m['prefill_calls']} prefill calls ({m['resumed_grants']} "
            f"resumed), {m['decode_calls']} decode steps, launches per rank "
            f"{ranks[0]['moe'][i]['launches']} ({TP_LABEL}) [{card}]")
    cfg = hyb_cfg.model
    for i, v in enumerate(hyb_v):
        for r, rank in enumerate(ranks):
            run = rank["hymba"][i]
            if run["tokens"] != hymba_want["tokens"]:
                raise AssertionError(f"[tp] hymba tp=2 rank {r} "
                                     f"{run['decode_schedule']}: tokens "
                                     f"differ from tp=1's")
            for kname in ATTENTION_KERNELS:
                if run["launches"][kname] <= 0:
                    raise AssertionError(f"[tp] hymba tp=2: {kname} never "
                                         f"launched: {run['launches']}")
        m = ranks[0]["hymba"][i]["metrics"]
        log(f"[tp] hymba-1.5b full width, {cfg.num_layers} layers, window "
            f"{cfg.sliding_window}, fp32, tp=2 (SSM inner 1600 and 15/3 head "
            f"slots a rank), {ranks[0]['hymba'][i]['decode_schedule']} "
            f"decode, prompts {[len(p) for p in v['prompts']]}: tokens on "
            f"both ranks == the tp=1 engine's on the same weights; "
            f"{m['prefill_calls']} prefill calls ({m['resumed_grants']} "
            f"resumed), {m['decode_calls']} decode steps, launches per rank "
            f"{ranks[0]['hymba'][i]['launches']} ({TP_LABEL}) [{card}]")
    cfg = vlm_cfg.model
    for r, rank in enumerate(ranks):
        run = rank["vlm"][0]
        if run["tokens"] != vlm_want["tokens"]:
            raise AssertionError(f"[tp] internvl2-2b tp=2 rank {r}: tokens "
                                 f"differ from tp=1's")
        for kname in ATTENTION_KERNELS:
            if run["launches"][kname] <= 0:
                raise AssertionError(f"[tp] internvl2-2b tp=2: {kname} never "
                                     f"launched: {run['launches']}")
    m = ranks[0]["vlm"][0]["metrics"]
    log(f"[tp] internvl2-2b full width, {cfg.num_layers} layers, fp32, tp=2 "
        f"(8/4 heads a rank; the patches replicated), "
        f"{ranks[0]['vlm'][0]['decode_schedule']} decode, prompts "
        f"{[len(p) for p in vlm_v[0]['prompts']]} (the first text-only): "
        f"tokens on both ranks == the tp=1 engine's on the same weights; "
        f"{m['prefill_calls']} prefill calls ({m['resumed_grants']} "
        f"resumed), {m['decode_calls']} decode steps, launches per rank "
        f"{ranks[0]['vlm'][0]['launches']} ({TP_LABEL}) [{card}]")


# ---------------------------------------------------------------------------
# phase 7: the kernel entry point at full width
# ---------------------------------------------------------------------------

def serve_ops(report, card: str):
    """Drive ``repro_torch.kernels.ops`` at qwen3-8b's widths in bf16 (tp=1's
    heads and d_ff, then one tp=2 rank's), read the launch counts, then hold
    the ISO composition and every call against the plain versions."""
    import torch
    from repro_torch.kernels import native, ops
    from repro_torch.kernels.flash_prefill import flash_attention_plain
    from repro_torch.kernels.int8_quant import quantize_int8_plain
    from repro_torch.kernels.rmsnorm import rms_norm_plain
    from repro_torch.kernels.swiglu import swiglu_plain
    gen = torch.Generator(device="cuda").manual_seed(2)
    dt, S, c, hd, d_model = torch.bfloat16, 2048, 1024, 128, 4096

    def randn(*shape, dtype=dt):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    # (label, Hq, Hkv, d_ff): qwen3-8b at tp=1, and one rank's share at tp=2
    widths = (("tp=1", 32, 8, 12288), ("tp=2 rank", 16, 4, 6144))
    inputs = [(randn(1, hq, S, hd), randn(1, hkv, S, hd), randn(1, hkv, S, hd),
               randn(S, d_model), randn(d_model, dtype=torch.float32),
               randn(S, d_ff), randn(S, d_ff))
              for _, hq, hkv, d_ff in widths]
    torch.cuda.synchronize()
    native.reset_launches()
    t0 = time.perf_counter()
    outs = []
    for q, k, v, x, gamma, gate, up in inputs:
        full = ops.flash_attention(q, k, v)
        c0 = ops.flash_attention(q[:, :, :c], k[:, :, :c], v[:, :, :c])
        c1 = ops.flash_attention(q[:, :, c:], k, v, q_start=c)
        outs.append((full, c0, c1, ops.rms_norm(x, gamma),
                     ops.swiglu(gate, up), ops.quantize_int8(x)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: native.LAUNCHES[k]
                for k in OPS_KERNELS + ("quantize_int8",)}
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the ops "
                                 f"path: {launches}")
    tol = TOL["bfloat16"]
    for (label, hq, hkv, d_ff), inp, out in zip(widths, inputs, outs):
        q, k, v, x, gamma, gate, up = inp
        full, c0, c1, y, a, xq = out
        for g, w in zip(xq, quantize_int8_plain(x)):
            if not torch.equal(g, w):
                raise AssertionError(f"[ops] {label}: quantize_int8 differs "
                                     f"from its plain version")
        composed = torch.cat([c0, c1], dim=2)
        comp_err = max_err([composed.float()], [full.float()], tol)
        errs = [
            max_err([full.float()],
                    [flash_attention_plain(q, k, v).float()], tol),
            max_err([c0.float()], [flash_attention_plain(
                q[:, :, :c], k[:, :, :c], v[:, :, :c]).float()], tol),
            max_err([c1.float()], [flash_attention_plain(
                q[:, :, c:], k, v, q_start=c).float()], tol),
            max_err([y.float()], [rms_norm_plain(x, gamma).float()], tol),
            max_err([a.float()], [swiglu_plain(gate, up).float()], tol)]
        if full.shape != q.shape or y.shape != x.shape or \
                a.shape != gate.shape:
            raise AssertionError(f"[ops] {label}: output shapes")
        log(f"[ops] qwen3-8b {label} widths (Hq {hq}, Hkv {hkv}, hd {hd}, "
            f"d_model {d_model}, d_ff {d_ff}) bf16: flash({c}) ++ flash({c} "
            f"| prefix {c}) == flash({S}) within {tol}, max abs err "
            f"{comp_err}; each call vs its plain version, max abs err "
            f"(full, chunk 0, chunk 1, rms_norm, swiglu) {errs}; "
            f"quantize_int8 ({S}, {d_model}) equal")
    log(f"[ops] {wall:.3f}s for the calls, launches {launches} [{card}]")
    report["launches"].update(launches)


# ---------------------------------------------------------------------------
# phase 17: the examples/ scripts on the card
# ---------------------------------------------------------------------------

# serve_batch_torch.py's runs: (label, argv after its defaults)
EXAMPLE_SERVE_RUNS = (("defaults", []),
                      ("full dense", ["--preset", "full"]),
                      ("full paged", ["--preset", "full", "--paged"]),
                      ("full paged iso-off", ["--preset", "full", "--paged",
                                              "--iso-off"]))
EXAMPLE_CKPT = ROOT / "build" / "examples_ckpt"
EXAMPLE_TRAIN_FULL = ["--preset", "full", "--steps", "3", "--seq-len", "128",
                      "--batch", "4"]


class _Tee:
    """A stdout that writes to every stream given (the log and a buffer)."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text: str) -> int:
        for st in self.streams:
            st.write(text)
        return len(text)

    def flush(self) -> None:
        for st in self.streams:
            st.flush()


def load_example(name: str):
    """The module of ``examples/<name>_torch.py``, loaded by path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"{name}_torch", ROOT / "examples" / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(name: str, argv: list, totals: dict) -> dict:
    """Run ``examples/<name>_torch.py``'s ``main(argv)`` in this process
    with the launch counts set to 0 just before and read just after (added
    into ``totals``), its standard output teed into the log; a
    ``SystemExit`` or a return value other than 0 is fatal.  Returns its
    output, wall seconds, launches, the GiB allocated before it (what
    earlier phases still hold) and its peak allocated GiB above that."""
    import contextlib
    import gc
    import io
    import torch
    from repro_torch.kernels import native

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2**30
    native.reset_launches()
    buf = io.StringIO()
    log(f"[examples] examples/{name}_torch.py {' '.join(argv)}")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        try:
            rc = load_example(name).main(argv)
        except SystemExit as e:
            rc = e.code
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"[examples] {name}_torch.py {argv}: exit "
                             f"{rc!r}")
    launches = dict(native.LAUNCHES,
                    decode_reduce=native.VARIANTS["paged_decode/fold"])
    for k, n in launches.items():
        totals[k] = totals.get(k, 0) + n
    peak = torch.cuda.max_memory_allocated() / 2**30 - base
    gc.collect()
    free_cuda()
    return dict(out=buf.getvalue(), wall_s=wall, launches=launches,
                base_gib=base, peak_gib=peak)


def _last_value(argv: list, flag: str) -> str:
    """The value of the last ``flag`` in ``argv`` (argparse's pick)."""
    return argv[len(argv) - argv[::-1].index(flag)]


def _floats(pattern: str, text: str) -> list:
    import re
    return [float(x.replace(",", "")) for x in re.findall(pattern, text)]


def serve_examples(report, card: str, totals: dict) -> None:
    """Phase 17 (b): ``serve_batch_torch.py`` at its defaults, then
    qwen3-4b at full width and depth on the dense ``Engine``, on
    ``PagedEngine`` (prompts of 48-95 tokens in two ISO chunks under the
    64-token budget resume: B3 and B1 must launch) and on it with ISO off
    (whole-prompt grants: B1 must launch)."""
    runs = {}
    for label, extra in EXAMPLE_SERVE_RUNS:
        r = run_example("serve_batch", extra, totals)
        tok_s = _floats(r"\(([\d.]+) tok/s\)", r["out"])
        ms = _floats(r"\(([\d.]+) ms/step\)", r["out"])
        if len(tok_s) != 1 or len(ms) != 1 or "completed=5" not in r["out"]:
            raise AssertionError(f"[examples] serve_batch {label}: no "
                                 f"prefill/decode line or not every request "
                                 f"completed:\n{r['out']}")
        paged = "--paged" in extra
        # B1 decodes every paged run; B3 runs the resumed grants, which
        # ISO's chunks (the scheduling quantum) make: with ISO off a
        # prompt is one chunk, granted whole
        want = ("paged_decode", "paged_prefill") if paged and \
            "--iso-off" not in extra else ("paged_decode",) if paged else ()
        if any(r["launches"][k] <= 0 for k in want):
            raise AssertionError(f"[examples] serve_batch {label}: {want} "
                                 f"must launch: {r['launches']}")
        runs[label] = dict(prefill_tok_s=tok_s[0], decode_ms_step=ms[0],
                           peak_gib=r["peak_gib"], wall_s=r["wall_s"],
                           launches={k: n for k, n in r["launches"].items()
                                     if n})
        log(f"[examples] serve_batch {label} (qwen3-4b, "
            f"{'full width and depth, bf16' if extra else 'tiny preset'}, "
            f"{'PagedEngine' if paged else 'dense Engine'}, 5 requests of "
            f"48-95 prompt tokens, 12 new each): prefill {tok_s[0]:.1f} "
            f"tok/s, decode {ms[0]:.2f} ms/step, peak allocated "
            f"{r['peak_gib']:.3f} GiB above the {r['base_gib']:.3f} held "
            f"before it, {r['wall_s']:.1f}s in all; launches "
            f"{runs[label]['launches']} [{card}]")
    report["examples"]["serve"] = runs


def train_examples(report, card: str, totals: dict) -> None:
    """Phase 17 (d): ``train_small_torch.py`` at its defaults with a
    checkpoint under ``build/``, loaded back into the model's leaves; then
    qwen3-4b at full width for ``EXAMPLE_TRAIN_FULL``'s steps."""
    import re
    import shutil
    import numpy as np
    import torch
    from repro_torch.config import get_model_config
    from repro_torch.launch.train import reduce_cfg
    from repro_torch.models import api
    from repro_torch.training import checkpoint
    from repro_torch.training.trainer import param_leaves

    shutil.rmtree(EXAMPLE_CKPT, ignore_errors=True)
    defaults = load_example("train_small").DEFAULTS
    out = {}
    for label, argv in (("defaults", ["--ckpt", str(EXAMPLE_CKPT)]),
                        ("full", EXAMPLE_TRAIN_FULL)):
        r = run_example("train_small", argv, totals)
        rows = [tuple(float(x.replace(",", "")) for x in m) for m in
                re.findall(r"^step\s+\d+ loss (\S+) gnorm (\S+) tok/s "
                           r"(\S+)", r["out"], re.M)]
        if len(rows) < 2 or not np.isfinite(np.array(rows)).all():
            raise AssertionError(f"[examples] train_small {label}: losses "
                                 f"{rows}")
        full_argv = defaults + argv
        steps, batch, seq = (int(_last_value(full_argv, f)) for f in
                             ("--steps", "--batch", "--seq-len"))
        # the launcher prints tok/s since its first step at steps 0 and the
        # last: the seconds to each, and so ms a step after the first
        t_first = batch * seq / rows[0][2]
        t_last = steps * batch * seq / rows[-1][2]
        ms = 1e3 * (t_last - t_first) / (steps - 1)
        out[label] = dict(losses=[x[0] for x in rows], ms_step=ms,
                          peak_gib=r["peak_gib"], wall_s=r["wall_s"],
                          launches={k: n for k, n in r["launches"].items()
                                    if n})
        log(f"[examples] train_small {label} (qwen3-4b "
            f"{'full width and depth' if label == 'full' else 'tiny'}, "
            f"bf16, {steps} steps of {batch} x {seq}, remat): losses "
            f"{[x[0] for x in rows]}, {ms:.1f} ms a step after the first "
            f"(from the launcher's tok/s), peak allocated "
            f"{r['peak_gib']:.3f} GiB above the {r['base_gib']:.3f} held "
            f"before it, {r['wall_s']:.1f}s in all; launches "
            f"{out[label]['launches']} [{card}]")
        if label == "defaults":
            cfg = reduce_cfg(get_model_config("qwen3-4b"), "tiny")
            init = api.init_params(0, cfg, dtype=torch.bfloat16,
                                   device="cuda")
            tree, step = checkpoint.restore(str(EXAMPLE_CKPT),
                                            {"params": init})
            got, want = param_leaves(tree), param_leaves({"params": init})
            moved = False
            if step != steps or [g.name for g in got] != \
                    [w.name for w in want]:
                raise AssertionError(f"[examples] checkpoint: step {step}, "
                                     f"leaves {[g.name for g in got]}")
            for g, w in zip(got, want):
                for a, b in zip(g.tensors, w.tensors):
                    if a.shape != b.shape or a.dtype != b.dtype or \
                            not torch.isfinite(a.float()).all():
                        raise AssertionError(f"[examples] checkpoint leaf "
                                             f"{g.name}: {a.shape} "
                                             f"{a.dtype}")
                    moved |= not torch.equal(a, b)
            if not moved:
                raise AssertionError("[examples] the checkpoint holds the "
                                     "untrained weights")
            log(f"[examples] checkpoint {EXAMPLE_CKPT.name}: step {step}, "
                f"{len(got)} leaves restored with the model's names, "
                f"shapes and dtypes, trained away from the initial weights")
            del tree, init, got, want
            free_cuda()
    report["examples"]["train"] = out


def examples_all(report, card: str) -> None:
    """Phase 17: the five ``examples/*_torch.py`` scripts in this process:
    (a) quickstart and iso_prefill_demo (their fp32 exactness asserts),
    (b) ``serve_examples``, (c) speculative_demo (its stream identity),
    (d) ``train_examples``; ``report["launches_examples"]`` the phase's
    launches."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    report["examples"] = {}
    totals: dict = {}
    for name in ("quickstart", "iso_prefill_demo"):
        r = run_example(name, [], totals)
        log(f"[examples] {name}: passed its fp32 asserts in "
            f"{r['wall_s']:.1f}s [{card}]")
    serve_examples(report, card, totals)
    r = run_example("speculative_demo", [], totals)
    log(f"[examples] speculative_demo: streams identical on the graphed "
        f"dense Engine, {r['wall_s']:.1f}s [{card}]")
    train_examples(report, card, totals)
    report["launches_examples"] = totals
    log(f"[examples] phase launches {totals}")


# ---------------------------------------------------------------------------
# phase 18: the grouped expert kernels of the dropless afmoe MoE
# ---------------------------------------------------------------------------

AFMOE_CONFIG = ROOT / "bench" / "configs" / "trinity-mini.json"
# (rows, decode) of the kernel check: the trinity-mini.mixed-chat cell's
# decode call (24 rows) and a full grant call (1024), each on both kernel
# pairs; the timed cases are the two the serving path launches
MOE_CASES = ((24, True), (1024, False), (24, False), (1024, True))
MOE_TIMED = {"decode": (24, True), "grant": (1024, False)}
# phase 18 (b)'s engine: one prompt past the 2048-token window and past the
# 1024-token budget (a resumed grant), the cell's budget
AFMOE_SV = dict(page_size=16, max_batch=4, max_len=4096,
                prefill_token_budget=1024)
AFMOE_LENGTHS = (2600, 700, 1500, 300)


def afmoe_model():
    """Trinity-Mini's ``AfmoeModelConfig`` from the benchmark's
    configuration file, through ``bench/port_afmoe.py`` (loaded by path; it
    imports only ``repro_torch``)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "port_afmoe", ROOT / "bench" / "port_afmoe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.model_config(json.loads(AFMOE_CONFIG.read_text()))


def moe_case(gen, ws, T: int, decode: bool, k: int, scale: float,
             e_loc: int = 0) -> dict:
    """One call of the grouped kernels on ``T`` rows routed like the
    sigmoid router (top k of uniform scores, normalised, times ``scale``)
    against ``moe_experts_plain``; with ``e_loc`` the rank holding experts
    ``e_loc .. 2 e_loc - 1`` of a tp=2 split (the other slots another
    rank's).  Checks the launch counter of the pair it picked, the counts,
    a half batch bit-equal to its rows of the whole and, at decode, a CUDA
    graph's replay bit-equal to the eager call."""
    import torch
    from repro_torch.kernels import moe_experts as mx
    from repro_torch.kernels import native

    E, D = ws[0].shape[0], ws[0].shape[1]
    x = torch.randn((T, D), generator=gen, device="cuda").bfloat16()
    s = torch.rand((T, E), generator=gen, device="cuda")
    w, idx = torch.topk(s, k, dim=-1)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * scale
    if e_loc:
        idx = torch.where((idx >= e_loc) & (idx < 2 * e_loc), idx - e_loc,
                          torch.full_like(idx, e_loc))
        ws = tuple(t[e_loc:2 * e_loc] for t in ws)
    label = (f"T {T} {'decode' if decode else 'grant'}"
             + (f", rank 1 of 2 ({e_loc} experts)" if e_loc else ""))
    native.reset_launches()
    y, c = mx.moe_experts(x, idx, w, *ws, decode=decode)
    torch.cuda.synchronize()
    picked = {v: native.VARIANTS[f"moe_experts/{v}"]
              for v in ("decode", "grant")}
    want = {"decode": int(decode), "grant": int(not decode)}
    if native.LAUNCHES["moe_experts"] != 1 or picked != want:
        raise AssertionError(f"[afmoe] {label}: launches "
                             f"{native.LAUNCHES['moe_experts']}, variants "
                             f"{picked}; want one call, {want}")
    yp, cp = mx.moe_experts_plain(x, idx, w, *ws)
    y32, _ = mx.moe_experts_plain(x.float(), idx, w,
                                  *(t.float() for t in ws))
    top = yp.abs().max().item()
    err = (y - yp).abs().max().item()
    if not torch.equal(c, cp) or not err <= 2e-2 * top:
        raise AssertionError(f"[afmoe] {label}: max |kernel - plain| {err} "
                             f"against 2e-2 x {top}; counts equal "
                             f"{torch.equal(c, cp)}")
    h = T // 2
    yh, _ = mx.moe_experts(x[:h], idx[:h], w[:h], *ws, decode=decode)
    if not torch.equal(yh, y[:h]):
        raise AssertionError(f"[afmoe] {label}: the first {h} rows alone "
                             f"differ from their rows of the whole batch")
    if decode:
        st = torch.cuda.Stream()
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            mx.moe_experts(x, idx, w, *ws, decode=decode)
        torch.cuda.current_stream().wait_stream(st)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            yg, _ = mx.moe_experts(x, idx, w, *ws, decode=decode)
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(yg, y):
            raise AssertionError(f"[afmoe] {label}: a graph replay differs "
                                 f"from the eager call")
    hit = int((c[:-1] > 0).sum())
    res = dict(label=label, err=err / top,
               err32=(y - y32).abs().max().item() / y32.abs().max().item(),
               plain_err32=(yp - y32).abs().max().item()
               / y32.abs().max().item(), hit=hit,
               args=(x, idx, w, ws, decode))
    log(f"[afmoe] {label}: max |kernel - plain| {res['err']:.5f} of the "
        f"plain path's largest output (limit 0.02); against fp32: kernel "
        f"{res['err32']:.5f}, plain bf16 {res['plain_err32']:.5f}; counts "
        f"equal, half batch and{' graph replay and' if decode else ''} "
        f"launch counter right; {hit} experts reached")
    return res


def grouped_mm_ms(x, idx, ws, k: int):
    """``torch._grouped_mm`` three times (gate, up, down, the SiLU product
    between) over the same sort by expert as the kernels': the library
    yardstick; a string where this torch has no such call or it fails."""
    import torch
    import torch.nn.functional as F
    if not hasattr(torch, "_grouped_mm"):
        return "none: torch._grouped_mm is absent"
    wg, wu, wd = ws
    flat = idx.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    xs = x[order // k].contiguous()
    offs = torch.cumsum(torch.bincount(flat, minlength=wg.shape[0]),
                        0).to(torch.int32)

    def call():
        g = torch._grouped_mm(xs, wg, offs=offs)
        u = torch._grouped_mm(xs, wu, offs=offs)
        return torch._grouped_mm((F.silu(g.float()) * u.float()).bfloat16(),
                                 wd, offs=offs)
    try:
        return time_ms(call)
    except Exception as e:  # noqa: BLE001  (a yardstick only)
        return f"failed: {e}"[:200]


def check_moe_experts(report, card: str, cfg) -> None:
    """Phase 18 (a): the grouped kernels at ``cfg``'s widths (Trinity-Mini:
    128 experts of 2048 -> 1024 -> 2048, top 8), bf16, against
    ``moe_experts_plain`` (``moe_case``) at 24 and 1024 rows on both pairs
    and on one rank of a tp=2 split; then the serving path's two calls
    timed (``time_ms``) beside the plain path, ``torch._grouped_mm`` and
    their bound (the bytes of the experts the call reached, of x and of
    y, over 3.35 TB/s, or the operations over 989 TFLOP/s)."""
    import torch
    from repro_torch.kernels import moe_experts as mx

    mc = cfg.moe
    E, D, Fw, k = mc.num_experts, cfg.d_model, mc.d_ff_expert, mc.top_k
    gen = torch.Generator(device="cuda").manual_seed(18)
    ws = tuple((torch.randn(sh, generator=gen, device="cuda") * std
                ).bfloat16() for sh, std in (((E, D, Fw), 0.02),
                                             ((E, D, Fw), 0.02),
                                             ((E, Fw, D), 0.0025)))
    cases = {}
    for T, decode in MOE_CASES:
        cases[(T, decode)] = moe_case(gen, ws, T, decode, k, mc.route_scale)
    for T, decode in ((24, True), (1024, False)):
        moe_case(gen, ws, T, decode, k, mc.route_scale, e_loc=E // 2)
    timing, errs = {}, {}
    for name, key in MOE_TIMED.items():
        r = cases[key]
        x, idx, w, ws_, decode = r["args"]
        T = x.shape[0]
        nbytes = r["hit"] * 3 * D * Fw * 2 + 2 * T * D * 2
        flops = 2.0 * T * k * 3 * D * Fw
        by_bytes = nbytes / HBM_BYTES_PER_S >= flops / PEAK_FLOPS["bfloat16"]
        timing[name] = dict(
            ms=time_ms(lambda: mx.moe_experts(x, idx, w, *ws_,
                                              decode=decode)),
            plain_ms=time_ms(lambda: mx.moe_experts_plain(x, idx, w, *ws_),
                             reps=3),
            bound_ms=1e3 * max(nbytes / HBM_BYTES_PER_S,
                               flops / PEAK_FLOPS["bfloat16"]),
            bound_by="bytes" if by_bytes else "operations",
            library_ms=grouped_mm_ms(x, idx, ws_, k), rows=T,
            experts_reached=r["hit"])
        errs[name] = r["err"]
        t = timing[name]
        lib = t["library_ms"]
        lib = lib if isinstance(lib, str) else f"{lib:.4f}"
        log(f"[afmoe] {name} call, {T} rows, {r['hit']} experts: "
            f"{t['ms']:.4f} ms (the wrapper: sort, offsets, both kernels, "
            f"the slot sum), bound {t['bound_ms']:.4f} ms ({t['bound_by']}; "
            f"{t['bound_ms'] / t['ms']:.1%} of it), plain "
            f"{t['plain_ms']:.3f} ms, torch._grouped_mm x3 {lib} [{card}]")
    report["moe_timing"], report["moe_errs"] = timing, errs


def serve_afmoe(report, card: str, cfg) -> None:
    """Phase 18 (b): Trinity-Mini at full width and depth, bf16, tp=1, on
    ``PagedEngine`` (``AFMOE_SV``: the cell's budget) over
    ``AFMOE_LENGTHS``, eager then graphed (``eager_then_graphed``: graphed
    tokens equal to eager, B1 and B3 launched).  The timed pass's launch
    counts, through its replays, are the kernel line's ``launches``: one
    decode-pair call a MoE layer of every decode step, and grant-pair calls
    in whole MoE stacks, none on the other pair's side."""
    import numpy as np
    import torch
    from repro_torch.config import MOE_KINDS
    from repro_torch.models import api

    t0 = time.perf_counter()
    params = api.init_params(0, cfg, tp=1, dtype=torch.bfloat16,
                             device="cuda")
    torch.cuda.synchronize()
    moe_layers = sum(1 for i in range(cfg.num_layers)
                     if cfg.block_kind(i) in MOE_KINDS)
    log(f"[afmoe] trinity-mini {cfg.num_layers}L ({moe_layers} MoE) d="
        f"{cfg.d_model}, {cfg.moe.num_experts} experts top-"
        f"{cfg.moe.top_k}: {cfg.param_count() / 1e9:.4f}B params bf16 made "
        f"on the card in {time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated [{card}]")
    rng = np.random.default_rng(18)
    prompts = [rng.integers(2, cfg.vocab_size, n).astype(np.int32)
               for n in AFMOE_LENGTHS]
    d = eager_then_graphed(cfg, params, AFMOE_SV, prompts,
                           "trinity-mini (the cell's budget)", card, new=16,
                           tag="afmoe")
    m, v = d["m"], d["variants"]
    dec, grant = v["moe_experts/decode"], v["moe_experts/grant"]
    if dec != moe_layers * m["decode_calls"] or grant <= 0 or \
            grant % moe_layers or \
            d["launches"]["moe_experts"] != dec + grant:
        raise AssertionError(f"[afmoe] timed pass: decode-pair calls {dec} "
                             f"for {m['decode_calls']} decode steps x "
                             f"{moe_layers} MoE layers, grant-pair calls "
                             f"{grant}, wrapper calls "
                             f"{d['launches']['moe_experts']}")
    report["launches_afmoe"] = {
        "moe_experts": 2 * (dec + grant), "moe_experts/decode": 2 * dec,
        "moe_experts/grant": 2 * grant, "decode_calls": m["decode_calls"],
        "prefill_calls": m["prefill_calls"]}
    log(f"[afmoe] timed pass: kernel launches {2 * dec} on the decode pair "
        f"({2 * dec // m['decode_calls']} a decode step over "
        f"{m['decode_calls']} steps), {2 * grant} on the grant pair over "
        f"{m['prefill_calls']} prefill calls ({2 * moe_layers} a MoE stack "
        f"pass) [{card}]")
    del params
    free_cuda()


def afmoe_all(report, card: str) -> None:
    """Phase 18: (a) ``check_moe_experts``, (b) ``serve_afmoe``."""
    cfg = afmoe_model()
    check_moe_experts(report, card, cfg)
    free_cuda()
    serve_afmoe(report, card, cfg)


def moe_kernel_entry(report) -> dict:
    """The kernel line's entry of the grouped expert kernels (phase 18)."""
    t, launches = report["moe_timing"], report["launches_afmoe"]
    return {"name": "moe_experts", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/moe_experts.cu",
            "replaces": "none (the reference's expert einsums)",
            "launches": launches, "max_abs_err": report["moe_errs"],
            **{key: {name: t[name][key] for name in t}
               for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                           "library_ms", "rows", "experts_reached")}}


def tc_report(logs: str) -> list:
    """ptxas's register and spill lines of the tensor-core instantiations
    (``*_tc_kernel<KD>``), one line each."""
    import re
    out, cur = [], ""
    for line in logs.splitlines():
        if "Compiling entry function" in line:
            hit = re.search(r"([a-z_]+_tc_kernel)ILi(\d+)E", line)
            cur = f"{hit.group(1)}<{hit.group(2)}>" if hit else ""
        elif cur and ("registers" in line or "spill" in line):
            out.append(f"{cur}: {line.split(':', 1)[-1].strip()}")
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phase", action="append", default=[],
                    help="run only the phases whose number is given "
                         "(repeatable; the build runs always), e.g. "
                         "--phase 18; the kernel line then holds the "
                         "kernels those phases measured")
    only = ap.parse_args(argv).phase
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import native

    t0 = time.perf_counter()
    native.build_all()
    native.library()
    card = nvidia_smi()
    log(f"[build] {time.perf_counter() - t0:.1f}s  nvcc report:")
    for line in "".join(native.BUILD_LOGS.values()).splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            log("  " + line.strip())
    log("[build] tensor-core instantiations (flash_tc.cuh), registers and "
        "spills:")
    for line in tc_report("".join(native.BUILD_LOGS.values())):
        log("  " + line)
    log(f"[build] card: {card}")

    report = {"launches": {}}
    phases = (("2 kernels", lambda: check_kernels(report)),
              ("3 serve qwen3-8b", lambda: serve_full(report, card)),
              ("3 serve paper-30b", lambda: serve_paper30b(report, card)),
              ("4 parity", parity_tiny),
              ("5 tp", lambda: serve_tp(report, card)),
              ("6 time", lambda: time_kernels(report)),
              ("7 ops", lambda: serve_ops(report, card)),
              ("10 dense", lambda: serve_dense(report, card)),
              ("10 whisper", lambda: serve_whisper(report, card)),
              ("11 moe", lambda: serve_moe(report, card)),
              ("12 recurrent", lambda: serve_recurrent(report, card)),
              ("13 vlm", lambda: serve_vlm(report, card)),
              ("14 train", lambda: train_all(report, card)),
              ("15 runner", lambda: runner_all(report, card)),
              ("16 disagg tp", lambda: disagg_tp(report, card)),
              ("17 examples", lambda: examples_all(report, card)),
              ("18 afmoe", lambda: afmoe_all(report, card)),
              ("10 (c) profiles", lambda: dense_profiles(report, card)),
              ("11 profile", lambda: moe_profile(card)),
              ("12 (e) profiles", lambda: recurrent_profile(report, card)))
    if only:
        phases = tuple(p for p in phases if p[0].split()[0] in only)
        if not phases:
            log(f"chip_smoke: no phase numbered {only}")
            return 2
    for name, run in phases:
        t = time.perf_counter()
        run()
        log(f"[time] phase {name}: {time.perf_counter() - t:.1f}s")

    ran = ("phases " + ", ".join(p[0] for p in phases) if only
           else "every phase")
    log(f"[done] {ran} passed in {time.perf_counter() - t0:.1f}s (the "
        f"build included) [{card}]")
    kernels = []
    for name, (source, replaces) in ({} if only else SOURCES).items():
        t = report["timing"][name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": report["launches"][name],
                        "max_abs_err": report["errs"][name],
                        "ms": t["ms"], "plain_ms": t["plain_ms"],
                        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"],
                        "launches_moe": report["launches_moe"].get(name, 0),
                        "launches_hymba": report["launches_hymba"].get(
                            name, 0),
                        "launches_xlstm": report["recurrent"][
                            "xlstm-350m"]["launches"].get(name, 0),
                        "launches_vlm": report["launches_vlm"].get(name, 0),
                        "launches_train": report["launches_train"].get(
                            name, 0),
                        "launches_runner": report["launches_runner"].get(
                            name, 0),
                        "launches_examples": report[
                            "launches_examples"].get(name, 0),
                        "launches_disagg_tp": {
                            role: n.get(name, 0) for role, n in
                            report["launches_disagg_tp"].items()}})
        assert all(math.isfinite(x) for x in (t["ms"], t["plain_ms"],
                                              t["bound_ms"]))
    if "moe_timing" in report:
        kernels.append(moe_kernel_entry(report))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
