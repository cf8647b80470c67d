#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the script with a non-zero exit:

1. Setup: the card's name and power limit, TF32 off, the kernel build;
   beside the build, a process of its own compiles every
   ``flex_attention`` yardstick of phases 2m, 2n and 2p once
   (``warm_flex``), so that those phases find its kernels in the caches
   under build/.
2. Each hand-written kernel against its plain PyTorch version on the card,
   at the main paths' shapes and at edge cases, with stated tolerances:
   the gate (2a: exact, ties at k=2 and k=4, E=10 on the scalar path),
   the gather in both forms (2b, bitwise: the fan-out form with the
   maps of the port's own grouped and sort plans, drops and empty
   capacity slots included), the seed's row-per-step gather (2b',
   bitwise) and the grouped matmul (2a-2c: decode with 8 distinct experts, M=1,
   one expert holding every row, M off the tile, rows past offsets[E],
   skewed and empty segments), the grouped matmul's backward dlhs and
   drhs (2d, 2e; drhs's bf16 output bitwise its f32 output rounded), the
   scatter-add (2f: bitwise against the plain version on the CPU for any
   number of addends per row, top_k=3 included, and against its own
   reruns), and the flash forward, dq and
   dk/dv (2g-2i: the seq-1024 training shape, GQA with a window and a
   softcap, ragged S=600 with invalid key slots and a fully masked row,
   S=1, Sq != Sk, q positions offset against k, the first 100 key slots
   invalid); the forward at head dims 120 and 256 (2l-2m, with phase
   13), and dq and dk/dv there (2n: 2l's edge cases and the windowed
   presets' training shapes of phase 14, B=2 S=8192, kv head by kv head,
   timed beside ``flex_attention``'s backward; and the context-parallel
   shapes of 18g, gemma2's local and global attention with one row's
   chunk of 4096 or 2048 queries at every offset against its 8192 keys,
   the dk and dv of keys no query sees exactly 0, the 2x2 chunks timed
   beside ``flex_attention``'s forward and backward);
   2g's cases include
   hubert-xlarge's attention (d=80, non-causal, S=781: a last tile of 13
   rows), and 2o holds the forward, dq and dk/dv at the frontend presets'
   training shapes of phase 15 (hubert B=8 H=KV=16 S=781 d=80
   non-causal; internvl2 B=2 16:8 S=4096 d=128 causal), kv head by kv
   head, in f32 and bf16; 2p holds them at zamba2-7b's shared attention
   (MHA 32:32, head dim 112, whose build instances must not spill):
   the forward, dq and dk/dv at its training shape (B=2 S=4096 causal)
   and the forward at its long-context prefill (B=4 S=8064, window
   4096), timed beside SDPA and ``flex_attention``.
3. Serving at full width: ``hetumoe-paper-16e`` (bf16, seeded random
   weights) through ``repro_torch.launch.serve.run`` → ``generate``, batch 8,
   32 new tokens: prompt 512 with ``grouped`` and with ``sort`` dispatch,
   and prompt 1024 (the flash forward) with ``grouped``; the decode steps
   are replays of one captured CUDA graph (``engine.build_decode``); the
   kernels' launch counters must rise by what the path implies (the
   capture's eager warm-up step included; the flash forward once per
   layer in a prefill past 512 tokens, never in a decode step).  Then per
   cell, on the same prefilled caches, the graph step against the eager
   one (``decode_graph_vs_eager``): logits bitwise equal, wall and device
   ms, idle share and launches a step of each.  Then one eager decode
   step (grouped, batch 8, caches of 1024 + 32) against the
   executed-program analysis of the same step (``launch/dryrun
   .execute_pair`` on fake ``cuda`` tensors, host time only): its
   launches exactly the analysis's, its ``max_memory_allocated`` within
   ``PEAK_REL`` + ``PEAK_ABS`` of the predicted ``peak_per_device_bytes``
   (``decode_vs_analysis``).
4. Card against CPU at full width: the same f32 weights, batch 1, prompts
   of 64 and 600 tokens (the flash path), prefill last-token logits from
   the card (kernels) and the CPU (plain versions), both dispatch modes.
5. Per-kernel timings at the main paths' shapes (CUDA events, median of
   batches after warm-up; device-only from CUDA-graph replays, for the
   kernel and for the library call) beside the bound, the plain version
   and the nearest single PyTorch call (SDPA for the flash kernels); for
   the flash kernels the bound of their own arithmetic over the tiles they
   visit; the row-per-step gather beside the blocked one, with their
   ratio; an empty kernel's device time (the launch floor) beside the
   gate; the gather in its fan-out form (the dispatch's) and its gather
   form; the byte-bound rows (kernels 2, 6 and 10, ``index_select``,
   ``index_add``) also L2-cold, a 128 MB read before each call
   (``graph_cold_ms``); the grouped drhs at M=4096 and 8192, uniform,
   skewed and (4096) one-expert segments, in both output dtypes, with its
   skewed/uniform ratio.
6. Where the time goes: a profiled prefill and decode steps per serving
   cell (wall time, kernel time, the device's idle share, top kernels),
   and the host's waits for the device in a forward, which must be none;
   then one profiled train step per training cell, with its host waits
   reported (6b); the grouped seq-1024 step is first analysed on the host
   (``execute_pair`` on fake ``cuda`` tensors): the profiled step's
   launches must equal the analysis's and its peak the predicted one
   within the bound, and each port kernel's predicted bound is printed
   beside its profiled device time with its share.
7. Training at full width: ``hetumoe-paper-16e`` through
   ``repro_torch.launch.train.run`` (f32 masters, bf16 compute, batch 8,
   seeded weights and data, 2 warm-up + 8 timed AdamW steps) at seq 512
   per dispatch mode and at seq 1024 (the paper's length) with
   ``grouped``; every metric finite, no step skipped, and every kernel's
   launch counter risen by exactly the per-step count times the steps
   (the flash kernels 2/2/2 per step at seq 1024, 0 at 512).
8. Card against CPU at full width, f32: one attention layer's output and
   gradients at seq 1024 (the flash path), then one train step's loss and
   gradients from the same weights, batch 1, seq 64 in both dispatch modes
   and seq 1024 with ``grouped`` (there replayed on the card with the
   CPU's ReLU masks, since a few pre-activations lie within rounding of 0).
9. Rematerialisation: the paper's model through ``launch.train.run`` at
   batch 8 x seq 1024, ``grouped``, with ``remat`` none, block and full
   (2 warm-up + 4 timed steps each, the same seeded state): params and
   metrics bitwise equal across the modes, the forward kernels launched
   twice a step under block and full, the backward kernels once; median
   step and peak memory per mode, and in one more step the peak of the
   forward + backward apart from that of the update.
10. Crash and resume at full width (seq 512, ``grouped``): a run that
   saves every 3 steps (keep 1) and crashes at step 5, resumed from step
   3, bitwise the uninterrupted run in every metric and in the final
   params and moments; a ``train.grads:nan@1`` step skipped bitwise with
   no host wait; SIGKILL inside a save at the smoke config through the
   CLI, resumed bitwise.  Prints the npz size, the save and restore
   seconds and the free disk space.
11. The gates at full width: ``gshard`` (also with ``sort``), ``ktop1``
   (4 prototypes), ``sam`` (4 groups, top 2), ``base`` and
   ``dense_to_sparse`` (top 2, at the anneal's start and end) through
   ``launch.train.run``, batch 8 x seq 512, 3 AdamW steps each: finite
   metrics, the top-k gate kernel never launched (these gates are plain
   torch, as in the reference), the other kernels as the dispatch
   implies; ``hash`` refused on the model path.  Then one MoE layer per
   gate (``hash`` with token ids) on the card and the CPU, 512 tokens,
   f32: routes equal except at near-ties within ``TIE_MARGIN``, and with
   the CPU's routing decisions and ReLU masks replayed on the card,
   combine weights, output and gradients within 1e-4 of their max.
12. The presets at full width (bf16, seeded weights drawn leaf by leaf
   straight into bf16): ``dbrx-132b`` at 2 layers and
   ``llama4-maverick-400b-a17b`` at one ``("dense", "moe")`` period in
   both dispatch modes, ``yi-6b`` and ``starcoder2-3b`` whole, through
   ``Transformer`` → ``serving.engine.generate``, batch 8, 32 new tokens,
   prompts 512 and 1024, two runs per cell: launches as the path implies
   (per MoE layer per forward the gate 1, the gather 1 or 2, the grouped
   matmul 3 and the scatter-add 1 in grouped; dense presets none of
   these; the flash forward once per layer past 512), greedy tokens equal
   over the two runs, finite logits, one decode capture in the first run
   and none in the second (its warm-up step in the counts); prefill and
   decode times, tokens/s, the peak memory of the init and of serving; one
   profiled prefill and decode steps per preset (0 host waits), and the
   graph step against the eager one at prompt 1024.  Then card against
   CPU in f32 at full width, 64
   tokens: one dbrx ``moe`` block and one llama4 ``moe`` block (128
   routed experts and the shared expert, 65 GB of f32 weights on each
   side) in both dispatch modes (routes that differ must be near-ties,
   then replayed with the CPU's), one llama4 ``dense`` block and the
   llama4 shared expert, each within 1e-4 of its max.  Phase 2 holds
   the kernels at every shape these presets' paths give them (2j-2k: the
   gate at E=16 k=4 and E=128, the gather of T·4 rows in the served
   expert-sorted order in both forms, dbrx's sort dispatch with its
   empty slots, and the combine's scatter-add back, the grouped matmul
   at d=6144/f=10752 and d=5120/f=8192 with E=128 at M=8 and 8192, each at
   prompts 512 and 1024 and at decode; 2g: the flash kernels at H:KV
   48:8, 40:8, 32:4, 24:2, B=8, S=1024) and times the prompt-1024 and
   decode shapes on the same inputs (rows of phase 5).
13. The windowed presets whole (bf16, seeded weights drawn leaf by leaf
   into bf16): ``gemma2-9b`` (42 layers: ``local`` with window 4096 and
   ``global``, attention softcap 50, head dim 256) and
   ``h2o-danube-3-4b`` (24 layers, window 4096, head dim 120) through
   ``Transformer`` → ``serving.engine.generate``, batch 4, prompts 8064 +
   128 new tokens (the prefill overflows the 4096-slot ring caches) and
   4064 + 64 (the rings wrap at decode step 32), two runs per cell: the
   flash forward once per layer per prefill and no other kernel, greedy
   tokens equal over the two runs, finite logits, one decode capture in
   the first run and none in the second; prefill and decode times,
   tokens/s, the peak memory of the init and of serving; one profiled
   prefill and decode steps per preset (0 host waits) and the graph step
   against the eager one at prompt 8064.  Then danube's decode through its ring caches against linear caches of the
   full length under the same window, teacher-forced (logits within
   ``RING_BOUND`` of their max, differing greedy choices only at
   near-ties within it), and card against CPU in f32 at prompt 640 (the
   flash path): a gemma2 ``local`` and a ``global`` block and a danube
   block, each within 1e-4 of its max.  Phase 2 holds the flash forward
   at those head dims against its plain version, kv head by kv head, in
   f32 and bf16: 2l at edge cases (fully masked rows, -1 slots, shuffled
   key positions under a window, Sq != Sk), 2m at the prefill shapes at
   B=4, which it also times (beside its bound over the pairs the window
   keeps, the bound of its own arithmetic over the tiles it visits, and
   ``flex_attention`` with the window as a block mask and the softcap as
   a score_mod, the same function, held to the plain version too; SDPA
   with a boolean window mask, or without the cap, labelled beside it).
14. The windowed presets trained at their published widths (f32 masters,
   bf16 compute, seeded weights and data): ``h2o-danube-3-4b`` at 8 of
   24 layers and ``gemma2-9b`` at one ``("local", "global")`` period
   (an AdamW step holds ~40 bytes a parameter, so neither trains whole
   on one card), batch 2 x seq 8192 (the window of 4096 acts on every
   windowed layer), through ``make_train_step``, 2 warm-up + 8 timed
   AdamW steps: finite metrics, no skipped step, the flash forward, dq
   and dk/dv exactly once per layer and step, no host wait in a step;
   step ms, tokens/s, peak memory and one profiled step each.  Then a
   danube block and a gemma2 ``local`` and ``global`` block card against
   CPU in f32, forward and backward at seq 640 (every gradient leaf
   within 1e-3 of its max), and the training CLI on gemma2's smoke
   config at seq 1024 in a subprocess on the card.  Phase 2n holds dq
   and dk/dv at these shapes against their plain versions.
15. The frontend presets whole, at their published widths and depths
   (f32 masters, bf16 compute, seeded weights and data, (B, S, d)
   embeddings in place of tokens): ``hubert-xlarge`` (48 layers,
   encoder-only, bidirectional, d=80) at batch 8 x 781 frames and
   ``internvl2-2b`` (24 layers, untied head over 92553 entries) at batch
   2 x 4096, through ``launch.train.run``, 2 warm-up + 8 timed AdamW
   steps: finite metrics, no skipped step, the flash forward, dq and
   dk/dv exactly once per layer and step and no other kernel; step ms,
   tokens/s, peak memory (and bytes a parameter), one profiled step, no
   host wait.  Then hubert's inference forward of the same batch to its
   (8, 781, 504) cluster logits (bf16, the second of two runs), and
   internvl2 served through the API: a prefill of 4 x 3,584 embeddings
   into caches, then 64 ``decode_step``s fed (4, 1, d) embeddings (the
   second of two runs, a profile, 0 host waits).  Then card against CPU
   in f32 at full width: hubert at 2 of 48 layers over 781 frames and
   internvl2 at 2 of 24 over 640 positions (with a prefill into caches
   and 4 embedding-fed decode steps): logits within 1e-3 of their max,
   loss and grad norm 1e-4 relative, every gradient leaf within 1e-3 of
   its max.  Phases 2o and 5 hold and time kernels 7-9 at these shapes.
16. The serving path at full width: ``SlotServer`` (8 slots, caches of
   1088, grouped, a queue of 32) over ``hetumoe-paper-16e`` (bf16, seed
   0) replays ``benchmarks/bench_traffic.py``'s three scenarios (poisson
   rate 0.4 seed 7; bursty 6 every 8 steps seed 11; that one over a
   router skewed to expert 0 by 16) at 24 requests of prompts 256, 512
   and 1024 and budgets 16, 32 and 64, twice each (statuses, decode steps
   and tokens equal), the bursty one once more through the eager step
   (tokens equal); 8 prompts of 512 filling every slot, clean and under
   ``serve.decode_row:nan@1`` (exactly one request fails, the others'
   tokens unchanged); ``dbrx-132b`` at 2 of 40 layers replays the skewed
   scenario twice.  Every request ends ``ok`` without a plan, every
   replay's launches are what its prefills, decode steps and capture
   imply, each ``TrafficReport`` is printed whole, with the idle share of
   a profiled stretch of 16 busy decode steps and the peak memory.
17. The recurrent kinds (bf16, seeded weights): ``rwkv6-1.6b`` (24
   ``rwkv`` layers) and ``zamba2-7b`` (81 layers, Mamba-2 and the shared
   attention block at 27 of them) served whole at their published widths,
   batch 4, through ``launch.serve.run`` → ``generate``: rwkv6 at prompts
   1024 and 8192 (64 chunks of 128) + 64, zamba2 at 1024 + 64 and, through
   ``generate(long_context=True)``, 8064 + 128 (the shared block's rings
   of 4096 overflow in the prefill and wrap in decode), two runs per cell
   (greedy tokens equal, finite logits, the flash forward once per
   attending layer per prefill past 512 tokens and no other kernel);
   prefill and decode times, tokens/s and peaks; a profiled prefill and
   decode steps per preset and the graph decode step against the eager
   one (bitwise; the recurrent states put back between the two).  Then
   an ``rwkv`` and a ``mamba_sa`` block card against CPU in f32 at seq
   1024 (output and final states within 1e-4 of their max) and the
   chunked prefill against 16 recurrent decode steps on the card; both
   presets trained at seq 4096 (rwkv6 whole through ``launch.train.run``,
   zamba2 cut to whole periods, the first of the tries that fits), 2 + 8
   AdamW steps: no step skipped, finite metrics, kernels 7-9 once per
   attending layer a step; a ``SlotServer`` replay over rwkv6 twice.
18. Expert parallelism: four rank processes share the card over gloo
   (``launch.mesh.spawn``; NCCL refuses two ranks on one device, gloo
   stages CUDA tensors through the host, so no time here is a speed of
   EP).  18a: the flat and the hierarchical (inner 2) AllToAll of 16 MB a
   rank at 1x4, bitwise equal and equal to the host permutation of every
   rank's input.  18b: the paper's layer (d=2048, 16 experts, d_ff 2048,
   2048 tokens a rank, f32, gelu: relu's derivative flips at
   pre-activations within rounding of 0 between card and CPU) at 1x4
   (hierarchical) and 2x2, sort / dense / grouped, forward and backward,
   each rank on the card then on the CPU over the same group: every
   output within 1e-4 of its max; grouped 1x4 against one process on the
   8192 global tokens; kernels 3-5 (1e-4) and 6 (bitwise) against their
   plain versions at the receive side's group sizes.  18c: the paper
   model whole (2 layers) trained 4 AdamW steps at 1x4 through
   ``launch.train.run``, batch 8 x 1024, sort (``--tune calibrate``
   over the gloo group, the calibration's label and fit printed) and
   grouped (4 overlap windows), every plain version made to raise in the
   ranks: finite losses, none skipped, the ranks' losses equal, the
   replicated leaves bitwise equal across ranks, grouped's first loss
   within 1e-3 of one process's, per-rank peak memory, and rank 0's
   profiled step with kernels 1-9.  18d: expert tensor parallelism over
   the data group (the paper's layer, f32, at 2x2 and 4x1, 32 tokens over
   the world and 2048 a rank, sort and grouped): card ranks against the
   same ranks on the CPU (1e-4 of each max, forward and backward, 4 / 5
   TP collectives), grouped against one process, kernels 3-6 on the
   experts' stored f-slice; the int8 and fp8 wire at 1x4, card against CPU
   ranks within the reference's QWIRE_TOLS.  18e: ``dbrx-132b`` (2 of 40
   layers, published widths, bf16, grouped) served at 2x2 through
   ``launch.serve.run`` (batch 8, prompt 1024, 16 new tokens; prefill
   expert parallel, decode expert TP, the decode step eager) on the
   reference's activation and cache layout (each data rank its 4 rows;
   the prefill context-parallel over ``model``, 512 queries a rank against
   the row's 1024 keys through kernel 7; each rank's caches its 4 of the
   8 kv heads of its rows, the ``heads`` form: a quarter of one process's
   cache bytes, equal to the dry run's ``caches``), every plain
   version made to raise, the state stored by the reference's serving rule
   (each rank its 8 experts' half of f: the prefill gathers each block's
   experts whole in f, the decode step computes on the stored slice), each
   rank's stored bytes equal to ``launch/dryrun.count_pair``'s for the
   same config and its expert bytes a quarter of the layer's, the
   prefill's expert gathers counted: the tokens bitwise equal on all four
   ranks;
   teacher-forced on one process's tokens (the parent, before the spawn,
   which also holds kernel 3 on the f-slice views at dbrx's shapes), the
   router logits within 2^-4 of each call's max, the routes that differ
   printed with their margins, and, replaying one process's routes, each
   step's logits within 2^-4 of its largest |logit| and the greedy token
   equal wherever one process's top-2 margin clears that; the per-rank
   peak, the prefill and the eager decode ms a step (host-staged); rank
   0's launches of kernels 1, 2, 3, 6 and 7; then the same model stored
   under FSDP (``Transformer(fsdp=True)``, what ``needs_fsdp(4e9)``
   resolves for it: the dense leaves over data x model too), a prefill and
   4 decode steps on one process's replayed routes: their logits bitwise
   the stored-slice run's, its stored bytes the dry run's.  18e-p, 18e-r,
   18e-z and 18e-c, every served cache by the reference's cache rule
   (``EP_SERVE_STATES``): ``starcoder2-3b`` (4 of 30 layers) at 1x4 in
   the ``positions`` form (its 2 kv heads do not divide over 4 ranks, its
   caches of 1040 positions do: 260 a rank); ``rwkv6-1.6b`` (4
   of 24 layers) at 1x4, each ``s`` cut in its key dim (16 of 64 columns
   a rank, the time mix's output summed over ``model``); ``zamba2-7b``
   (one mamba, mamba, mamba_sa period) at 2x2, Mamba's ``s`` cut in its
   head dim (32 of 64), ``conv`` in its channels (3648 of 7296), the
   shared attention in the ``heads`` form and its prefill context-
   parallel through kernel 7 at d=112; ``starcoder2-3b`` (2 of 30) at 1x4
   with caches of 1039 positions, which neither its 2 kv heads nor the
   positions divide over 4: the ``channels`` form (32 of 128 a rank), the
   partial scores summed over ``model``; each at published widths, bf16
   weights and f32 states, batch 4 x 1024 + 16 (+ 15 for the 2-layer
   starcoder2), teacher-forced on one process's tokens (the parent's,
   before the spawn): each step's logits within 2^-4 of its largest
   |logit|, the greedy token equal where one process's top-2 margin
   clears that, every recurrent state leaf on rank 0 within 1e-3 of the
   largest magnitude of its block of one process's state after the
   prefill and after the last step within its leaf's bound
   (``EP_STATE_LAST_BOUNDS``: bf16 activations on both sides), the
   cache bytes a rank the dry run's and the case's, each case's forms,
   ``generate``'s
   tokens through ``launch.serve.run`` bitwise equal on the ranks, its
   prefill and eager decode ms and rank 0's kernel 7 launches printed
   (host-staged).  In the parent,
   ``python -m repro_torch.launch.dryrun --all --jobs 2`` (every pair's
   rank-0 step executed on fake tensors in two worker processes) and
   ``--all --multi-pod`` (counted only; the CPU only, no JAX), started
   after phase 1's build and awaited beside the ranks, their seconds
   printed.
   18b also runs the paper's
   own ReLU experts (``grouped-relu``) at 1x4, the card replaying the CPU
   ranks' ReLU masks (``forced_relu_ffn``), at 1e-4.  18f: the paper
   model whole trained at 2x2 under FSDP (ZeRO-3, the state stored by the
   reference's ``param_shardings``) through ``launch.train.run(fsdp=
   True)``, grouped, batch 8 x 1024: 3 steps (the first loss within 1e-3
   of one process's, rank 0's launches of kernels 1-9, the all-gathers a
   step); the same 3 steps cut at the top of step 2 after a save there,
   then ``run(resume=True)`` from it: step 3 and the save at the run's
   end (every block and metric bitwise the uninterrupted run's); in the
   parent that last checkpoint restored on one process and cut into every
   rank's blocks (bitwise the ranks' blocks, by digest); each rank's peak
   below a 1-step ``fsdp=False`` run's at
   2x2; the checkpoint's bytes, save / restore seconds and step walls
   printed as host-staged.  18g: context parallelism, a batch with fewer
   rows than ranks.  18g-a: a ``gemma2-9b`` local and global block (f32,
   published widths) at 1x4 over 2 rows of 8192 (two ranks a row, the
   chunk's queries against the row's keys gathered over the row group),
   forward and backward against one process (the parent): y and dx
   within 1e-4, every gradient leaf summed over the ranks within 1e-3 of
   its max, kernels 7-9 once each and one row-group gather a rank.  18g-b:
   ``gemma2-9b`` at one local/global period trained at 2x2 through
   ``launch.train.run`` (FSDP by ``needs_fsdp``), batch 2 x 8192, 2 AdamW
   steps: finite, none skipped, the ranks' losses equal, each step's loss
   within 1e-5 and gradient norm within 1e-3 of the same run on one
   process (the parent's, before the spawn), rank 0's
   launches of kernels 7-9 exactly the path's (the forward twice a layer
   and step under FSDP's recompute), the row-group gathers a step; the
   per-rank peak, stored bytes and step walls printed as host-staged.
19. The graph-invariant linter on the card (``repro_torch.analysis.lint``,
   ``--device cuda``'s one-device part): ``lint_cell`` over the ``r1``
   cells (each forward and, grouped, its gradient recorded as an op graph
   — aten ops, logged collectives, kernel calls — with every op-graph
   rule run over it), the decode cells (the serving step-build
   validation) and the probes at the paper model's published size (an
   f32 train state's aliasing; two identical ``generate`` calls, each
   decode key captured once as a CUDA graph).  Any finding fails the
   phase.  The launch counters read around the backward of
   ``grouped/r1/flat/P2``'s gradient, printed on a line of their own:
   the forward grouped kernel does not launch there, dlhs and drhs do,
   as often as the graph's backward calls them.

The last lines are the card's name and power limit, one JSON object of
per-kernel numbers (all ten kernels; the row-per-step gather, on no
serving or training path, with the launches of its phase-5 run;
``launches_ep_serve``: rank 0's in 18e; ``launches_fsdp``: rank 0's in
18f; ``launches_cp``: rank 0's in 18g-b; ``launches_lint``: phase 19's;
``max_abs_err_cp``: 2n's context-parallel shapes), and
``{"ok": true, "device": {...}}``.  ``--phases kernels`` runs phases 1, 2
and 5 only, for work on a kernel, ``--phases trainer`` phases 1, 9-11
and 14, ``--phases presets`` phases 1, 12 and 13, ``--phases
frontends`` phases 1, 2g-2i, 2o, phase 5's rows at the frontend presets'
shapes and 15, ``--phases serving`` phases 1, 3 and 16, ``--phases
recurrent`` phases 1, 2p and 17, ``--phases ep`` phases 1, 2 and 18,
``--phases lint`` phases 1 and 19, and ``--phases analysis`` phase 1,
phase 3's eager decode step against the analysis and 6b; each ends with
``"ok": false``.  The script
imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import time
import warnings

ROOT = pathlib.Path(__file__).resolve().parent
ARCH = "hetumoe-paper-16e"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM
BF16_FLOPS = 989e12                # dense tensor-core bf16
F32_FLOPS = 67e12                  # f32 outside the tensor cores
SERVE = dict(batch=8, prompt_len=512, gen=32)
Q_CHUNK = 512                      # longer sequences take the flash kernels
# (dispatch, prompt length) of the serving cells
SERVE_CELLS = (("grouped", 512), ("sort", 512), ("grouped", 1024))
CARD = "cuda"                      # the device phases 9-11 drive


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else (
        f"nvidia-smi failed: {out.stderr.strip()}")


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_ms(torch, fn, *, batches: int = 25, per_batch: int = 10,
            warmup: int = 5) -> float:
    """Median over ``batches`` of the per-call time of ``per_batch``
    back-to-back calls between two CUDA events (host launch cost
    included, as the caller pays it)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(per_batch):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / per_batch)
    return statistics.median(times)


def graph_ms(torch, fn, *, reps: int = 25, per_graph: int = 10,
             stream=None):
    """Device time per call from CUDA-graph replays (no host launch cost),
    or None when the call cannot be captured.  ``stream``: the stream to
    capture on (a backward runs on its forward's stream, so a backward is
    captured on the stream its forward ran on)."""
    try:
        side = stream or torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=stream):
            for _ in range(per_graph):
                fn()
    except RuntimeError as e:
        print(f"    (graph capture failed: {str(e).splitlines()[0]})")
        return None
    return time_ms(torch, g.replay, batches=reps, per_batch=1,
                   warmup=3) / per_graph


FLUSH_BYTES = 128 * 2 ** 20        # 2.5x an H100's 50 MB L2


def l2_flush(torch):
    """A call that reads 128 MB of device memory: run between two calls of
    a kernel, it leaves none of that kernel's inputs in the L2."""
    buf = torch.ones(FLUSH_BYTES // 4, device="cuda")
    return lambda: buf.sum()


def graph_cold_ms(torch, fn, flush, *, reps: int = 25, per_graph: int = 10):
    """Device time per call of ``fn`` with the L2 flushed before each call
    (the way a caller finds it whose input was not just written): a graph
    of ``per_graph`` (flush, fn) pairs and one of ``per_graph`` flushes,
    replayed in turns; the median over ``reps`` of their difference.
    None when ``fn`` cannot be captured."""
    graphs = []
    for body in ((lambda: (flush(), fn())), flush):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        try:
            with torch.cuda.stream(side):
                body()
            torch.cuda.current_stream().wait_stream(side)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                for _ in range(per_graph):
                    body()
        except RuntimeError as e:
            print(f"    (graph capture failed: {str(e).splitlines()[0]})")
            return None
        graphs.append(g)
    for g in graphs * 2:
        g.replay()
    torch.cuda.synchronize()
    diffs = []
    for _ in range(reps):
        ms = []
        for g in graphs:
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            g.replay()
            e.record()
            e.synchronize()
            ms.append(s.elapsed_time(e))
        diffs.append((ms[0] - ms[1]) / per_graph)
    return statistics.median(diffs)


class TimingRows(list):
    """Phase 5's rows, one per kernel and shape: ``add`` times the kernel
    (eager and device-only), its plain version and its library call, and
    computes the bound of the work."""

    def __init__(self, torch, smi):
        super().__init__()
        self.torch, self.smi = torch, smi
        self.flush = None

    def add(self, name, source, replaces, kernel, plain, library, nbytes,
            flops, peak, shape, slow=False, library_graph=None, cold=False,
            **extra):
        """``slow``: a kernel call of several ms, timed in 5 batches of
        3 calls after one (eager, and the same in CUDA-graph replays, for
        the kernel and the library call), and a plain version of up to
        seconds a call, timed in 3 single calls after one; otherwise the
        plain version (10-50x the kernel, a yardstick and no check) in 5
        batches of 2 calls after 2.  ``cold``: also the
        device-only times of the kernel and of the library call with the
        L2 flushed before each call (``graph_cold_ms``), for a byte-bound
        kernel whose caller finds its input cold."""
        torch = self.torch
        kw = dict(batches=5, per_batch=3, warmup=1) if slow else {}
        gkw = dict(reps=5, per_graph=3) if slow else {}
        ms = time_ms(torch, kernel, **kw)
        dev_ms = graph_ms(torch, kernel, **gkw)
        plain_ms = time_ms(torch, plain, **(
            dict(batches=3, per_batch=1, warmup=1) if slow
            else dict(batches=5, per_batch=2, warmup=2)))
        lib_ms = lib_dev_ms = None
        if library is not None:
            try:
                lib_ms = time_ms(torch, library, **kw)
            except RuntimeError as e:
                print(f"    library call does not run on this build: "
                      f"{str(e).splitlines()[0]}")
            else:
                # (callable, capture stream) for the device-only time
                fn, stream = library_graph or (library, None)
                lib_dev_ms = graph_ms(torch, fn, stream=stream, **gkw)
        dev_cold = lib_cold = None
        if cold:
            if self.flush is None:
                self.flush = l2_flush(torch)
            dev_cold = graph_cold_ms(torch, kernel, self.flush, **gkw)
            if lib_ms is not None:
                lib_cold = graph_cold_ms(torch, library, self.flush, **gkw)
        tb, tf = nbytes / HBM_BYTES_PER_S, flops / peak
        bound_ms, by = 1e3 * max(tb, tf), ("bytes" if tb >= tf
                                           else "operations")

        def fmt(x):
            return "not measured" if x is None else f"{x:.4f}"
        cold_txt = (f", L2-cold device-only {fmt(dev_cold)} (library "
                    f"{fmt(lib_cold)})" if cold else "")
        print(f"  [{self.smi}] {name} {shape}: kernel_ms {ms:.4f} "
              f"(device-only {fmt(dev_ms)}), plain_ms {plain_ms:.4f}, "
              f"library_ms {fmt(lib_ms)} (device-only {fmt(lib_dev_ms)})"
              f"{cold_txt}, bound_us {1e3 * bound_ms:.2f} ({by}) "
              f"{extra or ''}")
        self.append(dict(name=name, route="cuda", source=source,
                         replaces=replaces, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=by, library_ms=lib_ms,
                         device_ms=dev_ms, library_device_ms=lib_dev_ms,
                         device_cold_ms=dev_cold,
                         library_device_cold_ms=lib_cold, shape=shape,
                         **extra))


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def bf16_ulp(torch, v):
    """One bf16 ulp at the magnitude of each element of ``v`` (f32)."""
    a = v.abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


# Relative Frobenius distance ||drhs - plain|| / ||plain|| of the WMMA drhs
# kernel that the cp.async + mma.sync one replaced, per phase-2e case with
# bf16 inputs (the same shapes and offsets, drhs_ab.py's draws), from
# drhs_ab.py on an H100 80GB HBM3 at 700 W; phase 2e holds the kernel
# to at most 4x these.  (Its outputs and the new kernel's were bitwise
# equal in every case: both add each 16 rows' products into the
# accumulator by one tensor-core step, in row order.)
WMMA_DRHS_FRO = {
    "M=4096 K=N=2048 E=16 skewed, expert 9 empty, tail 96": 5.520e-07,
    "decode M=8 K=N=2048 E=16": 3.717e-09,
    "decode M=8, 8 distinct experts": 0.0,
    "M=1 K=N=2048": 0.0,
    "M=4096 all rows in one expert": 4.424e-06,
    "M=1000 K=N=256 (off the 128-row tile), single-row segments": 4.635e-07,
    "M=300 K=N=512, rows 250.. past offsets[E]": 1.451e-07,
    "ragged M=100 K=72 N=40 E=3 (partial tiles)": 6.938e-08,
    "M=50 K=20 N=12 E=2 (unvectorised loads)": 4.414e-08,
    "M=200 K=16 N=72 E=3, segment ends off the tiles, expert 1 empty":
    1.225e-07}


def skewed_offsets(torch, M: int, E: int, tail: int, empty: int):
    """Offsets with geometrically skewed segments, expert ``empty`` empty
    and ``tail`` rows past offsets[E]."""
    w = torch.tensor([0.8 ** e for e in range(E)], dtype=torch.float64)
    w[empty] = 0
    sizes = torch.floor(w / w.sum() * (M - tail)).to(torch.int64)
    offs = torch.zeros(E + 1, dtype=torch.int32)
    offs[1:] = torch.cumsum(sizes, 0).to(torch.int32)
    return offs


def grouped_cases(torch):
    """(name, M, K, N, E, offsets) of phases 2c-2e."""
    E = 16
    return [("M=4096 K=N=2048 E=16 skewed, expert 9 empty, tail 96",
            4096, 2048, 2048, E, skewed_offsets(torch, 4096, E, 96, 9)),
           ("decode M=8 K=N=2048 E=16", 8, 2048, 2048, E,
            torch.tensor([0, 1, 1, 3, 3, 3, 4, 4, 4, 4, 5, 6, 6, 6, 7, 7,
                          8], dtype=torch.int32)),
           ("decode M=8, 8 distinct experts", 8, 2048, 2048, E,
            torch.tensor([0, 1, 1, 2, 3, 3, 4, 5, 5, 6, 6, 7, 8, 8, 8, 8,
                          8], dtype=torch.int32)),
           ("M=1 K=N=2048", 1, 2048, 2048, E,
            torch.tensor([0] * 5 + [1] * 12, dtype=torch.int32)),
           ("M=4096 all rows in one expert", 4096, 2048, 2048, E,
            torch.tensor([0] * 4 + [4096] * 13, dtype=torch.int32)),
           ("M=1000 K=N=256 (off the 128-row tile), single-row segments",
            1000, 256, 256, 6,
            torch.tensor([0, 1, 2, 3, 500, 999, 1000], dtype=torch.int32)),
           ("M=300 K=N=512, rows 250.. past offsets[E]", 300, 512, 512, 3,
            torch.tensor([0, 100, 100, 250], dtype=torch.int32)),
           ("ragged M=100 K=72 N=40 E=3 (partial tiles)", 100, 72, 40, 3,
            torch.tensor([0, 30, 31, 90], dtype=torch.int32)),
           ("M=50 K=20 N=12 E=2 (unvectorised loads)", 50, 20, 12, 2,
            torch.tensor([0, 25, 45], dtype=torch.int32))]


def drhs_cases(torch):
    """Phase 2e's cases: 2c's and a segment ending off the tiles."""
    return grouped_cases(torch) + [
        ("M=200 K=16 N=72 E=3, segment ends off the tiles, expert 1 empty",
         200, 16, 72, 3, torch.tensor([0, 127, 127, 190], dtype=torch.int32))]


def routed_maps(torch, g, S: int, E: int, K: int, dispatch: str,
                capacity: int = 0):
    """The index maps a dispatch hands the gather, from the port's own
    plan over ``S`` tokens routed to ``K`` distinct of ``E`` experts
    uniformly at random (on the CPU): ``grouped`` gives (token, dest),
    the expert-sorted buffer's source tokens and their inverse; ``sort``
    gives (inv, slot) at ``capacity`` rows an expert, -1 for an empty
    capacity slot and for a dropped assignment."""
    from repro_torch.core import gating, layout
    experts = torch.rand(S, E, generator=g).argsort(-1)[:, :K].to(
        torch.int32)
    gate = gating.GateOutput(experts, torch.ones(S, K), torch.zeros(S, E),
                             torch.zeros(S, E))
    if dispatch == "grouped":
        plan = layout.plan_grouped(gate, E)
        return plan.token, plan.dest
    plan = layout.plan_sort(gate, E, capacity)
    return plan.inv, plan.slot


def check_gather(torch, L, name, src, idx, dest, errs):
    """Phase 2b's check of the gather on the card, bitwise against the
    plain version of the gather form; with ``dest`` the fan-out form."""
    out = L.gather_rows(src, idx, dest)
    ref = L.gather_rows_plain(src, idx)
    torch.cuda.synchronize()
    same = torch.equal(out, ref)
    err = (out.float() - ref.float()).abs().max().item()
    errs["gather_rows"] = max(errs["gather_rows"], err)
    form = "gather" if dest is None else f"fan-out K={dest.shape[1]}"
    print(f"  {name} ({form}): bitwise equal={same}, max abs err {err:.3e}")
    check(same, f"gather_rows {name} ({form}) disagrees with its plain "
                f"version")


def launch_floor_ms(torch):
    """An empty kernel's device-only time: the launch floor."""
    from repro_torch.kernels import build
    lib = build.load()
    dummy = torch.empty(0, device="cuda")

    def empty():
        build.check(lib.launch_empty(build.stream(dummy)), "launch_empty")
    return graph_ms(torch, empty)


def check_gate(torch, K, name, xd, k, errs):
    """Phase 2a's check of the gate on logits ``xd`` on the card: idx,
    vals and rowmax equal to the plain version's, sumexp within rtol
    1e-6."""
    kv, ki, km, ks = K.fused_topk_gate(xd, k)
    pv, pi, pm, ps = K.topk_gate_plain(xd, k)
    torch.cuda.synchronize()
    rel = ((ks - ps).abs() / ps.abs()).max().item()
    errs["topk_gate"] = max(errs["topk_gate"], (kv - pv).abs().max().item(),
                            (ks - ps).abs().max().item())
    ok = (torch.equal(ki, pi) and torch.equal(kv, pv)
          and torch.equal(km, pm) and rel <= 1e-6)
    print(f"  {name}: idx/vals/rowmax equal={ok and True}, sumexp max "
          f"rel err {rel:.3e} (tol 1e-6)")
    check(ok, f"topk_gate {name} disagrees with its plain version")


def check_grouped_bf16(torch, G, name, lhs, rhs, o, errs):
    """Phase 2c's bf16 check of the grouped matmul: within 1 ulp of the
    f32-accumulated plain result rounded once, plus the f32 summation-order
    bound K·2^-24·Σ|a·b| (the two sums add in other orders; it only
    matters where the products cancel to near 0); rows past offsets[E]
    zero."""
    out = G.grouped_matmul(lhs, rhs, o)
    ref = G.grouped_matmul_plain(lhs, rhs, o)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    errs["grouped_matmul"] = max(errs["grouped_matmul"], err.max().item())
    tail_zero = bool((out[int(o[-1]):] == 0).all())
    del out
    order = lhs.shape[1] * 2.0 ** -24 * G.grouped_matmul_plain(
        lhs.float().abs(), rhs.abs(), o)
    ulp = bf16_ulp(torch, ref.float())
    ok = bool((err <= ulp + order).all())
    print(f"  {name} bf16: max abs err {err.max().item():.3e} "
          f"({(err / ulp).max().item():.2f} ulp max, "
          f"{int((err > ulp).sum())} elements past 1 ulp, all within 1 ulp "
          f"+ the f32 order bound: {ok}), tail rows zero={tail_zero}")
    check(ok and tail_zero,
          f"grouped_matmul {name} bf16 disagrees with its plain version")


def phase_kernels(torch, dev):
    from repro_torch.kernels import grouped_ffn as G
    from repro_torch.kernels import layout_transform as L
    from repro_torch.kernels import topk_gate as K
    g = torch.Generator(device="cpu").manual_seed(1234)
    errs = {"topk_gate": 0.0, "gather_rows": 0.0, "grouped_matmul": 0.0}

    print("phase 2a: topk_gate (idx, vals, rowmax exact; sumexp rtol 1e-6)")
    ties = torch.randint(0, 3, (777, 16), generator=g).float()
    cases = [("S=4096 E=16 k=1", torch.randn(4096, 16, generator=g), 1),
             ("S=4096 E=16 k=2", torch.randn(4096, 16, generator=g), 2),
             ("S=1000 (not a multiple of 32) k=2",
              torch.randn(1000, 16, generator=g), 2),
             ("exact ties S=777 k=2", ties, 2),
             ("decode S=8 k=1", torch.randn(8, 16, generator=g), 1),
             ("E=40 k=3", torch.randn(300, 40, generator=g), 3),
             ("exact ties S=4096 E=16 k=4",
              torch.randint(0, 3, (4096, 16), generator=g).float(), 4),
             ("E=10 (not a multiple of 4: the scalar path) k=3",
              torch.randn(1000, 10, generator=g), 3),
             ("E=384 (the widest instance) k=8",
              torch.randn(500, 384, generator=g), 8)]
    for name, x, k in cases:
        check_gate(torch, K, name, x.to(dev), k, errs)

    print("phase 2b: gather_rows, the gather form and the fan-out form "
          "with the dispatches' maps (tolerance: bitwise)")
    gcases = []
    for dt in (torch.bfloat16, torch.float32):
        src = torch.randn(4096, 2048, generator=g).to(dt)
        idx = torch.randint(-1, 4096, (4096,), generator=g, dtype=torch.int32)
        idx[torch.rand(4096, generator=g) < 0.1] = -1
        gcases.append((f"M=N=4096 d=2048 {dt} with -1 rows", src, idx, None))
        gcases.append((f"grouped dispatch T=4096 E=16 k=1 d=2048 {dt}", src,
                       *routed_maps(torch, g, 4096, 16, 1, "grouped")))
    src = torch.randn(4096, 2048, generator=g).to(torch.bfloat16)
    gcases.append(("decode M=8 bf16", src,
                   torch.tensor([5, -1, 4095, 0, 17, 17, -1, 3],
                                dtype=torch.int32), None))
    gcases.append(("sort dispatch T=4096 E=16 k=2 C=512 (drops, empty "
                   "slots) d=2048 bf16", src,
                   *routed_maps(torch, g, 4096, 16, 2, "sort", 512)))
    src = torch.randn(8, 2048, generator=g).to(torch.bfloat16)
    gcases.append(("decode grouped T=8 E=16 k=4 bf16", src,
                   *routed_maps(torch, g, 8, 16, 4, "grouped")))
    gcases.append(("decode sort T=8 E=16 k=4 C=8 bf16", src,
                   *routed_maps(torch, g, 8, 16, 4, "sort", 8)))
    src = torch.randn(300, 1001, generator=g).to(torch.bfloat16)
    gcases.append(("d=1001 bf16 (byte path)", src, torch.randint(
        -1, 300, (500,), generator=g, dtype=torch.int32), None))
    gcases.append(("d=1001 bf16 (byte path)", src,
                   *routed_maps(torch, g, 300, 8, 2, "sort", 64)))
    gcases.append(("d=3 f32 (word path)", torch.randn(50, 3, generator=g),
                   torch.randint(-1, 50, (70,), generator=g,
                                 dtype=torch.int32), None))
    gcases.append(("d=3 f32 (word path)", torch.randn(50, 3, generator=g),
                   *routed_maps(torch, g, 50, 4, 2, "grouped")))
    for name, src, idx, dest in gcases:
        check_gather(torch, L, name, src.to(dev), idx.to(dev),
                     None if dest is None else dest.to(dev), errs)

    errs["gather_rows_rowstep"] = 0.0
    print("phase 2b': gather_rows_rowstep, the seed's row-per-step baseline "
          "(tolerance: bitwise)")
    rcases = []
    for dt in (torch.bfloat16, torch.float32):
        src = torch.randn(4096, 2048, generator=g).to(dt)
        idx = torch.randint(-1, 4096, (4096,), generator=g, dtype=torch.int32)
        idx[torch.rand(4096, generator=g) < 0.1] = -1
        rcases.append((f"M=N=4096 d=2048 {dt} with -1 rows", src, idx))
    src = torch.randn(4096, 2048, generator=g).to(torch.bfloat16)
    rcases += [("M=8 bf16", src, torch.tensor([5, -1, 4095, 0, 17, 17, -1, 3],
                                              dtype=torch.int32)),
               ("M=1 bf16", src, torch.tensor([4000], dtype=torch.int32)),
               ("all -1 bf16", src, torch.full((300,), -1,
                                               dtype=torch.int32)),
               ("d=100 bf16 (ragged: element loads)",
                torch.randn(300, 100, generator=g).to(torch.bfloat16),
                torch.randint(-1, 300, (500,), generator=g,
                              dtype=torch.int32))]
    for name, src, idx in rcases:
        s, i = src.to(dev), idx.to(dev)
        out = L.gather_rows_rowstep(s, i)
        ref = L.gather_rows_rowstep_plain(s, i)
        torch.cuda.synchronize()
        same = torch.equal(out, ref)
        err = (out.float() - ref.float()).abs().max().item()
        errs["gather_rows_rowstep"] = max(errs["gather_rows_rowstep"], err)
        print(f"  {name}: bitwise equal={same}, max abs err {err:.3e}")
        check(same, f"gather_rows_rowstep {name} disagrees with its plain "
                    f"version")
    del rcases, src, s, out, ref

    print("phase 2c: grouped_matmul (f32 rtol/atol 1e-4; bf16 within 1 ulp "
          "of the f32-accumulated plain result rounded once, plus the f32 "
          "summation-order bound)")
    mcases = grouped_cases(torch)
    for name, M, Kd, N, E_, offs in mcases:
        lhs32 = torch.randn(M, Kd, generator=g)
        rhs32 = torch.randn(E_, Kd, N, generator=g) * Kd ** -0.5
        o = offs.to(dev)
        lhs, rhs = lhs32.to(dev), rhs32.to(dev)
        out = G.grouped_matmul(lhs, rhs, o)
        ref = G.grouped_matmul_plain(lhs, rhs, o)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        errs["grouped_matmul"] = max(errs["grouped_matmul"], err)
        tail_zero = bool((out[int(offs[-1]):] == 0).all())
        ok = bool(torch.allclose(out, ref, rtol=1e-4, atol=1e-4))
        print(f"  {name} torch.float32: max abs err {err:.3e} (rtol/atol "
              f"1e-4), tail rows zero={tail_zero}")
        check(ok and tail_zero, f"grouped_matmul {name} torch.float32 "
                                f"disagrees with its plain version")
        check_grouped_bf16(torch, G, name, lhs.to(torch.bfloat16),
                           rhs.to(torch.bfloat16), o, errs)

    errs.update(grouped_matmul_t=0.0, grouped_drhs=0.0, scatter_add_rows=0.0)
    print("phase 2d: grouped_matmul_t, dlhs = g @ w[e]^T (f32 rtol/atol 1e-4; "
          "bf16 within 1 ulp of the f32-accumulated plain result rounded "
          "once, plus the f32 summation-order bound)")
    for name, M, Kd, N, E_, offs in mcases:
        g32 = torch.randn(M, N, generator=g)
        rhs32 = torch.randn(E_, Kd, N, generator=g) * N ** -0.5
        o = offs.to(dev)
        for dt in (torch.float32, torch.bfloat16):
            gd, rhs = g32.to(dt).to(dev), rhs32.to(dt).to(dev)
            out = G.grouped_matmul_t(gd, rhs, o)
            ref = G.grouped_matmul_t_plain(gd, rhs, o)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs()
            errs["grouped_matmul_t"] = max(errs["grouped_matmul_t"],
                                           err.max().item())
            if dt == torch.float32:
                ok = bool(torch.allclose(out, ref, rtol=1e-4, atol=1e-4))
                tol = "rtol/atol 1e-4"
            else:
                order = N * 2.0 ** -24 * G.grouped_matmul_t_plain(
                    gd.float().abs(), rhs.float().abs(), o)
                ulp = bf16_ulp(torch, ref.float())
                ok = bool((err <= ulp + order).all())
                tol = (f"{(err / ulp).max().item():.2f} ulp max, within 1 "
                       f"ulp + the f32 order bound: {ok}")
            tail = out[int(offs[-1]):]
            ok = ok and bool((tail == 0).all())
            print(f"  {name} {dt}: max abs err {err.max().item():.3e} "
                  f"({tol}), tail rows zero={bool((tail == 0).all())}")
            check(ok, f"grouped_matmul_t {name} {dt} disagrees with its "
                      f"plain version")

    print("phase 2e: grouped_drhs, drhs[e] = lhs[seg_e]^T @ g[seg_e] in f32 "
          "(f32 FMA variant: rtol 1e-4 plus the f32 summation-order bound "
          "M*2^-24*sum|a*b|; bf16 inputs: within that order bound, and the "
          "bf16-out form bitwise the f32 form rounded to bf16; empty "
          "experts exactly 0; relative Frobenius distance from the plain "
          "version beside the WMMA kernel this one replaced, at most 4x it)")
    for name, M, Kd, N, E_, offs in drhs_cases(torch):
        lhs32 = torch.randn(M, Kd, generator=g)
        g32 = torch.randn(M, N, generator=g)
        o = offs.to(dev)
        empty = [e for e in range(E_) if offs[e + 1] <= offs[e]]
        for dt in (torch.float32, torch.bfloat16):
            lhs, gd = lhs32.to(dt).to(dev), g32.to(dt).to(dev)
            out = G.grouped_drhs(lhs, gd, o)
            ref = G.grouped_drhs_plain(lhs, gd, o)
            torch.cuda.synchronize()
            err = (out - ref).abs()
            errs["grouped_drhs"] = max(errs["grouped_drhs"], err.max().item())
            order = M * 2.0 ** -24 * G.grouped_drhs_plain(
                lhs.float().abs(), gd.float().abs(), o)
            bound = order + (1e-4 * ref.abs() if dt == torch.float32 else 0)
            ok = bool((err <= bound + 1e-7).all())
            zero = all(bool((out[e] == 0).all()) for e in empty)
            extra = ""
            if dt == torch.bfloat16:
                out16 = G.grouped_drhs(lhs, gd, o, out_dtype=torch.bfloat16)
                rounded = torch.equal(out16, out.to(torch.bfloat16))
                fro = (err.norm() / ref.norm().clamp(min=1e-30)).item()
                was = WMMA_DRHS_FRO.get(name)
                near = was is None or fro <= 4 * max(was, 1e-12)
                ok = ok and rounded and near
                extra = (f"; bf16 out == f32 out rounded: {rounded}; "
                         f"Frobenius {fro:.3e} (WMMA kernel "
                         f"{'not recorded' if was is None else f'{was:.3e}'})")
                del out16
            print(f"  {name} {dt}: max abs err {err.max().item():.3e} "
                  f"(max err/bound {(err / (bound + 1e-7)).max().item():.3f}),"
                  f" empty experts {empty} zero={zero}{extra}")
            check(ok and zero, f"grouped_drhs {name} {dt} disagrees with its "
                               f"plain version")
        del out, ref, order, bound

    print("phase 2f: scatter_add_rows (bitwise against the plain version "
          "computed on the CPU, for any number c of addends per row; the "
          "kernel's output bitwise equal over 3 reruns)")
    d = 2048
    perm = torch.randperm(4096, generator=g).to(torch.int32)
    inv = torch.full((5120,), -1, dtype=torch.int32)
    inv[torch.randperm(5120, generator=g)[:4096]] = perm
    slot = torch.randperm(5120, generator=g)[:4096].to(torch.int32)
    slot[torch.rand(4096, generator=g) < 0.05] = -1
    pair = torch.cat([torch.randperm(4096, generator=g),
                      torch.randperm(4096, generator=g)]).to(torch.int32)
    pair[torch.rand(8192, generator=g) < 0.1] = -1
    triple = torch.cat([torch.randperm(4096, generator=g)
                        for _ in range(3)]).to(torch.int32)
    triple[torch.rand(12288, generator=g) < 0.05] = -1
    scases = [("grouped dispatch VJP (4096 -> 4096, a permutation)", 4096,
               perm, 4096),
              ("sort dispatch VJP (5120 -> 4096, -1 for empty slots)", 5120,
               inv, 4096),
              ("sort combine VJP (4096 -> 5120, -1 for dropped)", 4096, slot,
               5120),
              ("top_k=2 pairs (8192 -> 4096)", 8192, pair, 4096),
              ("top_k=3 triples (12288 -> 4096)", 12288, triple, 4096),
              ("many duplicates (4096 -> 50)", 4096,
               torch.randint(-1, 50, (4096,), generator=g, dtype=torch.int32),
               50),
              ("indices past n and n > the plan's shared memory (3000 -> "
               "20000)", 3000,
               torch.randint(-5, 20100, (3000,), generator=g,
                             dtype=torch.int32), 20000),
              ("d=1001 (odd width) pairs", 600,
               torch.cat([torch.randperm(300, generator=g)] * 2).to(
                   torch.int32), 300)]
    for name, M, idx, n in scases:
        width = 1001 if "1001" in name else d
        g32 = torch.randn(M, width, generator=g)
        i = idx.to(dev)
        valid = idx[(idx >= 0) & (idx < n)]
        c = int(torch.bincount(valid.long(), minlength=n).max()) if len(
            valid) else 0
        for dt in (torch.bfloat16, torch.float32):
            gd = g32.to(dt)
            ref = L.scatter_add_rows_plain(gd, idx, n)      # on the CPU
            gd = gd.to(dev)
            out = L.scatter_add_rows(gd, i, n)
            reruns = [L.scatter_add_rows(gd, i, n) for _ in range(3)]
            torch.cuda.synchronize()
            out_cpu = out.cpu()
            err = (out_cpu.float() - ref.float()).abs()
            errs["scatter_add_rows"] = max(errs["scatter_add_rows"],
                                           err.max().item())
            same = torch.equal(out_cpu, ref)
            stable = all(torch.equal(r, out) for r in reruns)
            print(f"  {name} {dt}: c={c}, max abs err {err.max().item():.3e}"
                  f", bitwise equal to the CPU's plain version: {same}, to "
                  f"its own 3 reruns: {stable}")
            check(same and stable, f"scatter_add_rows {name} {dt} disagrees "
                                   f"with its plain version or its reruns")
        del reruns, out
    return errs


def uniform_offsets(torch, g, M: int, E: int, unit: int = 1):
    """Offsets of ``M`` rows assigned uniformly at random to ``E`` experts,
    in blocks of ``unit`` rows."""
    assign = torch.randint(0, E, (M // unit,), generator=g)
    offs = torch.zeros(E + 1, dtype=torch.int32)
    offs[1:] = torch.cumsum(torch.bincount(assign, minlength=E) * unit, 0)
    return offs


def distinct_offsets(torch, g, M: int, E: int):
    """Offsets of ``M`` rows, one in each of ``M`` distinct experts (a
    decode batch of ``M`` tokens at top-1)."""
    counts = torch.zeros(E, dtype=torch.int64)
    counts[torch.randperm(E, generator=g)[:M]] = 1
    offs = torch.zeros(E + 1, dtype=torch.int32)
    offs[1:] = torch.cumsum(counts, 0)
    return offs


# The kernels at the shapes phase 12's presets give them, one table per
# kernel; phase 2j-2k checks every case against its plain version and
# times those marked ``timed`` on the same inputs (their rows join phase
# 5's).  T = 8 x 1024 tokens (a prompt-1024 prefill), 8 x 512 at prompt
# 512, 8 at decode.
T_PRESET = 8 * 1024
# (name, S, E, k, timed) of the gate: dbrx's top-4 over 16, llama4's top-1
# over 128
PRESET_GATES = (
    ("dbrx prefill 1024", T_PRESET, 16, 4, True),
    ("dbrx prefill 512", T_PRESET // 2, 16, 4, False),
    ("dbrx decode", 8, 16, 4, False),
    ("llama4 prefill 1024", T_PRESET, 128, 1, True),
    ("llama4 prefill 512", T_PRESET // 2, 128, 1, False),
    ("llama4 decode", 8, 128, 1, False))
# (name, N tokens, E, k, d, timed) of the grouped dispatch's gather (M =
# N·k rows in the served expert-sorted order, in both forms) and of the
# grouped combine's scatter-add (f32 rows back onto N tokens, k addends
# each); and dbrx's sort dispatch (E·C rows, the empty capacity slots zero)
PRESET_ROWS = (
    ("dbrx prefill 1024 (k=4)", T_PRESET, 16, 4, 6144, True),
    ("dbrx prefill 512 (k=4)", T_PRESET // 2, 16, 4, 6144, False),
    ("dbrx decode (k=4)", 8, 16, 4, 6144, False),
    ("llama4 prefill 1024 (k=1)", T_PRESET, 128, 1, 5120, True),
    ("llama4 prefill 512 (k=1)", T_PRESET // 2, 128, 1, 5120, False),
    ("llama4 decode (k=1)", 8, 128, 1, 5120, False))
# (name, M, K, N, E, offsets kind, timed) of the grouped matmul, grouped by
# weight shape (one draw of each): dbrx's up/gate (d=6144 -> f=10752) and
# out projections over 16 experts, T·4 rows; llama4's (d=5120, f=8192)
# over 128, T rows (at decode 8 rows on 8 distinct experts)
PRESET_GROUPED = (
    ("dbrx up prefill 1024", 4 * T_PRESET, 6144, 10752, 16, "uniform", True),
    ("dbrx up prefill 512", 2 * T_PRESET, 6144, 10752, 16, "uniform", False),
    ("dbrx up decode (8 tokens x 4)", 32, 6144, 10752, 16, "uniform", True),
    ("dbrx out prefill 1024", 4 * T_PRESET, 10752, 6144, 16, "uniform",
     False),
    ("dbrx out prefill 512", 2 * T_PRESET, 10752, 6144, 16, "uniform", False),
    ("llama4 up prefill 1024", T_PRESET, 5120, 8192, 128, "uniform", True),
    ("llama4 up prefill 512", T_PRESET // 2, 5120, 8192, 128, "uniform",
     False),
    ("llama4 up prefill 1024 skewed (0.8^e, expert 9 empty, tail 96)",
     T_PRESET, 5120, 8192, 128, "skewed", False),
    ("llama4 up decode, 8 distinct experts", 8, 5120, 8192, 128, "distinct",
     True),
    ("llama4 out prefill 1024", T_PRESET, 8192, 5120, 128, "uniform", False))
# (H, KV, preset) of the flash forward at B=8, S=1024, d=128 (phase 2g
# checks them, phase 2k times them)
PRESET_HEADS = ((48, 8, "dbrx"), (40, 8, "llama4"), (32, 4, "yi"),
                (24, 2, "starcoder2"))


def phase_preset_kernels(torch, dev, smi, errs):
    """Phases 2j-2k: the gate, the gather, the scatter-add and the grouped
    matmul at every shape of ``PRESET_GATES``, ``PRESET_ROWS`` and
    ``PRESET_GROUPED``, against their plain versions with the tolerances
    of 2a-2c and 2f; the cases marked ``timed`` (and the flash forward at
    ``PRESET_HEADS``) then timed on the same inputs.  The expert weights
    (up to 10.7 GB at E=128) are drawn on the card, in bf16, the serving
    dtype.  Returns the timing rows."""
    from repro_torch.kernels import flash_attention as F
    from repro_torch.kernels import grouped_ffn as G
    from repro_torch.kernels import layout_transform as L
    from repro_torch.kernels import topk_gate as K
    g = torch.Generator(device="cpu").manual_seed(818)
    gd = torch.Generator(device=dev).manual_seed(818)
    rows = TimingRows(torch, smi)
    print("phase 2j: topk_gate, gather_rows and scatter_add_rows at the "
          "presets' shapes (tolerances of 2a, 2b and 2f: the scatter-add "
          "bitwise its plain version and its own rerun); the rows marked "
          "timed then timed as in phase 5")
    for name, S, E, k, timed in PRESET_GATES:
        x = torch.randn(S, E, generator=g).to(dev)
        check_gate(torch, K, f"{name} S={S} E={E} k={k}", x, k, errs)
        if timed:
            rows.add("topk_gate", "src/repro_torch/csrc/topk_gate.cu",
                     "src/repro/kernels/topk_gate.py:24",
                     lambda x=x, k=k: K.fused_topk_gate(x, k),
                     lambda x=x, k=k: K.topk_gate_plain(x, k),
                     lambda x=x, k=k: torch.topk(x, k, dim=-1),
                     S * E * 4 + S * k * 8 + S * 8, (3 + k) * S * E,
                     F32_FLOPS, f"{name} S={S} E={E} k={k}")
    ties = torch.randint(0, 3, (4096, 128), generator=g).float()
    check_gate(torch, K, "exact ties S=4096 E=128 k=4", ties.to(dev), 4, errs)
    floor_ms = launch_floor_ms(torch)
    print(f"  [{smi}] launch floor (an empty kernel, device-only): "
          f"{floor_ms:.4f} ms; the gate's bound is the larger of its bytes "
          f"and this")
    for r in rows:
        r["launch_floor_device_ms"] = floor_ms
    for name, N, E, k, d, timed in PRESET_ROWS:
        M = N * k
        src = torch.randn((N, d), generator=gd, device=dev).to(torch.bfloat16)
        idx, dest = (t.to(dev) for t in routed_maps(torch, g, N, E, k,
                                                     "grouped"))
        for form in (dest, None):
            check_gather(torch, L, f"{name}: M={M} rows of d={d} bf16 from "
                         f"N={N}, expert-sorted", src, idx, form, errs)
        contrib = torch.randn((M, d), generator=gd, device=dev)
        acc = L.scatter_add_rows(contrib, idx, N)
        again = L.scatter_add_rows(contrib, idx, N)
        plain = L.scatter_add_rows_plain(contrib, idx, N)
        torch.cuda.synchronize()
        s_same = torch.equal(acc, plain) and torch.equal(acc, again)
        s_err = (acc - plain).abs().max().item()
        errs["scatter_add_rows"] = max(errs["scatter_add_rows"], s_err)
        print(f"  scatter-add {name}: M={M} f32 rows of d={d} onto N={N}: "
              f"bitwise equal to the plain version and to a rerun="
              f"{s_same}, max abs err {s_err:.3e}")
        check(s_same, f"scatter_add_rows {name} disagrees with its plain "
                      f"version or its rerun")
        del acc, again, plain
        if timed:
            for form, dst in (("fan-out", dest), ("gather", None)):
                rows.add("gather_rows",
                         "src/repro_torch/csrc/layout_transform.cu",
                         "src/repro/kernels/layout_transform.py:42",
                         lambda src=src, idx=idx, dst=dst: L.gather_rows(
                             src, idx, dst),
                         lambda src=src, idx=idx: L.gather_rows_plain(
                             src, idx),
                         lambda src=src, idx=idx: torch.index_select(
                             src, 0, idx),
                         N * d * 2 + M * 4 + M * d * 2
                         + (dest.numel() * 4 if dst is not None else 0), 0,
                         BF16_FLOPS, f"{name} M={M} from N={N} d={d} bf16, "
                         f"{form} form", cold=True, form=form)
            zeros = torch.zeros((N, d), device=dev)
            rows.add("scatter_add_rows",
                     "src/repro_torch/csrc/layout_transform.cu",
                     "src/repro/kernels/layout_transform.py:104",
                     lambda c=contrib, idx=idx: L.scatter_add_rows(c, idx, N),
                     lambda c=contrib, idx=idx: L.scatter_add_rows_plain(
                         c, idx, N),
                     lambda c=contrib, idx=idx: torch.index_add(
                         zeros, 0, idx, c),
                     M * d * 4 + M * 4 + N * d * 4, M * d, F32_FLOPS,
                     f"grouped combine {name} M={M} f32 rows onto N={N} "
                     f"d={d}", cold=True)
            del zeros
        del src, idx, dest, contrib
    # dbrx's sort dispatch at prompt 1024: capacity as the preset's
    # capacity_factor gives it, the empty capacity slots zero
    from repro_torch import configs
    from repro_torch.core import capacity
    N, E, k, d = T_PRESET, 16, 4, 6144
    C = capacity.expert_capacity(configs.get_config("dbrx-132b").moe, N, E)
    src = torch.randn((N, d), generator=gd, device=dev).to(torch.bfloat16)
    inv, slot = (t.to(dev) for t in routed_maps(torch, g, N, E, k, "sort", C))
    empty = int((inv < 0).sum())
    check_gather(torch, L, f"dbrx sort dispatch prefill 1024: E*C={E * C} "
                 f"rows (C={C}, {empty} empty) of d={d} bf16 from N={N}",
                 src, inv, slot, errs)
    rows.add("gather_rows", "src/repro_torch/csrc/layout_transform.cu",
             "src/repro/kernels/layout_transform.py:42",
             lambda: L.gather_rows(src, inv, slot),
             lambda: L.gather_rows_plain(src, inv),
             lambda: torch.index_select(src, 0, inv.clamp(min=0)),
             N * d * 2 + E * C * 4 + slot.numel() * 4 + E * C * d * 2, 0,
             BF16_FLOPS, f"dbrx sort dispatch prefill 1024 E*C={E * C} "
             f"({empty} empty) from N={N} d={d} bf16, fan-out form",
             cold=True, form="fan-out")
    del src, inv, slot
    print("phase 2k: grouped_matmul at the presets' expert widths, bf16 "
          "(tolerance of 2c: within 1 ulp of the f32-accumulated plain "
          "result rounded once, plus the f32 summation-order bound)")
    gmm = hasattr(torch, "_grouped_mm")
    rhs, key = None, None
    for name, M, Kd, N, E, kind, timed in PRESET_GROUPED:
        if key != (E, Kd, N):
            rhs = None
            torch.cuda.empty_cache()
            rhs = torch.randn((E, Kd, N), generator=gd, device=dev,
                              dtype=torch.bfloat16).mul_(Kd ** -0.5)
            key = (E, Kd, N)
        offs = {"uniform": lambda: uniform_offsets(torch, g, M, E),
                "skewed": lambda: skewed_offsets(torch, M, E, 96, 9),
                "distinct": lambda: distinct_offsets(torch, g, M, E)}[kind]()
        o = offs.to(dev)
        lhs = torch.randn((M, Kd), generator=gd, device=dev).to(
            torch.bfloat16)
        shape = f"{name} M={M} K={Kd} N={N} E={E}"
        check_grouped_bf16(torch, G, shape, lhs, rhs, o, errs)
        if timed:
            active = int((offs[1:] > offs[:-1]).sum())
            rows.add("grouped_matmul", "src/repro_torch/csrc/grouped_ffn.cu",
                     "src/repro/kernels/grouped_ffn.py:60",
                     lambda lhs=lhs, o=o: G.grouped_matmul(lhs, rhs, o),
                     lambda lhs=lhs, o=o: G.grouped_matmul_plain(lhs, rhs, o),
                     (lambda lhs=lhs, o=o: torch._grouped_mm(
                         lhs, rhs, offs=o[1:])) if gmm else None,
                     M * Kd * 2 + active * Kd * N * 2 + (E + 1) * 4
                     + M * N * 2, 2 * M * Kd * N, BF16_FLOPS,
                     f"{shape} ({active} experts active)", slow=M >= T_PRESET)
        del lhs
    del rhs
    torch.cuda.empty_cache()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, S, d = 8, 1024, 128
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    st = (d ** -0.5, True, None, None)
    pairs = S * (S + 1) // 2
    for H, KV, who in PRESET_HEADS:
        q = torch.randn((B, H, S, d), generator=gd, device=dev).to(
            torch.bfloat16)
        k, v = (torch.randn((B, KV, S, d), generator=gd, device=dev).to(
            torch.bfloat16) for _ in range(2))
        nbytes = 2 * B * H * S * d * 2 + 2 * B * KV * S * d * 2 + \
            B * H * S * 4 + 2 * S * 4
        rows.add("flash_fwd", "src/repro_torch/csrc/flash_attention.cu",
                 "src/repro/kernels/flash_attention.py:49",
                 lambda q=q, k=k, v=v: F.flash_fwd(q, k, v, pos, pos, *st),
                 lambda q=q, k=k, v=v: F.flash_fwd_plain(q, k, v, pos, pos,
                                                         *st),
                 lambda q=q, k=k, v=v: sdpa(q, k, v, is_causal=True,
                                            enable_gqa=True),
                 nbytes, 2 * 2 * B * H * pairs * d, BF16_FLOPS,
                 f"{who} B={B} H:KV={H}:{KV} S={S} d={d} bf16 causal "
                 f"(checked in 2g)", slow=True)
        del q, k, v
    return rows


# (name, B, H, KV, Sq, Sk, d, causal, window, cap, share of k_pos set to -1,
#  first q position, leading k slots set to -1)
FLASH_CASES = [
    ("main B=8 H=KV=16 S=1024 d=128 causal", 8, 16, 16, 1024, 1024, 128,
     True, None, None, 0.0, 0, 0),
    ("GQA G=2, window 100, softcap 30 (B=2 H=8 KV=4 S=256 d=64)", 2, 8, 4,
     256, 256, 64, True, 100, 30.0, 0.0, 0, 0),
    ("S=600 (ragged), k_pos -1 slots, row 0 fully masked (d=128)", 1, 4, 2,
     600, 600, 128, True, None, None, 0.1, 0, 0),
    ("S=1 (d=32)", 2, 4, 2, 1, 1, 32, True, None, None, 0.0, 0, 0),
    ("Sq=100 Sk=200 non-causal d=16, k_pos -1 slots", 1, 2, 1, 100, 200, 16,
     False, None, None, 0.2, 0, 0),
    ("q offset: q_pos 512..1023 against 1024 keys (B=2 H=KV=4 d=128)", 2, 4,
     4, 512, 1024, 128, True, None, None, 0.0, 512, 0),
    ("first 100 key slots invalid (B=2 H=KV=4 S=1024 d=128)", 2, 4, 4, 1024,
     1024, 128, True, None, None, 0.0, 0, 100),
    # hubert-xlarge's attention: bidirectional at d=80, and 781 frames
    # leave a last q and k tile of 13 rows
    ("d=80 non-causal, S=781 (12 x 64 + 13), k_pos -1 slots (B=2 H=KV=8)",
     2, 8, 8, 781, 781, 80, False, None, None, 0.1, 0, 0),
] + [
    # the presets' head ratios at phase 12's prefill shape: G = 6, 5, 8, 12
    (f"{who} GQA {H}:{KV} (B=8 S=1024 d=128 causal)", 8, H, KV, 1024, 1024,
     128, True, None, None, 0.0, 0, 0) for H, KV, who in PRESET_HEADS]


def fwd_order_bound(torch, F, q, k, v, q_pos, k_pos, st, lse):
    """The forward's part of ``flash_order_bounds``, per element of o:
    2*(Sk + 2*dp*max_k SA)*2^-24*(p@|v|)/l for the f32 summation order
    (dp: the head dim the tensor cores sum over, d padded to a multiple of
    16 with zeros) and 2^-16*(p@|v|)/l for the split p = hi + lo."""
    B, H, Sq, d = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G, scale = H // KV, st[0]
    dp = -(-d // 16) * 16
    s, _, _ = F._scores(q, k, q_pos, k_pos, *st)
    sa = torch.einsum("bkgqd,bksd->bkgqs", F._grouped(q, KV).abs(),
                      k.float().abs()) * scale
    p = torch.exp(s - lse.reshape(B, KV, G, Sq)[..., None])
    del s
    pv = torch.einsum("bkgqs,bksd->bkgqd", p, v.float().abs())
    m = sa.amax(-1, keepdim=True)
    return ((2 * (Sk + 2 * dp * m) * 2.0 ** -24 + 2.0 ** -16) * pv
            ).reshape(q.shape)


def flash_fwd_bf16p_plain(torch, F, q, k, v, q_pos, k_pos, st):
    """o of the plain forward with p rounded to bf16 before its product
    (the chunked ``_attend``'s rounding of p)."""
    s, _, _ = F._scores(q, k, q_pos, k_pos, *st)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bkgqs,bksd->bkgqd", p.to(torch.bfloat16).float(),
                     v.float()) / p.sum(-1, keepdim=True)
    return o.reshape(q.shape).to(q.dtype)


def flash_order_bounds(torch, F, q, k, v, do, lse, delta, q_pos, k_pos, st):
    """Per-element bounds of o, dq, dk and dv between the bf16 kernels and
    their plain versions on the same inputs (the same o, lse and delta for
    the backward).  First the f32 summation order: a score adds d products
    in another order (|ds| <= d*2^-24*SA, SA = scale*|q|.|k|), which moves
    p by that much relatively; dP likewise (d*2^-24*A, A = |dO|.|v|), so dS
    moves by p*(A + D)*d*2^-24*(1 + SA) with |dS| <= p*(A + D), D =
    sum|dO*o|; then the sums over Sk keys (o, dq) or G*Sq queries (dk, dv)
    add their own length times 2^-24 of the sum of |terms|.  Twice the
    first-order terms:
      o   2*(Sk + 2d*max_k SA)*2^-24 * (p@|v|)/l
      dq  2*2^-24*scale * (p*(A + D)*(d*(1 + SA) + Sk)) @ |k|
      dk  2*2^-24*scale * sum_g (p*(A + D)*(d*(1 + SA) + G*Sq))^T @ |q|
      dv  2*2^-24 * sum_g (p*(G*Sq + d*SA))^T @ |dO|
    Then the split x = hi + lo of the f32 factor of each tensor-core
    product (hi = bf16(x), lo = bf16(x - hi)), which leaves out at most
    2^-16*|x| of each x: P v in the forward, dS k in dq, dS^T q and P^T dO
    in dk/dv:
      o   2^-16 * (p@|v|)/l
      dq  2^-16*scale * |dS| @ |k|
      dk  2^-16*scale * sum_g |dS|^T @ |q|
      dv  2^-16 * sum_g p^T @ |dO|"""
    o_plain, _ = F.flash_fwd_plain(q, k, v, q_pos, k_pos, *st)
    return (fwd_order_bound(torch, F, q, k, v, q_pos, k_pos, st, lse),
            *bwd_order_bounds(torch, F, q, k, v, do, lse, delta, q_pos,
                              k_pos, st, o_plain))


def bwd_order_bounds(torch, F, q, k, v, do, lse, delta, q_pos, k_pos, st,
                     o_plain):
    """dq's, dk's and dv's bounds of ``flash_order_bounds`` (``o_plain``:
    the plain forward's o)."""
    B, H, Sq, d = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G, scale, u, r = H // KV, st[0], 2.0 ** -24, 2.0 ** -16
    gq, gdo = F._grouped(q, KV), F._grouped(do, KV)
    ak = k.float().abs()
    s, _, _ = F._scores(q, k, q_pos, k_pos, *st)
    sa = torch.einsum("bkgqd,bksd->bkgqs", gq.abs(), ak) * scale
    p = torch.exp(s - lse.reshape(B, KV, G, Sq)[..., None])
    del s
    a = torch.einsum("bkgqd,bksd->bkgqs", gdo.abs(), v.float().abs())
    dsum = (gdo.abs() * F._grouped(o_plain, KV).abs()).sum(-1)[..., None]
    w = p * (a + dsum)
    wd = d * (1 + sa)
    del a
    ads = F._probs_and_ds(q, k, v, do, lse, delta, q_pos, k_pos, *st)[1].abs()
    dq_b = scale * torch.einsum("bkgqs,bksd->bkgqd",
                                2 * u * w * (wd + Sk) + r * ads, ak
                                ).reshape(q.shape)
    dk_b = scale * torch.einsum("bkgqs,bkgqd->bksd",
                                2 * u * w * (wd + G * Sq) + r * ads, gq.abs())
    del w, wd, ads
    dv_b = torch.einsum("bkgqs,bkgqd->bksd",
                        p * (2 * u * (G * Sq + d * sa) + r), gdo.abs())
    return dq_b, dk_b, dv_b


def flash_bf16p_plain(torch, F, q, k, v, do, lse, delta, q_pos, k_pos, st):
    """o, dq, dk, dv of the plain versions with p and dS rounded to bf16
    before their products (the chunked ``_attend``'s rounding of p): what
    a kernel computes that rounds them.  The bf16 kernels must stay
    measurably nearer the f32-p plain versions than this."""
    return (flash_fwd_bf16p_plain(torch, F, q, k, v, q_pos, k_pos, st),
            *bwd_bf16p_plain(torch, F, q, k, v, do, lse, delta, q_pos, k_pos,
                             st))


def bwd_bf16p_plain(torch, F, q, k, v, do, lse, delta, q_pos, k_pos, st):
    """dq, dk and dv of ``flash_bf16p_plain``."""
    KV, scale = k.shape[1], st[0]

    def r(t):
        return t.to(torch.bfloat16).float()
    p, ds = F._probs_and_ds(q, k, v, do, lse, delta, q_pos, k_pos, *st)
    dq = torch.einsum("bkgqs,bksd->bkgqd", r(ds), k.float()) * scale
    dk = torch.einsum("bkgqs,bkgqd->bksd", r(ds), F._grouped(q, KV)) * scale
    dv = torch.einsum("bkgqs,bkgqd->bksd", r(p), F._grouped(do, KV))
    return dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


FLASH_TOLERANCES = (
    "f32: rtol/atol 1e-4; bf16: within 1 ulp of the plain result plus the "
    "f32 summation-order bound and what the split x = hi + lo of p and dS "
    "leaves out (flash_order_bounds: 2^-16*(p@|v|)/l for o, "
    "2^-16*scale*|dS|@|k| for dq, 2^-16*scale*|dS|^T@|q| for dk, "
    "2^-16*p^T@|dO| for dv), and where Sk > 1 a Frobenius distance from the "
    "plain result at most 1/4 of that of the plain versions with p and dS "
    "rounded to bf16 (flash_bf16p_plain); lse (f32 in both) rtol/atol 1e-4")


def check_flash_case(torch, F, x32, qp, kp, st, name, errs, suffix=""):
    """The flash forward, dq and dk/dv on the card against their plain
    versions on the same inputs (``x32``: q, k, v, dO in f32 on the card;
    the backward's o, lse and delta from the plain forward), in f32 and
    bf16, to ``FLASH_TOLERANCES``.  Each kernel's largest error lands in
    ``errs[kernel + suffix]``."""
    Sk = x32[1].shape[2]
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, do = (t.to(dt) for t in x32)
        o_k, lse_k = F.flash_fwd(q, k, v, qp, kp, *st)
        o_p, lse_p = F.flash_fwd_plain(q, k, v, qp, kp, *st)
        delta = (do.float() * o_p.float()).sum(-1)
        bwd = (q, k, v, do, lse_p, delta, qp, kp, *st)
        dq_k = F.flash_dq(*bwd)
        dk_k, dv_k = F.flash_dkv(*bwd)
        dq_p = F.flash_dq_plain(*bwd)
        dk_p, dv_p = F.flash_dkv_plain(*bwd)
        torch.cuda.synchronize()
        bf16 = dt == torch.bfloat16
        bounds = (flash_order_bounds(torch, F, q, k, v, do, lse_p, delta,
                                     qp, kp, st) if bf16 else (None,) * 4)
        rounded = (flash_bf16p_plain(torch, F, q, k, v, do, lse_p, delta,
                                     qp, kp, st) if bf16 and Sk > 1
                   else (None,) * 4)
        lse_ok = bool(torch.allclose(lse_k, lse_p, rtol=1e-4, atol=1e-4))
        results = []
        for what, key, out, ref, bound, rnd in (
                ("o", "flash_fwd", o_k, o_p, bounds[0], rounded[0]),
                ("dq", "flash_dq", dq_k, dq_p, bounds[1], rounded[1]),
                ("dk", "flash_dkv", dk_k, dk_p, bounds[2], rounded[2]),
                ("dv", "flash_dkv", dv_k, dv_p, bounds[3], rounded[3])):
            err = (out.float() - ref.float()).abs()
            errs[key + suffix] = max(errs.get(key + suffix, 0.0),
                                     err.max().item())
            if dt == torch.float32:
                ok = bool(torch.allclose(out, ref, rtol=1e-4, atol=1e-4))
                note = ""
            else:
                ulp = bf16_ulp(torch, ref.float())
                ok = bool((err <= ulp + bound).all())
                note = (f", {(err / ulp).max().item():.2f} ulp max, "
                        f"{int((err > ulp).sum())} past 1 ulp, max "
                        f"err/(ulp + bound) "
                        f"{(err / (ulp + bound)).max().item():.3f}")
                if rnd is not None:
                    far = (rnd.float() - ref.float()).norm().item()
                    near = err.norm().item()
                    ok = ok and near <= far / 4
                    note += (f", |kernel - plain|_F {near:.3e} vs "
                             f"|bf16-p plain - plain|_F {far:.3e}")
            results.append(ok)
            print(f"  {name} {dt} {what}: max abs err "
                  f"{err.max().item():.3e}{note}: {ok}")
        print(f"  {name} {dt} lse: max abs err "
              f"{(lse_k - lse_p).abs().max().item():.3e}: {lse_ok}")
        check(all(results) and lse_ok,
              f"flash kernels {name} {dt} disagree with their plain "
              f"versions")
        del q, k, v, do, o_k, o_p, dq_k, dk_k, dv_k, dq_p, dk_p, dv_p
        del bounds, rounded, bwd
    torch.cuda.empty_cache()


def phase_flash_kernels(torch, dev):
    """Phases 2g-2i: the flash forward, dq and dk/dv kernels against their
    plain versions on the card, on the same inputs."""
    from repro_torch.kernels import flash_attention as F
    g = torch.Generator(device="cpu").manual_seed(4321)
    errs = {"flash_fwd": 0.0, "flash_dq": 0.0, "flash_dkv": 0.0}
    print(f"phase 2g-2i: flash forward (o, lse), dq, dk/dv against their "
          f"plain versions on the same inputs (the backward's o, lse and "
          f"delta from the plain forward). {FLASH_TOLERANCES}")
    for (name, B, H, KV, Sq, Sk, d, causal, window, cap, invalid, q_first,
         dead) in FLASH_CASES:
        shapes = ((B, H, Sq, d), (B, KV, Sk, d), (B, KV, Sk, d), (B, H, Sq, d))
        x32 = [torch.randn(s, generator=g) for s in shapes]
        q_pos = torch.arange(q_first, q_first + Sq, dtype=torch.int32)
        k_pos = torch.arange(Sk, dtype=torch.int32)
        k_pos[:dead] = -1
        if invalid:
            k_pos[0] = -1
            k_pos[torch.rand(Sk, generator=g) < invalid] = -1
        check_flash_case(torch, F, [t.to(dev) for t in x32], q_pos.to(dev),
                         k_pos.to(dev), (d ** -0.5, causal, window, cap),
                         name, errs)
    return errs


# The windowed presets' flash forward at 4 prompts of 8064 tokens, phase
# 13's prefill: (name, H, KV, d, window, cap); phase 2m checks and times
# each at that batch
WINDOWED_FLASH = (("gemma2-9b local", 16, 8, 256, 4096, 50.0),
                  ("gemma2-9b global", 16, 8, 256, None, 50.0),
                  ("h2o-danube-3-4b", 32, 8, 120, 4096, None))
WINDOWED_B, WINDOWED_S = 4, 8064
# (name, B, H, KV, Sq, Sk, d, causal, window, cap, share of k_pos set to -1
#  (and the key at the first query's position: that row has no key),
#  shuffled key positions) of phases 2l and 2n: edge cases at head dims
#  120 and 256
FLASH_WIDE_CASES = [
    ("d=120 window 100, k_pos -1 slots, row 0 fully masked (S=600)", 1, 4,
     2, 600, 600, 120, True, 100, None, 0.1, False),
    ("d=256 window 100, softcap 50, shuffled key positions (S=700)", 1, 4,
     2, 700, 700, 256, True, 100, 50.0, 0.0, True),
    ("d=120 window 64, shuffled key positions, -1 slots, row 0 fully "
     "masked (B=2 Sq=300 Sk=900)", 2, 8, 2, 300, 900, 120, True, 64, None,
     0.1, True),
    ("d=256 non-causal, softcap 50, Sq=100 Sk=333 (ragged)", 1, 4, 4, 100,
     333, 256, False, None, 50.0, 0.0, False)]
WIDE_TOLERANCES = ("f32 rtol/atol 1e-4; bf16 1 ulp + fwd_order_bound, "
                   "Frobenius distance <= 1/4 of the bf16-p plain "
                   "version's; lse rtol/atol 1e-4")


def check_by_kv_head(torch, F, q, k, v, qp, kp, st, o_k, lse_k, do=None,
                     others=None):
    """The flash forward's ``o_k``, ``lse_k`` against its plain version on
    the same inputs, kv head by kv head (the plain versions' scores at
    S=8192 take 0.5-1 GiB a kv head), to 2g's tolerances
    (``FLASH_TOLERANCES``; ``fwd_order_bound`` for o).  Given the
    cotangent ``do``, also dq and dk/dv, launched here on the whole
    tensors with the forward's own lse and delta = sum(do * o_k), as
    training feeds them, against their plain versions given the same.
    ``others``: {name: {"o" | "dq" | "dk" | "dv": tensor}} of further bf16
    computations of the same function, whose Frobenius distances from the
    plain results are returned beside the kernels'.  Returns (ok, {what:
    max abs err}, note, {name: {what: distance}} with "kernel" and, in
    bf16, "bf16-p plain")."""
    B, H = q.shape[:2]
    KV = k.shape[1]
    G = H // KV
    bf16 = q.dtype == torch.bfloat16
    outs, whats = (o_k,), ("o",)
    if do is not None:
        delta_k = (do.float() * o_k.float()).sum(-1)
        bwd = (q, k, v, do, lse_k, delta_k, qp, kp, *st)
        outs, whats = (o_k, F.flash_dq(*bwd), *F.flash_dkv(*bwd)), (
            "o", "dq", "dk", "dv")
        torch.cuda.synchronize()
    others = others or {}
    ok, lse_err = True, 0.0
    worst, ratio = dict.fromkeys(whats, 0.0), dict.fromkeys(whats, 0.0)
    past = dict.fromkeys(whats, 0)
    sq = {n: dict.fromkeys(whats, 0.0) for n in ("kernel", "bf16-p plain")}
    sq.update({n: dict.fromkeys(got, 0.0) for n, got in others.items()})
    for b in range(B):
        for kh in range(KV):
            # the heads of o and dq, and of dk and dv
            hs, ks_ = slice(kh * G, (kh + 1) * G), slice(kh, kh + 1)
            parts = dict(o=hs, dq=hs, dk=ks_, dv=ks_)
            qs, ks, vs = q[b:b + 1, hs], k[b:b + 1, ks_], v[b:b + 1, ks_]
            o_p, lse_p = F.flash_fwd_plain(qs, ks, vs, qp, kp, *st)
            lk = lse_k[b:b + 1, hs]
            lse_err = max(lse_err, (lk - lse_p).abs().max().item())
            ok &= bool(torch.allclose(lk, lse_p, rtol=1e-4, atol=1e-4))
            refs = [o_p]
            if bf16:
                bounds = [fwd_order_bound(torch, F, qs, ks, vs, qp, kp, st,
                                          lse_p)]
                rounded = [flash_fwd_bf16p_plain(torch, F, qs, ks, vs, qp, kp,
                                                 st)]
            if do is not None:
                args = (qs, ks, vs, do[b:b + 1, hs], lk, delta_k[b:b + 1, hs],
                        qp, kp)
                refs += [F.flash_dq_plain(*args, *st),
                         *F.flash_dkv_plain(*args, *st)]
                if bf16:
                    bounds += bwd_order_bounds(torch, F, *args, st, o_p)
                    rounded += bwd_bf16p_plain(torch, F, *args, st)
            for i, what in enumerate(whats):
                out, ref = outs[i][b:b + 1, parts[what]], refs[i].float()
                err = (out.float() - ref).abs()
                worst[what] = max(worst[what], err.max().item())
                if not bf16:
                    ok &= bool(torch.allclose(out.float(), ref, rtol=1e-4,
                                              atol=1e-4))
                    continue
                ulp = bf16_ulp(torch, ref)
                ok &= bool((err <= ulp + bounds[i]).all())
                ratio[what] = max(ratio[what],
                                  (err / (ulp + bounds[i])).max().item())
                past[what] += int((err > ulp).sum())
                sq["kernel"][what] += err.norm().item() ** 2
                sq["bf16-p plain"][what] += (rounded[i].float()
                                             - ref).norm().item() ** 2
                for name, got in others.items():
                    if what in got:
                        sq[name][what] += (got[what][b:b + 1, parts[what]]
                                           .float() - ref).norm().item() ** 2
            del refs, o_p
            if bf16:
                del bounds, rounded
    note, dist = f"; lse max abs err {lse_err:.3e}", {}
    if bf16:
        dist = {n: {w: x ** 0.5 for w, x in d.items()} for n, d in sq.items()}
        for what in whats:
            ok &= dist["kernel"][what] <= dist["bf16-p plain"][what] / 4
            note += (f"; {what}: {past[what]} past 1 ulp, max err/(ulp + "
                     f"bound) {ratio[what]:.3f}, " + ", ".join(
                         f"|{n} - plain|_F {d[what]:.3e}"
                         for n, d in dist.items() if what in d))
    return ok, worst, note, dist


def phase_flash_wide(torch, dev, errs):
    """Phase 2l: the flash forward at head dims 120 and 256 against its
    plain version on the card, on the same inputs, at
    edge cases (fully masked rows, -1 slots, shuffled key positions under
    a window, Sq != Sk), in f32 and bf16, to ``WIDE_TOLERANCES``; phase
    2m checks the served shapes."""
    from repro_torch.kernels import flash_attention as F
    g = torch.Generator(device="cpu").manual_seed(2020)
    print(f"phase 2l: flash forward at head dims 120 and 256, edge cases, "
          f"against its plain version (phase 2n holds dq and dk/dv there); "
          f"{WIDE_TOLERANCES}")
    for (name, B, H, KV, Sq, Sk, d, causal, window, cap, invalid,
         shuffle) in FLASH_WIDE_CASES:
        x32 = [torch.randn(s, generator=g) for s in
               ((B, H, Sq, d), (B, KV, Sk, d), (B, KV, Sk, d))]
        q_pos = torch.arange(Sq, dtype=torch.int32)
        k_pos = (torch.randperm(Sk, generator=g).to(torch.int32) if shuffle
                 else torch.arange(Sk, dtype=torch.int32))
        if invalid:
            k_pos[k_pos == 0] = -1          # query 0 keeps no key
            k_pos[torch.rand(Sk, generator=g) < invalid] = -1
        qp, kp = q_pos.to(dev), k_pos.to(dev)
        st = (d ** -0.5, causal, window, cap)
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (t.to(dt).to(dev) for t in x32)
            o_k, lse_k = F.flash_fwd(q, k, v, qp, kp, *st)
            torch.cuda.synchronize()
            ok, worst, note, _ = check_by_kv_head(torch, F, q, k, v, qp, kp,
                                                  st, o_k, lse_k)
            errs["flash_fwd_wide"] = max(errs.get("flash_fwd_wide", 0.0),
                                         worst["o"])
            print(f"  {name} {dt} o: max abs err {worst['o']:.3e}{note}: "
                  f"{ok}")
            check(ok, f"flash forward {name} {dt} disagrees with its plain "
                      f"version")
            del q, k, v, o_k, lse_k
        torch.cuda.empty_cache()


def flex_compile_env(torch):
    """The compile settings every ``flex_attention`` yardstick (and
    ``warm_flex``) shares: the inductor and Triton caches under build/,
    one compile thread, and a recompile limit above the yardsticks' count
    of shapes (past Dynamo's default of 8 the call ran uncompiled, and ran
    out of memory, in phase 2p)."""
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / "build" / sub))
    os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")
    import torch._dynamo
    cfg = torch._dynamo.config
    cfg.recompile_limit = max(cfg.recompile_limit, FLEX_RECOMPILE_LIMIT)


FLEX_RECOMPILE_LIMIT = 64


def flex_yardstick(torch, q, k, v, scale, window, cap):
    """One call of ``torch.nn.attention.flex_attention`` computing the
    kernel's function on the same inputs (positions 0..S-1): the causal
    window as a block mask, the softcap as a score_mod, GQA in the call;
    compiled here, once, outside any timing.  Returns (call, seconds to
    compile) or (None, why not)."""
    flex_compile_env(torch)
    try:
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)
        S = q.shape[2]

        def mask_mod(b, h, qi, ki):
            keep = ki <= qi
            return keep if window is None else keep & (ki > qi - window)

        def softcap(s, b, h, qi, ki):
            return cap * torch.tanh(s / cap)
        block_mask = create_block_mask(mask_mod, None, None, S, S,
                                       device=q.device)
        fn = torch.compile(flex_attention, dynamic=False)

        def call():
            return fn(q, k, v, score_mod=None if cap is None else softcap,
                      block_mask=block_mask, scale=scale, enable_gqa=True)
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        return call, time.perf_counter() - t0
    except Exception as e:                     # noqa: BLE001 - reported
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"


def phase_windowed_flash(torch, dev, smi, errs, shapes=None, phase="2m",
                         key="flash_fwd_wide"):
    """Phase 2m: the flash forward at the windowed presets' prefill of
    ``WINDOWED_B`` prompts of ``WINDOWED_S`` tokens (``shapes``, by
    default ``WINDOWED_FLASH``; phase 2p gives zamba2's, its largest
    error under ``key``),
    checked in f32 and bf16 against its plain version on the same inputs
    (``check_by_kv_head``, ``WIDE_TOLERANCES``) and timed in bf16 as
    phase 5 times it: ``bound_ms`` from the (q, k) pairs the causal
    window keeps (2 products of 2d operations each) or the bytes of q, k,
    v, o and lse, whichever is larger; ``visited_bound_ms`` the bound of
    the kernel's own arithmetic over the tiles it visits (q k^T over dp =
    d padded to 16, P v twice over d, as hi and lo).  The plain version
    runs kv head by kv head, the same function in 32 calls.  Yardstick:
    ``flex_attention`` with the window as a block mask and the softcap as
    a score_mod (``flex_yardstick``), the same function, held to the
    plain version as the kernel's bf16-p plain twin is (Frobenius
    distance at most that of the plain version with p rounded to bf16,
    which flex also rounds p to, times 2); beside it, labelled, SDPA:
    with a boolean mask of the window over k and v expanded to the query
    heads (danube, the same function), or without the cap (gemma2, a
    different function)."""
    from repro_torch.kernels import flash_attention as F
    gd = torch.Generator(device=dev).manual_seed(2021)
    rows = TimingRows(torch, smi)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, S = WINDOWED_B, WINDOWED_S
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    print(f"phase {phase}: flash forward at the windowed prefill (B={B}"
          f" S={S} causal): f32 and bf16 against its plain version "
          f"({WIDE_TOLERANCES}); bf16 timed as in phase 5, beside "
          f"flex_attention")
    for name, H, KV, d, window, cap in shapes or WINDOWED_FLASH:
        G = H // KV
        q = torch.randn((B, H, S, d), generator=gd, device=dev)
        k, v = (torch.randn((B, KV, S, d), generator=gd, device=dev)
                for _ in range(2))
        st = (d ** -0.5, True, window, cap)
        o_k, lse_k = F.flash_fwd(q, k, v, pos, pos, *st)
        ok, worst, note, _ = check_by_kv_head(torch, F, q, k, v, pos, pos,
                                              st, o_k, lse_k)
        print(f"  {name} f32 o: max abs err {worst['o']:.3e}{note}: {ok}")
        check(ok, f"flash forward {name} f32 disagrees with its plain "
                  f"version")
        del o_k, lse_k
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        torch.cuda.empty_cache()
        flex, built = flex_yardstick(torch, q, k, v, st[0], window, cap)
        o_k, lse_k = F.flash_fwd(q, k, v, pos, pos, *st)
        others = {} if flex is None else {"flex_attention": {"o": flex()}}
        ok, worst, note, dist = check_by_kv_head(
            torch, F, q, k, v, pos, pos, st, o_k, lse_k, others=others)
        errs[key] = max(errs.get(key, 0.0), worst["o"])
        print(f"  {name} bf16 o: max abs err {worst['o']:.3e}{note}: {ok}")
        check(ok, f"flash forward {name} bf16 disagrees with its plain "
                  f"version")
        if flex is None:
            print(f"    flex_attention does not run here: {built}")
        check(flex is not None, f"flex_attention, the yardstick at {name}, "
                                f"did not run: {built}")
        if flex is not None:
            print(f"    flex_attention compiled in {built:.1f} s")
            check(dist["flex_attention"]["o"]
                  <= 2 * dist["bf16-p plain"]["o"],
                  f"flex_attention computes another function than the "
                  f"kernel at {name}: {dist}")
        del o_k, lse_k, others
        allowed = F._mask(pos, pos, True, window)
        pairs = int(allowed.sum())
        visited = int(F.visited_k_tiles(pos.cpu(), pos.cpu(), True, window)
                      .sum()) * F.GROUP / F.TILE     # in 64x64 tiles
        dp = -(-d // 16) * 16
        own = visited * B * H * 2 * F.TILE ** 2 * (dp + 2 * d)
        nbytes = (2 * B * H * S * d * 2 + 2 * B * KV * S * d * 2
                  + B * H * S * 4 + 2 * S * 4)
        ke, ve = (t.repeat_interleave(G, dim=1) for t in (k, v))
        mask = None if window is None else allowed

        def sdpa_call(ke=ke, ve=ve, mask=mask):
            return sdpa(q, ke, ve, attn_mask=mask, is_causal=mask is None)
        extra = {"flex_attention_compile_s": built} if flex else {
            "library_note": f"flex_attention does not run: {built}"}
        extra["sdpa_masked_device_ms" if cap is None
              else "sdpa_uncapped_device_ms"] = graph_ms(
            torch, sdpa_call, reps=10, per_graph=3)
        rows.add("flash_fwd", "src/repro_torch/csrc/flash_attention.cu",
                 "src/repro/kernels/flash_attention.py:49",
                 lambda q=q, k=k, v=v, st=st: F.flash_fwd(q, k, v, pos, pos,
                                                          *st),
                 lambda q=q, k=k, v=v, st=st, G=G, KV=KV: [
                     F.flash_fwd_plain(q[b:b + 1, h * G:(h + 1) * G],
                                       k[b:b + 1, h:h + 1],
                                       v[b:b + 1, h:h + 1], pos, pos, *st)
                     for b in range(B) for h in range(KV)],
                 flex, nbytes, 2 * 2 * d * B * H * pairs, BF16_FLOPS,
                 f"{name} B={B} H:KV={H}:{KV} S={S} d={d} bf16 causal "
                 f"window={window} cap={cap}", slow=True,
                 visited_tiles=f"{visited:g} of {(S // F.TILE) ** 2}",
                 visited_bound_ms=1e3 * own / BF16_FLOPS, **extra)
        del q, k, v, ke, ve, allowed, mask, flex
        torch.cuda.empty_cache()
    return rows


# The windowed presets' training shapes, phase 14's batch 2 x seq 8192:
# (name, H, KV, d, window, cap); phase 2n checks dq and dk/dv there, kv
# head by kv head, and times them
WINDOWED_TRAIN = (("h2o-danube-3-4b", 32, 8, 120, 4096, None),
                  ("gemma2-9b local", 16, 8, 256, 4096, 50.0),
                  ("gemma2-9b global", 16, 8, 256, None, 50.0))
WINDOWED_TRAIN_B, WINDOWED_TRAIN_S = 2, 8192


def flex_bwd_yardstick(torch, q, k, v, do, scale, window, cap):
    """``flex_attention``'s backward (``flex_yardstick``'s call: the
    window as a block mask, the softcap as a score_mod, GQA in the call)
    on the same inputs and cotangent: (call, graph, seconds, grads) where
    ``call()`` runs the backward of one saved forward (dq, dk, dv),
    ``graph`` is (callable, stream) of the same on a side stream for the
    device-only time (a backward runs on its forward's stream), the
    seconds those compiles took outside any timing, and ``grads`` one
    call's result; or (None, None, why not, None)."""
    try:
        t0 = time.perf_counter()
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        fwd, _ = flex_yardstick(torch, *leaves, scale, window, cap)
        if fwd is None:
            raise RuntimeError("the forward does not run")
        out = fwd()

        def call():
            return torch.autograd.grad(out, leaves, do, retain_graph=True)
        grads = call()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            side_leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            side_fwd, _ = flex_yardstick(torch, *side_leaves, scale, window,
                                         cap)
            out_side = side_fwd()
        torch.cuda.current_stream().wait_stream(side)

        def call_side():
            return torch.autograd.grad(out_side, side_leaves, do,
                                       retain_graph=True)
        torch.cuda.synchronize()
        return call, (call_side, side), time.perf_counter() - t0, grads
    except Exception as e:                     # noqa: BLE001 - reported
        return None, None, (f"{type(e).__name__}: "
                            f"{str(e).splitlines()[0][:200]}"), None


def phase_flash_wide_bwd(torch, dev, smi, errs):
    """Phase 2n: dq and dk/dv (with the forward) at head dims 120 and 256
    against their plain versions on the card, on the same inputs, in f32
    and bf16, to ``FLASH_TOLERANCES``: the edge cases of 2l
    (``FLASH_WIDE_CASES``: fully masked rows, -1 slots, shuffled key
    positions under a window, a softcap, Sq != Sk), then the windowed
    presets' training shapes (``WINDOWED_TRAIN``, B=2 S=8192, o, lse, dq
    and dk/dv kv head by kv head, the backward fed the forward kernel's lse
    and o as training feeds it: ``check_by_kv_head``).  The largest errors
    land in errs[``flash_*_wide``] (the forward's beside 2l-2m's).  At the
    training shapes dq and dk/dv
    are timed in bf16 as phase 5 times them (``bound_ms`` over the (q, k)
    pairs the causal window keeps: 3 products of 2d operations each for
    dq, 4 for dk/dv; ``visited_bound_ms`` the bound of the kernels' own
    arithmetic over the tiles they visit, the score products twice at d
    = 256, where two warps compute them, the products of dS and p twice,
    as hi and lo), beside ``flex_attention``'s backward
    (``flex_bwd_yardstick``: dq, dk and dv in one call, the same number
    in both rows), held to the plain versions as 2m holds its forward
    (Frobenius distance at most twice that of the plain versions with p
    and dS rounded to bf16).  Returns the timing rows."""
    from repro_torch.kernels import flash_attention as F
    g = torch.Generator(device="cpu").manual_seed(2121)
    rows = TimingRows(torch, smi)
    print(f"phase 2n: flash dq and dk/dv at head dims 120 and 256 against "
          f"their plain versions, the edge cases of 2l and the windowed "
          f"presets' training shapes (there with the forward's o and lse, "
          f"the backward fed the forward kernel's lse and o); "
          f"{FLASH_TOLERANCES}")
    for (name, B, H, KV, Sq, Sk, d, causal, window, cap, invalid,
         shuffle) in FLASH_WIDE_CASES:
        x32 = [torch.randn(s, generator=g) for s in
               ((B, H, Sq, d), (B, KV, Sk, d), (B, KV, Sk, d), (B, H, Sq, d))]
        q_pos = torch.arange(Sq, dtype=torch.int32)
        k_pos = (torch.randperm(Sk, generator=g).to(torch.int32) if shuffle
                 else torch.arange(Sk, dtype=torch.int32))
        if invalid:
            k_pos[k_pos == 0] = -1          # query 0 keeps no key
            k_pos[torch.rand(Sk, generator=g) < invalid] = -1
        check_flash_case(torch, F, [t.to(dev) for t in x32], q_pos.to(dev),
                         k_pos.to(dev), (d ** -0.5, causal, window, cap),
                         name, errs, suffix="_wide")
    gd = torch.Generator(device=dev).manual_seed(2122)
    B, S = WINDOWED_TRAIN_B, WINDOWED_TRAIN_S
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    src, ref = ("src/repro_torch/csrc/flash_attention.cu",
                "src/repro/kernels/flash_attention.py")
    for name, H, KV, d, window, cap in WINDOWED_TRAIN:
        x32 = [torch.randn(s, generator=gd, device=dev) for s in
               ((B, H, S, d), (B, KV, S, d), (B, KV, S, d), (B, H, S, d))]
        st = (d ** -0.5, True, window, cap)
        label = f"{name} B={B} H:KV={H}:{KV} S={S} d={d}"
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, do = (t.to(dt) for t in x32)
            others, flex = {}, (None, None, None, None)
            if dt == torch.bfloat16:
                flex = flex_bwd_yardstick(torch, q, k, v, do, st[0], window,
                                          cap)
                if flex[0] is not None:
                    others = {"flex_attention": dict(zip(("dq", "dk", "dv"),
                                                         flex[3]))}
            o, lse = F.flash_fwd(q, k, v, pos, pos, *st)
            ok, worst, note, dist = check_by_kv_head(
                torch, F, q, k, v, pos, pos, st, o, lse, do=do, others=others)
            for key, whats in (("flash_fwd_wide", ("o",)),
                               ("flash_dq_wide", ("dq",)),
                               ("flash_dkv_wide", ("dk", "dv"))):
                errs[key] = max(errs.get(key, 0.0),
                                *(worst[w] for w in whats))
            print(f"  {label} {dt}: max abs err " + ", ".join(
                f"{w} {x:.3e}" for w, x in worst.items()) + f"{note}: {ok}")
            check(ok, f"flash forward, dq or dk/dv {name} {dt} disagree "
                      f"with their plain versions")
            torch.cuda.empty_cache()
        if flex[0] is None:
            print(f"    flex_attention's backward does not run here: "
                  f"{flex[2]}")
        else:
            print(f"    flex_attention forward + backward compiled in "
                  f"{flex[2]:.1f} s")
            far = dist["flex_attention"]
            check(all(far[w] <= 2 * dist["bf16-p plain"][w] for w in far),
                  f"flex_attention's backward computes another function "
                  f"than the kernels at {name}: {dist}")
        # timings, bf16, on these inputs and the forward's lse and o
        G = H // KV
        delta = (do.float() * o.float()).sum(-1)
        bwd = (q, k, v, do, lse, delta, pos, pos, *st)

        def by_kv_head(fn, bwd=bwd, G=G, KV=KV):
            q, k, v, do, lse, delta = bwd[:6]
            return [fn(q[b:b + 1, h * G:(h + 1) * G], k[b:b + 1, h:h + 1],
                       v[b:b + 1, h:h + 1], do[b:b + 1, h * G:(h + 1) * G],
                       lse[b:b + 1, h * G:(h + 1) * G],
                       delta[b:b + 1, h * G:(h + 1) * G], *bwd[6:])
                    for b in range(B) for h in range(KV)]
        pairs = int(F._mask(pos, pos, True, window).sum())
        need = 2 * B * H * pairs * d                 # one product, needed
        tile = 2 * B * H * F.TILE ** 2               # per head-dim column
        nh, dp = (2 if d > 128 else 1), -(-d // 16) * 16
        k_tiles = int(F.visited_k_tiles(pos.cpu(), pos.cpu(), True, window)
                      .sum()) * F.GROUP / F.TILE     # in 64x64 tiles
        codes = F.visited_q_tiles(pos.cpu(), pos.cpu(), True, window)
        dv_only = int((codes == F.DV_ONLY).sum())
        q_tiles = int((codes > 0).sum())
        t_q, t_kv = B * H * S * d * 2, B * KV * S * d * 2
        t_rows = B * H * S * 4
        extra = ({"library_note": f"flex_attention's backward does not "
                                  f"run: {flex[2]}"} if flex[0] is None
                 else {"flex_attention_compile_s": flex[2],
                       "library_call": "flex_attention's backward (dq, dk "
                                       "and dv in one call)"})
        for kname, line, kern, plain, nbytes, n_prod, tiles, own in (
                ("flash_dq", 81, lambda bwd=bwd: F.flash_dq(*bwd),
                 lambda: by_kv_head(F.flash_dq_plain),
                 3 * t_q + 2 * t_kv + 2 * t_rows + 2 * S * 4, 3, k_tiles,
                 k_tiles * (nh * 2 * dp + 2 * d)),
                ("flash_dkv", 115, lambda bwd=bwd: F.flash_dkv(*bwd),
                 lambda: by_kv_head(F.flash_dkv_plain),
                 2 * t_q + 4 * t_kv + 2 * t_rows + 2 * S * 4, 4, q_tiles,
                 (q_tiles - dv_only) * (nh * 2 * dp + 4 * d)
                 + dv_only * 2 * d)):
            rows.add(kname, src, f"{ref}:{line}", kern, plain, flex[0],
                     nbytes, n_prod * need, BF16_FLOPS,
                     f"{label} bf16 causal window={window} cap={cap}",
                     slow=True, library_graph=flex[1],
                     visited_tiles=f"{tiles:g} of {(S // F.TILE) ** 2}",
                     visited_bound_ms=1e3 * own * tile / BF16_FLOPS, **extra)
        del x32, q, k, v, do, o, lse, delta, bwd, flex, others
        torch.cuda.empty_cache()
    return rows


# Phase 2n's context-parallel shapes: gemma2's training attention as a
# rank of a split row sees it (18g: B=1, H:KV 16:8, d=256, the row's
# Sk=8192 keys): its chunk of Sq queries at positions off..off+Sq-1 —
# (Sq, offsets checked, offsets timed): 2x2 (two ranks a row), 1x4 (four)
CP_KINDS = (("gemma2-9b local", 16, 8, 256, 4096, 50.0),
            ("gemma2-9b global", 16, 8, 256, None, 50.0))
CP_SK = 8192
CP_SHAPES = ((4096, (0, 4096), (0, 4096)), (2048, (0, 2048, 4096, 6144), ()))


def phase_flash_cp(torch, dev, smi, errs):
    """Phase 2n at the context-parallel shapes (``CP_SHAPES``): kernels
    7-9 in bf16 with a chunk's q positions offset against the whole row's
    keys, kv head by kv head against their plain versions to 2n's
    tolerances (``check_by_kv_head``: o, lse, dq, dk, dv, the backward fed
    the forward kernel's lse and o); dk and dv of the keys no query of the
    chunk may see (past its last position; before its first minus the
    window) exactly 0 — the dk/dv blocks of those k tiles visit no q
    tile and store their zeroed accumulators.  The 2x2 shapes timed as
    2n times its training shapes (``bound_ms`` over the pairs the chunk's
    mask keeps), beside ``flex_attention``'s forward and backward at the
    same shape (``flex_cp_yardstick``: one compile for every kind and
    offset), held to the plain versions as 2n holds its backward.
    Returns the timing rows."""
    from repro_torch.kernels import flash_attention as F
    gd = torch.Generator(device=dev).manual_seed(2123)
    rows = TimingRows(torch, smi)
    memo = {}
    kp = torch.arange(CP_SK, dtype=torch.int32, device=dev)
    src, ref = ("src/repro_torch/csrc/flash_attention.cu",
                "src/repro/kernels/flash_attention.py")
    unseen_total = 0
    print(f"phase 2n (context-parallel shapes): kernels 7-9 bf16, one row "
          f"of Sk={CP_SK} keys, a chunk of Sq queries at offset q "
          f"positions, {CP_SHAPES} (Sq, offsets, timed); "
          f"{FLASH_TOLERANCES}; dk, dv of the keys no query sees exactly 0")
    for name, H, KV, d, window, cap in CP_KINDS:
        k, v = (torch.randn((1, KV, CP_SK, d), generator=gd, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        st = (d ** -0.5, True, window, cap)
        for Sq, offsets, timed in CP_SHAPES:
            for off in offsets:
                q, do = (torch.randn((1, H, Sq, d), generator=gd,
                                     device=dev).to(torch.bfloat16)
                         for _ in range(2))
                qp = torch.arange(off, off + Sq, dtype=torch.int32,
                                  device=dev)
                flex = (flex_cp_yardstick(torch, memo, q, k, v, do, off,
                                          st[0], window, cap)
                        if off in timed else None)
                others = ({"flex_attention": flex[3]}
                          if flex and flex[0] else {})
                o, lse = F.flash_fwd(q, k, v, qp, kp, *st)
                ok, worst, note, dist = check_by_kv_head(
                    torch, F, q, k, v, qp, kp, st, o, lse, do=do,
                    others=others)
                delta = (do.float() * o.float()).sum(-1)
                bwd = (q, k, v, do, lse, delta, qp, kp, *st)
                dk, dv = F.flash_dkv(*bwd)
                unseen = ~F._mask(qp, kp, True, window).any(dim=0)
                n_unseen = int(unseen.sum())
                zero = bool((dk[:, :, unseen] == 0).all()
                            and (dv[:, :, unseen] == 0).all())
                for key, whats in (("flash_fwd_cp", ("o",)),
                                   ("flash_dq_cp", ("dq",)),
                                   ("flash_dkv_cp", ("dk", "dv"))):
                    errs[key] = max(errs.get(key, 0.0),
                                    *(worst[w] for w in whats))
                label = (f"{name} B=1 H:KV={H}:{KV} Sq={Sq} at q offset "
                         f"{off} Sk={CP_SK} d={d}")
                print(f"  {label} bf16: max abs err " + ", ".join(
                    f"{w} {x:.3e}" for w, x in worst.items()) + f"{note}; "
                    f"{n_unseen} keys no query sees, their dk and dv "
                    f"exactly 0: {zero}: {ok and zero}")
                check(ok, f"kernels 7-9 at {label} disagree with their "
                          f"plain versions")
                check(zero, f"{label}: dk/dv of the {n_unseen} keys no "
                            f"query sees are not 0")
                unseen_total += n_unseen
                if flex and flex[0] is None:
                    print(f"    flex_attention does not run here: {flex[4]}")
                elif flex:
                    print(f"    flex_attention forward and backward "
                          f"compiled and run in {flex[4]:.1f} s")
                    far = dist["flex_attention"]
                    check(all(far[w] <= 2 * dist["bf16-p plain"][w]
                              for w in far),
                          f"flex_attention computes another function than "
                          f"kernels 7-9 at {label}: {dist}")
                if off in timed:
                    cp_timing_rows(torch, F, rows, bwd, H, KV, d, window,
                                   label, src, ref, flex)
                del q, do, o, lse, delta, bwd, dk, dv, flex, others
                torch.cuda.empty_cache()
        del k, v
    check(unseen_total > 0, "2n: no context-parallel case has a key that "
                            "no query sees")
    return rows


def flex_cp_yardstick(torch, memo, q, k, v, do, off, scale, window, cap):
    """``flex_attention`` at one context-parallel shape of phase 2n: the
    chunk's queries at positions ``off``.. against the row's keys at
    0..Sk-1, the causal window as a mask that reads the offset and the
    window from two tensors (a global layer's window past every key),
    the softcap as a score_mod, GQA in the call.  ``memo`` keeps the
    compiled call and those tensors, so every kind and offset of one cap
    shares the compiles.  Returns (forward call, backward call of one
    saved forward (dq, dk, dv), (the same backward on a side stream,
    the stream) for its device-only time, {"o", "dq", "dk", "dv"},
    seconds this call took with any compile) or (None, None, None, None,
    why not)."""
    t0 = time.perf_counter()
    try:
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)
        if not memo:
            flex_compile_env(torch)
            at0, win = (torch.zeros((), dtype=torch.int32, device=q.device)
                        for _ in range(2))

            def mask_mod(b, h, qi, ki):
                at = qi + at0
                return (ki <= at) & (ki > at - win)

            def softcap(s, b, h, qi, ki):
                return memo["cap"] * torch.tanh(s / memo["cap"])
            memo.update(at0=at0, win=win, mask_mod=mask_mod, cap=cap,
                        softcap=softcap,
                        fn=torch.compile(flex_attention, dynamic=False))
        if memo["cap"] != cap:
            raise ValueError(f"softcap {cap} after {memo['cap']}")
        memo["at0"].fill_(off)
        memo["win"].fill_(1 << 30 if window is None else window)
        bm = create_block_mask(memo["mask_mod"], None, None, q.shape[2],
                               k.shape[2], device=q.device)

        def call(*t):
            return memo["fn"](*t, score_mod=memo["softcap"], block_mask=bm,
                              scale=scale, enable_gqa=True)

        def fwd():
            return call(q, k, v)
        o = fwd()
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = call(*leaves)

        def bwd():
            return torch.autograd.grad(out, leaves, do, retain_graph=True)
        grads = bwd()
        # a backward runs on its forward's stream: a forward on a side
        # stream for the backward's graph
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            side_leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out_side = call(*side_leaves)
        torch.cuda.current_stream().wait_stream(side)

        def bwd_side():
            return torch.autograd.grad(out_side, side_leaves, do,
                                       retain_graph=True)
        torch.cuda.synchronize()
        return (fwd, bwd, (bwd_side, side),
                dict(zip(("o", "dq", "dk", "dv"), (o, *grads))),
                time.perf_counter() - t0)
    except Exception as e:                     # noqa: BLE001 - reported
        return None, None, None, None, (f"{type(e).__name__}: "
                                        f"{str(e).splitlines()[0][:200]}")


def warm_flex(torch):
    """Compile every ``flex_attention`` yardstick of phases 2m, 2n and 2p
    once at its shape and kind of inputs (the yardsticks' own calls, on
    random bf16 inputs; nothing timed or checked), in a process of its
    own that ``main`` starts beside the kernels' build: the phases'
    compiles then find the generated kernels in the inductor and Triton
    caches under build/ (a backward's compile ~38 → ~18 s on the H100
    host), and the yardsticks' timings come after their compiles either
    way."""
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)
    for name, H, KV, d, window, cap in WINDOWED_FLASH + ZAMBA_FLASH_PREFILL:
        B, S = WINDOWED_B, WINDOWED_S
        flex_yardstick(torch, rnd(B, H, S, d), rnd(B, KV, S, d),
                       rnd(B, KV, S, d), d ** -0.5, window, cap)
        torch.cuda.empty_cache()
    for name, H, KV, d, window, cap in WINDOWED_TRAIN:
        B, S = WINDOWED_TRAIN_B, WINDOWED_TRAIN_S
        flex_bwd_yardstick(torch, rnd(B, H, S, d), rnd(B, KV, S, d),
                           rnd(B, KV, S, d), rnd(B, H, S, d), d ** -0.5,
                           window, cap)
        torch.cuda.empty_cache()
    memo = {}
    for name, H, KV, d, window, cap in CP_KINDS:
        k, v = rnd(1, KV, CP_SK, d), rnd(1, KV, CP_SK, d)
        for Sq, _, timed in CP_SHAPES:
            for off in timed:
                flex_cp_yardstick(torch, memo, rnd(1, H, Sq, d), k, v,
                                  rnd(1, H, Sq, d), off, d ** -0.5, window,
                                  cap)
    print(f"warm_flex: {time.perf_counter() - t0:.1f} s", flush=True)


def start_flex_warm():
    """:func:`warm_flex` in a new process on the card, its output in
    build/flex_warm.log; returns (process, its log's path, start)."""
    log = ROOT / "build" / "flex_warm.log"
    log.parent.mkdir(parents=True, exist_ok=True)
    code = ("import sys, torch; sys.path.insert(0, 'src'); import chip_smoke;"
            " chip_smoke.flex_compile_env(torch); chip_smoke.warm_flex(torch)")
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                                stdout=f, stderr=subprocess.STDOUT)
    return proc, log, time.perf_counter()


def finish_flex_warm(warm, timeout: float = 120.0) -> None:
    """Wait for :func:`start_flex_warm`'s process (at most ``timeout``
    seconds, then end it) and print how it went: it only fills caches, so
    its failure fails nothing."""
    proc, log, t0 = warm
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    tail = log.read_text(errors="replace").strip().splitlines()[-1:]
    print(f"  flex_attention caches warmed beside the build: exit "
          f"{proc.returncode} after {time.perf_counter() - t0:.1f} s "
          f"({tail[0][:200] if tail else 'no output'})")


def cp_timing_rows(torch, F, rows, bwd, H, KV, d, window, label, src, ref,
                   flex):
    """Kernels 7-9 timed at one context-parallel shape (``bwd``: the
    backward's arguments), as phases 2m and 2n time theirs: bound_ms from
    the pairs the chunk's mask keeps (2 products of 2d operations for the
    forward, 3 for dq, 4 for dk/dv) or the bytes each reads and writes;
    the plain versions kv head by kv head; beside them ``flex``
    (``flex_cp_yardstick``'s result): its forward, and its backward (dq,
    dk and dv in one call) for both backward kernels."""
    q, k, v, do, lse, delta, qp, kp = bwd[:8]
    st = bwd[8:]
    G, Sq, Sk = H // KV, q.shape[2], k.shape[2]

    def by_kv_head(fn, fwd=False):
        heads = [(slice(h * G, (h + 1) * G), slice(h, h + 1))
                 for h in range(KV)]
        if fwd:
            return [fn(q[:, hs], k[:, ks], v[:, ks], qp, kp, *st)
                    for hs, ks in heads]
        return [fn(q[:, hs], k[:, ks], v[:, ks], do[:, hs], lse[:, hs],
                   delta[:, hs], qp, kp, *st) for hs, ks in heads]
    pairs = int(F._mask(qp, kp, True, window).sum())
    need = 2 * H * pairs * d
    t_q, t_kv, t_rows = H * Sq * d * 2, KV * Sk * d * 2, H * Sq * 4
    pos = (Sq + Sk) * 4
    fwd_lib, bwd_lib, bwd_graph, _, why = flex
    if fwd_lib is None:
        note = {"library_note": f"flex_attention does not run: {why}"}
        libs = [(None, None, note)] * 3
    else:
        seen = {"flex_attention_s": why}
        back = (bwd_lib, bwd_graph, dict(seen, library_call=(
            "flex_attention's backward (dq, dk and dv in one call)")))
        libs = [(fwd_lib, None, dict(seen, library_call="flex_attention")),
                back, back]
    kernels = (
            ("flash_fwd", 49, lambda: F.flash_fwd(q, k, v, qp, kp, *st),
             lambda: by_kv_head(F.flash_fwd_plain, fwd=True),
             2 * t_q + 2 * t_kv + t_rows + pos, 2),
            ("flash_dq", 81, lambda: F.flash_dq(*bwd),
             lambda: by_kv_head(F.flash_dq_plain),
             3 * t_q + 2 * t_kv + 2 * t_rows + pos, 3),
            ("flash_dkv", 115, lambda: F.flash_dkv(*bwd),
             lambda: by_kv_head(F.flash_dkv_plain),
             2 * t_q + 4 * t_kv + 2 * t_rows + pos, 4))
    for (kname, line, kern, plain, nbytes, n_prod), (lib, graph, extra) in (
            zip(kernels, libs)):
        rows.add(kname, src, f"{ref}:{line}", kern, plain, lib, nbytes,
                 n_prod * need, BF16_FLOPS,
                 f"{label} bf16 causal window={window} cap={st[3]}",
                 slow=True, library_graph=graph, **extra)


def phase_flash_frontends(torch, dev, errs, shapes=None, phase="2o",
                          suffix="_frontends"):
    """Phase 2o: kernels 7-9 at the frontend presets' training shapes
    (``shapes``, by default ``FRONTEND_FLASH``: hubert-xlarge non-causal at
    d=80 with a last tile of 13 rows, internvl2-2b causal GQA 16:8 at
    S=4096; phase 2p gives zamba2's) against their plain
    versions on the card, on the same inputs, in f32 and bf16, to 2g's
    tolerances (``FLASH_TOLERANCES``), kv head by kv head
    (``check_by_kv_head``: o and lse, then dq and dk/dv fed the forward
    kernel's lse and o as training feeds them; the bf16 bound sums over
    dp = 80 at hubert's head dim).  The largest errors land in
    errs[``flash_*`` + ``suffix``]; phase 5 times the kernels there."""
    from repro_torch.kernels import flash_attention as F
    gd = torch.Generator(device=dev).manual_seed(2222)
    print(f"phase {phase}: flash forward, dq and dk/dv at the training "
          f"shapes {[t[0] for t in shapes or FRONTEND_FLASH]}, kv head by kv "
          f"head (the backward fed the forward kernel's lse and o); "
          f"{FLASH_TOLERANCES}")
    for name, B, H, KV, S, d, causal in shapes or FRONTEND_FLASH:
        pos = torch.arange(S, dtype=torch.int32, device=dev)
        st = (d ** -0.5, causal, None, None)
        x32 = [torch.randn(s, generator=gd, device=dev) for s in
               ((B, H, S, d), (B, KV, S, d), (B, KV, S, d), (B, H, S, d))]
        label = (f"{name} B={B} H:KV={H}:{KV} S={S} d={d} "
                 f"{'causal' if causal else 'non-causal'}")
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, do = (t.to(dt) for t in x32)
            o, lse = F.flash_fwd(q, k, v, pos, pos, *st)
            ok, worst, note, _ = check_by_kv_head(
                torch, F, q, k, v, pos, pos, st, o, lse, do=do)
            for key, whats in (("flash_fwd", ("o",)), ("flash_dq", ("dq",)),
                               ("flash_dkv", ("dk", "dv"))):
                key += suffix
                errs[key] = max(errs.get(key, 0.0),
                                *(worst[w] for w in whats))
            print(f"  {label} {dt}: max abs err " + ", ".join(
                f"{w} {x:.3e}" for w, x in worst.items()) + f"{note}: {ok}")
            check(ok, f"flash forward, dq or dk/dv {label} {dt} disagree "
                      f"with their plain versions")
            del q, k, v, do, o, lse
            torch.cuda.empty_cache()
        del x32


# ---------------------------------------------------------------------------
# phase 3: serving at full width
# ---------------------------------------------------------------------------

COUNTERS = (("topk_gate", "topk_gate", "launches"),
            ("gather_rows", "layout_transform", "launches"),
            ("grouped_matmul", "grouped_ffn", "launches"),
            ("grouped_matmul_t", "grouped_ffn", "dlhs_launches"),
            ("grouped_drhs", "grouped_ffn", "drhs_launches"),
            ("scatter_add_rows", "layout_transform", "scatter_launches"),
            ("flash_fwd", "flash_attention", "fwd_launches"),
            ("flash_dq", "flash_attention", "dq_launches"),
            ("flash_dkv", "flash_attention", "dkv_launches"))
# the kernels a forward launches (the grouped combine is the scatter-add)
SERVE_KERNELS = ("topk_gate", "gather_rows", "grouped_matmul",
                 "scatter_add_rows", "flash_fwd")


def _kernel_module(name):
    import importlib
    return importlib.import_module(f"repro_torch.kernels.{name}")


def reset_counts():
    for _, mod, attr in COUNTERS:
        setattr(_kernel_module(mod), attr, 0)


def read_counts(names=None):
    """Launch counters of the kernels ``names`` (default: the four the
    serving path runs)."""
    names = names or SERVE_KERNELS
    return {k: getattr(_kernel_module(mod), attr)
            for k, mod, attr in COUNTERS if k in names}


def decode_captures() -> int:
    """Decode steps captured (built, where no graph) since the step cache
    was last cleared: each capture runs one eager warm-up step first."""
    from repro_torch.serving import engine
    return sum(n for k, n in engine.trace_counts.items() if k[0] == "decode")


def state_leaves(caches) -> list:
    """The cache tensors a decode step rewrites whole: the positions and
    the recurrent states (``s``, ``x_last``, ``conv``); not the attention
    keys and values, of which a step writes one slot that a rerun from the
    same position rewrites."""
    out = []
    for c in caches:
        for name, t in c.items():
            if isinstance(t, dict):
                out += state_leaves([t])
            elif name not in ("k", "v"):
                out.append(t)
    return out


# decode steps of the graph-against-eager comparison: checked one by one,
# then timed (and profiled) per form
GRAPH_CHECK_STEPS, GRAPH_TIMED_STEPS = 4, 8


def decode_graph_vs_eager(torch, smi, model, cfg, B: int, S: int,
                          label: str, *, seed: int = 5,
                          timed: int = GRAPH_TIMED_STEPS) -> dict:
    """The decode step captured in a CUDA graph (``engine.build_decode``)
    against the eager step (``engine.make_serve_step``) on the same
    prefilled caches: B prompts of S tokens prefilled into the graph
    step's caches, then ``GRAPH_CHECK_STEPS`` steps each run by the graph,
    the positions and recurrent states put back (``state_leaves``), and
    run again eagerly from the same state (the eager step rewrites the
    slot the graph wrote, with its own k and v): the logits must be
    bitwise equal, since both run the same kernels
    in the same order (else within one bf16 ulp of max|logit| with equal
    greedy tokens, reported as not bitwise).  Then ``timed``
    (``GRAPH_TIMED_STEPS``) greedy steps of each form timed (host clock to
    a synchronise) and as many profiled: device ms, idle share, kernel
    launches and graph launches per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import engine
    n, m = GRAPH_CHECK_STEPS, timed
    cache_len = S + n + 4 * m + 1
    prompt = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(seed))
    prefill = engine.build_prefill(model, cfg, cache_len=cache_len, batch=B)
    out = dict(bitwise=True, max_abs_diff=0.0, greedy_equal=True)
    with torch.inference_mode(), engine.holding_decode(
            model, cfg, batch=B, cache_len=cache_len) as step:
        check(step.graph is not None,
              f"{label}: the decode step is not a graph")
        eager = engine.make_serve_step(step.cfg)
        step.reset()
        logits, _ = prefill(prompt, step.caches)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        for _ in range(n):
            saved = [t.clone() for t in state_leaves(step.caches)]
            lg_g = step(tok).clone()
            for t, was in zip(state_leaves(step.caches), saved):
                t.copy_(was)
            lg_e, _ = eager(model, tok, step.caches)
            if not torch.equal(lg_g, lg_e):
                out["bitwise"] = False
                diff = (lg_g.float() - lg_e.float()).abs().max().item()
                out["max_abs_diff"] = max(out["max_abs_diff"], diff)
                ulp = bf16_ulp(torch, lg_e.float().abs().max()).item()
                out["greedy_equal"] &= torch.equal(lg_g.argmax(-1),
                                                   lg_e.argmax(-1))
                check(diff <= ulp and out["greedy_equal"],
                      f"{label}: graph and eager decode logits differ by "
                      f"{diff:.4e} (one bf16 ulp of the max: {ulp:.4e})")
            tok = lg_e[:, -1].argmax(-1, keepdim=True)

        def run(fn):
            nonlocal tok
            for _ in range(m):
                tok = fn(tok)[:, -1].argmax(-1, keepdim=True)

        forms = (("graph", lambda t: step(t)),
                 ("eager", lambda t: eager(model, t, step.caches)[0]))
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        for name, fn in forms:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(fn)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0) / m
            with profile(activities=acts) as prof:
                run(fn)
                torch.cuda.synchronize()
            dev_ms = _device_ms(prof, DeviceType) / m
            host = [e for e in _averages(prof)
                    if e.device_type == DeviceType.CPU]
            out[name] = dict(
                wall_ms=wall, device_ms=dev_ms, idle=1 - dev_ms / wall,
                kernel_launches=sum(e.count for e in host
                                    if "LaunchKernel" in e.key) / m,
                graph_launches=sum(e.count for e in host
                                   if e.key == "cudaGraphLaunch") / m)
    g, e = out["graph"], out["eager"]
    print(f"  [{smi}] {label} decode step, batch {B} after {S} tokens: "
          f"graph {g['wall_ms']:.3f} ms wall / {g['device_ms']:.3f} device "
          f"(idle {g['idle']:.3f}; a step: graph launches "
          f"{g['graph_launches']:g}, kernel launches "
          f"{g['kernel_launches']:g}, the argmax between steps included), "
          f"eager {e['wall_ms']:.3f} / "
          f"{e['device_ms']:.3f} (idle {e['idle']:.3f}; "
          f"{e['kernel_launches']:g} kernel launches); logits of {n} steps "
          f"bitwise equal={out['bitwise']} (max|diff| "
          f"{out['max_abs_diff']:.4e})")
    check(g["graph_launches"] == 1,
          f"{label}: {g['graph_launches']} graph launches a step")
    return out


def phase_serve(torch, smi):
    """Serving at batch 8 and 32 new tokens: prompt 512 in both dispatch
    modes (the chunk-free ``_attend`` path, no flash launch) and prompt
    1024 grouped (the flash forward, 2 launches in the prefill, none in a
    decode step).  Each ``serve.run`` draws its model, so its ``generate``
    captures the decode step once: one eager warm-up step, which really
    launches the kernels, then the graph's replays, each of which adds the
    launches its capture recorded.  Then, per cell, the graph step
    against the eager one on one model (``decode_graph_vs_eager``)."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models.transformer import Transformer
    from repro_torch.serving import engine
    cfg = configs.get_config(ARCH)
    L = cfg.num_layers
    # 1 prefill + gen-1 decode steps + the capture's warm-up step
    forwards = SERVE["gen"] + 1
    print("phase 3: warm-up (grouped, 2 new tokens)")
    serve.run(ARCH, smoke=False, batch=SERVE["batch"],
              prompt_len=SERVE["prompt_len"], gen=2, dispatch="grouped",
              device="cuda")
    totals = dict.fromkeys(SERVE_KERNELS, 0)
    results = {}
    for mode, prompt_len in SERVE_CELLS:
        expect = {"topk_gate": L * forwards,
                  "gather_rows": (1 if mode == "grouped" else 2) * L * forwards,
                  "grouped_matmul": (2 * L * forwards if mode == "grouped"
                                     else 0),
                  "scatter_add_rows": (L * forwards if mode == "grouped"
                                       else 0),
                  "flash_fwd": L if prompt_len > Q_CHUNK else 0}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        stats = {}
        reset_counts()
        out = serve.run(ARCH, smoke=False, dispatch=mode, device="cuda",
                        stats=stats, batch=SERVE["batch"],
                        prompt_len=prompt_len, gen=SERVE["gen"])
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        for k, v in counts.items():
            totals[k] += v
        B, gen = SERVE["batch"], SERVE["gen"]
        decode_ms = 1e3 * stats["decode_s"] / stats["decode_steps"]
        tok_s = B * gen / (stats["prefill_s"] + stats["decode_s"])
        cell = f"{mode} prompt {prompt_len}"
        print(f"  [{smi}] {cell}: prefill {1e3 * stats['prefill_s']:.3f} ms, "
              f"decode {decode_ms:.3f} ms/step (the graph), {tok_s:.1f} "
              f"tokens/s (batch {B} x {gen} new), peak memory "
              f"{peak / 2 ** 30:.3f} GiB, launches {counts}")
        check(counts == expect,
              f"{cell}: launch counts {counts} != expected {expect}")
        check(tuple(out.shape) == (B, prompt_len + gen),
              f"{cell}: output shape {tuple(out.shape)}")
        new = out[:, prompt_len:]
        check(bool(((new >= 0) & (new < cfg.vocab_size)).all()),
              f"{cell}: generated ids out of range")
        check(stats["logits_finite"], f"{cell}: non-finite logits")
        results[cell] = dict(prefill_ms=1e3 * stats["prefill_s"],
                             decode_ms_per_step=decode_ms, tokens_per_s=tok_s,
                             peak_gib=peak / 2 ** 30)
    model = Transformer(cfg, device="cuda", seed=0)
    for mode, prompt_len in SERVE_CELLS:
        cell = f"{mode} prompt {prompt_len}"
        results[cell]["graph_vs_eager"] = decode_graph_vs_eager(
            torch, smi, model, engine.serve_config(cfg, dispatch=mode),
            SERVE["batch"], prompt_len, f"{ARCH} {cell}")
    results["decode_vs_analysis"] = decode_vs_analysis(
        torch, smi, model, engine.serve_config(cfg, dispatch="grouped"))
    return totals, results


# ---------------------------------------------------------------------------
# phase 4: card against CPU at full width, f32
# ---------------------------------------------------------------------------

def phase_card_vs_cpu(torch):
    from repro_torch import configs
    from repro_torch.models.transformer import Transformer, init_params
    from repro_torch.serving.engine import serve_config
    cfg = configs.get_config(ARCH).replace(dtype="float32")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator().manual_seed(7), device="cpu")
    cpu = Transformer(cfg, device="cpu", params=params)
    gpu = Transformer(cfg, device="cuda", params=params)
    print(f"phase 4: f32 weights on both devices in "
          f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator().manual_seed(8)
    for S, mode in ((64, "grouped"), (64, "sort"), (600, "grouped"),
                    (600, "sort")):
        prompt = torch.randint(0, cfg.vocab_size, (1, S), generator=gen)
        c = serve_config(cfg, dispatch=mode)
        with torch.inference_mode():
            logits = []
            for model in (cpu, gpu):
                reset_counts()
                h, _, _ = model.forward(prompt.to(model.device), cfg=c)
                logits.append(model.logits_from_hidden(h[:, -1:]).cpu())
        # the card's forward went through the kernels (2 layers), and
        # through the flash forward past q_chunk
        want = {"topk_gate": 2, "gather_rows": 2 if mode == "grouped" else 4,
                "grouped_matmul": 4 if mode == "grouped" else 0,
                "scatter_add_rows": 2 if mode == "grouped" else 0,
                "flash_fwd": 2 if S > Q_CHUNK else 0}
        check(read_counts() == want,
              f"{mode}: card forward launches {read_counts()} != {want}")
        diff = (logits[0] - logits[1]).abs().max().item()
        scale = logits[0].abs().max().item()
        print(f"  {mode} prompt {S}: max |card - cpu| = {diff:.3e}, tol "
              f"1e-3 * max|logit| = {1e-3 * scale:.3e}")
        check(math.isfinite(diff) and diff <= 1e-3 * scale,
              f"{mode} prompt {S}: card and CPU logits disagree")
    del cpu, gpu, params


# ---------------------------------------------------------------------------
# phase 5: per-kernel timings
# ---------------------------------------------------------------------------

def phase_timings(torch, dev, smi):
    from repro_torch.kernels import grouped_ffn as G
    from repro_torch.kernels import layout_transform as L
    from repro_torch.kernels import topk_gate as K
    g = torch.Generator(device="cpu").manual_seed(99)
    T, E, d = SERVE["batch"] * SERVE["prompt_len"], 16, 2048
    rows = TimingRows(torch, smi)
    row = rows.add

    print("phase 5: timings (CUDA events; median of 25 batches of 10 calls "
          "after warm-up; device-only: CUDA-graph replays, for the kernel "
          "and for the library call, 'not measured' where a call cannot be "
          "captured; the byte-bound rows also L2-cold: a 128 MB read "
          "before each call)")
    # gate at prefill: logits (T, E) f32, k=1
    for S in (T, SERVE["batch"]):
        x = torch.randn(S, E, generator=g).to(dev)
        nbytes = S * E * 4 + S * (4 + 4 + 4 + 4)
        row("topk_gate", "src/repro_torch/csrc/topk_gate.cu",
            "src/repro/kernels/topk_gate.py:24",
            lambda: K.fused_topk_gate(x, 1), lambda: K.topk_gate_plain(x, 1),
            lambda: torch.topk(x, 1, dim=-1), nbytes, 4 * S * E, F32_FLOPS,
            f"S={S} E={E} k=1")
    # the launch floor beside the gate: an empty kernel's device time
    floor_ms = launch_floor_ms(torch)
    for r in rows:
        r["launch_floor_device_ms"] = floor_ms
    print(f"  [{smi}] launch floor (an empty kernel, device-only): "
          f"{'not measured' if floor_ms is None else f'{floor_ms:.4f}'} ms")
    # gather: the grouped dispatch's maps at k=1 (a permutation) over
    # (T, d), in the fan-out form the dispatch runs and in the gather form;
    # L2-cold beside warm (the dispatch's input was written one kernel
    # earlier, but the 16 MB source fits the L2 only in a replay loop)
    for M in (T, SERVE["batch"]):
        src = torch.randn(M, d, generator=g).to(torch.bfloat16).to(dev)
        idx, dest = (t.to(dev) for t in routed_maps(torch, g, M, E, 1,
                                                     "grouped"))
        for form, dst in (("fan-out", dest), ("gather", None)):
            row("gather_rows", "src/repro_torch/csrc/layout_transform.cu",
                "src/repro/kernels/layout_transform.py:42",
                lambda src=src, idx=idx, dst=dst: L.gather_rows(src, idx,
                                                                dst),
                lambda src=src, idx=idx: L.gather_rows_plain(src, idx),
                lambda src=src, idx=idx: torch.index_select(src, 0, idx),
                M * d * 2 + M * 4 + M * d * 2
                + (M * 4 if dst is not None else 0), 0, BF16_FLOPS,
                f"M=N={M} d={d} bf16, {form} form", cold=True, form=form)
    # kernel 10, the seed's row-per-step gather, at kernel 2's main shape
    # beside its gather form (the same index map): its own entry point is
    # its path (bench_layout's baseline), so its launches are counted over
    # this timing run
    src = torch.randn(T, d, generator=g).to(torch.bfloat16).to(dev)
    idx = routed_maps(torch, g, T, E, 1, "grouped")[0].to(dev)
    blocked = next(r for r in rows if r["name"] == "gather_rows"
                   and r["form"] == "gather")
    L.rowstep_launches = 0
    row("gather_rows_rowstep", "src/repro_torch/csrc/layout_transform.cu",
        "src/repro/kernels/layout_transform.py:150",
        lambda: L.gather_rows_rowstep(src, idx),
        lambda: L.gather_rows_rowstep_plain(src, idx),
        lambda: torch.index_select(src, 0, idx),
        T * d * 2 + T * 4 + T * d * 2, 0, BF16_FLOPS, f"M=N={T} d={d} bf16",
        cold=True)
    rows[-1]["launches"] = L.rowstep_launches
    rows[-1]["rowstep_over_blocked"] = rows[-1]["ms"] / blocked["ms"]
    rows[-1]["rowstep_over_blocked_device"] = (
        None if None in (rows[-1]["device_ms"], blocked["device_ms"])
        else rows[-1]["device_ms"] / blocked["device_ms"])
    print(f"    rowstep / blocked gather (bench_layout's speedup_vs_rowstep "
          f"on the card): {rows[-1]['rowstep_over_blocked']:.3f} eager, "
          f"{rows[-1]['rowstep_over_blocked_device']} device-only; "
          f"{L.rowstep_launches} launches of the rowstep kernel")
    # grouped matmul: routed segments of a uniform random assignment
    for M in (T, SERVE["batch"]):
        offs = uniform_offsets(torch, g, M, E)
        counts = offs[1:] - offs[:-1]
        lhs = torch.randn(M, d, generator=g).to(torch.bfloat16).to(dev)
        rhs = (torch.randn(E, d, d, generator=g) * d ** -0.5).to(
            torch.bfloat16).to(dev)
        o = offs.to(dev)
        active = int((counts > 0).sum())
        nbytes = M * d * 2 + active * d * d * 2 + (E + 1) * 4 + M * d * 2
        flops = 2 * M * d * d

        def lib(lhs=lhs, rhs=rhs, o=o):
            return torch._grouped_mm(lhs, rhs, offs=o[1:])
        row("grouped_matmul", "src/repro_torch/csrc/grouped_ffn.cu",
            "src/repro/kernels/grouped_ffn.py:60",
            lambda: G.grouped_matmul(lhs, rhs, o),
            lambda: G.grouped_matmul_plain(lhs, rhs, o),
            lib if hasattr(torch, "_grouped_mm") else None, nbytes, flops,
            BF16_FLOPS, f"M={M} K=N={d} E={E} ({active} experts active)")
        del rhs

    # the training backward at the phase-7 shapes (T = 8 x 512 tokens, k=1);
    # segments of a multiple of 8 rows: torch._grouped_mm's grouped-K form
    # (the drhs yardstick) needs each group's rows to span 16 bytes
    M = T
    offs = uniform_offsets(torch, g, M, E, unit=8)
    counts = offs[1:] - offs[:-1]
    o = offs.to(dev)
    active = int((counts > 0).sum())
    gd = torch.randn(M, d, generator=g).to(torch.bfloat16).to(dev)
    lhs = torch.randn(M, d, generator=g).to(torch.bfloat16).to(dev)
    rhs = (torch.randn(E, d, d, generator=g) * d ** -0.5).to(
        torch.bfloat16).to(dev)
    flops = 2 * M * d * d
    gmm = hasattr(torch, "_grouped_mm")
    row("grouped_matmul_t", "src/repro_torch/csrc/grouped_ffn.cu",
        "src/repro/kernels/grouped_ffn.py:206",
        lambda: G.grouped_matmul_t(gd, rhs, o),
        lambda: G.grouped_matmul_t_plain(gd, rhs, o),
        (lambda: torch._grouped_mm(gd, rhs.transpose(-2, -1), offs=o[1:]))
        if gmm else None,
        M * d * 2 + active * d * d * 2 + (E + 1) * 4 + M * d * 2, flops,
        BF16_FLOPS, f"dlhs M={M} K=N={d} E={E} ({active} experts active)")
    del rhs
    # drhs at seq 512's M = 4096 and seq 1024's M = 8192: uniform segments
    # (the first row, bf16 out, is the train step's call), geometrically
    # skewed ones (expert 9 empty) and, at 4096, one expert holding every
    # row; each in both output dtypes.  Bytes: lhs and g read once, the
    # (E, K, N) gradient written once.
    drhs_rows = {}
    for Md, kind in ((T, "uniform"), (T, "skewed"), (T, "one expert"),
                     (2 * T, "uniform"), (2 * T, "skewed")):
        if kind == "uniform":
            od = offs if Md == T else torch.cat(
                [offs[:1], 2 * offs[1:]])
        elif kind == "skewed":
            od = skewed_offsets(torch, Md // 8, E, 0, 9) * 8
        else:
            od = torch.tensor([0] * 4 + [Md] * 13, dtype=torch.int32)
        od_dev = od.to(dev)
        sizes = (od[1:] - od[:-1]).tolist()
        xl = torch.randn(Md, d, generator=g).to(torch.bfloat16).to(dev)
        xg = torch.randn(Md, d, generator=g).to(torch.bfloat16).to(dev)
        xl_t = xl.t().contiguous()     # the library call's (K, M) layout
        for out_dt in (torch.bfloat16, torch.float32):
            lib = None
            if gmm:
                def lib(xl_t=xl_t, xg=xg, od_dev=od_dev, out_dt=out_dt):
                    if out_dt == torch.bfloat16:
                        return torch._grouped_mm(xl_t, xg, offs=od_dev[1:])
                    return torch._grouped_mm(xl_t, xg, offs=od_dev[1:],
                                             out_dtype=out_dt)
                try:
                    lib()
                except (RuntimeError, TypeError) as e:
                    print(f"    torch._grouped_mm refuses out_dtype="
                          f"{out_dt}: {str(e).splitlines()[0]}")
                    lib = None
            size = 2 if out_dt == torch.bfloat16 else 4
            row("grouped_drhs", "src/repro_torch/csrc/grouped_ffn.cu",
                "src/repro/kernels/grouped_ffn.py:120",
                lambda xl=xl, xg=xg, od_dev=od_dev, out_dt=out_dt:
                G.grouped_drhs(xl, xg, od_dev, out_dtype=out_dt),
                lambda xl=xl, xg=xg, od_dev=od_dev, out_dt=out_dt:
                G.grouped_drhs_plain(xl, xg, od_dev).to(out_dt),
                lib, 2 * Md * d * 2 + (E + 1) * 4 + E * d * d * size,
                2 * Md * d * d, BF16_FLOPS,
                f"drhs M={Md} K=N={d} E={E} {kind} (rows per expert "
                f"{min(sizes)}..{max(sizes)}) -> "
                f"{str(out_dt).removeprefix('torch.')}")
            drhs_rows[(Md, kind, out_dt)] = rows[-1]
        del xl, xg, xl_t
    for (Md, kind, out_dt), r in drhs_rows.items():
        base = drhs_rows[(Md, "uniform", out_dt)]
        if kind != "uniform" and None not in (r["device_ms"],
                                              base["device_ms"]):
            r["over_uniform_device"] = r["device_ms"] / base["device_ms"]
            print(f"    drhs M={Md} {kind} {out_dt} / uniform, device-only: "
                  f"{r['over_uniform_device']:.3f} (rows are split over "
                  f"blocks only past 2)")
    zeros = torch.zeros(M, d, dtype=torch.bfloat16, device=dev)
    for src_rows, n, what in ((M, M, "grouped dispatch VJP"),
                              (5120, M, "sort dispatch VJP")):
        gs = torch.randn(src_rows, d, generator=g).to(torch.bfloat16).to(dev)
        idx = torch.full((src_rows,), -1, dtype=torch.int32)
        idx[torch.randperm(src_rows, generator=g)[:n]] = torch.randperm(
            n, generator=g).to(torch.int32)
        idx = idx.to(dev)
        row("scatter_add_rows", "src/repro_torch/csrc/layout_transform.cu",
            "src/repro/kernels/layout_transform.py:104",
            lambda gs=gs, idx=idx, n=n: L.scatter_add_rows(gs, idx, n),
            lambda gs=gs, idx=idx, n=n: L.scatter_add_rows_plain(gs, idx, n),
            # index_add_ cannot skip -1 rows: a yardstick only for the
            # permutation
            (lambda gs=gs, idx=idx: torch.index_add(zeros, 0, idx, gs))
            if src_rows == n else None,
            src_rows * d * 2 + src_rows * 4 + n * d * 2, 0, BF16_FLOPS,
            f"{what} {src_rows} -> {n} rows, d={d} bf16", cold=True)
    del zeros, gs
    flash_timings(torch, dev, g, row)
    return rows


def flash_timings(torch, dev, g, row, B=8, H=16, KV=16, S=1024, d=128,
                  causal=True, name=None):
    """Kernels 7-9 in bf16 at B, H:KV, S, d and ``causal``, by default the
    seq-1024 training shapes (B=8, H=KV=16, S=1024, d=128, causal).
    ``bound_ms`` counts the work the function needs: the (q, k) pairs its
    mask keeps on this run's positions (S(S+1)/2 per (b, h) causal, S^2
    not), 2*d operations per pair and product; the forward does 2
    products, dq 3, dk/dv 4.  ``visited_bound_ms`` is the bound of each
    kernel's own arithmetic over the 64x64 tiles it visits, all on the
    bf16 tensor cores (the products of p and dS twice, as hi and lo): the
    forward q k^T once and P v twice, dq q k^T, dO v^T once and dS k
    twice, over the tiles of ``visited_k_tiles`` (its 16-row warps);
    dk/dv K Q^T and V dO^T once and P^T dO, dS^T q twice each over the
    tiles of ``visited_q_tiles`` (P^T dO only, twice, on a DV_ONLY tile).
    Yardsticks: SDPA's forward (``is_causal``, ``enable_gqa`` where KV <
    H: the same function), and one backward of SDPA for dq and dk/dv
    together (the same number in both rows), its device-only time
    captured on the stream its forward ran on.  With ``name`` (a preset's
    shape) the forward's row also gives SDPA's forward + backward in one
    call and the kernels' (``flash_attention``'s forward and backward:
    the forward, delta, dq and dk/dv), eager and device-only (fresh
    leaves in each call: a graph kept alive from a forward on another
    stream made the capture fail at hubert's shape, and the calls after
    that failure ran slower, so both eager times come first)."""
    from repro_torch.kernels import flash_attention as F
    G = H // KV
    q, do = (torch.randn(B, H, S, d, generator=g).to(torch.bfloat16).to(dev)
             for _ in range(2))
    k, v = (torch.randn(B, KV, S, d, generator=g).to(torch.bfloat16).to(dev)
            for _ in range(2))
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    st = (d ** -0.5, causal, None, None)
    o, lse = F.flash_fwd(q, k, v, pos, pos, *st)
    delta = (do.float() * o.float()).sum(-1)
    bwd = (q, k, v, do, lse, delta, pos, pos, *st)
    kw = dict(is_causal=causal, enable_gqa=G > 1)

    def sdpa(*x):
        return torch.nn.functional.scaled_dot_product_attention(*x, **kw)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = sdpa(*leaves)

    def sdpa_bwd():
        return torch.autograd.grad(out, leaves, do, retain_graph=True)
    # for the graph: leaves and a forward of their own on the capture
    # stream (autograd runs a backward on its forward's stream, and a
    # leaf's gradient accumulator on the stream of the leaf's first use)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        side_leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out_side = sdpa(*side_leaves)

    def sdpa_bwd_side():
        return torch.autograd.grad(out_side, side_leaves, do,
                                   retain_graph=True)
    bwd_graph = (sdpa_bwd_side, side)
    extra = {}
    if name is not None:
        def both(attn):
            def call():             # fresh leaves: no graph kept alive
                x = [t.detach().requires_grad_() for t in (q, k, v)]
                return torch.autograd.grad(attn(*x), x, do)
            return call
        pair = (("sdpa", both(sdpa)), ("kernels", both(
            lambda *x: F.flash_attention(*x, pos, pos, *st))))
        for key, fn in pair:
            extra[f"{key}_fwd_bwd_ms"] = time_ms(torch, fn, batches=10,
                                                 per_batch=3, warmup=2)
        for key, fn in pair:
            extra[f"{key}_fwd_bwd_device_ms"] = graph_ms(torch, fn, reps=10,
                                                         per_graph=3)
    t_q, t_kv = B * H * S * d * 2, B * KV * S * d * 2   # bf16 tensors
    t_rows = B * H * S * 4
    # S(S+1)/2 or S^2 (a non-causal mask comes as one broadcast row)
    pairs = int(F._mask(pos, pos, causal, None).expand(S, S).sum())
    need = 2 * B * H * pairs * d                       # one product, needed
    tile = 2 * B * H * F.TILE ** 2 * d                 # one 64x64 tile product
    k_tiles = int(F.visited_k_tiles(pos.cpu(), pos.cpu(), causal, None).sum()
                  ) * F.GROUP / F.TILE                 # in 64x64 tiles
    codes = F.visited_q_tiles(pos.cpu(), pos.cpu(), causal, None)
    dv_only = int((codes == F.DV_ONLY).sum())
    q_tiles = int((codes > 0).sum())
    shape = (f"{name + ' ' if name else ''}B={B} "
             f"{f'H=KV={H}' if G == 1 else f'H:KV={H}:{KV}'} S={S} d={d} "
             f"bf16 {'causal' if causal else 'non-causal'}")
    src, ref = ("src/repro_torch/csrc/flash_attention.cu",
                "src/repro/kernels/flash_attention.py")
    all_tiles = (-(-S // F.TILE)) ** 2
    # (name, line, kernel, plain, library, its graph, (B, H, S, d) tensors
    #  and (B, KV, S, d) ones read or written, f32 rows, products, tiles,
    #  own tile products)
    for (kname, line, kern, plain, lib, lib_graph, n_q, n_kv, n_rows,
         n_prod, tiles, own) in (
            ("flash_fwd", 49, lambda: F.flash_fwd(q, k, v, pos, pos, *st),
             lambda: F.flash_fwd_plain(q, k, v, pos, pos, *st),
             lambda: sdpa(q, k, v), None, 2, 2, 1, 2, k_tiles,
             3 * k_tiles),
            ("flash_dq", 81, lambda: F.flash_dq(*bwd),
             lambda: F.flash_dq_plain(*bwd), sdpa_bwd, bwd_graph, 3, 2, 2,
             3, k_tiles, 4 * k_tiles),
            ("flash_dkv", 115, lambda: F.flash_dkv(*bwd),
             lambda: F.flash_dkv_plain(*bwd), sdpa_bwd, bwd_graph, 2, 4, 2,
             4, q_tiles, 6 * (q_tiles - dv_only) + 2 * dv_only)):
        nbytes = n_q * t_q + n_kv * t_kv + n_rows * t_rows + 2 * S * 4
        row(kname, src, f"{ref}:{line}", kern, plain, lib, nbytes,
            n_prod * need, BF16_FLOPS, shape, slow=True,
            library_graph=lib_graph,
            visited_tiles=f"{tiles:g} of {all_tiles}",
            visited_bound_ms=1e3 * own * tile / BF16_FLOPS,
            **(extra if kname == "flash_fwd" else {}))


# The frontend presets' attention at their training shapes, phase 15's
# batches: hubert-xlarge 8 x 781 frames (non-causal, d = 1280 / 16 = 80)
# and internvl2-2b 2 x 4096 (causal, GQA 16:8, d=128); phase 2o checks
# kernels 7-9 there and phase 5 times them:
# (name, B, H, KV, S, d, causal)
FRONTEND_FLASH = (("hubert-xlarge", 8, 16, 16, 781, 80, False),
                  ("internvl2-2b", 2, 16, 8, 4096, 128, True))


def frontend_timings(torch, dev, smi, shapes=None):
    """Phase 5's rows of kernels 7-9 at ``shapes`` (by default
    ``FRONTEND_FLASH``; ``flash_timings`` with each preset's name: SDPA's
    forward + backward beside the kernels')."""
    g = torch.Generator(device="cpu").manual_seed(98)
    rows = TimingRows(torch, smi)
    for name, B, H, KV, S, d, causal in shapes or FRONTEND_FLASH:
        flash_timings(torch, dev, g, rows.add, B, H, KV, S, d, causal, name)
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 6: where the time goes
# ---------------------------------------------------------------------------

class EventAvg:
    """One key of :func:`read_profile`: the fields of
    ``FunctionEventAvg`` that this script reads (times in us; a host
    event's self device time, the kernels it launched, is not read:
    None)."""
    __slots__ = ("key", "device_type", "count", "self_cpu_time_total",
                 "self_device_time_total")

    def __init__(self, key, device_type):
        self.key, self.device_type = key, device_type
        self.count = 0
        self.self_cpu_time_total = self.self_device_time_total = 0.0


# the names torch.autograd.profiler leaves out of its event list
PROFILER_SKIPPED = frozenset((
    "[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
    "profiler::_record_function_enter_new", "profiler::_record_function_exit",
    "aten::is_leaf", "aten::output_nr", "aten::_version"))


def read_profile(prof) -> list:
    """``prof.key_averages()``'s count, self CPU time and (for a device
    event) self device time per (name, device type), read from the
    profiler's raw events: the
    same rules as ``torch.autograd.profiler`` (the names it skips; an
    async event has no time; a runtime call nests on the thread of the op
    that issued it; a CPU event's children are the events of its thread
    inside its interval, and one whose only child has its name gives it
    up), without a Python object per event, whose making takes ~70 us an
    event: an eager decode step of a 42-layer model is ~40,000 events."""
    from torch.autograd import DeviceType
    CPU = int(DeviceType.CPU)
    types = {}               # the device types by value (cheap to hash)
    rows = []                # [name, device type, start, end, thread, async]
    thread_of = {}           # an op's correlation id -> its thread
    linked = []              # (row, linked correlation id) of runtime calls
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        hidden = getattr(e, "is_hidden_event", None)
        if name in PROFILER_SKIPPED or (hidden is not None and hidden()):
            continue
        code = int(e.device_type())
        dt = types.setdefault(code, e.device_type()) and code
        row = [name, dt, e.start_ns(), e.end_ns(), e.start_thread_id(),
               e.is_async() or e.start_thread_id() != e.end_thread_id()]
        corr = e.linked_correlation_id()
        if corr == 0:
            if dt == CPU and not row[5]:
                thread_of[e.correlation_id()] = row[4]
        elif dt == CPU:
            linked.append((row, corr))
        rows.append(row)
    for row, corr in linked:
        if corr in thread_of:
            row[4] = thread_of[corr]
    # the CPU nesting, per thread (a stack over intervals by start)
    n = len(rows)
    parent = [-1] * n
    children = [[] for _ in range(n)]
    order = sorted((i for i in range(n) if rows[i][1] == CPU
                    and not rows[i][5]),
                   key=lambda i: (rows[i][4], rows[i][2], -rows[i][3]))
    stack, thread = [], None
    for i in order:
        if rows[i][4] != thread:
            stack, thread = [], rows[i][4]
        while stack and (rows[i][2] >= rows[stack[-1]][3]
                         or rows[i][3] > rows[stack[-1]][3]):
            stack.pop()
        if stack:
            parent[i] = stack[-1]
            children[stack[-1]].append(i)
        stack.append(i)
    gone = set()
    while True:                     # a child named as its only parent
        drop = [i for i in range(n) if i not in gone and parent[i] >= 0
                and rows[parent[i]][0] == rows[i][0]
                and len(children[parent[i]]) == 1]
        if not drop:
            break
        for i in drop:
            p = parent[i]
            children[p] = children[i]
            for c in children[i]:
                parent[c] = p
            gone.add(i)
    avgs = {}
    for i, (name, dt, t0, t1, _, is_async) in enumerate(rows):
        if i in gone:
            continue
        if name.startswith("ProfilerStep#"):
            name = "ProfilerStep*"
        a = avgs.get((name, dt))
        if a is None:
            a = avgs[(name, dt)] = EventAvg(name, types[dt])
        a.count += 1
        if dt == CPU:
            a.self_device_time_total = None
        if is_async:
            continue
        us = (t1 - t0) / 1e3
        if dt == CPU:
            a.self_cpu_time_total += us - sum(
                (rows[c][3] - rows[c][2]) / 1e3 for c in children[i])
        else:
            a.self_device_time_total += us
    return list(avgs.values())


def check_profile_reader(prof, label: str) -> None:
    """:func:`read_profile` against ``prof.key_averages()`` on one
    profile: every (name, device type)'s count, its self CPU time and a
    device event's self device time, each within 0.01 us."""
    want = {}
    for e in prof.key_averages():
        a = want.setdefault((e.key, e.device_type),
                            EventAvg(e.key, e.device_type))
        a.count += e.count
        a.self_cpu_time_total += e.self_cpu_time_total
        a.self_device_time_total += e.self_device_time_total
    got = {(a.key, a.device_type): a for a in read_profile(prof)}
    bad = [(k, (w.count, w.self_cpu_time_total, w.self_device_time_total),
            None if k not in got else (got[k].count,
                                       got[k].self_cpu_time_total,
                                       got[k].self_device_time_total))
           for k, w in want.items()
           if k not in got or got[k].count != w.count
           or abs(got[k].self_cpu_time_total - w.self_cpu_time_total) > 1e-2
           or (got[k].self_device_time_total is not None
               and abs(got[k].self_device_time_total
                       - w.self_device_time_total) > 1e-2)]
    bad += [(k, None, "extra") for k in set(got) - set(want)]
    bad.sort(key=lambda b: int(b[0][1]) == 0)    # device events first
    print(f"  the profile reader against key_averages on {label}: "
          f"{len(want)} keys, {sum(w.count for w in want.values())} "
          f"events, {len(bad)} differ {bad[:4]}")
    check(not bad, f"the profile reader disagrees with key_averages on "
                   f"{label}: {bad[:8]}")


PROFILE_READER_CHECKED = []
PROFILE_READ_S = [0.0]      # seconds spent reading profiles, for stamp()


def _averages(prof):
    """:func:`read_profile` of ``prof``, read once per profile; the first
    profile of the run is also read by ``key_averages`` and the two held
    equal (:func:`check_profile_reader`)."""
    avgs = getattr(prof, "chip_smoke_averages", None)
    if avgs is None:
        if not PROFILE_READER_CHECKED:
            check_profile_reader(prof, "the run's first profile")
            PROFILE_READER_CHECKED.append(True)
        t0 = time.perf_counter()
        gc.disable()        # a million small lists: no collection midway
        try:
            avgs = prof.chip_smoke_averages = read_profile(prof)
        finally:
            gc.enable()
        PROFILE_READ_S[0] += time.perf_counter() - t0
    return avgs


def _device_ms(prof, DeviceType) -> float:
    """Sum of the device time of every kernel the profiler saw, in ms."""
    return sum(e.self_device_time_total for e in _averages(prof)
               if e.device_type == DeviceType.CUDA) / 1e3


def host_waits(torch, fn) -> list:
    """Where ``fn()`` makes the host wait for the device, as ``file:line``
    (``torch.cuda.set_sync_debug_mode`` warns at each such operation)."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{pathlib.Path(w.filename).name}:{w.lineno}" for w in caught
            if "called a synchronizing CUDA operation" in str(w.message)]


def profile_serving(torch, smi, model, cfg, mode, S, B, *, seed=3,
                    decode_steps=8, name=""):
    """One profiled prefill of B prompts of S tokens (for a frontend
    config, embeddings fed to the prefill and to each step) and
    ``decode_steps`` profiled decode steps on ``model`` under dispatch
    ``mode`` (None for a dense model): wall time (host clock to a
    synchronise), the device time of all kernels, the device's idle
    share, the top kernels, the launches and the host's waits for the
    device (none may remain in a forward).
    ``name`` prefixes the cell's label.  Returns {label: numbers}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.frontend import synthetic_embeddings
    from repro_torch.serving.engine import resolve_decode_config, serve_config
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    if cfg.frontend is None:
        prompt = torch.randint(0, cfg.vocab_size, (B, S),
                               generator=torch.Generator().manual_seed(seed)
                               ).cuda()

        def feed(logits):                   # greedy
            return logits[:, -1].argmax(-1, keepdim=True)
    else:                                   # the API: embeddings in
        g = torch.Generator(device="cuda").manual_seed(seed)
        prompt = synthetic_embeddings(g, cfg, B, S, device="cuda")
        x = synthetic_embeddings(g, cfg, B, 1, device="cuda")

        def feed(logits):
            return x
    c = serve_config(cfg, dispatch=mode)
    dc = resolve_decode_config(c, B)
    cell = f"{name}{mode or 'dense'} prompt {S}"
    with torch.inference_mode():
        caches = model.init_caches(B, S + 16)
        model.forward(prompt, caches=model.init_caches(B, S + 16), cfg=c)
        waits = {"prefill": host_waits(torch, lambda: model.forward(
            prompt, caches=model.init_caches(B, S + 16), cfg=c))}
        torch.cuda.synchronize()
        with profile(activities=acts) as pp:
            t0 = time.perf_counter()
            h, _, caches = model.forward(prompt, caches=caches, cfg=c)
            tok = feed(model.logits_from_hidden(h[:, -1:]))
            torch.cuda.synchronize()
            prefill_wall = 1e3 * (time.perf_counter() - t0)
        model.decode_step(tok, caches, cfg=dc)          # warm decode
        waits["decode step"] = host_waits(
            torch, lambda: model.decode_step(tok, caches, cfg=dc))
        torch.cuda.synchronize()
        with profile(activities=acts) as pd:
            t0 = time.perf_counter()
            for _ in range(decode_steps):
                lg, caches = model.decode_step(tok, caches, cfg=dc)
                tok = feed(lg)
            torch.cuda.synchronize()
            decode_wall = 1e3 * (time.perf_counter() - t0) / decode_steps
    out = {}
    for label, prof, wall in (("prefill", pp, prefill_wall),
                              ("decode step", pd, decode_wall)):
        n = 1 if label == "prefill" else decode_steps
        dev_ms = _device_ms(prof, DeviceType) / n
        print(f"  [{smi}] {cell} {label}: wall {wall:.3f} ms, device "
              f"{dev_ms:.3f} ms, idle {1 - dev_ms / wall:.3f}")
        kernels = sorted((e for e in _averages(prof)
                          if e.device_type == DeviceType.CUDA),
                         key=lambda e: -e.self_device_time_total)
        for e in kernels[:6]:
            print(f"      {e.self_device_time_total / 1e3 / n:8.3f} ms "
                  f"x{e.count // n:<3d} {e.key[:90]}")
        host = sorted((e for e in _averages(prof)
                       if e.device_type == DeviceType.CPU),
                      key=lambda e: -e.self_cpu_time_total)
        calls = sum(e.count for e in host) // n
        launches = sum(e.count for e in host
                       if e.key == "cudaLaunchKernel") / n
        syncs = {e.key: e.count / n for e in host if "Synchronize" in e.key}
        print(f"      host: {calls} profiled calls, {launches:g} "
              f"cudaLaunchKernel per {label}; synchronise calls {syncs} "
              f"(the profiled region ends in one cudaDeviceSynchronize); "
              f"waits found by the sync debug mode in one more {label}: "
              f"{len(waits[label])} {sorted(set(waits[label]))}")
        check(not waits[label],
              f"{cell} {label}: the host waits for the device "
              f"{len(waits[label])} times")
        print("      top by self CPU time:")
        for e in host[:6]:
            print(f"      {e.self_cpu_time_total / 1e3 / n:8.3f} ms "
                  f"x{e.count // n:<3d} {e.key[:90]}")
        out[f"{cell} {label}"] = dict(
            wall_ms=wall, device_ms=dev_ms, idle=1 - dev_ms / wall,
            launches=launches, host_waits=len(waits[label]),
            top_kernels=[(e.key[:90], e.self_device_time_total / 1e3 / n)
                         for e in kernels[:6]])
    return out


def phase_profile(torch, smi):
    """One profiled prefill and 8 profiled decode steps per serving cell
    (``SERVE_CELLS``, :func:`profile_serving`)."""
    from repro_torch import configs
    from repro_torch.models.transformer import Transformer
    cfg = configs.get_config(ARCH)
    model = Transformer(cfg, device="cuda", seed=0)
    print("phase 6: profile (torch.profiler; device ms = sum of kernel "
          "times, idle = 1 - device/wall)")
    out = {}
    for mode, S in SERVE_CELLS:
        out.update(profile_serving(torch, smi, model, cfg, mode, S,
                                   SERVE["batch"]))
    return out


# the names of the kernels of csrc/*.cu, as the profiler shows them
PORT_KERNEL_NAMES = ("topk_gate_kernel", "gather_rows_kernel",
                     "gather_rowstep_kernel", "scatter_plan_kernel",
                     "scatter_sum_kernel", "grouped_mm_", "grouped_drhs_",
                     "flash_")


# the training cell whose step the executed-program analysis predicts
ANALYSED_TRAIN = ("grouped", 1024)
# the bound on |measured peak - predicted peak| of an analysed step: the
# caching allocator rounds each block up and holds the cuBLAS workspaces,
# which no op returns, and a kernel's own temporaries are not seen
PEAK_REL, PEAK_ABS = 0.05, 64 * 2 ** 20
# the launch counters under the names the kernel-call log gives them
LOGGED_AS = {"scatter_add": "scatter_add_rows"}


def port_wrapper(kernel: str):
    """The wrapper (its launch counter's name) whose call launched the
    profiled kernel ``kernel`` (its name without ``void`` and arguments),
    or None for a kernel of no wrapper."""
    if kernel.startswith("grouped_mm_"):
        return ("grouped_matmul_t" if kernel.endswith("true>")
                else "grouped_matmul")
    for prefix, wrapper in (("topk_gate", "topk_gate"),
                            ("gather_rowstep", "gather_rows_rowstep"),
                            ("gather_rows", "gather_rows"),
                            ("scatter_", "scatter_add_rows"),
                            ("grouped_drhs", "grouped_drhs"),
                            ("flash_fwd", "flash_fwd"),
                            ("flash_dq", "flash_dq"),
                            ("flash_dkv", "flash_dkv"),
                            ("plan_nokey", "flash_dkv")):
        if kernel.startswith(prefix):
            return wrapper
    return None


def analysed(cfg, shape, **kw):
    """``launch/dryrun.execute_pair`` of ``cfg`` at ``shape`` on one
    device, on fake ``cuda`` tensors (host time only): the predicted
    launches by counter name, the memory keys, each kernel's bound, and
    the seconds it took."""
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    ran = dryrun.execute_pair(cfg, shape, {"data": 1, "model": 1},
                              device="cuda", **kw)
    kernels = {LOGGED_AS.get(k, k): v
               for k, v in ran["op_analysis"]["kernels"].items()}
    return dict(launches={k: kernels.get(k, {}).get("launches", 0)
                          for k, _, _ in COUNTERS},
                memory=ran["memory_analysis"], kernels=kernels,
                host_s=time.perf_counter() - t0)


def check_analysed(label, pred, counts, peak, before, args):
    """The step's launches against the analysis's, exactly; the bytes of
    its real arguments' storages (``args``) against the predicted
    ``argument_bytes``, exactly; and its peak (``max_memory_allocated``
    over the step) against the predicted ``peak_per_device_bytes`` within
    ``PEAK_REL`` of it plus ``PEAK_ABS``, once what the card held beside
    the arguments when the step started (``before`` less ``args``:
    earlier phases' workspaces and leftovers, which no analysis of the
    step sees) is taken out."""
    ma = pred["memory"]
    want = ma["peak_per_device_bytes"]
    held = before - args
    print(f"    analysis ({pred['host_s']:.2f} s on the host, fake cuda "
          f"tensors): launches {pred['launches']}; measured {counts}; "
          f"arguments predicted {ma['argument_bytes']} B, measured {args} "
          f"B; peak predicted {want / 2 ** 30:.4f} GiB (temp "
          f"{ma['temp_bytes'] / 2 ** 30:.4f}, output "
          f"{ma['output_bytes'] / 2 ** 30:.4f}, alias "
          f"{ma['alias_bytes'] / 2 ** 30:.4f}), measured "
          f"{peak / 2 ** 30:.4f} GiB with {held / 2 ** 20:.1f} MiB held "
          f"beside the arguments at the start: "
          f"{(peak - held - want) / 2 ** 20:+.1f} MiB less that "
          f"({(peak - want) / 2 ** 20:+.1f} MiB with it)")
    check(counts == pred["launches"],
          f"{label}: launches {counts} != the analysis's "
          f"{pred['launches']}")
    check(args == ma["argument_bytes"],
          f"{label}: the arguments hold {args} B, the analysis "
          f"{ma['argument_bytes']} B")
    check(abs(peak - held - want) <= PEAK_REL * want + PEAK_ABS,
          f"{label}: peak {peak} B less the {held} B held beside the "
          f"arguments is not within {PEAK_REL:.0%} + {PEAK_ABS >> 20} MiB "
          f"of the predicted {want} B")
    return dict(predicted_launches=pred["launches"], launches=counts,
                predicted_peak_bytes=want, peak_bytes=peak,
                allocated_before_bytes=before, argument_bytes=args,
                memory_analysis=ma, analysis_host_s=pred["host_s"])


def decode_vs_analysis(torch, smi, model, cfg, B: int = 8,
                       cache_len: int = 1024 + 32) -> dict:
    """One eager decode step of ``model`` (``engine.build_decode(graph=
    False)``, batch ``B`` over caches of ``cache_len``) with its sampled
    token, against ``execute_pair``'s analysis of the same step: the
    launches and argument bytes exactly, the peak within the bound
    (``check_analysed``).  The step cache is cleared first, so the
    caches and graphs of earlier steps are gone."""
    from repro_torch.core.config import ShapeConfig
    from repro_torch.launch.dryrun import storage_bytes
    from repro_torch.serving import engine
    pred = analysed(cfg, ShapeConfig("decode", cache_len, B, "decode"))
    engine.clear_step_cache(model)
    step = engine.build_decode(model, cfg, batch=B, cache_len=cache_len,
                               graph=False)
    tok = torch.zeros((B, 1), dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        step(tok)                              # warm-up
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        reset_counts()
        logits = step(tok)
        nxt = logits[:, -1].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
    counts = read_counts([k for k, _, _ in COUNTERS])
    peak = torch.cuda.max_memory_allocated()
    print(f"  [{smi}] eager decode step, batch {B}, caches of {cache_len}, "
          f"against the executed-program analysis:")
    out = check_analysed("eager decode step", pred, counts, peak, before,
                         storage_bytes((model.tree(), tok, step.caches)))
    check(bool(((nxt >= 0) & (nxt < cfg.vocab_size)).all()),
          "eager decode step: sampled ids out of range")
    engine.clear_step_cache(model)
    return out


def phase_profile_train(torch, smi):
    """One profiled train step per phase-7 cell (``TRAIN_CELLS``, after a
    warm-up step): wall time (host clock to a synchronise), the
    device time of all kernels, the device's idle share, the top kernels
    and the port's own kernels, and the host's waits for the device inside
    one more step (reported; the aim is none).  At ``ANALYSED_TRAIN`` the
    step is first analysed on the host (``launch/dryrun.execute_pair`` on
    fake ``cuda`` tensors): the profiled step's launches and argument
    bytes must equal the analysis's and its peak (``max_memory_allocated``
    after a reset of the peak statistics, less what the card held beside
    the arguments) the predicted ``peak_per_device_bytes`` within
    ``PEAK_REL`` + ``PEAK_ABS`` (``check_analysed``); each port kernel's
    predicted bound is printed beside its profiled device time, with its
    share of the bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.core.config import TrainConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.serving.engine import serve_config
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)
    from repro_torch.core.config import ShapeConfig
    from repro_torch.launch.dryrun import storage_bytes
    B = TRAIN["batch"]
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    print("phase 6b: train step profile (torch.profiler; device ms = sum of "
          "kernel times, idle = 1 - device/wall)")
    out = {}
    for mode, S in TRAIN_CELLS:
        cfg = serve_config(configs.get_config(ARCH), dispatch=mode)
        tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=1,
                           total_steps=10)
        pred = (analysed(cfg, ShapeConfig("train", S, B, "train"),
                         tcfg=tcfg) if (mode, S) == ANALYSED_TRAIN else None)
        step = make_train_step(cfg, tcfg)
        state = init_train_state(cfg, tcfg, device="cuda")
        ds = SyntheticLM(cfg, B, S, seed=0, device="cuda")
        state, _ = step(state, ds.next_batch(0))
        batch = ds.next_batch(1)
        waits = host_waits(torch, lambda: step(state, batch))
        gc.collect()
        args = storage_bytes((state, batch))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        reset_counts()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        counts = read_counts([k for k, _, _ in COUNTERS])
        dev_ms = _device_ms(prof, DeviceType)
        print(f"  [{smi}] {mode} seq {S} train step: wall {wall:.3f} ms, device "
              f"{dev_ms:.3f} ms, idle {1 - dev_ms / wall:.3f}, loss "
              f"{float(m['loss']):.4f}")
        kernels = sorted((e for e in _averages(prof)
                          if e.device_type == DeviceType.CUDA),
                         key=lambda e: -e.self_device_time_total)
        for e in kernels[:10]:
            print(f"      {e.self_device_time_total / 1e3:8.3f} ms "
                  f"x{e.count:<4d} {e.key[:90]}")
        # the port's own kernels (csrc/*.cu), wherever they rank
        own = {}
        for e in kernels:
            name = e.key.removeprefix("void ").replace(
                "(anonymous namespace)::", "").split("(")[0]
            if name.startswith(PORT_KERNEL_NAMES):
                own[name] = (e.self_device_time_total / 1e3, e.count)
        print("      port kernels: " + ", ".join(
            f"{k} {t:.3f} ms x{n}" for k, (t, n) in own.items()))
        host = [e for e in _averages(prof)
                if e.device_type == DeviceType.CPU]
        launches = sum(e.count for e in host if e.key == "cudaLaunchKernel")
        print(f"      host: {sum(e.count for e in host)} profiled calls, "
              f"{launches} cudaLaunchKernel; waits found by the sync debug "
              f"mode in one more step: {len(waits)} {sorted(set(waits))}")
        out[f"{mode} seq {S} train step"] = dict(
            wall_ms=wall, device_ms=dev_ms, host_waits=len(waits),
            wait_sites=sorted(set(waits)),
            port_kernels_ms={k: t for k, (t, _) in own.items()})
        if pred is not None:
            res = check_analysed(f"{mode} seq {S} train step", pred,
                                 counts, peak, before, args)
            by = {}
            for e in kernels:
                w = port_wrapper(e.key.removeprefix("void ").replace(
                    "(anonymous namespace)::", "").split("(")[0])
                if w is not None:
                    by[w] = by.get(w, 0.0) + e.self_device_time_total / 1e3
            res["bound_vs_device"] = {}
            for w, k in sorted(pred["kernels"].items()):
                b_ms, d_ms = 1e3 * k["bound_s"], by.get(w)
                res["bound_vs_device"][w] = dict(
                    launches=k["launches"], bound_ms=b_ms, device_ms=d_ms,
                    share=None if not d_ms else b_ms / d_ms)
                print(f"      {w}: predicted bound {b_ms:.4f} ms over "
                      f"{k['launches']} launches, profiled device "
                      + ("not measured" if d_ms is None else
                         f"{d_ms:.4f} ms, {b_ms / d_ms:.3f} of the bound"))
            out[f"{mode} seq {S} train step"]["analysis"] = res
        del state, step, batch
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 7: training at full width
# ---------------------------------------------------------------------------

TRAIN = dict(batch=8, warmup=2, timed=8)
# (dispatch, sequence length) of the training cells
TRAIN_CELLS = (("grouped", 512), ("sort", 512), ("grouped", 1024))
# launches per MoE layer (relu, any k) in a forward and in a backward:
# the grouped dispatch is a gather (its VJP the scatter-add), the grouped
# combine a scatter-add (its VJP the gather)
LAYER_FORWARD = {
    "grouped": {"topk_gate": 1, "gather_rows": 1, "grouped_matmul": 2,
                "scatter_add_rows": 1},
    "sort": {"topk_gate": 1, "gather_rows": 2}}
LAYER_BACKWARD = {
    "grouped": {"gather_rows": 1, "grouped_matmul_t": 2, "grouped_drhs": 2,
                "scatter_add_rows": 1},
    "sort": {"scatter_add_rows": 2}}
TRAIN_KERNELS = ("topk_gate", "gather_rows", "grouped_matmul",
                 "grouped_matmul_t", "grouped_drhs", "scatter_add_rows")


def train_per_step(mode: str, seq: int, forwards: int = 1,
                   layers: int = 2) -> dict:
    """Launches per train step of each kernel: each layer's forward
    ``forwards`` times (2 when remat recomputes it in the backward), its
    backward once; past q_chunk the flash forward once per layer and
    forward, dq and dk/dv once per layer."""
    flash = layers if seq > Q_CHUNK else 0
    per = {k: layers * (forwards * LAYER_FORWARD[mode].get(k, 0)
                        + LAYER_BACKWARD[mode].get(k, 0))
           for k in TRAIN_KERNELS}
    return per | {"flash_fwd": forwards * flash, "flash_dq": flash,
                  "flash_dkv": flash}


def phase_train(torch, smi):
    from repro_torch.launch import train
    steps = TRAIN["warmup"] + TRAIN["timed"]
    B = TRAIN["batch"]
    names = [k for k, _, _ in COUNTERS]
    totals = dict.fromkeys(names, 0)
    results = {}
    print(f"phase 7: training at full width, f32 masters + bf16 compute, "
          f"batch {B}, {TRAIN['warmup']} warm-up + {TRAIN['timed']} timed "
          f"AdamW steps per cell {TRAIN_CELLS}")
    for mode, S in TRAIN_CELLS:
        cell = f"{mode} seq {S}"
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        stats = {}
        reset_counts()
        state, history = train.run(ARCH, steps=steps, batch=B, seq=S,
                                   smoke=False, seed=0, log_every=1,
                                   dispatch=mode, device="cuda", stats=stats)
        counts = read_counts(names)
        peak = torch.cuda.max_memory_allocated()
        want = {k: v * steps for k, v in train_per_step(mode, S).items()}
        timed = stats["step_s"][TRAIN["warmup"]:]
        med = statistics.median(timed)
        losses = [h["loss"] for h in history]
        print(f"  [{smi}] {cell}: median step {1e3 * med:.3f} ms (of "
              f"{len(timed)} timed; min {1e3 * min(timed):.3f}, max "
              f"{1e3 * max(timed):.3f}), {B * S / med:.1f} tokens/s, peak "
              f"memory {peak / 2 ** 30:.3f} GiB, launches {counts}")
        print(f"    loss trajectory {[round(v, 4) for v in losses]}")
        for k in counts:
            totals[k] += counts[k]
        check(counts == want, f"{cell}: training launch counts {counts} != "
                              f"{want} ({steps} steps)")
        bad = [(h["step"], k) for h in history for k, v in h.items()
               if not math.isfinite(v)]
        check(not bad, f"{cell}: non-finite metrics {bad}")
        check(all(h["skipped"] == 0 for h in history),
              f"{cell}: a step was skipped")
        results[cell] = dict(step_ms_median=1e3 * med,
                             step_ms=[1e3 * t for t in stats["step_s"]],
                             tokens_per_s=B * S / med,
                             peak_gib=peak / 2 ** 30, losses=losses)
        del state
    return totals, results


# ---------------------------------------------------------------------------
# phase 8: card against CPU, one f32 train step's gradients at full width
# ---------------------------------------------------------------------------

def phase_attention_card_vs_cpu(torch, params, cfg, S: int = 1024):
    """One full-width attention layer (block 0's f32 weights, batch 1, seq
    ``S`` > q_chunk, so the flash path) forward and backward, card against
    CPU: y and the gradients of sum(y * r) with respect to x and the four
    projections, each within 1e-4 of its max (f32 sums over S keys and
    2048-wide projections in other orders).  Returns the worst ratio."""
    from repro_torch.models import attention as A
    g = torch.Generator().manual_seed(13)
    x = torch.randn(1, S, cfg.d_model, generator=g)
    r = torch.randn(1, S, cfg.d_model, generator=g)
    pos = torch.arange(S, dtype=torch.int32)
    res = []
    for dev in ("cpu", "cuda"):
        p = {k: v.to(dev, copy=True).requires_grad_(True)
             for k, v in params["blocks"][0]["attn"].items()}
        xx = x.to(dev, copy=True).requires_grad_(True)
        reset_counts()
        y, _ = A.full_attention(p, xx, cfg.attention, positions=pos.to(dev))
        (y * r.to(dev)).sum().backward()
        res.append([t.detach().cpu() for t in
                    (y, xx.grad, *(p[k].grad for k in sorted(p)))])
    counts = read_counts(("flash_fwd", "flash_dq", "flash_dkv"))
    check(counts == {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1},
          f"attention layer at seq {S}: card launches {counts}")
    worst = max((a - b).abs().max().item() / a.abs().max().item()
                for a, b in zip(*res))
    print(f"  attention layer, seq {S}, full width: y and gradients "
          f"(x, wk, wo, wq, wv) worst max|d|/max {worst:.2e} (tol 1e-4); "
          f"card launches {counts}")
    check(worst <= 1e-4, f"attention layer at seq {S}: card and CPU disagree")
    return worst


def forced_relu_ffn(torch, G, masks):
    """``grouped_ffn`` for relu experts with each layer's ReLU replaced by
    the given mask (its value and its derivative), the masks taken in call
    order: a train step that makes the ReLU decisions of another run."""
    left = list(masks)

    def fn(params, xs, offsets, act):
        h = G.grouped_matmul(xs, params["w_up"], offsets)
        h = torch.where(left.pop(0).to(h.device), h,
                        torch.zeros((), dtype=h.dtype, device=h.device))
        return G.grouped_matmul(h, params["w_out"], offsets)
    return fn


def phase_train_card_vs_cpu(torch):
    """One f32 train step's loss and gradients, card against CPU, at seq 64
    (both dispatch modes) and seq 1024 (grouped, the flash path).

    Tolerances: loss and grad norm rtol 1e-4; every leaf max|dgrad|/max|grad|
    <= 1e-3 (f32 sums of up to 50304 terms in other orders).  At 1024
    tokens a few ReLU pre-activations lie within f32 rounding of 0 and
    fall on the positive side on one device only (2 units of layer 0 and 1
    of layer 1 on an H100 at seed 11/12, |pre| <= 2.3e-6); each moves a
    whole column of that expert's w_up gradient and what flows back from
    that token.  So the card's step at seq 1024 is replayed with the CPU's
    ReLU masks forced (``forced_relu_ffn``) and every leaf of that replay
    is held to the 1e-3 above; the unforced step's leaves are printed.
    The attention layer this seq exercises is held on its own first
    (``phase_attention_card_vs_cpu``)."""
    from repro_torch import configs, tree
    from repro_torch.kernels import grouped_ffn as G
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.adamw import clip_by_global_norm
    from repro_torch.serving.engine import serve_config
    from repro_torch.training.train_step import loss_and_grads
    cfg = configs.get_config(ARCH).replace(dtype="float32")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator().manual_seed(11), device="cpu")
    gen = torch.Generator().manual_seed(12)
    grouped_matmul, grouped_ffn = G.grouped_matmul, G.grouped_ffn

    def recording(store):
        """grouped_matmul that keeps its outputs: with relu experts, every
        other one is a layer's ReLU pre-activations (rows in the stable
        expert order, the same on both devices)."""
        def fn(lhs, rhs, offsets):
            out = grouped_matmul(lhs, rhs, offsets)
            store.append(out.detach().cpu())
            return out
        return fn

    def step(dev, toks, c, S, ffn=None):
        """(loss, grad norm, gradient leaves on the CPU, pre-activations)."""
        masters = tree.map_(lambda p: p.to(dev, copy=True)
                            .requires_grad_(True), params)
        batch = {"inputs": toks[:, :-1].to(dev),
                 "targets": toks[:, 1:].to(dev),
                 "loss_mask": torch.ones((1, S), device=dev)}
        pre = []
        G.grouped_matmul = recording(pre)
        G.grouped_ffn = ffn or grouped_ffn
        try:
            loss, _, _, grads = loss_and_grads(masters, batch, c)
        finally:
            G.grouped_matmul, G.grouped_ffn = grouped_matmul, grouped_ffn
        _, gn = clip_by_global_norm(grads, 1.0)
        return (loss.item(), gn.item(), [g.cpu() for g in tree.leaves(grads)],
                pre[::2])

    def leaf_rel(ga, gb):
        worst = max((a - b).abs().max().item() / max(
            a.abs().max().item(), 1e-30) for a, b in zip(ga, gb))
        fro = max(((a - b).norm() / a.norm().clamp(min=1e-30)).item()
                  for a, b in zip(ga, gb))
        return worst, fro
    print(f"phase 8: f32 train-step gradients, card against CPU, batch 1, "
          f"seq 64 and 1024 (weights in {time.perf_counter() - t0:.1f} s); "
          f"tolerances: loss and grad norm rtol 1e-4; every leaf "
          f"max|dgrad|/max|grad| <= 1e-3 (f32 sums of up to 50304 terms in "
          f"other orders), at seq 1024 in the card's replay with the CPU's "
          f"ReLU masks (see the docstring)")
    out = {"attention layer seq 1024 worst_rel":
           phase_attention_card_vs_cpu(torch, params, cfg)}
    names = ("grouped_matmul_t", "grouped_drhs", "scatter_add_rows",
             "flash_fwd", "flash_dq", "flash_dkv")
    for mode, S in (("grouped", 64), ("sort", 64), ("grouped", 1024)):
        want = {k: v for k, v in train_per_step(mode, S).items()
                if k in names}
        toks = torch.randint(0, cfg.vocab_size, (1, S + 1),
                             generator=gen).to(torch.int32)
        c = serve_config(cfg, dispatch=mode)
        lc, nc, gc, pre_c = step("cpu", toks, c, S)
        reset_counts()
        lg, ng, gg, pre_g = step("cuda", toks, c, S)
        counts = read_counts(names)
        check(counts == want,
              f"{mode} seq {S}: card launches {counts} != {want}")
        worst, fro = leaf_rel(gc, gg)
        rl, rn = abs(lc - lg) / abs(lc), abs(nc - ng) / abs(nc)
        print(f"  {mode} seq {S}: loss cpu {lc:.6f} card {lg:.6f} (rel "
              f"{rl:.2e}); grad norm cpu {nc:.6f} card {ng:.6f} (rel "
              f"{rn:.2e}); worst leaf max|dgrad|/max|grad| {worst:.2e}, "
              f"relative Frobenius {fro:.2e} over {len(gc)} leaves; card "
              f"launches {counts}")
        res = dict(loss_rel=rl, grad_norm_rel=rn, worst_leaf_rel=worst,
                   worst_leaf_frobenius_rel=fro)
        check(rl <= 1e-4 and rn <= 1e-4,
              f"{mode} seq {S}: card and CPU loss or grad norm disagree")
        if mode == "grouped":
            flips = [(a > 0) != (b > 0) for a, b in zip(pre_c, pre_g)]
            near = max((a.abs()[f].max().item() for a, f in
                        zip(pre_c, flips) if f.any()), default=0.0)
            res["relu_flips_per_layer"] = [int(f.sum()) for f in flips]
            print(f"  {mode} seq {S}: ReLU units active on one device and "
                  f"not the other, per layer: {res['relu_flips_per_layer']}"
                  f" (largest |pre-activation| among them {near:.2e}, of "
                  f"max {max(a.abs().max().item() for a in pre_c):.2e})")
        if S > Q_CHUNK:
            ffn = forced_relu_ffn(torch, G, [a > 0 for a in pre_c])
            _, _, gf, _ = step("cuda", toks, c, S, ffn)
            worst, fro = leaf_rel(gc, gf)
            res.update(forced_worst_leaf_rel=worst,
                       forced_worst_leaf_frobenius_rel=fro)
            print(f"  {mode} seq {S}, the card's step with the CPU's ReLU "
                  f"masks: worst leaf max|dgrad|/max|grad| {worst:.2e}, "
                  f"relative Frobenius {fro:.2e} (tol 1e-3)")
        check(worst <= 1e-3,
              f"{mode} seq {S}: card and CPU gradients disagree")
        out[f"{mode} seq {S}"] = res
    del params
    return out


# ---------------------------------------------------------------------------
# phase 9: rematerialisation at full width
# ---------------------------------------------------------------------------

REMAT = dict(batch=8, seq=1024, warmup=2, timed=4)


def remat_per_step(remat: str, mode: str, seq: int) -> dict:
    """Launches per train step under ``remat``: "block" and "full"
    recompute each layer in the backward, so its forward kernels run
    twice; the backward kernels once."""
    return train_per_step(mode, seq, forwards=1 if remat == "none" else 2)


def step_peaks(torch, state, remat: str, seq: int, step_index: int):
    """One more grouped train step from ``state`` with the peak device
    memory of its forward + backward (``loss_and_grads``) apart from the
    peak of the rest (the finite check, clipping and the AdamW update):
    where a mode's peak sits.  In GiB."""
    from repro_torch import configs
    from repro_torch.core.config import TrainConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.serving.engine import serve_config
    from repro_torch.training import train_step as ts
    cfg = serve_config(configs.get_config(ARCH), dispatch="grouped")
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=1,
                       total_steps=step_index + 1, remat=remat)
    batch = SyntheticLM(cfg, REMAT["batch"], seq, seed=0,
                        device=CARD).next_batch(step_index)
    real, peaks = ts.loss_and_grads, {}

    def measured(*a, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = real(*a, **kw)
        torch.cuda.synchronize()
        peaks["forward_backward_gib"] = (torch.cuda.max_memory_allocated()
                                         / 2 ** 30)
        torch.cuda.reset_peak_memory_stats()
        return out
    ts.loss_and_grads = measured
    try:
        ts.make_train_step(cfg, tcfg)(state, batch, step=step_index)
    finally:
        ts.loss_and_grads = real
    torch.cuda.synchronize()
    peaks["update_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return peaks


def phase_remat(torch, smi):
    """The paper's model through ``launch.train.run`` at batch 8 x seq
    1024, ``grouped``, once per remat mode from the same seeded state: 2
    warm-up + 4 timed steps.  Every metric and every parameter after the
    steps bitwise equal across the modes; launch counts exactly as the
    mode implies; the median step and the peak memory per mode."""
    from repro_torch import tree
    from repro_torch.launch import train
    B, S = REMAT["batch"], REMAT["seq"]
    steps = REMAT["warmup"] + REMAT["timed"]
    names = [k for k, _, _ in COUNTERS]
    print(f"phase 9: remat at full width, batch {B} x seq {S}, grouped, "
          f"{REMAT['warmup']} warm-up + {REMAT['timed']} timed AdamW steps "
          f"per mode; params and metrics bitwise equal across modes")
    out, ref = {}, None
    for remat in ("none", "block", "full"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        stats = {}
        reset_counts()
        state, history = train.run(ARCH, steps=steps, batch=B, seq=S,
                                   smoke=False, seed=0, log_every=100,
                                   dispatch="grouped", remat=remat,
                                   device=CARD, stats=stats)
        counts = read_counts(names)
        peak = torch.cuda.max_memory_allocated()
        want = {k: v * steps
                for k, v in remat_per_step(remat, "grouped", S).items()}
        timed = stats["step_s"][REMAT["warmup"]:]
        med = statistics.median(timed)
        print(f"  [{smi}] remat={remat}: median step {1e3 * med:.3f} ms (of "
              f"{len(timed)} timed; min {1e3 * min(timed):.3f}, max "
              f"{1e3 * max(timed):.3f}), peak memory "
              f"{peak / 2 ** 30:.3f} GiB, launches {counts}")
        check(counts == want, f"remat={remat}: launch counts {counts} != "
                              f"{want} ({steps} steps)")
        bad = [(h["step"], k) for h in history for k, v in h.items()
               if not math.isfinite(v)]
        check(not bad, f"remat={remat}: non-finite metrics {bad}")
        check(all(h["skipped"] == 0 for h in history),
              f"remat={remat}: a step was skipped")
        # the first mode's params wait on the host, so that no mode's peak
        # memory holds them
        leaves = [p.detach().cpu() for p in tree.leaves(state.params)]
        if ref is None:
            ref = (history, leaves)
        else:
            check(history == ref[0], f"remat={remat}: metrics differ from "
                                     f"remat=none")
            same = all(torch.equal(a, b) for a, b in zip(ref[1], leaves,
                                                         strict=True))
            check(same, f"remat={remat}: params differ from remat=none")
        peaks = step_peaks(torch, state, remat, S, steps)
        print(f"    one more step: peak {peaks['forward_backward_gib']:.3f} "
              f"GiB in the forward + backward, {peaks['update_gib']:.3f} "
              f"GiB in the update")
        out[remat] = dict(step_ms_median=1e3 * med,
                          step_ms=[1e3 * t for t in stats["step_s"]],
                          peak_gib=peak / 2 ** 30, launches=counts, **peaks)
        del state, leaves
    print("  params and every metric bitwise equal across none/block/full")
    del ref
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 10: crash and resume at full width
# ---------------------------------------------------------------------------

RESUME = dict(batch=8, seq=512, steps=6, every=3, crash=5)


def _train_cli(tmp, *extra):
    """The smoke trainer through its CLI in a subprocess (on the card)."""
    import os
    import subprocess
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
           "--smoke", "--steps", "8", "--batch", "2", "--seq", "16",
           "--log-every", "100", *extra]
    return subprocess.run(cmd, cwd=tmp, env=env, capture_output=True,
                          text=True, timeout=300)


def phase_resume(torch, smi):
    """Crash-safe checkpoint and resume of the paper's model at seq 512,
    ``grouped``: an uninterrupted 6-step run; a run saving every 3 steps
    (keep 1) that crashes at the top of step 5 (``train.loop:raise@5``);
    its resume from step 3 — steps 3-5 bitwise the uninterrupted run's in
    every metric, and the final params and moments too.  Then a
    ``train.grads:nan@1`` step: skipped, params and moments bitwise
    unchanged, and no host wait.  Then SIGKILL inside a save
    (``ckpt.data_tmp_written:kill@6``) at the smoke config through the
    CLI, resumed bitwise.  The npz size, the save and restore seconds and
    the free disk space are printed; the temp directories are removed."""
    import json as json_mod
    import os
    import shutil
    import signal
    import tempfile
    from repro_torch import configs, tree
    from repro_torch.core import faults
    from repro_torch.core.config import TrainConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.serving.engine import serve_config
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)
    B, S, steps = RESUME["batch"], RESUME["seq"], RESUME["steps"]
    kw = dict(batch=B, seq=S, smoke=False, seed=0, log_every=100,
              dispatch="grouped", device=CARD)
    keys = ("loss", "ce", "aux", "grad_norm", "lr", "skipped",
            "nonfinite_streak", "loss_scale")
    print(f"phase 10: crash and resume at full width, batch {B} x seq {S}, "
          f"grouped, {steps} steps, a save every {RESUME['every']} (keep "
          f"1), train.loop:raise@{RESUME['crash']}; bitwise")
    ref_state, ref = train.run(ARCH, steps=steps, **kw)
    ref_bits = [t.detach().clone() for t in tree.leaves(
        (ref_state.params, ref_state.opt))]
    del ref_state
    out = {}
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        free = shutil.disk_usage(d).free
        print(f"  checkpoint dir {d}: {free / 2 ** 30:.1f} GiB free before "
              f"the first save")
        plan = faults.plan_from_specs([f"train.loop:raise@{RESUME['crash']}"])
        crashed = {}
        raised = None
        try:
            train.run(ARCH, steps=steps, ckpt_dir=d,
                      ckpt_every=RESUME["every"], ckpt_keep=1, faults=plan,
                      stats=crashed, **kw)
        except faults.FaultInjected as e:       # the injected preemption
            raised = e
        check(raised is not None, "train.loop:raise did not fire")
        npz = os.path.join(d, f"ckpt_{RESUME['every']:08d}.npz")
        size = os.path.getsize(npz)
        resumed = {}
        state, res = train.run(ARCH, steps=steps, ckpt_dir=d, ckpt_keep=1,
                               resume=True, stats=resumed, **kw)
        check([h["step"] for h in res] == list(range(RESUME["every"],
                                                      steps)),
              f"resume replayed steps {[h['step'] for h in res]}")
        diff = [(h["step"], k) for h, g in zip(res, ref[RESUME["every"]:])
                for k in keys if h[k] != g[k]]
        check(not diff, f"resumed metrics differ from the uninterrupted run: "
                        f"{diff}")
        same = all(torch.equal(a, b) for a, b in zip(
            ref_bits, tree.leaves((state.params, state.opt)), strict=True))
        check(same, "resumed params or moments differ from the "
                    "uninterrupted run")
        left = sorted(f for f in os.listdir(d) if f.endswith(".npz"))
        check(left == [f"ckpt_{steps:08d}.npz"],
              f"keep=1 left {left}")
        out.update(npz_bytes=size, free_disk_bytes=free,
                   save_s=crashed["save_s"] + resumed["save_s"],
                   restore_s=resumed["restore_s"])
        print(f"  [{smi}] npz {size} bytes ({size / 2 ** 30:.3f} GiB); save "
              f"{crashed['save_s'][0]:.2f} s (step 3), "
              f"{resumed['save_s'][0]:.2f} s (step 6); restore "
              f"{resumed['restore_s']:.2f} s; steps 3-5 and the final "
              f"params and moments bitwise the uninterrupted run's")
        del state
    finally:
        shutil.rmtree(d, ignore_errors=True)

    # an injected NaN gradient: the step is skipped bitwise, without a wait
    cfg = serve_config(configs.get_config(ARCH), dispatch="grouped")
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=1,
                       total_steps=steps)
    plan = faults.plan_from_specs(["train.grads:nan@1"])
    step = make_train_step(cfg, tcfg, faults=plan)
    state = init_train_state(cfg, tcfg, device=CARD)
    ds = SyntheticLM(cfg, B, S, seed=0, device=CARD)
    state, _ = step(state, ds.next_batch(0), step=0)
    before = [t.detach().clone() for t in tree.leaves((state.params,
                                                       state.opt))]
    batch = ds.next_batch(1)
    got = {}
    waits = host_waits(torch, lambda: got.update(r=step(state, batch,
                                                        step=1)))
    after, m = got["r"]
    same = all(torch.equal(a, b) for a, b in zip(
        before, tree.leaves((after.params, after.opt)), strict=True))
    print(f"  train.grads:nan@1: skipped {float(m['skipped']):.0f}, params "
          f"and moments bitwise unchanged: {same}, host waits {len(waits)} "
          f"{sorted(set(waits))}")
    check(float(m["skipped"]) == 1 and int(after.step) == 2,
          "the NaN step was not counted as skipped")
    check(same, "the skipped step changed params or moments")
    check(not waits, f"the faulted step waits for the device {len(waits)} "
                     f"times")
    out["nan_step_host_waits"] = len(waits)
    del state, after, before, step
    torch.cuda.empty_cache()

    # SIGKILL between the tmp file's fsync and its os.replace, via the CLI
    tmp = tempfile.mkdtemp(prefix="chip_smoke_kill_")
    try:
        ck = os.path.join(tmp, "ckpt")
        t0 = time.perf_counter()
        r = _train_cli(tmp, "--history-out", "ref.json")
        check(r.returncode == 0, f"smoke CLI run failed: {r.stderr[-2000:]}")
        k = _train_cli(tmp, "--ckpt-dir", ck, "--ckpt-every", "3",
                       "--inject", "ckpt.data_tmp_written:kill@6")
        check(k.returncode == -signal.SIGKILL,
              f"the kill run ended {k.returncode}, not SIGKILL: "
              f"{k.stderr[-2000:]}")
        r2 = _train_cli(tmp, "--ckpt-dir", ck, "--resume", "--history-out",
                        "res.json")
        check(r2.returncode == 0, f"resume failed: {r2.stderr[-2000:]}")
        check("resumed from step 3" in r2.stdout, r2.stdout[-1000:])
        with open(os.path.join(tmp, "ref.json")) as f:
            want = json_mod.load(f)["history"][3:]
        with open(os.path.join(tmp, "res.json")) as f:
            res = json_mod.load(f)
        check(res["resumed"] and res["start"] == 3, f"history {res}")
        diff = [(h["step"], k) for h, g in zip(res["history"], want)
                for k in ("loss", "ce", "aux", "grad_norm", "lr")
                if h[k] != g[k]]
        check(len(res["history"]) == len(want) and not diff,
              f"SIGKILL resume differs: {diff}")
        print(f"  SIGKILL in the step-6 save (smoke config, CLI on the "
              f"card): resumed from step 3, steps 3-7 bitwise "
              f"({time.perf_counter() - t0:.1f} s for 3 processes)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 11: the gates at full width
# ---------------------------------------------------------------------------

GATES = dict(batch=8, seq=512, steps=3)


def gate_cells():
    """(label, MoEConfig fields, dispatch) of the phase-11 training runs:
    the six plain-torch gates, gshard once more with sort, and
    dense_to_sparse at the start and the end of its anneal."""
    from repro_torch.training.anneal import d2s_temperature
    t0, t1 = d2s_temperature(0), d2s_temperature(1000)
    return (("gshard", dict(gate="gshard"), "grouped"),
            ("gshard", dict(gate="gshard"), "sort"),
            ("ktop1 P=4", dict(gate="ktop1", num_prototypes=4), "grouped"),
            ("sam G=4 k=2", dict(gate="sam", num_groups=4, top_k=2),
             "grouped"),
            ("base", dict(gate="base"), "grouped"),
            (f"dense_to_sparse k=2 T={t0:g}",
             dict(gate="dense_to_sparse", top_k=2, gumbel_temperature=t0),
             "grouped"),
            (f"dense_to_sparse k=2 T={t1:g}",
             dict(gate="dense_to_sparse", top_k=2, gumbel_temperature=t1),
             "grouped"))


class ArgmaxTape:
    """Stands in for ``torch`` inside ``core/gating.py``: with no tape it
    records every ``argmax`` (its input on the CPU and its output), with
    one it returns the recorded outputs in call order — the gate's
    decisions of another run, its arithmetic this run's."""

    def __init__(self, torch, tape=None):
        self._torch = torch
        self.tape = None if tape is None else list(tape)
        self.calls = []

    def __getattr__(self, name):
        return getattr(self._torch, name)

    def argmax(self, x, dim=None, keepdim=False):
        if self.tape is not None:
            return self.tape.pop(0).to(x.device)
        out = self._torch.argmax(x, dim=dim, keepdim=keepdim)
        self.calls.append((x.detach().cpu(), out.cpu()))
        return out


def near_ties(cpu_calls, card_calls):
    """Each token whose route differs between the two runs' gates, at the
    first argmax that decided differently for it, with that decision's
    margin: the gap between the two choices in the CPU's scores."""
    seen, out = set(), []
    for (x, a), (_, b) in zip(cpu_calls, card_calls, strict=True):
        a, b = a.reshape(x.shape[:-1]), b.reshape(x.shape[:-1])
        for pos in (a != b).nonzero().tolist():
            if pos[0] in seen:
                continue
            seen.add(pos[0])
            row = x[tuple(pos)]
            out.append((pos[0], abs(row[a[tuple(pos)]]
                                    - row[b[tuple(pos)]]).item()))
    return out


# a differing route must sit within rounding of a tie: the gates' scores
# are O(1-10), the two devices' f32 router products over d=2048 terms
# differ by ~1e-6, and Sinkhorn's 8 sweeps carry that forward
TIE_MARGIN = 1e-4


def phase_gates_card_vs_cpu(torch, smi, cells):
    """One MoE layer at full width (512 tokens, f32, grouped) per gate, on
    the card and on the CPU, with the same weights, noise and token ids:
    routes equal except at near-ties (``TIE_MARGIN``).  Then the card
    replays the CPU's decisions — its routing (``ArgmaxTape``) and, as
    phase 8 does, its ReLU masks (``forced_relu_ffn``: a few
    pre-activations lie within f32 rounding of 0 and each flip moves a
    column of an expert's w_up gradient) — and its combine weights,
    output and gradients (x, gate_w, w_up, w_out) are held within 1e-4 of
    their max, phase 8's budget.  ``hash`` runs here with token ids.
    Kernel 1 never launches; the layer's other kernels once per product
    each way."""
    from repro_torch import configs
    from repro_torch.core import gating, moe
    from repro_torch.kernels import grouped_ffn as G
    cfg = configs.get_config(ARCH)
    d, E, f = cfg.d_model, cfg.moe.num_experts, cfg.d_ff
    T = 512
    g = torch.Generator().manual_seed(21)
    params = {"gate_w": torch.randn(d, E, generator=g) * d ** -0.5,
              "w_up": torch.randn(E, d, f, generator=g) * d ** -0.5,
              "w_out": torch.randn(E, f, d, generator=g) * f ** -0.5}
    x = torch.randn(T, d, generator=g)
    r = torch.randn(T, d, generator=g)
    ids = torch.randint(0, cfg.vocab_size, (T,), generator=g)
    want = train_per_step("grouped", T, layers=1) | {"topk_gate": 0}
    layer_cells = [(label, fields) for label, fields, mode in cells
                   if mode == "grouped"] + [("hash", dict(gate="hash"))]
    grouped_matmul, grouped_ffn = G.grouped_matmul, G.grouped_ffn

    def recording(store):
        def fn(lhs, rhs, offsets):
            out = grouped_matmul(lhs, rhs, offsets)
            store.append(out.detach().cpu())
            return out
        return fn
    out = {}
    for label, fields in layer_cells:
        mcfg = dataclasses.replace(cfg.moe, dispatch="grouped", **fields)
        noise = gating.draw_noise(mcfg, (T, E), g)
        tid = ids if mcfg.gate == "hash" else None

        def layer(dev, tape=None, masks=None):
            """(argmax record, gate, launches, ReLU pre-activations,
            [y, combine weights, dx, dgate_w, dw_up, dw_out])."""
            p = {k: v.to(dev, copy=True).requires_grad_(True)
                 for k, v in params.items()}
            xx = x.to(dev, copy=True).requires_grad_(True)
            nz = None if noise is None else noise.to(dev)
            tt = None if tid is None else tid.to(dev)
            proxy = ArgmaxTape(torch, tape)
            pre = []
            gating.torch = proxy
            G.grouped_matmul = recording(pre)
            if masks is not None:
                G.grouped_ffn = forced_relu_ffn(torch, G, masks)
            try:
                gate = gating.route(mcfg, gating.router_logits(
                    mcfg, xx, p["gate_w"]), noise=nz, token_ids=tt)
                rec = list(proxy.calls)
                if tape is not None:
                    proxy.tape = list(tape)
                reset_counts()
                y, aux, _ = moe.moe_apply(mcfg, p, xx, num_experts=E,
                                          act=cfg.act, noise=nz,
                                          token_ids=tt)
                ((y * r.to(dev)).sum() + aux).backward()
                counts = read_counts(list(want))
            finally:
                gating.torch = torch
                G.grouped_matmul, G.grouped_ffn = grouped_matmul, grouped_ffn
            return (rec, gate, counts, pre[::2],
                    [t.detach().cpu() for t in (y, gate.combine_weights,
                                                xx.grad, p["gate_w"].grad,
                                                p["w_up"].grad,
                                                p["w_out"].grad)])

        def rel(a_list, b_list):
            names = ("y", "combine_weights", "dx", "dgate_w", "dw_up",
                     "dw_out")
            return {n: ((a - b).abs().max() / a.abs().max().clamp(
                min=1e-30)).item() for n, a, b in zip(names, a_list, b_list)}
        cpu_rec, cpu_gate, _, cpu_pre, cpu_out = layer("cpu")
        card_rec, card_gate, counts, card_pre, card_out = layer(CARD)
        routes = (cpu_gate.expert_index.cpu()
                  != card_gate.expert_index.cpu()).any(-1)
        ties = near_ties(cpu_rec, card_rec)
        worst_tie = max((m for _, m in ties), default=0.0)
        check(int(routes.sum()) == len(ties) and worst_tie <= TIE_MARGIN,
              f"{label}: {int(routes.sum())} routes differ, margins {ties} "
              f"(bound {TIE_MARGIN})")
        check(counts == want, f"{label}: layer launches {counts} != {want}")
        flips = ([int(((a > 0) != (b > 0)).sum())
                  for a, b in zip(cpu_pre, card_pre)]
                 if not routes.any() else None)
        _, _, _, _, forced_out = layer(CARD, [o for _, o in cpu_rec],
                                       [a > 0 for a in cpu_pre])
        plain, forced = rel(cpu_out, card_out), rel(cpu_out, forced_out)
        print(f"  [{smi}] {label} layer, card vs CPU (512 tokens, f32): "
              f"{int(routes.sum())} routes differ {ties} (margin bound "
              f"{TIE_MARGIN}); ReLU units flipped {flips}; launches "
              f"{counts}\n    max|d|/max as run: "
              + ", ".join(f"{n} {v:.2e}" for n, v in plain.items())
              + "\n    with the CPU's routes and ReLU masks: "
              + ", ".join(f"{n} {v:.2e}" for n, v in forced.items())
              + " (tol 1e-4)")
        check(max(forced.values()) <= 1e-4,
              f"{label}: card and CPU layers disagree {forced}")
        out[label] = dict(routes_differ=int(routes.sum()), margins=ties,
                          relu_flips=flips, rel=plain, forced_rel=forced,
                          launches=counts)
    return out


def phase_gates(torch, smi):
    """Each gate (``gate_cells``) through ``launch.train.run``: the paper's
    model at batch 8 x seq 512, 3 AdamW steps; every metric finite, kernel
    1 never launched, the other kernels as the dispatch mode implies per
    step.  ``hash`` through the model path raises (the model passes no
    token ids, as the reference's); then the layer card-vs-CPU checks."""
    from repro_torch.launch import train
    B, S, steps = GATES["batch"], GATES["seq"], GATES["steps"]
    names = [k for k, _, _ in COUNTERS]
    cells = gate_cells()
    print(f"phase 11: the gates at full width, batch {B} x seq {S}, "
          f"{steps} AdamW steps each (the first is the warm-up)")
    out = {}
    for label, fields, mode in cells:
        stats = {}
        reset_counts()
        state, history = train.run(ARCH, steps=steps, batch=B, seq=S,
                                   smoke=False, seed=0, log_every=100,
                                   dispatch=mode, moe=fields, device=CARD,
                                   stats=stats)
        counts = read_counts(names)
        want = {k: (0 if k == "topk_gate" else v * steps)
                for k, v in train_per_step(mode, S).items()}
        med = statistics.median(stats["step_s"][1:])
        cell = f"{label} {mode}"
        print(f"  [{smi}] {cell}: median step {1e3 * med:.3f} ms (steps "
              f"{[round(1e3 * t, 3) for t in stats['step_s']]} ms), losses "
              f"{[round(h['loss'], 4) for h in history]}, launches {counts}")
        check(counts == want, f"{cell}: launch counts {counts} != {want}")
        bad = [(h["step"], k) for h in history for k, v in h.items()
               if not math.isfinite(v)]
        check(not bad, f"{cell}: non-finite metrics {bad}")
        out[cell] = dict(step_ms_median=1e3 * med,
                         step_ms=[1e3 * t for t in stats["step_s"]],
                         losses=[h["loss"] for h in history],
                         launches=counts)
        del state
    raised = None
    try:
        train.run(ARCH, steps=1, batch=B, seq=S, smoke=False, seed=0,
                  dispatch="grouped", moe=dict(gate="hash"), device=CARD)
    except ValueError as e:                     # the expected refusal
        raised = e
    check(raised is not None and "token_ids" in str(raised),
          f"hash through the model path did not raise: {raised!r}")
    print(f"  hash through the model path raises ValueError: {raised}")
    torch.cuda.empty_cache()
    out["layer card vs cpu"] = phase_gates_card_vs_cpu(torch, smi, cells)
    return out


# ---------------------------------------------------------------------------
# phase 12: the presets at full width
# ---------------------------------------------------------------------------

# (arch, layers served — None for the published depth — and why the cut)
PRESETS = (
    ("dbrx-132b", 2, "one layer with the embeddings is 4.49B parameters: "
     "the published 40 do not fit one card"),
    ("llama4-maverick-400b-a17b", 2, "one ('dense', 'moe') period is 18.55B "
     "parameters: the published 24 periods do not fit one card"),
    ("yi-6b", None, None),
    ("starcoder2-3b", None, None))
PRESET_SERVE = dict(batch=8, gen=32, prompts=(512, 1024))


def preset_expect(cfg, mode, prompt_len: int, forwards: int) -> dict:
    """Launches of kernels 1, 2, 3 and 7 in ``forwards`` forwards (1
    prefill + decode steps) of ``cfg`` under dispatch ``mode``: per MoE
    layer per forward the gate once (all k in one launch), the gather once
    (grouped) or twice (sort), the grouped matmul once per expert
    product (3 with a gated MLP) and the scatter-add once (the combine),
    grouped only; the flash forward once per layer in a prefill past
    q_chunk; a dense layer none of 1-3 and 6."""
    n_moe = cfg.block_pattern.count("moe") * cfg.num_super_blocks
    flash = attention_layers(cfg) if prompt_len > Q_CHUNK else 0
    if cfg.moe is None:
        return {"topk_gate": 0, "gather_rows": 0, "grouped_matmul": 0,
                "scatter_add_rows": 0, "flash_fwd": flash}
    mats = 3 if cfg.act in ("swiglu", "geglu") else 2
    grouped = mode == "grouped"
    return {"topk_gate": n_moe * forwards,
            "gather_rows": (1 if grouped else 2) * n_moe * forwards,
            "grouped_matmul": mats * n_moe * forwards if grouped else 0,
            "scatter_add_rows": n_moe * forwards if grouped else 0,
            "flash_fwd": flash}


def attention_layers(cfg) -> int:
    """The layers that attend: all but ``rwkv`` and ``mamba`` ones
    (``mamba_sa`` attends through the shared block)."""
    from repro_torch.models.transformer import layer_kinds
    return sum(k not in ("rwkv", "mamba") for k in layer_kinds(cfg))


STAGING = []          # one pinned host buffer, made on first use


def host_copy(torch, t, chunk: int = 1 << 28):
    """``t.cpu()`` for a tensor on the card, through one pinned buffer of
    ``chunk`` bytes: a copy to pageable memory crawls at ~1.8 GB/s (the
    65 GB of a llama4 block in f32 took 37 s), the pinned copy runs at the
    link's rate and the host copy after it on every core."""
    if STAGING and STAGING[0].numel() != chunk:
        STAGING.clear()
    if not STAGING:
        STAGING.append(torch.empty(chunk, dtype=torch.uint8,
                                   pin_memory=True))
    buf = STAGING[0]
    t = t.detach().contiguous()
    out = torch.empty(t.shape, dtype=t.dtype)
    src = t.reshape(-1).view(torch.uint8)
    dst = out.reshape(-1).view(torch.uint8)
    for i in range(0, src.numel(), chunk):
        n = min(chunk, src.numel() - i)
        buf[:n].copy_(src[i:i + n])
        dst[i:i + n].copy_(buf[:n])
    return out


def mem_available_gib() -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2 ** 20
    return float("nan")


def release(torch):
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_presets(torch, smi):
    """Phase 12: each preset of ``PRESETS`` at its published widths (bf16,
    weights drawn from seed 0 straight into bf16, leaf by leaf) through
    ``Transformer`` → ``serving.engine.generate``, batch 8, 32 new tokens,
    prompts of 512 and 1024, each MoE preset in both dispatch modes, two
    runs per cell: launches as ``preset_expect`` says in each run, greedy
    tokens equal over the two runs, every sampled logits row finite; the
    second run's times.  Then one profiled prompt-1024 prefill and 8
    decode steps per preset (grouped for the MoE ones:
    ``profile_serving``, 0 host waits), and the blocks card against CPU in
    f32 (``phase_presets_card_vs_cpu``).  Each model is released before
    the next is built."""
    from repro_torch import configs
    from repro_torch.models.transformer import Transformer
    from repro_torch.serving import engine
    B, gen = PRESET_SERVE["batch"], PRESET_SERVE["gen"]
    print(f"phase 12: the presets at full width, bf16, batch {B}, {gen} new "
          f"tokens, prompts {PRESET_SERVE['prompts']}, 2 runs per cell "
          f"(times from the second)")
    out, totals = {}, dict.fromkeys(SERVE_KERNELS, 0)
    for arch, layers, why in PRESETS:
        cfg = configs.get_config(arch)
        reduced = []
        if layers is not None:
            reduced.append(f"num_layers {cfg.num_layers} -> {layers} ({why})")
            cfg = cfg.replace(num_layers=layers)
        release(torch)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = Transformer(cfg, device="cuda", seed=0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        n_params = sum(p.numel() for p in model.parameters())
        weights = torch.cuda.memory_allocated() / 2 ** 30
        print(f"  [{smi}] {arch}: {cfg.num_layers} layers "
              f"{cfg.block_pattern}, {n_params / 1e9:.3f}B parameters, "
              f"weights {weights:.3f} GiB, init {init_s:.1f} s with peak "
              f"{init_peak:.3f} GiB; reduced {reduced}")
        modes = ("grouped", "sort") if cfg.moe is not None else (None,)
        gcpu = torch.Generator().manual_seed(12)
        prompts = {S: torch.randint(0, cfg.vocab_size, (B, S), generator=gcpu)
                   for S in PRESET_SERVE["prompts"]}
        engine.generate(model, prompts[PRESET_SERVE["prompts"][0]], steps=2,
                        dispatch=modes[0])                       # warm-up
        cells = {}
        for mode in modes:
            for S, prompt in prompts.items():
                cell = f"{arch} {mode or 'dense'} prompt {S}"
                release(torch)
                torch.cuda.reset_peak_memory_stats()
                runs = []
                for _ in range(2):
                    st = {}
                    reset_counts()
                    caps = decode_captures()
                    toks = engine.generate(model, prompt, steps=gen,
                                           dispatch=mode, stats=st)
                    counts = read_counts()
                    # the first run captures its step: one warm-up step more
                    caps = decode_captures() - caps
                    want = preset_expect(cfg, mode, S, gen + caps)
                    runs.append((toks.cpu(), st, counts, caps))
                    check(counts == want,
                          f"{cell}: launches {counts} != expected {want}")
                    check(st["logits_finite"], f"{cell}: non-finite logits")
                    for k in totals:
                        totals[k] += counts[k]
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                toks, st, counts, _ = runs[1]
                check([r[3] for r in runs] == [1, 0],
                      f"{cell}: decode captures per run "
                      f"{[r[3] for r in runs]}, not [1, 0]")
                check(tuple(toks.shape) == (B, S + gen),
                      f"{cell}: output shape {tuple(toks.shape)}")
                new = toks[:, S:]
                check(bool(((new >= 0) & (new < cfg.vocab_size)).all()),
                      f"{cell}: generated ids out of range")
                same = torch.equal(runs[0][0], toks)
                check(same, f"{cell}: greedy tokens differ between two runs")
                decode_ms = 1e3 * st["decode_s"] / st["decode_steps"]
                tok_s = B * gen / (st["prefill_s"] + st["decode_s"])
                print(f"  [{smi}] {cell}: prefill "
                      f"{1e3 * st['prefill_s']:.3f} ms (first run "
                      f"{1e3 * runs[0][1]['prefill_s']:.3f}), decode "
                      f"{decode_ms:.3f} ms/step, {tok_s:.1f} tokens/s, peak "
                      f"memory {peak:.3f} GiB, greedy tokens equal over 2 "
                      f"runs={same}, launches {counts}")
                cells[cell] = dict(prefill_ms=1e3 * st["prefill_s"],
                                   decode_ms_per_step=decode_ms,
                                   tokens_per_s=tok_s, peak_gib=peak,
                                   launches=counts)
                engine.clear_step_cache(model)    # free the cell's caches
        stamp(f"{arch}'s cells")
        profile = profile_serving(torch, smi, model, cfg, modes[0], 1024,
                                  B, name=f"{arch} ")
        stamp(f"{arch}'s profile")
        graph = decode_graph_vs_eager(
            torch, smi, model, engine.serve_config(cfg, dispatch=modes[0]),
            B, 1024, f"{arch} {modes[0] or 'dense'} prompt 1024")
        out[arch] = dict(layers=cfg.num_layers, params=n_params,
                         weights_gib=weights, init_s=init_s,
                         init_peak_gib=init_peak, reduced=reduced,
                         cells=cells, profile=profile, graph_vs_eager=graph)
        engine.clear_step_cache(model)      # the cache holds the model
        stamp(f"{arch} served")
        del model
    release(torch)
    out["card vs cpu"] = phase_presets_card_vs_cpu(torch, smi)
    stamp("phase 12 card vs CPU")
    return totals, out


class GateTape:
    """Stands in for ``topk_gate.fused_topk_gate``: with no tape it records
    each call's logits (on the CPU) and chosen experts; with one it runs
    the gate as usual (the kernel launches on the card) and hands back the
    recorded experts instead — another run's routes, this run's
    arithmetic.  The MoE layer reads only the experts and the row max of
    the gate (``ops.topk_softmax_weights``)."""

    def __init__(self, fn, tape=None):
        self.fn = fn
        self.tape = None if tape is None else list(tape)
        self.calls = []

    def __call__(self, logits, k):
        vals, idx, rowmax, sumexp = self.fn(logits, k)
        if self.tape is not None:
            idx = self.tape.pop(0).to(idx.device)
        else:
            self.calls.append((logits.cpu(), idx.cpu()))
        return vals, idx, rowmax, sumexp


def gate_near_ties(cpu_calls, card_calls):
    """Each token whose experts differ between the two runs' gates, with
    the margin of the first pick that differs: the gap between the two
    choices in the CPU's logits."""
    out = []
    for (x, a), (_, b) in zip(cpu_calls, card_calls, strict=True):
        for r in (a != b).any(-1).nonzero().flatten().tolist():
            j = int((a[r] != b[r]).nonzero()[0])
            out.append((r, abs(x[r, a[r, j]] - x[r, b[r, j]]).item()))
    return out


def phase_presets_card_vs_cpu(torch, smi):
    """Phase 12, card against CPU at full width in f32, 64 tokens: one
    dbrx-132b ``moe`` block (attention + the MoE FFN, 3.26B weights,
    13 GB on each side) and one llama4 ``moe`` block (attention, 128
    routed experts and the shared expert, 16.3B weights, 65 GB on each
    side), each in both dispatch modes, one llama4 ``dense`` block and the
    llama4 ``moe`` block's shared expert alone; each output within 1e-4
    of its max.  Where a near-tie (within ``TIE_MARGIN`` in the CPU's
    router logits) sends a token elsewhere on the card, the card's block
    is run again with the CPU's routes (``GateTape``) and that run is
    held to the budget; routes that differ elsewhere fail.  The weights
    are drawn on the card and copied to the CPU, one block at a time."""
    from repro_torch import configs, tree
    from repro_torch.kernels import topk_gate as K
    from repro_torch.models import layers
    from repro_torch.models.transformer import block_forward, init_block
    from repro_torch.serving.engine import serve_config
    S = 64
    print(f"phase 12 (card vs CPU): host MemAvailable "
          f"{mem_available_gib():.1f} GiB; f32, {S} tokens; tolerance: "
          f"max|card - cpu| <= 1e-4 * max|cpu|")
    gd = torch.Generator(device="cuda").manual_seed(31)
    out = {}

    def compare(label, cpu, card, extra=""):
        diff = (cpu - card).abs().max().item()
        scale = cpu.abs().max().item()
        rel = diff / scale
        print(f"  [{smi}] {label}: max|card - cpu| {diff:.3e}, "
              f"/ max|cpu| {rel:.3e} (tol 1e-4){extra}")
        check(math.isfinite(rel) and rel <= 1e-4,
              f"{label}: card and CPU disagree ({rel:.3e})")
        return rel

    def block_params(cfg, kind):
        return init_block(cfg, kind, gd, device="cuda")

    def run_block(p, x, cfg, kind="moe"):
        with torch.inference_mode():
            pos = torch.arange(S, dtype=torch.int32, device=x.device)
            y, _, _ = block_forward(p, x, cfg, kind=kind, positions=pos)
        return y.cpu()

    # one moe block of each MoE preset, both dispatch modes
    fused = K.fused_topk_gate
    for arch, short in (("dbrx-132b", "dbrx"),
                        ("llama4-maverick-400b-a17b", "llama4")):
        cfg = configs.get_config(arch).replace(dtype="float32")
        t0 = time.perf_counter()
        p_card = block_params(cfg, "moe")
        p_cpu = tree.map_(lambda t: host_copy(torch, t), p_card)
        n = sum(t.numel() for t in tree.leaves(p_cpu))
        x = torch.randn((1, S, cfg.d_model), generator=gd, device="cuda")
        print(f"  {short} moe block: {n / 1e9:.3f}B f32 weights on both "
              f"devices in {time.perf_counter() - t0:.1f} s; host "
              f"MemAvailable {mem_available_gib():.1f} GiB")
        for mode in ("grouped", "sort"):
            c = serve_config(cfg, dispatch=mode)
            try:
                K.fused_topk_gate = cpu_tape = GateTape(fused)
                y_cpu = run_block(p_cpu, x.cpu(), c)
                K.fused_topk_gate = card_tape = GateTape(fused)
                reset_counts()
                y_card = run_block(p_card, x, c)
                counts = read_counts()
                ties = gate_near_ties(cpu_tape.calls, card_tape.calls)
                replay = None
                if ties:
                    K.fused_topk_gate = GateTape(fused, [i for _, i in
                                                         cpu_tape.calls])
                    replay = run_block(p_card, x, c)
            finally:
                K.fused_topk_gate = fused
            want = preset_expect(cfg.replace(block_pattern=("moe",),
                                             num_layers=1), mode, S, 1)
            check(counts == want, f"{short} block {mode}: launches {counts} "
                                  f"!= {want}")
            worst = max((m for _, m in ties), default=0.0)
            check(worst <= TIE_MARGIN, f"{short} block {mode}: routes "
                                       f"differ beyond a near-tie {ties}")
            rel = compare(f"{arch} moe block {mode}", y_cpu,
                          y_card if replay is None else replay,
                          f"; routes differing {ties} (margin bound "
                          f"{TIE_MARGIN}){' replayed' if ties else ''}; "
                          f"launches {counts}")
            out[f"{short} moe block {mode}"] = dict(rel=rel, ties=ties,
                                                    launches=counts)
        del p_card, p_cpu
        release(torch)
    # llama4: one dense block, and the moe block's shared expert
    cfg = configs.get_config("llama4-maverick-400b-a17b").replace(
        dtype="float32")
    p_card = block_params(cfg, "dense")
    p_cpu = tree.map_(lambda t: host_copy(torch, t), p_card)
    x = torch.randn((1, S, cfg.d_model), generator=gd, device="cuda")
    out["llama4 dense block"] = dict(rel=compare(
        "llama4 dense block (qk-norm, GQA 40:8, SwiGLU d_ff 8192)",
        run_block(p_cpu, x.cpu(), cfg, "dense"),
        run_block(p_card, x, cfg, "dense")))
    f = cfg.moe.d_ff_expert * cfg.moe.num_shared_experts
    shared = layers.init_mlp(gd, cfg.d_model, f, cfg.act, device="cuda")
    shared_cpu = tree.map_(lambda t: host_copy(torch, t), shared)
    with torch.inference_mode():
        ys = [layers.apply_mlp(sp, xx, cfg.act).cpu()
              for sp, xx in ((shared_cpu, x.cpu()), (shared, x))]
    out["llama4 shared expert"] = dict(rel=compare(
        f"llama4 moe block's shared expert (SwiGLU, {f} wide)", *ys))
    del p_card, p_cpu, shared, shared_cpu
    STAGING.clear()
    release(torch)
    return out


# ---------------------------------------------------------------------------
# phase 13: the windowed presets, whole
# ---------------------------------------------------------------------------

WINDOWED = ("gemma2-9b", "h2o-danube-3-4b")
# batch, and (prompt, new tokens) of the cells: 8064 + 128 fills both
# models' 8192 context and overflows the 4096-slot rings in the prefill;
# 4064 + 64 wraps them at decode step 32
WINDOWED_SERVE = dict(batch=WINDOWED_B, cells=((WINDOWED_S, 128),
                                               (4064, 64)))
# ring against linear caches: greedy tokens that differ must be near-ties,
# within the logits' bound: RING_BOUND * max|logit| (16 bf16 ulps of the
# largest logit; the two runs sum each decode step's softmax and p v over
# the slots in other orders, and a 1-ulp flip of a bf16 p or o in one of
# 24 layers moves the logits by a few ulps)
RING_BOUND = 2.0 ** -4


def cache_lengths(cfg, cache_len: int):
    """The layers' cache lengths, as ``Transformer.init_caches`` sizes
    them (a ring where that is the window)."""
    from repro_torch.models.transformer import block_window, layer_kinds
    wins = {block_window(kind, cfg) for kind in layer_kinds(cfg)}
    return sorted({cache_len if w is None else min(cache_len, w)
                   for w in wins})


def phase_windowed(torch, smi):
    """Phase 13: ``gemma2-9b`` (42 layers, local/global, d=256, softcaps)
    and ``h2o-danube-3-4b`` (24 layers, window 4096, d=120) whole, bf16,
    weights drawn from seed 0 straight into bf16, through ``Transformer``
    → ``serving.engine.generate``, batch 4, prompts 8064 + 128 new tokens
    and 4064 + 64, two runs per cell: the flash forward once per layer per
    prefill and no other kernel, greedy tokens equal over the two runs,
    every sampled logits row finite; the second run's times.  Then one
    profiled prefill of 8064 tokens and 8 decode steps per preset (0 host
    waits), danube's ring caches against linear ones
    (``ring_vs_linear``), and the blocks card against CPU in f32
    (``phase_windowed_card_vs_cpu``)."""
    from repro_torch import configs
    from repro_torch.models.transformer import Transformer
    from repro_torch.serving import engine
    B = WINDOWED_SERVE["batch"]
    print(f"phase 13: the windowed presets whole, bf16, batch {B}, cells "
          f"(prompt, new tokens) {WINDOWED_SERVE['cells']}, 2 runs per cell "
          f"(times from the second)")
    out, totals = {}, dict.fromkeys(SERVE_KERNELS, 0)
    for arch in WINDOWED:
        cfg = configs.get_config(arch)
        release(torch)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = Transformer(cfg, device="cuda", seed=0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        n_params = sum(p.numel() for p in model.parameters())
        weights = torch.cuda.memory_allocated() / 2 ** 30
        print(f"  [{smi}] {arch}: {cfg.num_layers} layers "
              f"{cfg.block_pattern}, head dim {cfg.head_dim}, "
              f"{n_params / 1e9:.3f}B parameters, weights {weights:.3f} GiB, "
              f"init {init_s:.1f} s with peak {init_peak:.3f} GiB")
        gcpu = torch.Generator().manual_seed(13)
        prompts = {S: torch.randint(0, cfg.vocab_size, (B, S), generator=gcpu)
                   for S, _ in WINDOWED_SERVE["cells"]}
        engine.generate(model, prompts[WINDOWED_S][:, :600], steps=2)
        cells = {}
        for S, gen in WINDOWED_SERVE["cells"]:
            cell = f"{arch} prompt {S} + {gen}"
            lens = cache_lengths(cfg, S + gen)
            release(torch)
            torch.cuda.reset_peak_memory_stats()
            runs = []
            for _ in range(2):
                st = {}
                reset_counts()
                caps = decode_captures()
                toks = engine.generate(model, prompts[S], steps=gen, stats=st)
                counts = read_counts()
                caps = decode_captures() - caps
                want = preset_expect(cfg, None, S, gen + caps)
                runs.append((toks.cpu(), st, counts, caps))
                check(counts == want,
                      f"{cell}: launches {counts} != expected {want}")
                check(st["logits_finite"], f"{cell}: non-finite logits")
                for k in totals:
                    totals[k] += counts[k]
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            toks, st, counts, _ = runs[1]
            check([r[3] for r in runs] == [1, 0],
                  f"{cell}: decode captures per run {[r[3] for r in runs]}, "
                  f"not [1, 0]")
            check(tuple(toks.shape) == (B, S + gen),
                  f"{cell}: output shape {tuple(toks.shape)}")
            new = toks[:, S:]
            check(bool(((new >= 0) & (new < cfg.vocab_size)).all()),
                  f"{cell}: generated ids out of range")
            same = torch.equal(runs[0][0], toks)
            check(same, f"{cell}: greedy tokens differ between two runs")
            decode_ms = 1e3 * st["decode_s"] / st["decode_steps"]
            tok_s = B * gen / (st["prefill_s"] + st["decode_s"])
            prefill_tok_s = B * S / st["prefill_s"]
            print(f"  [{smi}] {cell}: prefill {1e3 * st['prefill_s']:.3f} ms "
                  f"({prefill_tok_s:.1f} prompt tokens/s; first run "
                  f"{1e3 * runs[0][1]['prefill_s']:.3f}), decode "
                  f"{decode_ms:.3f} ms/step, {tok_s:.1f} generated tokens/s, "
                  f"peak memory {peak:.3f} GiB, cache lengths {lens} (rings "
                  f"of {sorted(set(lens) - {S + gen})}), greedy tokens equal "
                  f"over 2 runs={same}, launches {counts}")
            cells[cell] = dict(prefill_ms=1e3 * st["prefill_s"],
                               decode_ms_per_step=decode_ms,
                               tokens_per_s=tok_s,
                               prefill_tokens_per_s=prefill_tok_s,
                               peak_gib=peak, launches=counts,
                               cache_lengths=lens)
            engine.clear_step_cache(model)        # free the cell's caches
        stamp(f"{arch}'s cells")
        profile = profile_serving(torch, smi, model, cfg, None, WINDOWED_S,
                                  B, name=f"{arch} ")
        stamp(f"{arch}'s profile")
        graph = decode_graph_vs_eager(torch, smi, model, cfg, B, WINDOWED_S,
                                      f"{arch} prompt {WINDOWED_S}")
        stamp(f"{arch}'s graph against eager")
        out[arch] = dict(layers=cfg.num_layers, params=n_params,
                         weights_gib=weights, init_s=init_s,
                         init_peak_gib=init_peak, cells=cells,
                         profile=profile, graph_vs_eager=graph)
        if arch == "h2o-danube-3-4b":       # the cell whose rings wrap
            S, gen = WINDOWED_SERVE["cells"][1]
            out["ring vs linear"] = ring_vs_linear(
                torch, smi, model, cfg, prompts[S], gen)
        engine.clear_step_cache(model)      # the cache holds the model
        stamp(f"{arch} served")
        del model
    release(torch)
    out["card vs cpu"] = phase_windowed_card_vs_cpu(torch, smi)
    stamp("phase 13 card vs CPU")
    return totals, out


def ring_vs_linear(torch, smi, model, cfg, prompt, steps):
    """Greedy decode of ``steps`` tokens after ``prompt`` through the
    served caches (rings of the window's 4096 slots, which wrap at step
    4096 - S) and through linear caches of the full length under the same
    window, the linear run fed the ring run's tokens, so that every step's
    logits compare: max|ring - linear| <= RING_BOUND * max|linear|, and a
    step whose two argmaxes differ must be a near-tie within that bound in
    the linear run's logits."""
    from repro_torch.models import attention as attn_lib
    B, S = prompt.shape
    L = S + steps
    prompt = prompt.to(model.device)

    def run(caches, feed=None):
        with torch.inference_mode():
            h, _, caches = model.forward(prompt, caches=caches)
            outs = [model.logits_from_hidden(h[:, -1:])[:, -1].float()]
            toks = []
            for i in range(steps - 1):
                tok = (outs[-1].argmax(-1, keepdim=True) if feed is None
                       else feed[i])
                toks.append(tok)
                lg, caches = model.decode_step(tok, caches)
                outs.append(lg[:, -1].float())
        return torch.stack(outs), toks, caches

    ring, toks, rc = run(model.init_caches(B, L))
    linear, _, lc = run([attn_lib.init_cache(cfg.attention, B, L,
                                             cfg.d_model, model.dtype,
                                             model.device)
                         for _ in model.blocks], feed=toks)
    check({c["k"].shape[1] for c in rc} == {cfg.attention.window}
          and {c["k"].shape[1] for c in lc} == {L},
          f"ring vs linear: cache lengths {rc[0]['k'].shape[1]}, "
          f"{lc[0]['k'].shape[1]}")
    scale = linear.abs().max().item()
    diff = (ring - linear).abs().max().item()
    a, b = ring.argmax(-1), linear.argmax(-1)
    differ = (a != b).nonzero().tolist()
    margins = [(linear[i, r, b[i, r]] - linear[i, r, a[i, r]]).item()
               for i, r in differ]
    wraps = cfg.attention.window - S
    print(f"  [{smi}] ring vs linear ({cfg.name}, prompt {S}, {steps} "
          f"steps, the rings wrap at step {wraps}): max|ring - linear| "
          f"{diff:.4e} / max|logit| {scale:.4e} = {diff / scale:.4e} (bound "
          f"{RING_BOUND:g}); greedy choices differing at (step, row) "
          f"{differ} with margins {margins} (near-tie bound "
          f"{RING_BOUND * scale:.4e})")
    check(diff <= RING_BOUND * scale,
          f"ring vs linear: logits differ by {diff:.4e}")
    check(all(m <= RING_BOUND * scale for m in margins),
          f"ring vs linear: greedy tokens differ beyond a near-tie "
          f"{list(zip(differ, margins))}")
    return dict(max_abs_diff=diff, max_abs_logit=scale, bound=RING_BOUND,
                differing=differ, margins=margins, wraps_at_step=wraps)


def phase_windowed_card_vs_cpu(torch, smi):
    """Phase 13, card against CPU at full width in f32, batch 1, prompt
    640 (past q_chunk: the flash forward, once): one gemma2 ``local``
    block (window 4096, softcap 50, d=256, GeGLU), one ``global`` block
    and one h2o-danube3 block (window 4096, d=120); each output within
    1e-4 of its max.  The weights are drawn on the card and copied to the
    CPU, whose flash path is the plain version."""
    from repro_torch import configs, tree
    from repro_torch.models.transformer import block_forward, init_block
    S = 640
    print(f"phase 13 (card vs CPU): f32, batch 1, prompt {S} (the flash "
          f"path); tolerance max|card - cpu| <= 1e-4 * max|cpu|")
    gd = torch.Generator(device="cuda").manual_seed(37)
    out = {}
    for arch, kind in (("gemma2-9b", "local"), ("gemma2-9b", "global"),
                       ("h2o-danube-3-4b", "attn")):
        cfg = configs.get_config(arch).replace(dtype="float32")
        p_card = init_block(cfg, kind, gd, device="cuda")
        p_cpu = tree.map_(lambda t: t.cpu(), p_card)
        x = torch.randn((1, S, cfg.d_model), generator=gd, device="cuda")
        ys = []
        for p, xx in ((p_cpu, x.cpu()), (p_card, x)):
            reset_counts()
            with torch.inference_mode():
                pos = torch.arange(S, dtype=torch.int32, device=xx.device)
                y, _, _ = block_forward(p, xx, cfg, kind=kind, positions=pos)
            ys.append(y.cpu())
        counts = read_counts(("flash_fwd",))
        check(counts == {"flash_fwd": 1},
              f"{arch} {kind} block: launches {counts}")
        diff = (ys[0] - ys[1]).abs().max().item()
        scale = ys[0].abs().max().item()
        rel = diff / scale
        label = f"{arch} {kind} block (d={cfg.head_dim})"
        print(f"  [{smi}] {label}: max|card - cpu| {diff:.3e}, / max|cpu| "
              f"{rel:.3e} (tol 1e-4); flash launches on the card {counts}")
        check(math.isfinite(rel) and rel <= 1e-4,
              f"{label}: card and CPU disagree ({rel:.3e})")
        out[label] = dict(rel=rel)
        del p_card, p_cpu
        release(torch)
    return out


# ---------------------------------------------------------------------------
# phase 14: the windowed presets trained at full width
# ---------------------------------------------------------------------------

# (preset, layers trained): every width, window and cap as published, the
# depth cut to fit one card's 80 GB.  An AdamW step holds for a moment
# the old and the new f32 params and moments, the f32 grads and the skip
# guard's torch.where copies: ~40 bytes a parameter, not the state's 16,
# so danube's 3.96B (24 layers) and gemma2's 9.24B (42) do not train
# whole on one card.  Danube at 8 of 24 layers: 1.49B parameters;
# gemma2 at one ("local", "global") period, 2 of 42: 1.31B, of which
# 0.92B the tied 256000 x 3584 embedding.
WINDOWED_TRAIN_RUNS = (("h2o-danube-3-4b", 8), ("gemma2-9b", 2))
WINDOWED_TRAIN_STEPS = dict(warmup=2, timed=8)
# a block of each kind card against CPU, f32, forward + backward at this
# length (past q_chunk: the flash kernels, once each)
WINDOWED_BLOCK_S = 640


def phase_windowed_train(torch, smi):
    """Phase 14: the windowed presets trained at their published widths
    (``WINDOWED_TRAIN_RUNS``: h2o-danube-3-4b at 8 of 24 layers, gemma2-9b
    at one local/global period) at batch ``WINDOWED_TRAIN_B`` x seq
    ``WINDOWED_TRAIN_S`` (the models' context: the window of 4096 acts on
    every windowed layer), f32 masters, bf16 compute, remat none,
    seeded weights and data, through ``make_train_step`` (the depth cut
    through ``cfg.replace(num_layers=)``), 2 warm-up + 8 timed AdamW
    steps: every metric finite, no step skipped, launches exactly the
    flash forward, dq and dk/dv once per layer and step and no other
    kernel, and no host wait in a step (``torch.cuda.set_sync_debug_mode``);
    step ms, tokens/s and peak memory, and one profiled step.  Then a
    block of each kind card against CPU in f32
    (``windowed_blocks_card_vs_cpu``) and the training CLI on gemma2's
    smoke config at seq 1024 (the flash path at head dim 32) in a
    subprocess on the card.  Returns (launch totals, results)."""
    from repro_torch import configs, tree
    from repro_torch.core.config import TrainConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)
    B, S = WINDOWED_TRAIN_B, WINDOWED_TRAIN_S
    steps = WINDOWED_TRAIN_STEPS["warmup"] + WINDOWED_TRAIN_STEPS["timed"]
    names = [k for k, _, _ in COUNTERS]
    totals = dict.fromkeys(names, 0)
    print(f"phase 14: the windowed presets trained at published widths, "
          f"batch {B} x seq {S}, f32 masters + bf16 compute, remat none, "
          f"{WINDOWED_TRAIN_STEPS['warmup']} warm-up + "
          f"{WINDOWED_TRAIN_STEPS['timed']} timed AdamW steps; depths "
          f"{WINDOWED_TRAIN_RUNS} of 24 and 42 layers: an AdamW step holds "
          f"~40 bytes a parameter (old and new f32 params and moments, f32 "
          f"grads, the skip guard's copies), so neither model trains whole "
          f"on one 80 GB card")
    out = {}
    for arch, layers in WINDOWED_TRAIN_RUNS:
        full = configs.get_config(arch)
        cfg = full.replace(num_layers=layers)
        tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=1,
                           total_steps=steps)
        release(torch)
        torch.cuda.reset_peak_memory_stats()
        step = make_train_step(cfg, tcfg)
        state = init_train_state(cfg, tcfg, device="cuda")
        n_params = sum(p.numel() for p in tree.leaves(state.params))
        ds = SyntheticLM(cfg, B, S, seed=0, device="cuda")
        kinds = sorted(set(cfg.block_pattern))
        print(f"  [{smi}] {arch}: {layers} of {full.num_layers} layers "
              f"{cfg.block_pattern}, head dim {cfg.head_dim}, window "
              f"{cfg.attention.window or cfg.local_window}, "
              f"{n_params / 1e9:.3f}B parameters")
        reset_counts()
        times, history = [], []
        for i in range(steps):
            batch = ds.next_batch(i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch, step=i)
            m = {k: float(v) for k, v in m.items()}
            times.append(time.perf_counter() - t0)
            history.append(m)
        counts = read_counts(names)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        want = dict.fromkeys(names, 0) | {
            k: layers * steps for k in ("flash_fwd", "flash_dq",
                                        "flash_dkv")}
        timed = times[WINDOWED_TRAIN_STEPS["warmup"]:]
        med = statistics.median(timed)
        losses = [h["loss"] for h in history]
        print(f"  [{smi}] {arch} ({layers} layers) B={B} S={S}: median step "
              f"{1e3 * med:.3f} ms (of {len(timed)} timed; min "
              f"{1e3 * min(timed):.3f}, max {1e3 * max(timed):.3f}), "
              f"{B * S / med:.1f} tokens/s, peak memory {peak:.3f} GiB, "
              f"launches {counts}")
        print(f"    loss trajectory {[round(v, 4) for v in losses]}")
        check(counts == want, f"{arch}: training launch counts {counts} != "
                              f"{want} ({steps} steps)")
        bad = [(i, k) for i, h in enumerate(history) for k, v in h.items()
               if not math.isfinite(v)]
        check(not bad, f"{arch}: non-finite metrics {bad}")
        check(all(h["skipped"] == 0 for h in history),
              f"{arch}: a step was skipped")
        for k in counts:
            totals[k] += counts[k]
        waits, prof = profile_train_step(torch, smi, arch, step, state,
                                         ds.next_batch(steps), steps)
        out[arch] = dict(layers=layers, of_layers=full.num_layers,
                         kinds=kinds, params=n_params,
                         step_ms_median=1e3 * med,
                         step_ms=[1e3 * t for t in times],
                         tokens_per_s=B * S / med, peak_gib=peak,
                         losses=losses, launches=counts,
                         host_waits=waits, profile=prof)
        del state, step, ds
        release(torch)
    out["card vs cpu"] = windowed_blocks_card_vs_cpu(torch, smi)
    out["cli"] = windowed_train_cli(smi)
    return totals, out


def profile_train_step(torch, smi, label, step, state, batch, index, *,
                       cuda_only=False):
    """One more train step ``step(state, batch, step=index)`` under
    ``torch.cuda.set_sync_debug_mode`` (``host_waits``: none may remain),
    then one profiled: wall (host clock to a synchronise), the device
    time of all kernels, the idle share, the top 10 kernels.  Returns
    (host waits, profile numbers).  ``cuda_only``: the device's kernels
    only, no host events (a step of ~10^5 host events takes the profiler
    tens of seconds to parse)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    waits = host_waits(torch, lambda: step(state, batch, step=index))
    print(f"    host waits in one more step (sync debug mode): "
          f"{len(waits)} {sorted(set(waits))}")
    check(not waits, f"{label}: a train step made the host wait: {waits}")
    release(torch)
    acts = [ProfilerActivity.CUDA] + ([] if cuda_only
                                      else [ProfilerActivity.CPU])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(state, batch, step=index)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    dev_ms = _device_ms(prof, DeviceType)
    kernels = sorted((e for e in _averages(prof)
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    print(f"  [{smi}] {label} profiled step: wall {wall:.3f} ms, device "
          f"{dev_ms:.3f} ms, idle {1 - dev_ms / wall:.3f}")
    top = []
    for e in kernels[:10]:
        ms = e.self_device_time_total / 1e3
        top.append((e.key[:90], ms, e.count))
        print(f"      {ms:8.3f} ms x{e.count:<4d} {e.key[:90]}")
    del prof
    release(torch)
    return len(waits), dict(wall_ms=wall, device_ms=dev_ms,
                            idle=1 - dev_ms / wall, top=top)


def windowed_blocks_card_vs_cpu(torch, smi):
    """Phase 14, card against CPU at full width in f32: one h2o-danube3
    block (window 4096, d=120), one gemma2 ``local`` and one ``global``
    block (softcap 50, d=256, GeGLU), batch 1, seq ``WINDOWED_BLOCK_S``
    (past q_chunk: the flash forward, dq and dk/dv once each on the card,
    their plain versions on the CPU), forward and backward from the same
    weights, input and cotangent: the output and every gradient leaf (the
    input's and each weight's) within 1e-3 of that leaf's max, phase 8's
    limit.  SwiGLU and GeGLU are smooth, so no activation mask is
    replayed (phase 8's ReLU masks).  At this length the window of 4096
    does not act: phase 2n holds the kernels where it does."""
    from repro_torch import configs, tree
    from repro_torch.models.transformer import block_forward, init_block
    S = WINDOWED_BLOCK_S
    print(f"phase 14 (card vs CPU): f32, batch 1, seq {S}, forward + "
          f"backward of one block; tolerance max|card - cpu| <= 1e-3 * "
          f"max|cpu| per leaf")
    gd = torch.Generator(device="cuda").manual_seed(41)
    out = {}
    for arch, kind in (("h2o-danube-3-4b", "attn"), ("gemma2-9b", "local"),
                       ("gemma2-9b", "global")):
        cfg = configs.get_config(arch).replace(dtype="float32")
        p_card = init_block(cfg, kind, gd, device="cuda")
        x = torch.randn((1, S, cfg.d_model), generator=gd, device="cuda")
        dy = torch.randn((1, S, cfg.d_model), generator=gd, device="cuda")
        results = []
        for dev in ("cpu", "cuda"):
            p = tree.map_(lambda t: t.detach().to(dev).requires_grad_(),
                          p_card)
            xx = x.to(dev).requires_grad_()
            reset_counts()
            pos = torch.arange(S, dtype=torch.int32, device=dev)
            y, _, _ = block_forward(p, xx, cfg, kind=kind, positions=pos)
            leaves = [xx, *tree.leaves(p)]
            grads = torch.autograd.grad(y, leaves, dy.to(dev))
            results.append([t.detach().cpu() for t in (y, *grads)])
            counts = read_counts(("flash_fwd", "flash_dq", "flash_dkv"))
        check(counts == dict.fromkeys(counts, 1),
              f"{arch} {kind} block: launches {counts}")
        worst = 0.0
        for a, b in zip(*results, strict=True):
            scale = a.abs().max().item()
            rel = (a - b).abs().max().item() / max(scale, 1e-30)
            worst = max(worst, rel)
        label = f"{arch} {kind} block (d={cfg.head_dim})"
        print(f"  [{smi}] {label}: output and {len(results[0]) - 1} "
              f"gradient leaves, max over leaves of max|card - cpu| / "
              f"max|cpu| {worst:.3e} (tol 1e-3); launches on the card "
              f"{counts}")
        check(math.isfinite(worst) and worst <= 1e-3,
              f"{label}: card and CPU gradients disagree ({worst:.3e})")
        out[label] = dict(rel=worst)
        del p_card, results
        release(torch)
    return out


def windowed_train_cli(smi):
    """``python -m repro_torch.launch.train --arch gemma2-9b --smoke --seq
    1024 --steps 2`` in a subprocess on the card: exit code 0 and two
    logged steps with finite losses."""
    import os
    import re
    import tempfile
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "gemma2-9b", "--smoke", "--seq", "1024", "--steps", "2",
           "--log-every", "1"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        r = subprocess.run(cmd, cwd=tmp, env=env, capture_output=True,
                           text=True, timeout=300)
    secs = time.perf_counter() - t0
    losses = [float(x) for x in re.findall(r"step +\d+ loss (\S+)",
                                           r.stdout)]
    print(f"  [{smi}] {' '.join(cmd[1:])}: exit {r.returncode} in "
          f"{secs:.1f} s, losses {losses}")
    check(r.returncode == 0 and len(losses) == 2
          and all(math.isfinite(x) for x in losses),
          f"the training CLI on gemma2-9b --smoke --seq 1024 failed:\n"
          f"{r.stdout[-2000:]}\n{r.stderr[-2000:]}")
    return dict(exit=r.returncode, seconds=secs, losses=losses)


# ---------------------------------------------------------------------------
# phase 15: the frontend presets, whole
# ---------------------------------------------------------------------------

# (preset, batch, seq, remat) of the training cells, at the published
# widths and depths: hubert-xlarge on 781 frames, what the wav2vec 2.0
# conv stack makes of a 250,000-sample crop (15.6 s at 16 kHz: fairseq's
# HuBERT pre-training max_sample_size); internvl2-2b at 4096 tokens,
# InternVL2 fine-tuning's max_seq_length
FRONTEND_TRAIN = (("hubert-xlarge", 8, 781, "none"),
                  ("internvl2-2b", 2, 4096, "none"))
FRONTEND_STEPS = dict(warmup=2, timed=8)
# internvl2-2b served through the API: 4 prompts of 12 dynamic 448 px
# tiles and a thumbnail at 256 tokens each (3,328) plus 256 text
# positions, then embedding-fed decode steps
FRONTEND_SERVE = dict(batch=4, prompt=3584, steps=64)
# card against CPU in f32: (preset, layers, seq), batch 1
FRONTEND_CPU = (("hubert-xlarge", 2, 781), ("internvl2-2b", 2, 640))
FLASH_NAMES = ("flash_fwd", "flash_dq", "flash_dkv")
ALL_KERNELS = tuple(k for k, _, _ in COUNTERS)


def phase_frontends(torch, smi):
    """Phase 15: the frontend presets whole, at their published widths and
    depths (f32 masters, bf16 compute, seeded weights and data), trained
    through ``launch.train.run`` (``FRONTEND_TRAIN``), 2 warm-up + 8 timed
    AdamW steps: every metric finite, no step skipped, launches exactly
    the flash forward, dq and dk/dv once per layer and step (hubert's
    non-causal at d=80) and no other kernel; step ms, tokens/s, peak
    memory, host waits and one profiled step (``profile_train_step``).
    Then hubert's inference forward of the same batch to its cluster
    logits (bf16, ``inference_mode``, the second of two runs), and
    internvl2 served through the API (``FRONTEND_SERVE``: a prefill into
    caches, then ``decode_step`` fed (B, 1, d) embeddings; the second of
    two runs, a profile, 0 host waits).  Then card against CPU in f32
    (``frontends_card_vs_cpu``).  Returns (launch totals of the training
    runs, results)."""
    from repro_torch import configs, tree
    from repro_torch.core.config import TrainConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    from repro_torch.training.train_step import make_train_step
    steps = FRONTEND_STEPS["warmup"] + FRONTEND_STEPS["timed"]
    names = ALL_KERNELS
    totals = dict.fromkeys(names, 0)
    print(f"phase 15: the frontend presets whole at published widths, f32 "
          f"masters + bf16 compute, {FRONTEND_STEPS['warmup']} warm-up + "
          f"{FRONTEND_STEPS['timed']} timed AdamW steps through "
          f"launch.train.run: {FRONTEND_TRAIN}")
    out = {}
    for arch, B, S, remat in FRONTEND_TRAIN:
        cfg = configs.get_config(arch)
        release(torch)
        torch.cuda.reset_peak_memory_stats()
        stats = {}
        reset_counts()
        state, history = train.run(arch, steps=steps, batch=B, seq=S,
                                   smoke=False, seed=0, log_every=steps,
                                   remat=remat, device="cuda", stats=stats)
        counts = read_counts(names)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        n_params = sum(p.numel() for p in tree.leaves(state.params))
        want = dict.fromkeys(names, 0) | dict.fromkeys(
            FLASH_NAMES, cfg.num_layers * steps)
        timed = stats["step_s"][FRONTEND_STEPS["warmup"]:]
        med = statistics.median(timed)
        losses = [h["loss"] for h in history]
        label = (f"{arch} ({cfg.num_layers} layers, {n_params / 1e9:.3f}B "
                 f"parameters, head dim {cfg.head_dim}, "
                 f"{'non-causal' if cfg.encoder_only else 'causal'}) B={B} "
                 f"S={S} remat={remat}")
        print(f"  [{smi}] {label}: median step {1e3 * med:.3f} ms (of "
              f"{len(timed)} timed; min {1e3 * min(timed):.3f}, max "
              f"{1e3 * max(timed):.3f}), {B * S / med:.1f} tokens/s, peak "
              f"memory {peak:.3f} GiB ({peak * 2 ** 30 / n_params:.1f} bytes "
              f"a parameter), launches {counts}")
        print(f"    loss trajectory {[round(v, 4) for v in losses]}")
        check(counts == want, f"{arch}: training launch counts {counts} != "
                              f"{want} ({steps} steps)")
        bad = [(h["step"], k) for h in history for k, v in h.items()
               if not math.isfinite(v)]
        check(not bad, f"{arch}: non-finite metrics {bad}")
        check(all(h["skipped"] == 0 for h in history),
              f"{arch}: a step was skipped")
        for k in counts:
            totals[k] += counts[k]
        # the step train.run ran, for one more step under the sync debug
        # mode and one profiled
        tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=max(steps // 10,
                                                                1),
                           total_steps=steps, remat=remat, seed=0)
        ds = SyntheticLM(cfg, B, S, seed=0, device="cuda")
        batch = ds.next_batch(steps)
        waits, prof = profile_train_step(torch, smi, arch,
                                         make_train_step(cfg, tcfg), state,
                                         batch, steps)
        out[arch] = dict(layers=cfg.num_layers, params=n_params, batch=B,
                         seq=S, remat=remat, step_ms_median=1e3 * med,
                         step_ms=[1e3 * t for t in stats["step_s"]],
                         tokens_per_s=B * S / med, peak_gib=peak,
                         bytes_per_param=peak * 2 ** 30 / n_params,
                         losses=losses, launches=counts, host_waits=waits,
                         profile=prof,
                         idle_of_median_step=1 - prof["device_ms"]
                         / (1e3 * med))
        print(f"    device {prof['device_ms']:.3f} ms of the median step "
              f"{1e3 * med:.3f} ms: idle "
              f"{out[arch]['idle_of_median_step']:.3f} (the profiler slows "
              f"the host)")
        params = tree.map_(lambda t: t.detach(), state.params)
        del state
        release(torch)
        if not cfg.has_decode:
            out[arch]["inference"] = encoder_inference(
                torch, smi, T.Transformer(cfg, device="cuda", params=params),
                batch["inputs"])
        del params, batch, ds
        release(torch)
    out["internvl2-2b API"] = serve_frontend(torch, smi, "internvl2-2b")
    release(torch)
    out["card vs cpu"] = frontends_card_vs_cpu(torch, smi)
    return totals, out


def encoder_inference(torch, smi, model, inputs):
    """An encoder-only model's inference forward of ``inputs`` (B, S, d) to
    its (B, S, V) logits in the compute dtype under ``inference_mode``,
    twice: finite logits of that shape, the flash forward once per layer
    past q_chunk, nothing else; the second run's time."""
    cfg = model.cfg
    B, S = inputs.shape[:2]
    runs = []
    for _ in range(2):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            h, _, _ = model.forward(inputs)
            logits = model.logits_from_hidden(h)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0, read_counts(ALL_KERNELS)))
    ms, counts = 1e3 * runs[1][0], runs[1][1]
    want = dict.fromkeys(counts, 0) | {
        "flash_fwd": cfg.num_layers if S > Q_CHUNK else 0}
    finite = bool(torch.isfinite(logits).all())
    print(f"  [{smi}] {cfg.name} inference forward B={B} S={S} -> "
          f"{tuple(logits.shape)} {logits.dtype}: {ms:.3f} ms (first run "
          f"{1e3 * runs[0][0]:.3f}), {B * S / ms * 1e3:.1f} frames/s, "
          f"finite={finite}, launches {counts}")
    check(tuple(logits.shape) == (B, S, cfg.vocab_size) and finite,
          f"{cfg.name} inference: logits {tuple(logits.shape)}, "
          f"finite={finite}")
    check(counts == want, f"{cfg.name} inference: launches {counts} != "
                          f"{want}")
    return dict(ms=ms, first_ms=1e3 * runs[0][0], frames_per_s=B * S / ms
                * 1e3, launches=counts)


def serve_frontend(torch, smi, arch):
    """``arch`` served through the API at ``FRONTEND_SERVE``: weights drawn
    from seed 0 straight into bf16, a prefill of (B, S, d) embeddings from
    ``synthetic_embeddings`` into caches of S + steps, then ``steps``
    ``decode_step``s fed (B, 1, d) embeddings, twice: the flash forward
    once per layer in the prefill and nothing else, every step's logits
    finite; the second run's prefill and per-step decode times, the peak
    memory; then a profiled prefill and decode steps
    (``profile_serving``, 0 host waits)."""
    from repro_torch import configs
    from repro_torch.models.frontend import synthetic_embeddings
    from repro_torch.models.transformer import Transformer
    cfg = configs.get_config(arch)
    B, S, n = (FRONTEND_SERVE[k] for k in ("batch", "prompt", "steps"))
    torch.cuda.reset_peak_memory_stats()
    model = Transformer(cfg, device="cuda", seed=0)
    g = torch.Generator(device="cuda").manual_seed(15)
    prompt = synthetic_embeddings(g, cfg, B, S, device="cuda")
    feed = [synthetic_embeddings(g, cfg, B, 1, device="cuda")
            for _ in range(n)]
    runs = []
    for _ in range(2):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            finite = torch.ones((), dtype=torch.bool, device="cuda")
            caches = model.init_caches(B, S + n)
            h, _, caches = model.forward(prompt, caches=caches)
            finite &= torch.isfinite(model.logits_from_hidden(h[:, -1:])
                                     ).all()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for x in feed:
                logits, caches = model.decode_step(x, caches)
                finite &= torch.isfinite(logits).all()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        runs.append((t1 - t0, (t2 - t1) / n, read_counts(ALL_KERNELS),
                     bool(finite)))
    prefill_s, step_s, counts, finite = runs[1]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = dict.fromkeys(counts, 0) | {"flash_fwd": cfg.num_layers}
    print(f"  [{smi}] {arch} API: prefill {B} x {S} embeddings "
          f"{1e3 * prefill_s:.3f} ms (first run {1e3 * runs[0][0]:.3f}), "
          f"{n} embedding-fed decode steps {1e3 * step_s:.3f} ms/step, "
          f"{B / step_s:.1f} tokens/s in decode, peak memory {peak:.3f} GiB, "
          f"finite={finite}, launches {counts}")
    check(finite and runs[0][3], f"{arch} API: non-finite logits")
    check(counts == want and runs[0][2] == want,
          f"{arch} API: launches {counts} != {want}")
    profile = profile_serving(torch, smi, model, cfg, None, S, B,
                              name=f"{arch} API ")
    return dict(prefill_ms=1e3 * prefill_s, decode_ms_per_step=1e3 * step_s,
                peak_gib=peak, launches=counts, profile=profile)


def frontends_card_vs_cpu(torch, smi):
    """Phase 15, card against CPU in f32 at full width (``FRONTEND_CPU``,
    batch 1, the weights drawn on the card and copied): hubert-xlarge at 2
    of 48 layers over 781 frames (the f32 flash kernels at d=80,
    non-causal) and internvl2-2b at 2 of 24 layers over 640 positions:
    the logits of a forward (internvl2's through ``Transformer``: a
    prefill into caches, then 4 embedding-fed decode steps) within 1e-3 of
    max|logit|; one train step's loss and gradient norm within 1e-4
    relative and every gradient leaf within 1e-3 of its max (phases 8 and
    14's limits).  GELU and SwiGLU are smooth, so no activation mask is
    replayed (phase 8's ReLU masks)."""
    from repro_torch import configs, tree
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import transformer as T
    from repro_torch.models.frontend import synthetic_embeddings
    from repro_torch.training.train_step import loss_and_grads
    print("phase 15 (card vs CPU): f32, batch 1; logits within 1e-3 * "
          "max|logit|, loss and grad norm 1e-4 relative, each gradient leaf "
          "within 1e-3 of its max")
    gd = torch.Generator(device="cuda").manual_seed(151)
    out = {}

    def rel(a, b):
        return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
    for arch, layers, S in FRONTEND_CPU:
        cfg = configs.get_config(arch).replace(num_layers=layers,
                                               dtype="float32")
        p_card = T.init_params(cfg, gd, device="cuda")
        batch = SyntheticLM(cfg, 1, S, seed=1, device="cpu").next_batch(0)
        feed = [synthetic_embeddings(torch.Generator().manual_seed(i), cfg,
                                     1, 1, dtype=torch.float32)
                for i in range(4 if cfg.has_decode else 0)]
        res = {}
        for dev in ("cpu", "cuda"):
            p = tree.map_(lambda t: t.detach().to(dev), p_card)
            b = {k: v.to(dev) for k, v in batch.items()}
            reset_counts()
            model = T.Transformer(cfg, device=dev, params=p)
            with torch.inference_mode():
                caches = model.init_caches(1, S + len(feed)) \
                    if feed else None
                h, _, _ = model.forward(b["inputs"], caches=caches)
                logits = [model.logits_from_hidden(h).cpu()]
                for x in feed:
                    lg, caches = model.decode_step(x.to(dev), caches)
                    logits.append(lg.cpu())
            fwd = read_counts(FLASH_NAMES)
            del model
            reset_counts()
            p = tree.map_(lambda t: t.requires_grad_(), p)
            loss, _, _, grads = loss_and_grads(p, b, cfg)
            leaves = [g.detach().cpu() for g in tree.leaves(grads)]
            gnorm = torch.sqrt(sum((g.double() ** 2).sum() for g in leaves))
            res[dev] = (logits, loss.item(), gnorm.item(), leaves, fwd,
                        read_counts(FLASH_NAMES))
            del p, b, grads
            release(torch)
        (lc, loss_c, gn_c, gc, _, _), (lg, loss_g, gn_g, gg, fwd, bwd) = (
            res["cpu"], res["cuda"])
        logit_rel = max(rel(a, b) for a, b in zip(lg, lc, strict=True))
        leaf_rel = max(rel(a, b) for a, b in zip(gg, gc, strict=True))
        loss_rel = abs(loss_g - loss_c) / abs(loss_c)
        gn_rel = abs(gn_g - gn_c) / gn_c
        flash = S > Q_CHUNK
        want_f = dict.fromkeys(FLASH_NAMES, 0) | {
            "flash_fwd": layers if flash else 0}
        want_b = dict.fromkeys(FLASH_NAMES, layers if flash else 0)
        label = (f"{arch} {layers} of {configs.get_config(arch).num_layers}"
                 f" layers S={S}")
        print(f"  [{smi}] {label}: logits ({len(lc)} passes: the forward"
              f"{' and ' + str(len(feed)) + ' decode steps' if feed else ''}"
              f") max|card - cpu| / max|cpu| {logit_rel:.3e} (tol 1e-3); "
              f"loss {loss_g:.6f} vs {loss_c:.6f} (rel {loss_rel:.2e}), grad "
              f"norm {gn_g:.6f} vs {gn_c:.6f} (rel {gn_rel:.2e}) (tol 1e-4); "
              f"{len(gc)} gradient leaves, max over leaves {leaf_rel:.3e} "
              f"(tol 1e-3); launches on the card: forward {fwd}, train step "
              f"{bwd}")
        check(max(logit_rel, leaf_rel) <= 1e-3
              and max(loss_rel, gn_rel) <= 1e-4,
              f"{label}: card and CPU disagree")
        check(fwd == want_f and bwd == want_b,
              f"{label}: launches {fwd} / {bwd} != {want_f} / {want_b}")
        out[label] = dict(logits_rel=logit_rel, loss_rel=loss_rel,
                          grad_norm_rel=gn_rel, leaf_rel=leaf_rel)
        del p_card, res
        release(torch)
    return out


# ---------------------------------------------------------------------------
# phase 16: the serving path at full width
# ---------------------------------------------------------------------------

# SlotServer at the paper's lengths: 8 slots over caches of 1088 positions
# (a 1024-token prompt and 64 new tokens), grouped, a queue of 32
TRAFFIC = dict(slots=8, cache_len=1088, dispatch="grouped", queue_limit=32)
# benchmarks/bench_traffic.py's arrivals, seeds and skew over 24 requests
# of the paper's lengths: (name, TrafficConfig fields, skewed router)
TRAFFIC_SHAPES = dict(num_requests=24, prompt_lens=(256, 512, 1024),
                      max_new_choices=(16, 32, 64))
TRAFFIC_SCENARIOS = (
    ("poisson", dict(arrival="poisson", rate=0.4, seed=7), False),
    ("bursty", dict(arrival="bursty", burst_size=6, burst_every=8, seed=11),
     False),
    ("skewed", dict(arrival="bursty", burst_size=6, burst_every=8, seed=11),
     True))
# the fault run's workload: 8 prompts of 512 at step 0 fill every slot, so
# the one element serve.decode_row poisons at decode step 1 lies in an
# active request's row wherever the seeded draw puts it
TRAFFIC_FAULT = dict(TRAFFIC_SHAPES, num_requests=16, arrival="bursty",
                     burst_size=8, burst_every=8, seed=11, prompt_lens=(512,))
TRAFFIC_DBRX_LAYERS = 2                  # phase 12's cut
TRAFFIC_PROFILED_STEPS = 16


def replay_once(torch, model, fields, *, graph=True, plan=None,
                server=None):
    """One replay of the workload ``fields`` (``TrafficConfig``'s) on a
    new ``SlotServer`` over ``model``, the counters set to 0 just before
    the server is built (a capture's warm-up step counts) and read after:
    every request must end ``ok`` without ``plan``, and the counters must
    have risen by exactly what the path implies (per MoE layer and
    forward, ``preset_expect``; a forward is a slot prefill, a decode step
    or the warm-up; the flash forward once per layer in a prefill past
    512).  ``server``: the ``SlotServer`` arguments (default ``TRAFFIC``).
    Returns (report, {uid: tokens}, counts, facts of the run)."""
    from repro_torch.core import faults
    from repro_torch.serving import (SlotServer, TrafficConfig, replay,
                                     synthesize_workload)
    cfg = model.cfg
    wl = synthesize_workload(TrafficConfig(**fields), cfg)
    reset_counts()
    caps = decode_captures()
    srv = SlotServer(model, graph=graph, **(server or TRAFFIC))
    warm = decode_captures() - caps if graph else 0
    calls = srv._step.calls
    with faults.active(plan):
        rep = replay(srv, wl)
    counts = read_counts()
    served = [r for _, r in wl if r.out]          # each ran one prefill
    long = sum(r.prompt.numel() > Q_CHUNK for r in served)
    facts = dict(decode_steps_run=srv._decode_steps,
                 step_calls=srv._step.calls - calls, graph=graph,
                 warmup_steps=warm, prefills=len(served),
                 prefills_past_512=long)
    want = preset_expect(cfg, "grouped", 0, srv._decode_steps + len(served)
                         + warm) | {"flash_fwd": attention_layers(cfg) * long}
    check(counts == want, f"replay {fields}: launches {counts} != {want}")
    check(facts["step_calls"] == srv._decode_steps,
          f"replay: {facts['step_calls']} step calls for "
          f"{srv._decode_steps} decode steps")
    if plan is None:
        check(rep.completed == len(wl) and not srv.active
              and set(rep.statuses.values()) == {"ok"},
              f"replay {fields}: statuses {rep.statuses}")
    return rep, {r.uid: list(r.out) for _, r in wl}, counts, facts


def profile_slot_steps(torch, smi, model, label):
    """``TRAFFIC_PROFILED_STEPS`` decode steps of a ``SlotServer`` with
    every slot busy (8 prompts of 512 tokens), unprofiled then profiled:
    the wall a step (host clock; each step ends in its host copy of the
    tokens), the device time of its kernels and the device's idle share,
    the scheduler's host work included."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import Request, SlotServer
    n = TRAFFIC_PROFILED_STEPS
    srv = SlotServer(model, **TRAFFIC)
    g = torch.Generator().manual_seed(16)
    for uid in range(TRAFFIC["slots"]):
        srv.submit(Request(uid=uid, prompt=torch.randint(
            0, model.cfg.vocab_size, (512,), generator=g), max_new=2 * n + 4))
    srv.step()
    t0 = time.perf_counter()
    for _ in range(n):
        srv.step()
    wall = 1e3 * (time.perf_counter() - t0) / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            srv.step()
        prof_wall = 1e3 * (time.perf_counter() - t0) / n
    dev = _device_ms(prof, DeviceType) / n
    check(len(srv.active) == TRAFFIC["slots"], f"{label}: a slot finished")
    out = dict(wall_ms=wall, profiled_wall_ms=prof_wall, device_ms=dev,
               idle=1 - dev / wall, idle_profiled=1 - dev / prof_wall)
    print(f"  [{smi}] {label}: a SlotServer step with {TRAFFIC['slots']} "
          f"busy slots (after 512 tokens): wall {wall:.3f} ms (profiled "
          f"{prof_wall:.3f}), device {dev:.3f} ms, idle {out['idle']:.3f} "
          f"(of the profiled wall {out['idle_profiled']:.3f})")
    return out


def report_line(smi, label, rep, facts):
    d = dataclasses.asdict(rep)
    print(f"  [{smi}] {label}: {rep.summary()}; p50/p99 first token "
          f"{1e3 * rep.p50_first_token_s:.3f} / "
          f"{1e3 * rep.p99_first_token_s:.3f} ms, tokens {rep.tokens_out}, "
          f"wall {rep.wall_s:.3f} s; {facts}")
    print(f"      report: {json.dumps(d)}")
    return d | {"facts": facts}


def phase_traffic(torch, smi):
    """Phase 16: the serving path at full width — ``SlotServer`` (slots 8,
    cache 1088, grouped, queue 32) over ``hetumoe-paper-16e`` (bf16, seed
    0) replaying ``TRAFFIC_SCENARIOS`` twice each (statuses, decode steps
    and tokens equal over the two), the bursty one once more through the
    eager step (tokens equal to the graph's), ``TRAFFIC_FAULT`` clean and
    under ``serve.decode_row:nan@1`` (exactly one request fails, with
    ``non_finite_decode_logits``; every other one's tokens are the clean
    run's), a profiled stretch of decode steps; then ``dbrx-132b`` at
    ``TRAFFIC_DBRX_LAYERS`` of 40 layers at its published widths replaying
    the skewed scenario twice (top-4 over 16 experts with every token on
    the hot one), and its profiled stretch.  Each replay's launches are
    checked (``replay_once``)."""
    from repro_torch import configs
    from repro_torch.core import faults
    from repro_torch.models.transformer import Transformer
    from repro_torch.serving import engine, skew_router
    print(f"phase 16: the serving path at full width, SlotServer {TRAFFIC}, "
          f"workloads {TRAFFIC_SHAPES}")
    out, totals = {}, dict.fromkeys(SERVE_KERNELS, 0)
    release(torch)
    torch.cuda.reset_peak_memory_stats()
    model = Transformer(configs.get_config(ARCH), device="cuda", seed=0)
    skewed = skew_router(model)

    def run(label, m, fields, **kw):
        rep, toks, counts, facts = replay_once(torch, m, fields, **kw)
        for k in totals:
            totals[k] += counts[k]
        out[label] = report_line(smi, label, rep, facts)
        return rep, toks

    for name, kw, skew in TRAFFIC_SCENARIOS:
        fields = TRAFFIC_SHAPES | kw
        m = skewed if skew else model
        first = run(f"{ARCH} {name}", m, fields)
        second = run(f"{ARCH} {name} (again)", m, fields)
        same = (first[0].statuses == second[0].statuses
                and first[0].decode_steps == second[0].decode_steps
                and first[1] == second[1])
        check(same, f"{name}: two replays differ")
        if name == "bursty":
            eager = run(f"{ARCH} {name} (eager step)", m, fields,
                        graph=False)
            check(eager[1] == first[1] and eager[0].statuses
                  == first[0].statuses,
                  f"{name}: the eager step's tokens differ from the graph's")
    clean = run(f"{ARCH} fault workload", model, TRAFFIC_FAULT)
    plan = faults.plan_from_specs(["serve.decode_row:nan@1"])
    bad = run(f"{ARCH} fault workload under serve.decode_row:nan@1", model,
              TRAFFIC_FAULT, plan=plan)
    failed = [u for u, st in bad[0].statuses.items() if st != "ok"]
    check(plan.fired == [("serve.decode_row", 1)] and bad[0].failed == 1
          and len(failed) == 1,
          f"decode_row: fired {plan.fired}, statuses {bad[0].statuses}")
    check(all(bad[1][u] == clean[1][u] for u in clean[1] if u != failed[0])
          and bad[1][failed[0]] == clean[1][failed[0]][:2],
          "decode_row: a request other than the poisoned one changed")
    out["fault"] = dict(failed_uid=failed[0], fired=plan.fired)
    print(f"  decode_row:nan@1 failed request {failed[0]} only (2 tokens, "
          f"then non_finite_decode_logits); every other request's tokens "
          f"equal the clean run's")
    out[f"{ARCH} profiled steps"] = profile_slot_steps(torch, smi, model,
                                                       ARCH)
    out[f"{ARCH} peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    engine.clear_step_cache(model)
    engine.clear_step_cache(skewed)
    del model, skewed
    release(torch)
    torch.cuda.reset_peak_memory_stats()
    cfg = configs.get_config("dbrx-132b").replace(
        num_layers=TRAFFIC_DBRX_LAYERS)
    t0 = time.perf_counter()
    base = Transformer(cfg, device="cuda", seed=0)
    hot = skew_router(base)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    name, kw, _ = TRAFFIC_SCENARIOS[2]
    fields = TRAFFIC_SHAPES | kw
    first = run(f"dbrx-132b ({cfg.num_layers} layers) {name}", hot, fields)
    second = run(f"dbrx-132b ({cfg.num_layers} layers) {name} (again)", hot,
                 fields)
    check(first[0].statuses == second[0].statuses
          and first[0].decode_steps == second[0].decode_steps
          and first[1] == second[1], "dbrx skewed: two replays differ")
    out["dbrx-132b profiled steps"] = profile_slot_steps(
        torch, smi, hot, f"dbrx-132b ({cfg.num_layers} layers) skewed")
    out["dbrx-132b peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["dbrx-132b init_s"] = init_s
    print(f"  [{smi}] peak memory: {ARCH} {out[f'{ARCH} peak_gib']:.3f} GiB, "
          f"dbrx-132b {out['dbrx-132b peak_gib']:.3f} GiB (init {init_s:.1f} "
          f"s)")
    engine.clear_step_cache(base)
    engine.clear_step_cache(hot)
    del base, hot
    release(torch)
    return totals, out


# ---------------------------------------------------------------------------
# phase 2p: kernels 7-9 at zamba2-7b's shared attention (head dim 112)
# ---------------------------------------------------------------------------

# zamba2-7b's shared block: MHA 32:32 at head dim 3584 / 32 = 112; the
# training shape of phase 17d, batch 2 x seq 4096 causal (name, B, H, KV,
# S, d, causal), and the long-context prefill of phase 17b, batch 4 x 8064
# under the window of 4096 (name, H, KV, d, window, cap; B and S are
# WINDOWED_B, WINDOWED_S)
ZAMBA_FLASH_TRAIN = (("zamba2-7b", 2, 32, 32, 4096, 112, True),)
ZAMBA_FLASH_PREFILL = (("zamba2-7b long-context", 32, 32, 112, 4096, None),)


def ptxas_spills(report: str, dim: int) -> list:
    """(kernel, spill bytes) of each instance at head dim ``dim`` (``<dim,
    ...>`` mangled as ``ILi<dim>E``) in the build's ptxas report."""
    import re
    out, entry = [], None
    for line in report.splitlines():
        if "Compiling entry" in line:
            entry = line.split(chr(39))[1]
            if f"ILi{dim}E" in entry:
                out.append([entry[:100], 0])
            else:
                entry = None
        elif entry is not None and "spill" in line:
            out[-1][1] += sum(int(x) for x in
                              re.findall(r"(\d+) bytes spill", line))
    return out


def phase_flash_zamba2(torch, dev, smi, errs):
    """Phase 2p: kernels 7-9 at head dim 112, first launched here: the
    build's instances at d=112 must not spill (ptxas -v); the forward, dq
    and dk/dv at ``ZAMBA_FLASH_TRAIN`` and the forward at
    ``ZAMBA_FLASH_PREFILL``, f32 and bf16, against their plain versions
    kv head by kv head under phase 2's bounds (``phase_flash_frontends``,
    ``phase_windowed_flash``); then timed as phase 5 times them, beside
    SDPA (the training shape: the same causal function) and
    ``flex_attention`` (the windowed prefill).  Returns the timing rows;
    the largest errors land in errs[``flash_*_zamba2``]."""
    from repro_torch.kernels import build
    spills = ptxas_spills(build.build_info.get("ptxas", ""), 112)
    print(f"phase 2p: kernels 7-9 at zamba2-7b's head dim 112: "
          f"{len(spills)} instances at d=112 in the build, spill bytes "
          f"{sum(b for _, b in spills)}")
    for entry, nbytes in spills:
        print(f"    {entry}: {nbytes} bytes spill")
    check(spills and not any(b for _, b in spills),
          f"the d=112 flash instances spill or are missing: {spills}")
    phase_flash_frontends(torch, dev, errs, ZAMBA_FLASH_TRAIN, "2p",
                          "_zamba2")
    rows = phase_windowed_flash(torch, dev, smi, errs, ZAMBA_FLASH_PREFILL,
                                "2p", "flash_fwd_zamba2")
    rows += frontend_timings(torch, dev, smi, ZAMBA_FLASH_TRAIN)
    return rows


# ---------------------------------------------------------------------------
# phase 17: the recurrent kinds, rwkv6-1.6b and zamba2-7b
# ---------------------------------------------------------------------------

# (arch, serving cells (prompt, new tokens, long_context)): rwkv6's 8192
# gives 64 chunks of 128; zamba2's 8064 + 128 under long_context wraps the
# shared block's rings of local_window = 4096 (the prefill overflows them)
RECURRENT_SERVE = (("rwkv6-1.6b", ((1024, 64, False), (8192, 64, False))),
                   ("zamba2-7b", ((1024, 64, False), (8064, 128, True))))
RECURRENT_B = 4
RECURRENT_BLOCK_S = 1024           # card against CPU, f32
RECURRENT_DECODE_TAIL = 16         # chunked prefill against decode steps
RECURRENT_TRAIN_S = 4096           # the reference's train_4k length
RECURRENT_TRAIN_STEPS = dict(warmup=2, timed=8)
# decode steps profiled, and timed per form against the graph, in 17a/17b:
# an eager zamba2 step is ~6,400 launches and ~31,000 host events, which
# take the profiler seconds to parse
RECURRENT_PROFILED_STEPS = 2
# (arch, tries in order: (periods, None for the published depth; batch;
# remat)); the first that fits one card runs.  Reckoned from ~37 bytes a
# parameter at the update (PERF.md section 7) and the activations of a
# forward at seq 4096 (measured: 5 zamba2 periods, 1.451B parameters,
# peaked at 49.2 GiB: ~21.6 of f32 params, moments and grads, ~1.8 a
# Mamba-2 layer): 7 of 27 periods (21 layers, 1.919B) ~28.6 + 38 GiB in
# the backward, ~65 GiB at the update; 8 (2.153B) ~75 GiB, too close to
# the card's 79.2 GiB.  rwkv6 whole (1.499B) at batch 2 x 4096 peaked at
# 57.4 GiB
RECURRENT_TRAIN = (("rwkv6-1.6b", ((None, 2, "none"), (None, 1, "none"),
                                   (None, 2, "block"))),
                   ("zamba2-7b", ((7, 1, "none"), (6, 1, "none"),
                                  (5, 1, "none"))))
# SlotServer over rwkv6 at full width: phase 16's slots, caches and queue
# (no dispatch: no MoE layer), replaying its poisson scenario
RECURRENT_TRAFFIC = dict(slots=8, cache_len=1088, queue_limit=32)


def phase_recurrent(torch, smi):
    """Phase 17: the recurrent kinds.  17a/17b serve rwkv6-1.6b (24
    ``rwkv`` layers) and zamba2-7b (81: ``mamba``, ``mamba``,
    ``mamba_sa``) whole at their published widths, bf16, batch
    ``RECURRENT_B``, through ``launch.serve.run`` → ``generate`` (the
    long-context cell through ``generate(long_context=True)``: the serving
    CLI has no such flag, as the reference's has none), two runs per cell:
    greedy tokens equal, finite logits, the flash forward once per
    attending layer per prefill past 512 tokens and no other kernel; then
    per preset, at its first prompt (1024), a profiled prefill and decode
    steps and the graph decode step against the eager one (bitwise).  17c holds one ``rwkv`` block
    and one ``mamba_sa`` block card against CPU in f32, and the chunked
    prefill against the recurrent decode on the card.  17d trains both
    (``phase_recurrent_train``), 17e replays a ``SlotServer`` workload over
    rwkv6.  Returns (launch totals, results)."""
    from repro_torch import configs
    from repro_torch.launch import serve as serve_launch
    from repro_torch.models.transformer import Transformer
    from repro_torch.serving import engine
    B = RECURRENT_B
    names = [k for k, _, _ in COUNTERS]
    totals = dict.fromkeys(names, 0)
    print(f"phase 17: the recurrent kinds whole at published widths, bf16, "
          f"batch {B}, cells (prompt, new tokens, long_context) "
          f"{dict(RECURRENT_SERVE)}, 2 runs per cell (times from the second)")
    out = {}
    for arch, cells in RECURRENT_SERVE:
        cfg = configs.get_config(arch)
        res = out[arch] = {}
        for S, gen, long_context in cells:
            cell = (f"{arch} prompt {S} + {gen}"
                    + (" long_context" if long_context else ""))
            release(torch)
            torch.cuda.reset_peak_memory_stats()
            runs = []
            for _ in range(2):
                st = {}
                reset_counts()
                if long_context:
                    model = Transformer(cfg, device="cuda", seed=0)
                    prompt = torch.randint(
                        0, cfg.vocab_size, (B, S),
                        generator=torch.Generator().manual_seed(0))
                    toks = engine.generate(model, prompt, steps=gen,
                                           long_context=True, stats=st)
                    engine.clear_step_cache(model)
                    del model
                else:
                    toks = serve_launch.run(arch, smoke=False, batch=B,
                                            prompt_len=S, gen=gen, seed=0,
                                            device="cuda", stats=st)
                counts = read_counts(names)
                runs.append((toks.cpu(), st, counts))
                want = dict.fromkeys(names, 0) | {
                    "flash_fwd": attention_layers(cfg) * (S > Q_CHUNK)}
                check(counts == want,
                      f"{cell}: launches {counts} != expected {want}")
                check(st["logits_finite"], f"{cell}: non-finite logits")
                for k in totals:
                    totals[k] += counts[k]
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            toks, st, counts = runs[1]
            check(tuple(toks.shape) == (B, S + gen),
                  f"{cell}: output shape {tuple(toks.shape)}")
            same = torch.equal(runs[0][0], toks)
            check(same, f"{cell}: greedy tokens differ between two runs")
            decode_ms = 1e3 * st["decode_s"] / st["decode_steps"]
            tok_s = B * gen / (st["prefill_s"] + st["decode_s"])
            print(f"  [{smi}] {cell}: prefill {1e3 * st['prefill_s']:.3f} ms "
                  f"({B * S / st['prefill_s']:.1f} prompt tokens/s; first "
                  f"run {1e3 * runs[0][1]['prefill_s']:.3f}), decode "
                  f"{decode_ms:.3f} ms/step, {tok_s:.1f} generated tokens/s, "
                  f"peak memory {peak:.3f} GiB, greedy tokens equal over 2 "
                  f"runs={same}, launches {counts}")
            res[cell] = dict(prefill_ms=1e3 * st["prefill_s"],
                             decode_ms_per_step=decode_ms,
                             tokens_per_s=tok_s, peak_gib=peak,
                             launches=counts)
            stamp(cell)
        release(torch)
        torch.cuda.reset_peak_memory_stats()
        model = Transformer(cfg, device="cuda", seed=0)
        n_params = sum(p.numel() for p in model.parameters())
        weights = torch.cuda.memory_allocated() / 2 ** 30
        print(f"  [{smi}] {arch}: {cfg.num_layers} layers "
              f"{cfg.block_pattern}, {n_params / 1e9:.3f}B parameters, "
              f"weights {weights:.3f} GiB")
        S = cells[0][0]
        res["params"], res["weights_gib"] = n_params, weights
        res["profile"] = profile_serving(
            torch, smi, model, cfg, None, S, B, name=f"{arch} ",
            decode_steps=RECURRENT_PROFILED_STEPS)
        res["graph_vs_eager"] = decode_graph_vs_eager(
            torch, smi, model, cfg, B, S, f"{arch} prompt {S}",
            timed=RECURRENT_PROFILED_STEPS)
        engine.clear_step_cache(model)
        del model
        stamp(f"phase 17{'ab'[arch == 'zamba2-7b']} ({arch} served)")
    release(torch)
    out["card vs cpu"] = recurrent_blocks_card_vs_cpu(torch, smi)
    stamp("phase 17c")
    train_counts, out["train"] = phase_recurrent_train(torch, smi)
    stamp("phase 17d")
    out["traffic"] = recurrent_traffic(torch, smi)
    for k in totals:
        totals[k] += train_counts[k]
    check(all(totals[k] > 0 for k in FLASH_NAMES),
          f"a flash kernel was not launched on the recurrent presets' path: "
          f"{totals}")
    return totals, out


def recurrent_blocks_card_vs_cpu(torch, smi):
    """Phase 17c, card against CPU at full width in f32, batch 1, seq
    ``RECURRENT_BLOCK_S`` (past q_chunk: the flash forward on the card, its
    plain version on the CPU): one rwkv6 ``rwkv`` block and one zamba2
    ``mamba_sa`` block with the shared attention, from the same weights
    (drawn on the CPU; the leaves that init to zero or one — the LoRA's
    ``sa_lora_b``, Mamba's ``norm``, RWKV's ``ln_x`` — drawn non-zero),
    each block's output and final state (the caches' recurrent tensors
    and the shared attention's keys and values) within 1e-4 of their max,
    phase 12's budget.  Then, on the card, the chunked prefill of all S
    tokens against a prefill of S - ``RECURRENT_DECODE_TAIL`` tokens and
    that many recurrent decode steps: the last outputs within 1e-4 of
    their max."""
    from repro_torch import configs, tree
    from repro_torch.models import attention as attn_lib
    from repro_torch.models.transformer import (block_forward, init_block,
                                                init_cache)
    S, n = RECURRENT_BLOCK_S, RECURRENT_DECODE_TAIL
    print(f"phase 17c (card vs CPU): f32, batch 1, seq {S}; tolerance "
          f"max|card - cpu| <= 1e-4 * max|cpu| for the output and each "
          f"state tensor; chunked prefill against {n} decode steps on the "
          f"card, 1e-4 of the max")
    out = {}
    for arch, kind in (("rwkv6-1.6b", "rwkv"), ("zamba2-7b", "mamba_sa")):
        cfg = configs.get_config(arch).replace(dtype="float32")
        g = torch.Generator().manual_seed(171)
        p = init_block(cfg, kind, g)
        shared = None
        if kind == "mamba_sa":
            p["sa_lora_b"] = torch.randn(p["sa_lora_b"].shape, generator=g) \
                * cfg.d_model ** -0.5
            p["mamba"]["norm"] = 0.1 * torch.randn(p["mamba"]["norm"].shape,
                                                   generator=g)
            shared = {"ln": 0.1 * torch.randn((cfg.d_model,), generator=g),
                      "attn": attn_lib.init_attention(g, cfg.attention,
                                                      cfg.d_model)}
        else:
            p["rwkv"]["ln_x"] = 1 + 0.1 * torch.randn(
                p["rwkv"]["ln_x"].shape, generator=g)
        x = torch.randn((1, S, cfg.d_model), generator=g)
        results = []
        for dev in ("cpu", "cuda"):
            pd, sd = (tree.map_(lambda t: t.to(dev), t) if t is not None
                      else None for t in (p, shared))
            cache = init_cache(cfg, kind, 1, S, dtype=torch.float32,
                               device=dev)
            pos = torch.arange(S, dtype=torch.int32, device=dev)
            with torch.inference_mode():
                y, cache, _ = block_forward(pd, x.to(dev), cfg, kind=kind,
                                            positions=pos, cache=cache,
                                            shared=sd)
            results.append([t.cpu() for t in (y, *tree.leaves(cache))
                            if t.is_floating_point()])
        worst = max((a - b).abs().max().item()
                    / max(a.abs().max().item(), 1e-30)
                    for a, b in zip(*results, strict=True))
        # on the card: the prefill of S - n tokens, then n decode steps
        dev = "cuda"
        pd, sd = (tree.map_(lambda t: t.to(dev), t) if t is not None
                  else None for t in (p, shared))
        xd = x.to(dev)
        cache = init_cache(cfg, kind, 1, S, dtype=torch.float32, device=dev)
        with torch.inference_mode():
            block_forward(pd, xd[:, :S - n], cfg, kind=kind,
                          positions=torch.arange(S - n, dtype=torch.int32,
                                                 device=dev),
                          cache=cache, shared=sd)
            steps = [block_forward(pd, xd[:, t:t + 1], cfg, kind=kind,
                                   cache=cache, decode=True, shared=sd)[0]
                     for t in range(S - n, S)]
        full = results[1][0][:, S - n:]
        dec = torch.cat(steps, dim=1).cpu()
        tail = (full - dec).abs().max().item() / full.abs().max().item()
        label = f"{arch} {kind} block"
        print(f"  [{smi}] {label}: output and {len(results[0]) - 1} state "
              f"tensors, max over them of max|card - cpu| / max|cpu| "
              f"{worst:.3e} (tol 1e-4); chunked prefill vs {n} decode steps "
              f"on the card {tail:.3e} (tol 1e-4)")
        check(math.isfinite(worst) and worst <= 1e-4,
              f"{label}: card and CPU disagree ({worst:.3e})")
        check(math.isfinite(tail) and tail <= 1e-4,
              f"{label}: chunked prefill and decode steps disagree "
              f"({tail:.3e})")
        out[label] = dict(rel=worst, prefill_vs_decode=tail)
        del p, shared, results, pd, sd, cache
        release(torch)
    return out


def phase_recurrent_train(torch, smi):
    """Phase 17d: both presets trained at their published widths, f32
    masters + bf16 compute, seq ``RECURRENT_TRAIN_S``, seeded weights and
    data, 2 warm-up + 8 timed AdamW steps, the first of each preset's
    ``RECURRENT_TRAIN`` tries that fits the card: rwkv6 whole through
    ``launch.train.run``, zamba2 cut to whole periods through
    ``make_train_step`` (``cfg.replace(num_layers=)``: the CLI has no depth
    flag, as the reference's has none).  Every metric finite, no step
    skipped (the Mamba-2 chunk's gradient is finite at chunk 128), the
    flash forward, dq and dk/dv once per attending layer a step and no
    other kernel; step ms, tokens/s, peak memory and bytes a parameter, a
    profiled step with no host wait.  Returns (launch totals, results)."""
    from repro_torch import configs, tree
    from repro_torch.core.config import TrainConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train as train_launch
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)
    S = RECURRENT_TRAIN_S
    steps = RECURRENT_TRAIN_STEPS["warmup"] + RECURRENT_TRAIN_STEPS["timed"]
    names = [k for k, _, _ in COUNTERS]
    totals = dict.fromkeys(names, 0)
    print(f"phase 17d: the recurrent presets trained at published widths, "
          f"seq {S}, f32 masters + bf16 compute, "
          f"{RECURRENT_TRAIN_STEPS['warmup']} warm-up + "
          f"{RECURRENT_TRAIN_STEPS['timed']} timed AdamW steps; tries "
          f"(periods, batch, remat) {dict(RECURRENT_TRAIN)}")
    out = {}
    for arch, tries in RECURRENT_TRAIN:
        full = configs.get_config(arch)
        for periods, B, remat in tries:
            cfg = full if periods is None else full.replace(
                num_layers=periods * len(full.block_pattern))
            tcfg = TrainConfig(learning_rate=3e-3,
                               warmup_steps=max(steps // 10, 1),
                               total_steps=steps, remat=remat, seed=0)
            release(torch)
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            st = {}
            label = f"{arch} ({cfg.num_layers} layers) B={B} S={S} {remat}"
            try:
                if periods is None:
                    state, history = train_launch.run(
                        arch, steps=steps, batch=B, seq=S, smoke=False,
                        remat=remat, log_every=steps - 1, device="cuda",
                        stats=st)
                    times = st["step_s"]
                    step = make_train_step(cfg, tcfg)
                else:
                    step = make_train_step(cfg, tcfg)
                    state = init_train_state(cfg, tcfg, device="cuda")
                    ds = SyntheticLM(cfg, B, S, seed=0, device="cuda")
                    times, history = [], []
                    for i in range(steps):
                        batch = ds.next_batch(i)
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        state, m = step(state, batch, step=i)
                        history.append({k: float(v) for k, v in m.items()})
                        times.append(time.perf_counter() - t0)
            except torch.cuda.OutOfMemoryError as e:
                why = str(e).splitlines()[0][:160]
            else:
                break
            state = step = None
            print(f"  [{smi}] {label}: does not fit ({why})")
            release(torch)
        else:
            check(False, f"{arch}: no training try fits the card")
        counts = read_counts(names)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        n_params = sum(p.numel() for p in tree.leaves(state.params))
        n_attn = attention_layers(cfg)
        want = dict.fromkeys(names, 0) | {k: n_attn * steps
                                          for k in FLASH_NAMES}
        timed = times[RECURRENT_TRAIN_STEPS["warmup"]:]
        med = statistics.median(timed)
        losses = [h["loss"] for h in history]
        print(f"  [{smi}] {label}: {n_params / 1e9:.3f}B parameters, "
              f"median step {1e3 * med:.3f} ms (of {len(timed)} timed; min "
              f"{1e3 * min(timed):.3f}, max {1e3 * max(timed):.3f}), "
              f"{B * S / med:.1f} tokens/s, peak memory {peak:.3f} GiB "
              f"({peak * 2 ** 30 / n_params:.2f} bytes a parameter), "
              f"launches {counts}")
        print(f"    loss trajectory {[round(v, 4) for v in losses]}; skipped "
              f"{[h['skipped'] for h in history]}")
        check(counts == want, f"{arch}: training launch counts {counts} != "
                              f"{want} ({steps} steps)")
        bad = [(i, k) for i, h in enumerate(history) for k, v in h.items()
               if not math.isfinite(v)]
        check(not bad, f"{arch}: non-finite metrics {bad}")
        check(all(h["skipped"] == 0 for h in history),
              f"{arch}: a step was skipped")
        for k in counts:
            totals[k] += counts[k]
        ds = SyntheticLM(cfg, B, S, seed=0, device="cuda")
        waits, prof = profile_train_step(torch, smi, label, step, state,
                                         ds.next_batch(steps), steps,
                                         cuda_only=True)
        out[arch] = dict(layers=cfg.num_layers, of_layers=full.num_layers,
                         batch=B, seq=S, remat=remat, params=n_params,
                         step_ms_median=1e3 * med,
                         step_ms=[1e3 * t for t in times],
                         tokens_per_s=B * S / med, peak_gib=peak,
                         bytes_per_param=peak * 2 ** 30 / n_params,
                         losses=losses, launches=counts, host_waits=waits,
                         profile=prof)
        del state, step, ds
        release(torch)
    return totals, out


def recurrent_traffic(torch, smi):
    """Phase 17e: ``SlotServer`` (``RECURRENT_TRAFFIC``) over rwkv6-1.6b at
    full width (bf16, seed 0) replaying phase 16's poisson scenario twice:
    every request ``ok``, launches as the path implies (none: rwkv6 has no
    kernel on its path), statuses, decode steps and tokens equal over the
    two replays; each slot prefill commits its recurrent states through
    ``engine.put_slot``."""
    from repro_torch import configs
    from repro_torch.models.transformer import Transformer
    from repro_torch.serving import engine
    name, kw, _ = TRAFFIC_SCENARIOS[0]
    fields = TRAFFIC_SHAPES | kw
    print(f"phase 17e: SlotServer {RECURRENT_TRAFFIC} over rwkv6-1.6b, "
          f"{name} {fields}, twice")
    release(torch)
    torch.cuda.reset_peak_memory_stats()
    model = Transformer(configs.get_config("rwkv6-1.6b"), device="cuda",
                        seed=0)
    out, reps = {}, []
    for again in ("", " (again)"):
        label = f"rwkv6-1.6b {name}{again}"
        rep, toks, counts, facts = replay_once(torch, model, fields,
                                               server=RECURRENT_TRAFFIC)
        out[label] = report_line(smi, label, rep, facts)
        reps.append((rep, toks))
    check(reps[0][0].statuses == reps[1][0].statuses
          and reps[0][0].decode_steps == reps[1][0].decode_steps
          and reps[0][1] == reps[1][1], "rwkv6 poisson: two replays differ")
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  [{smi}] rwkv6-1.6b SlotServer: peak memory "
          f"{out['peak_gib']:.3f} GiB; two replays equal")
    engine.clear_step_cache(model)
    del model
    release(torch)
    return out


# ---------------------------------------------------------------------------
# phase 18: expert parallelism — ranks sharing the one card over gloo
# ---------------------------------------------------------------------------

# what every time of phase 18 measures: several rank processes take turns
# on one card and exchange through the host (gloo), so no time here is a
# speed of expert parallelism on a fabric
EP_LABEL = "ranks time-sharing one card over gloo"
# the paper's layer (PAPER_LAYER): width, experts, expert FFN, tokens a rank
EP_LAYER = dict(d=2048, E=16, f=2048, T=2048)
EP_LAYER_MESHES = ((1, 4), (2, 2))
EP_LAYER_CASES = (("sort", dict(dispatch="sort")),
                  ("dense", dict(dispatch="dense")),
                  ("grouped", dict(dispatch="grouped")))
# the paper's own ReLU experts, grouped, at 1x4 only: the card's run
# replays the CPU ranks' ReLU masks (forced_relu_ffn, as phase 8 does:
# relu's derivative flips at pre-activations within rounding of 0)
EP_RELU_CASE = ("grouped-relu", dict(dispatch="grouped"))
# the kernels each dispatch launches in a layer's forward and backward
# (dense: the one-hot products are plain matrix products)
EP_LAYER_KERNELS = {
    "sort": ("topk_gate", "gather_rows", "scatter_add_rows"),
    "dense": ("topk_gate",),
    "grouped": ("topk_gate", "gather_rows", "grouped_matmul",
                "grouped_matmul_t", "grouped_drhs", "scatter_add_rows")}
EP_LAYER_KERNELS["grouped-relu"] = EP_LAYER_KERNELS["grouped"]
# card against CPU: within this share of each output's max (f32)
EP_TOL = 1e-4
# routing kept this far from a tie (f64 logits): card and CPU logits
# differ by ~1e-6, and a flipped route is not a rounding difference
EP_TIE_MARGIN = 1e-3
# 18c: the paper model whole, trained at 1x4
EP_TRAIN = dict(mesh=(1, 4), batch=8, seq=1024, steps=4)
# (dispatch, --tune, --fabric): sort's a2a from a calibration over the
# gloo group; grouped scored on the paper's pair (4 overlap windows)
EP_TRAIN_CELLS = (("sort", "calibrate", None),
                  ("grouped", "auto", "pcie_eth100"))
# 18d: expert TP over the data group — the paper's layer at decode size (32
# tokens over the world) and at EP_LAYER's 2048 tokens a rank, sort and
# grouped, card ranks against the same ranks on the CPU and grouped against
# one process; the quantized wire (grouped, 1x4) card against CPU ranks
# within the reference's QWIRE_TOLS (tests/test_grouped.py:688): normwise
# (output, gradient) budgets per wire dtype
EP_TP_MESHES = ((2, 2), (4, 1))
EP_TP_TOKENS = (("decode", 32), ("prefill", EP_LAYER["T"] * 4))
EP_TP_CASES = ("sort", "grouped")
EP_QWIRE = (("int8", 5e-2, 1e-1), ("float8_e4m3fn", 1.5e-1, 3e-1))
# 18e: dbrx-132b served at its published widths, 2 of 40 layers (phase 12's
# cut), bf16, grouped, at 2x2 through launch.serve.run; teacher-forced on
# one process's tokens, each step's logits within EP_SERVE_BOUND of that
# step's largest |logit| (the bound ring against linear caches keep,
# phase 13: the 4-way split of the f-contraction and the exchange rows
# round in bf16 in other places than one process).  The top-4 gate turns
# such rounding into another expert where two of a token's router logits
# nearly tie (one row of one step moved by ~0.3 of the largest logit in
# the builder's runs), so the logits are held on the ranks' replay of one
# process's routes (GateTape, as phase 12 does), and the free routes are
# held to the same bound on the router logits, each route that differs
# printed with its margin
EP_SERVE = dict(arch="dbrx-132b", layers=2, batch=8, prompt_len=1024,
                gen=16, mesh=(2, 2))
EP_SERVE_BOUND = 2.0 ** -4
# 18e's FSDP case: the same model stored under FSDP, a prefill and 4 decode
# steps on the replayed routes (each step gathers the 1.23 GB embedding and
# head over gloo: host staging, seconds a step)
EP_SERVE_FSDP_STEPS = 5
# 18e-p, 18e-r, 18e-z, 18e-c: every served cache leaf by the reference's
# cache rule, teacher-forced against one process at EP_SERVE_BOUND: each
# case, its attention forms, its state leaves' cut dims
# (launch/shard.CacheLayout) and the cache bytes a rank, reckoned from the
# shapes.  18e-p: starcoder2-3b's 2 kv heads do not divide over 4 model
# ranks, its caches of 1040 positions do (260 a rank: a quarter of one
# process's keys and values, the 0-d positions whole); 18e-c: caches of
# 1039 positions, so the channels (32 of 128 a rank)
EP_SERVE_STATES = {
    "18e-p": (dict(arch="starcoder2-3b", layers=4, batch=4, prompt_len=1024,
                   gen=16, mesh=(1, 4)), ["positions"], [()], 4_259_856),
    "18e-r": (dict(arch="rwkv6-1.6b", layers=4, batch=4, prompt_len=1024,
                   gen=16, mesh=(1, 4)), [None], [(("s", 2),)], 2_228_224),
    "18e-z": (dict(arch="zamba2-7b", layers=3, batch=4, prompt_len=1024,
                   gen=16, mesh=(2, 2)), [None, "heads"],
              [(("s", 2), ("conv", 2))], 20_677_136),
    "18e-c": (dict(arch="starcoder2-3b", layers=2, batch=4,
                   prompt_len=1024, gen=15, mesh=(1, 4)), ["channels"], [()],
              2_127_880),
}
# a recurrent state leaf on rank 0 against its block of one process's, of
# the block's largest magnitude (bf16 weights, f32 states).  After the
# prefill every leaf at EP_STATE_BOUND (bitwise one process's on an H100,
# PERF.md).  After the last step each leaf at its own bound: 15
# teacher-forced steps of bf16 activations on both sides, where rwkv6's
# sum over the model group rounds the bf16 hidden one ulp apart from one
# process's here and there.  x_last is that bf16 hidden stored in f32, so
# a few bf16 ulps (8.0e-3 on an H100); s and conv are f32 (rwkv6's s
# 1.4e-3, zamba2's s and conv 0 on an H100)
EP_STATE_BOUND = 1e-3
EP_STATE_LAST_BOUNDS = {"s": 1e-2, "conv": 1e-2, "x_last": 2.0 ** -6}
# 18f: the paper model whole trained at 2x2 under FSDP (ZeRO-3) through
# launch.train.run(fsdp=True), grouped: 3 steps uninterrupted; 3 steps
# saving at step 2 and cut at the top of step 2 (train.loop:raise@2), then
# run(resume=True): the restore, step 3 and the save at the run's end; a
# 1-step fsdp=False run at 2x2 for the peak memory (its first step holds
# the peak: the optimizer's update)
EP_FSDP = dict(mesh=(2, 2), batch=8, seq=1024, steps=3, save_at=2,
               nofsdp_steps=1)
# 18g: context parallelism, a batch with fewer rows than ranks.  18g-a: a
# gemma2-9b local and a global block (published widths, f32) at 1x4 over
# 2 rows of 8192 (row groups {0, 1} and {2, 3}: 4096 positions a rank,
# the window of 4096 reaching across the chunks), forward and backward
# against one process on the card (the parent, before the spawn): the
# output and dx within EP_TOL of their max, every gradient leaf (summed
# over the ranks) within 1e-3 of its max, phase 14's block tolerances.
# 18g-b: gemma2-9b at one local/global period (1.31B parameters, phase
# 14's cut) trained at 2x2 through launch.train.run, FSDP by needs_fsdp
# (1.31B x 12 B over model=2 > 6e9), batch 2 x 8192 (each rank 4096
# positions of one row), 2 AdamW steps (the first at lr 0, a warm-up
# step), against the same run on one process (the parent, before the
# spawn: launch.train.run with the same arguments but the mesh): each
# step's loss within EP_CP_LOSS_TOL of it, each step's gradient norm (the
# backward through the row groups) within EP_CP_NORM_TOL (bf16 compute:
# the ranks' bf16 partial gradients summed in f32)
EP_CP = dict(arch="gemma2-9b", batch=2, seq=8192)
EP_CP_BLOCKS = dict(mesh=(1, 4), kinds=("local", "global"), seed=43)
EP_CP_BLOCK_TOL = 1e-3
EP_CP_TRAIN = dict(mesh=(2, 2), layers=2, steps=2)
EP_CP_RUN = dict(steps=EP_CP_TRAIN["steps"], batch=EP_CP["batch"],
                 seq=EP_CP["seq"], smoke=False, seed=0, log_every=1,
                 num_layers=EP_CP_TRAIN["layers"])
EP_CP_LOSS_TOL, EP_CP_NORM_TOL = 1e-5, 1e-3
# every kernel's plain version: a rank of 18c must never run one
PLAIN_VERSIONS = (("topk_gate", "topk_gate_plain"),
                  ("layout_transform", "gather_rows_plain"),
                  ("layout_transform", "gather_rows_fanout_plain"),
                  ("layout_transform", "scatter_add_rows_plain"),
                  ("grouped_ffn", "grouped_matmul_plain"),
                  ("grouped_ffn", "grouped_matmul_t_plain"),
                  ("grouped_ffn", "grouped_drhs_plain"),
                  ("flash_attention", "flash_fwd_plain"),
                  ("flash_attention", "flash_dq_plain"),
                  ("flash_attention", "flash_dkv_plain"))


def ep_label(world: int) -> str:
    return f"{world} {EP_LABEL}"


def forbid_plain_versions():
    """Make every kernel's plain version raise in this process."""
    for mod, name in PLAIN_VERSIONS:
        def refuse(*args, _what=f"{mod}.{name}", **kw):
            raise SmokeFailure(f"{_what} ran on the card's EP path")
        setattr(_kernel_module(mod), name, refuse)


def ep_layer_inputs(torch, n_tokens: int):
    """The paper layer's global inputs from seed 18 on the CPU (gelu
    experts: relu's derivative flips at pre-activations within rounding of
    0 between card and CPU, phase 8), tokens nudged along their chosen
    expert's router column until every route clears ``EP_TIE_MARGIN``."""
    d, E, f = EP_LAYER["d"], EP_LAYER["E"], EP_LAYER["f"]
    g = torch.Generator().manual_seed(18)
    x = torch.randn(n_tokens, d, generator=g)
    p = {"gate_w": torch.randn(d, E, generator=g) * d ** -0.5,
         "w_up": torch.randn(E, d, f, generator=g) * d ** -0.5,
         "w_out": torch.randn(E, f, d, generator=g) * f ** -0.5}
    gy = torch.randn(n_tokens, d, generator=g)
    w = p["gate_w"].double()
    for _ in range(8):
        top2 = (x.double() @ w).topk(2, dim=-1)
        bad = (top2.values[:, 0] - top2.values[:, 1]) < EP_TIE_MARGIN
        if not bool(bad.any()):
            break
        col = w.T[top2.indices[bad, 0]]
        x[bad] += (2 * EP_TIE_MARGIN * col / (col * col).sum(
            dim=1, keepdim=True)).float()
    else:
        raise SmokeFailure("ep_layer_inputs: routes stay near ties")
    return x, gy, p


def _max_rel(torch, a, b) -> float:
    """max |a - b| over max |b| (b the CPU's)."""
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def ep_exchange_check(torch, mesh):
    """18a: flat and hierarchical (inner 2) AllToAll of CUDA tensors, bitwise
    equal and equal to the host permutation of every rank's input."""
    from repro_torch.core import alltoall
    M = mesh.shape["model"]

    def chunk(r):
        return torch.randn((M, 512, EP_LAYER["d"]),
                           generator=torch.Generator().manual_seed(100 + r))
    x = chunk(mesh.rank).to(mesh.device)
    times = {}
    outs = {}
    for name, fn in (("flat", lambda v: alltoall.flat_all_to_all(
            v, mesh.model_group)), ("hierarchical", lambda v:
            alltoall.all_to_all(v, mesh, mode="hierarchical", inner=2))):
        fn(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            outs[name] = fn(x)
        torch.cuda.synchronize()
        times[name] = 1e3 * (time.perf_counter() - t0) / 5
    want = torch.stack([chunk(m)[mesh.model_index] for m in range(M)])
    return dict(flat_eq_hier=bool(torch.equal(outs["flat"],
                                              outs["hierarchical"])),
                eq_host_permutation=bool(torch.equal(outs["flat"].cpu(),
                                                     want)),
                bytes=x.numel() * 4, ms=times)


def ep_receive_side_kernels(torch, rec):
    """Kernels 3-6 at the shapes the grouped EP path gave them (recorded
    on the card, the experts' ``w_up`` as the FFN saw it: under expert TP
    a view of its f-slice, read in place): the grouped matmul, dlhs and
    drhs against their plain versions on the CPU (``EP_TOL`` of the max),
    the scatter-add bitwise."""
    from repro_torch.kernels import grouped_ffn as G
    from repro_torch.kernels import layout_transform as L
    xs, offs, w_up = rec["ffn"]
    g = torch.randn((xs.shape[0], w_up.shape[2]),
                    generator=torch.Generator(device=xs.device).manual_seed(
                        5), device=xs.device)
    c, idx, n = rec["scatter"]
    out = {"rows": int(xs.shape[0]), "group_sizes": torch.diff(
        offs).tolist(), "w_up": [list(w_up.shape), list(w_up.stride())]}
    with torch.no_grad():
        out["grouped_matmul"] = _max_rel(
            torch, G.grouped_matmul(xs, w_up, offs),
            G.grouped_matmul_plain(xs.cpu(), w_up.cpu(), offs.cpu()))
        out["grouped_matmul_t"] = _max_rel(
            torch, G.grouped_matmul_t(g, w_up, offs),
            G.grouped_matmul_t_plain(g.cpu(), w_up.cpu(), offs.cpu()))
        out["grouped_drhs"] = _max_rel(
            torch, G.grouped_drhs(xs, g, offs),
            G.grouped_drhs_plain(xs.cpu(), g.cpu(), offs.cpu()))
        out["scatter_add_rows_bitwise"] = bool(torch.equal(
            L.scatter_add_rows(c, idx, n).cpu(),
            L.scatter_add_rows_plain(c.cpu(), idx.cpu(), n)))
    return out


def ep_layer_run(torch, mesh, cfg, params, xl, gyl, valid, *, record=False,
                 tp=None, act="gelu"):
    """The paper's layer (``act`` experts, gelu unless given) through
    ``sharded_moe_apply`` on the card and then on the CPU over the same
    gloo group, forward and backward of ``sum(y·gy) + aux`` from the
    global ``params`` (this rank's experts cut here; ``tp`` the
    ``expert_tp_axis``, under which the rank holds the f-slice of its
    experts that serving stores, data index di of D the slice
    ``[di·f/D, (di+1)·f/D)``).  With relu (grouped) the CPU runs first and
    its ReLU masks are replayed on the card (``forced_relu_ffn``).  Returns
    the per-device results (outputs, gradients, launches, expert-TP
    collectives, ms) and, with ``record``, the card's grouped FFN and
    scatter-add inputs."""
    from repro_torch.core import alltoall, moe
    from repro_torch.kernels import grouped_ffn as G
    from repro_torch.kernels import layout_transform as L
    E = cfg.num_experts
    n = E // mesh.shape["model"]
    m = mesh.model_index
    D, di = mesh.shape["data"], mesh.data_index
    res, rec = {}, {}
    relu = act == "relu"
    masks = []

    def share(k, v):
        if k == "gate_w":
            return v
        v = v[m * n:(m + 1) * n]
        if tp is None or D == 1:
            return v
        dim = 1 if k == "w_out" else 2
        f = v.shape[dim] // D
        return v.narrow(dim, di * f, f).contiguous()
    for dev in ("cpu", "cuda") if relu else ("cuda", "cpu"):
        p = {k: share(k, v).to(mesh.device if dev == "cuda" else "cpu"
                               ).requires_grad_(True)
             for k, v in params.items()}
        xr = xl.to(p["gate_w"].device).requires_grad_(True)
        ffn, sca = G.grouped_ffn, L.scatter_add_rows
        if relu and dev == "cpu":
            def mask_ffn(params_, xs, offsets, act_):
                with torch.no_grad():
                    masks.append(G.grouped_matmul(
                        xs, params_["w_up"], offsets) > 0)
                return ffn(params_, xs, offsets, act_)
            G.grouped_ffn = mask_ffn
        elif relu:
            G.grouped_ffn = forced_relu_ffn(torch, G, list(masks))
        if dev == "cuda" and record:
            base = G.grouped_ffn

            def rec_ffn(params_, xs, offsets, act_):
                rec.setdefault("ffn", (xs.detach(), offsets,
                                       params_["w_up"].detach()))
                return base(params_, xs, offsets, act_)

            def rec_sca(c, idx, k):
                rec.setdefault("scatter", (c.detach(), idx, k))
                return sca(c, idx, k)
            G.grouped_ffn, L.scatter_add_rows = rec_ffn, rec_sca
        reset_counts()
        alltoall.tp_collectives = 0
        if dev == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            y, aux, met = moe.sharded_moe_apply(
                mesh, cfg, p, xr, num_experts=E, act=act,
                valid=valid.to(xr.device), expert_tp_axis=tp)
            loss = (y * gyl.to(xr.device)).sum() + aux
            keys = sorted(p)
            grads = torch.autograd.grad(loss, [xr] + [p[k] for k in keys])
            if dev == "cuda":
                torch.cuda.synchronize()
        finally:
            G.grouped_ffn, L.scatter_add_rows = ffn, sca
        res[dev] = dict(ms=1e3 * (time.perf_counter() - t0),
                        counts=read_counts([k for k, _, _ in COUNTERS]),
                        tp_collectives=alltoall.tp_collectives,
                        y=y.detach(), aux=aux.detach(), dx=grads[0],
                        **{k: g for k, g in zip(keys, grads[1:])})
    return res, rec


def vs_one_process(torch, card, ref, rows):
    """The card's y, dx and aux against one process's on the same global
    tokens (``ref``: the npz of :func:`ep_one_process_reference`)."""
    return {"y": _max_rel(torch, card["y"], torch.from_numpy(ref["y"][rows])),
            "dx": _max_rel(torch, card["dx"],
                           torch.from_numpy(ref["dx"][rows])),
            "aux": _max_rel(torch, card["aux"],
                            torch.tensor(float(ref["aux"])))}


def ep_layer_checks(torch, rank, shape, ref_path):
    """18a (at 1x4) and 18b on one rank: the paper's layer through
    ``sharded_moe_apply`` on the card and then on the CPU over the same
    gloo group, forward and backward of ``sum(y·gy) + aux``; returns the
    card's distance from the CPU per output, its launches and times."""
    import numpy as np
    from repro_torch.core import moe
    from repro_torch.core.config import MoEConfig
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(shape, backend="gloo")
    E, T = EP_LAYER["E"], EP_LAYER["T"]
    M = shape[1]
    x, gy, params = ep_layer_inputs(torch, T * mesh.world)
    xl, valid, _, _ = moe.rank_tokens(mesh, x)
    gyl = moe.rank_tokens(mesh, gy)[0]
    out = {"exchange": ep_exchange_check(torch, mesh)
           if shape == (1, 4) else None}
    cases = EP_LAYER_CASES + ((EP_RELU_CASE,) if shape == (1, 4) else ())
    for name, fields in cases:
        a2a = dict(a2a="hierarchical", a2a_inner=2) if M == 4 else {}
        cfg = MoEConfig(num_experts=E, top_k=1, gate="switch",
                        capacity_factor=1.25, d_ff_expert=EP_LAYER["f"],
                        **fields, **a2a)
        res, rec = ep_layer_run(torch, mesh, cfg, params, xl, gyl, valid,
                                record=name == "grouped",
                                act="relu" if name == EP_RELU_CASE[0]
                                else "gelu")
        card, cpu = res["cuda"], res["cpu"]
        errs = {k: _max_rel(torch, card[k], cpu[k])
                for k in ("y", "aux", "dx", "gate_w", "w_up", "w_out")}
        cell = dict(errs=errs, card_ms=card["ms"], cpu_ms=cpu["ms"],
                    launches={k: v for k, v in card["counts"].items() if v})
        if name == "grouped":
            cell["receive_side"] = ep_receive_side_kernels(torch, rec)
            if shape == (1, 4):
                cell["vs_one_process"] = vs_one_process(
                    torch, card, np.load(ref_path),
                    slice(rank * T, (rank + 1) * T))
        out[name] = cell
        del res, card, cpu
    return out


def ep_one_process_reference(torch, path, n_tokens=EP_LAYER["T"] * 4):
    """The grouped layer in one process on the card over ``n_tokens``
    global tokens (what 1x4 grouped, and grouped under expert TP, must
    equal), saved for the ranks."""
    import numpy as np
    from repro_torch.core import moe
    from repro_torch.core.config import MoEConfig
    x, gy, params = ep_layer_inputs(torch, n_tokens)
    cfg = MoEConfig(num_experts=EP_LAYER["E"], top_k=1, gate="switch",
                    capacity_factor=1.25, d_ff_expert=EP_LAYER["f"],
                    dispatch="grouped")
    p = {k: v.cuda() for k, v in params.items()}
    xr = x.cuda().requires_grad_(True)
    y, aux, _ = moe.moe_apply(cfg, p, xr, num_experts=EP_LAYER["E"],
                              act="gelu")
    (dx,) = torch.autograd.grad((y * gy.cuda()).sum() + aux, [xr])
    np.savez(path, y=y.detach().cpu().numpy(), dx=dx.cpu().numpy(),
             aux=np.float32(aux.detach().cpu()))


def ep_train_run(torch, rank, shape, dispatch, tune, fabric):
    """18c on one rank: the paper model whole through ``launch.train.run``
    at ``shape`` (bf16 compute, f32 masters, seed 0); then one more step,
    rank 0's under the profiler.  Returns the history, the step times, the
    launches, the peak memory, a digest of the replicated leaves, rank 0's
    profiled kernel counts and the fabric the tuner scored against."""
    import hashlib

    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs, tree
    from repro_torch.core import tuning
    from repro_torch.core.config import TrainConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh, parse_fabric
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import serve_config
    from repro_torch.training.train_step import make_train_step
    B, S, steps = EP_TRAIN["batch"], EP_TRAIN["seq"], EP_TRAIN["steps"]
    torch.cuda.empty_cache()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    state, hist = train.run(ARCH, steps=steps, batch=B, seq=S, smoke=False,
                            seed=0, log_every=1, mesh_shape=shape,
                            dispatch=dispatch, tune=tune, stats=stats,
                            fabric=fabric and parse_fabric(fabric))
    counts = read_counts([k for k, _, _ in COUNTERS])
    peak = torch.cuda.max_memory_allocated()
    fab_name, (fast, slow) = tuning.get_tuning()[1]
    fabric = dict(name=fab_name, fast=dataclasses.asdict(fast),
                  slow=dataclasses.asdict(slow))
    digest = hashlib.sha256()
    for p, f in zip(tree.leaves(state.params),
                    tree.leaves(T.expert_leaf_mask(state.params))):
        if not f:
            digest.update(p.detach().cpu().numpy().tobytes())
    # one more step, rank 0's under the profiler
    cfg = serve_config(configs.get_config(ARCH), dispatch=dispatch)
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=1,
                       total_steps=steps + 1)
    mesh = make_mesh(shape, backend="gloo")
    step = make_train_step(cfg, tcfg, mesh=mesh)
    batch = SyntheticLM(cfg, B, S, seed=0, device=mesh.device).next_batch(
        steps)
    prof_counts = None
    torch.cuda.synchronize()
    if rank == 0:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, _ = step(state, batch, step=steps)
            torch.cuda.synchronize()
        prof_counts = {}
        for e in read_profile(prof):
            name = e.key.removeprefix("void ").replace(
                "(anonymous namespace)::", "").split("(")[0]
            if name.startswith(PORT_KERNEL_NAMES):
                prof_counts[name] = prof_counts.get(name, 0) + e.count
    else:
        state, _ = step(state, batch, step=steps)
        torch.cuda.synchronize()
    del state
    return dict(history=hist, step_s=stats["step_s"], counts=counts,
                peak_gib=peak / 2 ** 30, digest=digest.hexdigest(),
                profiled=prof_counts, fabric=fabric)


def state_digest(torch, leaves) -> str:
    """sha256 over the sha256 of each of ``leaves``' bytes, in order: the
    leaves copied to the host and hashed on 8 threads (both let go of the
    interpreter lock), a state being gigabytes."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    def one(t):
        return hashlib.sha256(t.detach().contiguous().cpu().numpy()
                              .reshape(-1).view("uint8")).digest()
    with ThreadPoolExecutor(max_workers=8) as ex:
        return hashlib.sha256(b"".join(ex.map(one, leaves))).hexdigest()


def _state_leaves(state):
    from repro_torch import tree
    return (tree.leaves((state.params, state.opt["m"], state.opt["v"]))
            + [state.opt["count"], state.step, state.skipped,
               state.nonfinite_streak, state.good_streak, state.loss_scale])


def ep_fsdp_run(torch, rank, ckpt_dir):
    """18f on one rank (every plain version made to raise): the paper
    model whole at 2x2 under FSDP through ``launch.train.run(fsdp=True)``,
    grouped — 3 steps uninterrupted (the launches counted from 0, the
    peak, the all-gathers); the same 3 steps saving at step 2 into
    ``ckpt_dir`` and cut at the top of step 2 (``train.loop:raise@2``);
    then the trainer's own resume, ``run(resume=True)``: the restore, step
    3 and the save at its end, every block bitwise the uninterrupted
    run's (and the digest of its blocks, for the parent); a 1-step
    ``fsdp=False`` run's peak."""
    from repro_torch.core import faults
    from repro_torch.launch import shard, train
    B, S, steps = EP_FSDP["batch"], EP_FSDP["seq"], EP_FSDP["steps"]
    at = EP_FSDP["save_at"]
    kw = dict(batch=B, seq=S, smoke=False, seed=0, log_every=1,
              mesh_shape=EP_FSDP["mesh"], dispatch="grouped")
    out = {}

    def fresh():
        release(torch)
        torch.cuda.reset_peak_memory_stats()

    fresh()
    reset_counts()
    shard.gathers = 0
    st = {}
    done, hist = train.run(ARCH, steps=steps, fsdp=True, stats=st, **kw)
    out["counts"] = read_counts([k for k, _, _ in COUNTERS])
    out["gathers_per_step"] = shard.gathers / steps
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["history"], out["step_s"] = hist, st["step_s"]
    out["stored_gb"] = sum(t.numel() * t.element_size()
                           for t in _state_leaves(done)) / 1e9
    fresh()
    plan = faults.plan_from_specs([f"train.loop:raise@{at}"])
    cut = {}
    try:
        train.run(ARCH, steps=steps, fsdp=True, ckpt_dir=ckpt_dir,
                  ckpt_every=at, faults=plan, stats=cut, **kw)
        raise SmokeFailure(f"18f: the run was not cut at step {at}")
    except faults.FaultInjected:
        pass
    fresh()
    rs = {}
    state, resumed = train.run(ARCH, steps=steps, fsdp=True,
                               ckpt_dir=ckpt_dir, resume=True, stats=rs,
                               **kw)
    out["save_s"] = cut["save_s"] + rs["save_s"]
    out["restore_s"] = rs["restore_s"]
    out["resumed_steps"] = [m["step"] for m in resumed]
    out["resumed_history_equal"] = resumed == hist[at:]
    out["resume_bitwise"] = all(
        torch.equal(a, b) for a, b in zip(_state_leaves(state),
                                          _state_leaves(done), strict=True))
    out["digest"] = state_digest(torch, _state_leaves(state))
    del state, done
    fresh()
    nf = {}
    state, _ = train.run(ARCH, steps=EP_FSDP["nofsdp_steps"], fsdp=False,
                         stats=nf, **kw)
    out["nofsdp_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["nofsdp_stored_gb"] = sum(t.numel() * t.element_size()
                                  for t in _state_leaves(state)) / 1e9
    out["nofsdp_step_s"] = nf["step_s"]
    del state
    release(torch)
    return out


def fsdp_one_process_restore(torch, ckpt_dir, world_shape):
    """18f's parent side: the ranks' checkpoint restored on one process on
    the card (``restore_checkpoint`` into a one-device template), then cut
    into each rank's blocks (``launch/shard`` layouts, no group needed)
    and digested as the ranks digest theirs."""
    from repro_torch import configs, convert, tree
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.core.config import TrainConfig
    from repro_torch.launch import shard
    from repro_torch.launch.mesh import tree_paths
    from repro_torch.training.train_step import init_train_state
    cfg = configs.get_config(ARCH)
    tpl = init_train_state(cfg, TrainConfig(), device="cuda")
    t0 = time.perf_counter()
    state, step = restore_checkpoint(ckpt_dir, tpl, cfg=cfg)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    del tpl
    shapes = convert.param_shapes(cfg)
    D, M = world_shape
    digests = []
    for r in range(D * M):
        lay = shard.make_layout(shapes, {"data": D, "model": M}, r,
                                fsdp=True)
        cut = [lay.cut(p, t) for sec in (state.params, state.opt["m"],
                                         state.opt["v"])
               for p, t in tree_paths(sec)]
        digests.append(state_digest(torch, cut + _state_leaves(state)[
            len(tree.leaves(state.params)) * 3:]))
        del cut
    del state
    release(torch)
    return dict(step=step, restore_s=restore_s, digests=digests)


def report_ep_fsdp(ranks, smi, world, one_loss, parent):
    """18f's checks and printout (see :func:`ep_fsdp_run`)."""
    res = [r["18f"] for r in ranks]
    label = f"[{smi}; {ep_label(world)}: host-staged, not a speed of FSDP]"
    losses = [h["loss"] for h in res[0]["history"]]
    print(f"  18f, {ARCH} whole at 2x2 under FSDP, grouped, batch "
          f"{EP_FSDP['batch']} x {EP_FSDP['seq']}, "
          f"{max(r['18f_s'] for r in ranks):.1f} s {label}:")
    for r, x in enumerate(res):
        print(f"    rank {r}: stored {x['stored_gb']:.3f} GB (fsdp=False "
              f"{x['nofsdp_stored_gb']:.3f} GB), peak {x['peak_gib']:.2f} "
              f"GiB (fsdp=False 2x2 {x['nofsdp_peak_gib']:.2f} GiB), step s "
              f"{[round(t, 3) for t in x['step_s']]} (fsdp=False "
              f"{[round(t, 3) for t in x['nofsdp_step_s']]}), save s "
              f"{[round(t, 3) for t in x['save_s']]}, restore s "
              f"{x['restore_s']:.3f}, all-gathers a step "
              f"{x['gathers_per_step']:g}, launches {x['counts']}")
    rel = abs(losses[0] - one_loss) / abs(one_loss)
    print(f"    losses {losses}; step 1 loss vs one process {one_loss:.6f}: "
          f"relative {rel:.2e}")
    print(f"    checkpoint {parent['bytes']} bytes at step "
          f"{parent['step']}; one-process restore on the card "
          f"{parent['restore_s']:.3f} s {label}")
    hist = [x["history"] for x in res]
    check(all(math.isfinite(v) for h in hist for m in h
              for v in m.values()), "18f: non-finite metrics")
    check(all(m["skipped"] == 0 for h in hist for m in h),
          "18f: a step was skipped")
    check(all([m["loss"] for m in h] == losses for h in hist),
          "18f: the ranks' losses differ")
    check(rel <= 1e-3, f"18f step 1 loss {losses[0]} vs one process "
                       f"{one_loss}")
    check(all(x["resumed_steps"] == list(range(EP_FSDP["save_at"],
                                                EP_FSDP["steps"]))
              for x in res),
          f"18f: the resumed runs took steps "
          f"{[x['resumed_steps'] for x in res]}")
    check(all(x["resume_bitwise"] and x["resumed_history_equal"]
              for x in res),
          "18f: the resumed state or metrics differ from the uninterrupted "
          "run's")
    check(parent["step"] == EP_FSDP["steps"]
          and parent["digests"] == [x["digest"] for x in res],
          "18f: the one-process restore differs from the ranks' state")
    check(all(x["peak_gib"] < x["nofsdp_peak_gib"] for x in res),
          f"18f: a rank's peak under FSDP is not below fsdp=False's: "
          f"{[(x['peak_gib'], x['nofsdp_peak_gib']) for x in res]}")
    check(all(res[0]["counts"][k] > 0 for k, _, _ in COUNTERS),
          f"18f: a kernel of the path was not launched on rank 0: "
          f"{res[0]['counts']}")
    return dict(losses=losses, one_process_step1_loss=one_loss,
                launches_rank0=res[0]["counts"],
                peak_gib=[x["peak_gib"] for x in res],
                nofsdp_peak_gib=[x["nofsdp_peak_gib"] for x in res],
                stored_gb=[x["stored_gb"] for x in res],
                gathers_per_step=res[0]["gathers_per_step"],
                nofsdp_stored_gb=[x["nofsdp_stored_gb"] for x in res],
                step_s=[x["step_s"] for x in res],
                nofsdp_step_s=[x["nofsdp_step_s"] for x in res],
                save_s=[x["save_s"] for x in res],
                restore_s=[x["restore_s"] for x in res],
                checkpoint_bytes=parent["bytes"],
                one_process_restore_s=parent["restore_s"],
                seconds=max(r["18f_s"] for r in ranks))


def cp_blocks_inputs(torch, cfg, kind, index):
    """18g-a's block weights, input and output cotangent, drawn on the card
    from ``EP_CP_BLOCKS["seed"]`` + ``index`` (the same bits in the parent
    and in every rank)."""
    from repro_torch import tree
    from repro_torch.models.transformer import init_block
    gd = torch.Generator(device="cuda").manual_seed(
        EP_CP_BLOCKS["seed"] + index)
    p = init_block(cfg, kind, gd, device="cuda")
    B, S, d = EP_CP["batch"], EP_CP["seq"], cfg.d_model
    x = torch.randn((B, S, d), generator=gd, device="cuda")
    dy = torch.randn((B, S, d), generator=gd, device="cuda")
    return tree.map_(lambda t: t.requires_grad_(), p), x, dy


def cp_blocks_reference(torch, path):
    """18g-a's parent side: each block forward and backward in one process
    on the card (f32, the whole rows, the flash kernels over S=8192);
    y and dx saved to ``path`` + ``.{kind}.io``, every leaf's gradient
    to ``.{kind}.grads``, then freed.  Returns the seconds taken."""
    from repro_torch import configs, tree
    from repro_torch.models.transformer import block_forward
    t0 = time.perf_counter()
    cfg = configs.get_config(EP_CP["arch"]).replace(dtype="float32")
    for i, kind in enumerate(EP_CP_BLOCKS["kinds"]):
        p, x, dy = cp_blocks_inputs(torch, cfg, kind, i)
        x.requires_grad_()
        pos = torch.arange(EP_CP["seq"], dtype=torch.int32, device="cuda")
        y, _, _ = block_forward(p, x, cfg, kind=kind, positions=pos)
        grads = torch.autograd.grad(y, [x, *tree.leaves(p)], dy)
        torch.save({"y": y.detach().cpu(), "dx": grads[0].cpu()},
                   f"{path}.{kind}.io")
        torch.save([g.cpu() for g in grads[1:]], f"{path}.{kind}.grads")
        del p, x, dy, y, grads
        release(torch)
    return time.perf_counter() - t0


def ep_cp_blocks(torch, rank, path):
    """18g-a on one rank (every plain version made to raise): each block
    over this rank's chunk of its row at 1x4 (``launch/mesh.token_block``:
    attention context-parallel over the row group), forward and backward
    from the parent's weights, input and cotangent; the chunk's y and dx
    against the parent's, the gradients summed over the ranks (one
    all-reduce) against the parent's on rank 0; the flash launches and
    the row-group gathers of the pass."""
    import torch.distributed as dist
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    from repro_torch import configs, tree
    from repro_torch.launch import shard
    from repro_torch.launch.mesh import cut_tokens, make_mesh, token_block
    from repro_torch.models.transformer import block_forward
    cfg = configs.get_config(EP_CP["arch"]).replace(dtype="float32")
    mesh = make_mesh(EP_CP_BLOCKS["mesh"], backend="gloo", rows=(cut_tokens(
        EP_CP_BLOCKS["mesh"], 0, EP_CP["batch"], EP_CP["seq"]).n,))
    blk = token_block(mesh, EP_CP["batch"], EP_CP["seq"])
    out = {"block": (blk.rows.start, blk.seq.start, blk.seq.stop, blk.n)}
    for i, kind in enumerate(EP_CP_BLOCKS["kinds"]):
        p, x, dy = cp_blocks_inputs(torch, cfg, kind, i)
        xl = x[blk.rows, blk.seq].clone().requires_grad_()
        dyl = dy[blk.rows, blk.seq]
        del x, dy
        reset_counts()
        shard.row_gathers = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, _, _ = block_forward(p, xl, cfg, kind=kind,
                                positions=blk.positions("cuda"), mesh=mesh,
                                block=blk)
        grads = list(torch.autograd.grad(y, [xl, *tree.leaves(p)], dyl))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counts(FLASH_NAMES)
        gathers = shard.row_gathers
        flat = _flatten_dense_tensors(grads[1:])
        dist.all_reduce(flat)
        summed = _unflatten_dense_tensors(flat, grads[1:])
        ref = torch.load(f"{path}.{kind}.io")

        def rel(got, want):
            want = want.to(got.device)
            return ((got.detach() - want).abs().max()
                    / want.abs().max().clamp(min=1e-30)).item()
        res = dict(y=rel(y, ref["y"][blk.rows, blk.seq]),
                   dx=rel(grads[0], ref["dx"][blk.rows, blk.seq]),
                   counts=counts, gathers=gathers, seconds=secs)
        if rank == 0:
            res["leaves"] = max(rel(g, w) for g, w in zip(
                summed, torch.load(f"{path}.{kind}.grads"), strict=True))
        out[kind] = res
        del p, xl, dyl, y, grads, flat, summed, ref
        release(torch)
    return out


def ep_cp_train(torch, rank):
    """18g-b on one rank (every plain version made to raise): gemma2-9b at
    one local/global period trained at 2x2 through ``launch.train.run``
    (FSDP by ``needs_fsdp``), batch 2 x 8192 — each rank 4096 positions
    of one row — 2 AdamW steps from seed 0: the history, the step walls,
    the launches, the row-group and FSDP gathers a step, the peak and
    the stored bytes."""
    from repro_torch.launch import shard, train
    c = EP_CP_TRAIN
    release(torch)
    torch.cuda.reset_peak_memory_stats()
    free_gib = torch.cuda.mem_get_info()[0] / 2 ** 30
    reset_counts()
    shard.row_gathers = shard.gathers = 0
    st = {}
    state, hist = train.run(EP_CP["arch"], mesh_shape=c["mesh"], stats=st,
                            **EP_CP_RUN)
    out = dict(history=hist, step_s=st["step_s"], free_gib=free_gib,
               counts=read_counts([k for k, _, _ in COUNTERS]),
               row_gathers_per_step=shard.row_gathers / c["steps"],
               fsdp_gathers_per_step=shard.gathers / c["steps"],
               fsdp=st["layout"].fsdp,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               reserved_gib=torch.cuda.max_memory_reserved() / 2 ** 30,
               stored_gb=sum(t.numel() * t.element_size()
                             for t in _state_leaves(state)) / 1e9)
    del state
    release(torch)
    return out


def cp_one_process_run(torch):
    """18g-b's parent side: the same run on one process (``EP_CP_RUN``,
    no mesh), its history; its state freed after."""
    from repro_torch.launch import train
    state, hist = train.run(EP_CP["arch"], device="cuda", **EP_CP_RUN)
    del state
    release(torch)
    return hist


def report_ep_cp(ranks, smi, world, one, parent_s):
    """18g's checks and printout (``ep_cp_blocks``, ``ep_cp_train``);
    ``one``: the history of 18g-b's run on one process."""
    label = f"[{smi}; {ep_label(world)}: host-staged, not a speed of CP]"
    print(f"  18g-a, {EP_CP['arch']} blocks {EP_CP_BLOCKS['kinds']} f32 at "
          f"1x4, batch {EP_CP['batch']} x {EP_CP['seq']} (two ranks a row), "
          f"against one process ({parent_s:.1f} s in the parent) {label}:")
    out = {"a": [r["18g-a"] for r in ranks]}
    for r, res in enumerate(out["a"]):
        print(f"    rank {r} block {res['block']}: " + "; ".join(
            f"{k} y {res[k]['y']:.2e} dx {res[k]['dx']:.2e}"
            + (f" leaves {res[k]['leaves']:.2e}" if "leaves" in res[k]
               else "") + f", launches {res[k]['counts']}, row gathers "
            f"{res[k]['gathers']}, fwd + bwd {res[k]['seconds']:.2f} s"
            for k in EP_CP_BLOCKS["kinds"]))
        for k in EP_CP_BLOCKS["kinds"]:
            x = res[k]
            check(x["y"] <= EP_TOL and x["dx"] <= EP_TOL
                  and x.get("leaves", 0.0) <= EP_CP_BLOCK_TOL,
                  f"18g-a rank {r} {k}: against one process {x}")
            check(x["counts"] == dict.fromkeys(FLASH_NAMES, 1)
                  and x["gathers"] == 1,
                  f"18g-a rank {r} {k}: launches {x['counts']}, row "
                  f"gathers {x['gathers']}")
    res = [r["18g-b"] for r in ranks]
    c = EP_CP_TRAIN
    losses = [h["loss"] for h in res[0]["history"]]
    print(f"  18g-b, {EP_CP['arch']} at {c['layers']} layers trained at "
          f"2x2, batch {EP_CP['batch']} x {EP_CP['seq']} (two ranks a "
          f"row), {c['steps']} steps, {max(r['18g-b_s'] for r in ranks):.1f}"
          f" s {label}:")
    for r, x in enumerate(res):
        print(f"    rank {r}: fsdp={x['fsdp']}, stored {x['stored_gb']:.3f}"
              f" GB, peak {x['peak_gib']:.2f} GiB (reserved "
              f"{x['reserved_gib']:.2f}; the card's free memory at its start "
              f"{x['free_gib']:.2f} GiB), step s "
              f"{[round(t, 3) for t in x['step_s']]}, row gathers a step "
              f"{x['row_gathers_per_step']:g}, FSDP all-gathers a step "
              f"{x['fsdp_gathers_per_step']:g}, launches {x['counts']}")
    rel = {k: [abs(m[k] - o[k]) / abs(o[k])
               for m, o in zip(res[0]["history"], one, strict=True)]
           for k in ("loss", "grad_norm")}
    print(f"    losses {losses}, grad norms "
          f"{[m['grad_norm'] for m in res[0]['history']]}; one process "
          f"{[m['loss'] for m in one]}, {[m['grad_norm'] for m in one]}: "
          f"relative {[f'{x:.2e}' for x in rel['loss']]}, "
          f"{[f'{x:.2e}' for x in rel['grad_norm']]}")
    hist = [x["history"] for x in res]
    check(all(math.isfinite(v) for h in hist for m in h
              for v in m.values()), "18g-b: non-finite metrics")
    check(all(m["skipped"] == 0 for h in hist for m in h),
          "18g-b: a step was skipped")
    check(all([m["loss"] for m in h] == losses for h in hist),
          "18g-b: the ranks' losses differ")
    check(max(rel["loss"]) <= EP_CP_LOSS_TOL
          and max(rel["grad_norm"]) <= EP_CP_NORM_TOL,
          f"18g-b against one process: relative {rel}")
    check(all(x["fsdp"] for x in res), "18g-b: needs_fsdp did not ask for "
                                       "FSDP")
    L, n = c["layers"], c["steps"]
    want = dict.fromkeys((k for k, _, _ in COUNTERS), 0) | {
        "flash_fwd": 2 * L * n, "flash_dq": L * n, "flash_dkv": L * n}
    check(res[0]["counts"] == want,
          f"18g-b: rank 0's launches {res[0]['counts']} != {want} (the "
          f"forward twice a layer and step: forward and recompute)")
    check(all(x["row_gathers_per_step"] == 2 * L for x in res),
          f"18g-b: row-group gathers a step "
          f"{[x['row_gathers_per_step'] for x in res]} != {2 * L}")
    out["b"] = dict(losses=losses, one_process=one, relative=rel,
                    launches_rank0=res[0]["counts"],
                    row_gathers_per_step=res[0]["row_gathers_per_step"],
                    fsdp_gathers_per_step=res[0]["fsdp_gathers_per_step"],
                    peak_gib=[x["peak_gib"] for x in res],
                    reserved_gib=[x["reserved_gib"] for x in res],
                    stored_gb=[x["stored_gb"] for x in res],
                    step_s=[x["step_s"] for x in res],
                    seconds=max(r["18g-b_s"] for r in ranks))
    out["launches_rank0"] = res[0]["counts"]
    return out


def ep_tp_checks(torch, rank, ref_paths):
    """18d on one rank: the paper's layer under expert TP over the data
    group (``expert_tp_axis="data"``) at each mesh of ``EP_TP_MESHES``,
    token count of ``EP_TP_TOKENS`` and dispatch of ``EP_TP_CASES``: the
    card against the same ranks on the CPU, grouped against one process
    (``ref_paths[tokens]``) and kernels 3-6 at the f-slice shapes; then the
    quantized wire at 1x4 (no TP), card against CPU ranks."""
    import numpy as np
    from repro_torch.core import moe
    from repro_torch.core.config import MoEConfig
    from repro_torch.launch.mesh import make_mesh
    E, f = EP_LAYER["E"], EP_LAYER["f"]
    out = {}
    for shape in EP_TP_MESHES:
        mesh = make_mesh(shape, backend="gloo")
        for tokens, n_glob in EP_TP_TOKENS:
            x, gy, params = ep_layer_inputs(torch, n_glob)
            xl, valid, _, _ = moe.rank_tokens(mesh, x)
            gyl = moe.rank_tokens(mesh, gy)[0]
            for name in EP_TP_CASES:
                cfg = MoEConfig(num_experts=E, top_k=1, gate="switch",
                                capacity_factor=1.25, d_ff_expert=f,
                                dispatch=name)
                res, rec = ep_layer_run(torch, mesh, cfg, params, xl, gyl,
                                        valid, record=name == "grouped",
                                        tp="data")
                card, cpu = res["cuda"], res["cpu"]
                cell = dict(
                    errs={k: _max_rel(torch, card[k], cpu[k])
                          for k in ("y", "aux", "dx", "gate_w", "w_up",
                                    "w_out")},
                    card_ms=card["ms"], cpu_ms=cpu["ms"],
                    tp_collectives=card["tp_collectives"],
                    launches={k: v for k, v in card["counts"].items() if v})
                if name == "grouped":
                    cell["receive_side"] = ep_receive_side_kernels(torch, rec)
                    n = xl.shape[0]
                    cell["vs_one_process"] = vs_one_process(
                        torch, card, np.load(ref_paths[tokens]),
                        slice(rank * n, (rank + 1) * n))
                out[f"{shape[0]}x{shape[1]} {tokens} {name}"] = cell
                del res, card, cpu, rec
    mesh = make_mesh((1, 4), backend="gloo")
    x, gy, params = ep_layer_inputs(torch, EP_LAYER["T"] * 4)
    xl, valid, _, _ = moe.rank_tokens(mesh, x)
    gyl = moe.rank_tokens(mesh, gy)[0]
    for q, _, _ in EP_QWIRE:
        cfg = MoEConfig(num_experts=E, top_k=1, gate="switch",
                        capacity_factor=1.25, d_ff_expert=f,
                        dispatch="grouped", payload_dtype=q)
        res, _ = ep_layer_run(torch, mesh, cfg, params, xl, gyl, valid)
        card, cpu = res["cuda"], res["cpu"]
        rel = {k: float((card[k].float().cpu() - cpu[k].float()).norm()
                        / cpu[k].float().norm().clamp(min=1e-30))
               for k in ("y", "dx", "gate_w", "w_up", "w_out")}
        out[f"1x4 qwire {q}"] = dict(rel=rel, card_ms=card["ms"],
                                     cpu_ms=cpu["ms"])
        del res, card, cpu
    return out


def greedy_with_logits(torch, model, prompt, steps, forced=None,
                       graph=None, cache_len=None, info=None, states=None):
    """Greedy generation through the step builders, each step's logits
    (f32) kept: ``(tokens (B, S + steps), logits (steps, B, V))``, across
    ranks each rank's rows gathered over ``data`` (``engine.whole_rows``,
    as ``generate`` samples); with ``forced`` (B, S + steps) the decode
    steps are fed its tokens (teacher forcing) instead of their own;
    ``graph`` as ``engine.build_decode`` takes it; caches of ``cache_len``
    (default S + steps); ``info`` (a dict) receives the bytes of the
    caches this process holds; ``states`` (a dict) the recurrent state
    leaves this process holds (:func:`served_states`) after the prefill
    (``"prefill"``) and after the last step (``"last"``), on the host."""
    from repro_torch.serving import engine
    B, S = prompt.shape
    cache_len = cache_len or S + steps
    out, logits = [prompt], []
    with torch.inference_mode():
        prefill = engine.build_prefill(model, cache_len=cache_len, batch=B)
        with engine.holding_decode(model, batch=B, cache_len=cache_len,
                                   graph=graph) as step:
            step.reset()
            if info is not None:
                info["cache_bytes"] = sum(
                    t.numel() * t.element_size()
                    for t in engine._cache_leaves(step.caches))
            last, _ = prefill(prompt, step.caches)
            if states is not None:
                states["prefill"] = served_states(step.caches)
            for i in range(steps):
                logits.append(engine.whole_rows(
                    model, last[:, -1].float(), B).cpu())
                tok = engine.whole_rows(
                    model, last[:, -1].argmax(-1, keepdim=True), B)
                out.append(tok)
                if i + 1 < steps:
                    feed = tok if forced is None else forced[
                        :, S + i:S + i + 1].to(tok.device)
                    last = step(feed, step_index=i)
            if states is not None:
                states["last"] = served_states(step.caches)
    return torch.cat(out, 1).cpu(), torch.stack(logits)


def served_states(caches):
    """Every recurrent state leaf of per-layer caches (``rwkv`` and
    ``mamba``: ``s``, ``x_last``, ``conv``; not the positions) by its
    path, copied to the host."""
    from repro_torch.launch.mesh import tree_paths
    return {p: t.detach().cpu().clone() for p, t in tree_paths(list(caches))
            if t.ndim and ("/rwkv/" in p or "/mamba/" in p)}


def ep_serve_prompt(torch, cfg):
    """The prompts ``launch.serve.run`` draws for ``EP_SERVE`` (its seed
    0 CPU generator)."""
    return torch.randint(0, cfg.vocab_size,
                         (EP_SERVE["batch"], EP_SERVE["prompt_len"]),
                         generator=torch.Generator().manual_seed(0))


def ep_serve_cfg():
    """18e's config: the preset cut to ``EP_SERVE["layers"]``, grouped."""
    from repro_torch import configs
    from repro_torch.serving.engine import serve_config
    return serve_config(configs.get_config(EP_SERVE["arch"]).replace(
        num_layers=EP_SERVE["layers"]), dispatch="grouped")


def ep_serve_reference(torch, path):
    """18e's one process: dbrx-132b (2 layers, bf16, grouped, seed 0) served
    greedy on the card over ``launch.serve.run``'s prompts, each step's
    logits and every gate call's router logits and experts kept (the eager
    decode step, bitwise the graph one: phase 3), saved for the ranks;
    returns its seconds."""
    import numpy as np
    from repro_torch.kernels import topk_gate as K
    from repro_torch.models.transformer import Transformer
    from repro_torch.serving import engine
    cfg = ep_serve_cfg()
    t0 = time.perf_counter()
    model = Transformer(cfg, device="cuda", seed=0)
    prompt = ep_serve_prompt(torch, cfg).cuda()
    fused = K.fused_topk_gate
    K.fused_topk_gate = tape = GateTape(fused)
    try:
        tokens, logits = greedy_with_logits(torch, model, prompt,
                                            EP_SERVE["gen"], graph=False)
    finally:
        K.fused_topk_gate = fused
    top2 = logits.topk(2, dim=-1).values
    gates = {}
    for i, (x, idx) in enumerate(tape.calls):
        gates[f"gate_logits_{i}"] = x.float().numpy()
        gates[f"gate_idx_{i}"] = idx.numpy()
    np.savez(path, tokens=tokens.numpy(), logits=logits.numpy(),
             margin=(top2[..., 0] - top2[..., 1]).numpy(),
             gate_calls=len(tape.calls), **gates)
    engine.clear_step_cache(model)
    del model
    release(torch)
    return time.perf_counter() - t0


def ep_fslice_kernel3(torch):
    """Kernel 3 at the f-slice shapes expert TP gives it in 18e (dbrx at
    2x2: 8 experts a rank, half of each expert's f, a view read in place)
    against its plain version, bf16 (phase 2c's bound), at decode's 32
    rows and a prefill-sized 4096; returns the largest error."""
    from repro_torch.kernels import grouped_ffn as G
    cfg = ep_serve_cfg()
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    g = torch.Generator(device="cuda").manual_seed(26)
    w_up = torch.randn((8, d, f), generator=g, device="cuda").to(
        torch.bfloat16)
    w_out = torch.randn((8, f, d), generator=g, device="cuda").to(
        torch.bfloat16)
    errs = {"grouped_matmul": 0.0}
    for M in (32, 4096):
        o = torch.tensor([0] + [M * (e + 1) // 8 for e in range(8)],
                         dtype=torch.int32, device="cuda")
        lhs = torch.randn((M, d), generator=g, device="cuda").to(
            torch.bfloat16)
        check_grouped_bf16(torch, G, f"18e f-slice w_up M={M} K={d} "
                           f"N={f // 2} (row stride {f})", lhs,
                           w_up[..., f // 2:], o, errs)
        h = torch.randn((M, f // 2), generator=g, device="cuda").to(
            torch.bfloat16)
        check_grouped_bf16(torch, G, f"18e f-slice w_out M={M} K={f // 2} "
                           f"N={d} (expert stride {f * d})", h,
                           w_out[:, f // 2:], o, errs)
    del w_up, w_out
    release(torch)
    return errs["grouped_matmul"]


def ep_serve_routes(torch, rank, one, calls):
    """This rank's gate calls against one process's on the same rows (the
    rank's block of each call's tokens): the router logits' distance over
    each call's largest |logit|, and each token whose experts differ, with
    the margin of the first pick that differs in one process's logits."""
    dist, flips = [], []
    for i, (x, idx) in enumerate(calls):
        n = x.shape[0]
        rows = slice(rank * n, (rank + 1) * n)
        ref_x = torch.from_numpy(one[f"gate_logits_{i}"][rows])
        ref_i = torch.from_numpy(one[f"gate_idx_{i}"][rows])
        dist.append(float((x.float() - ref_x).abs().max()
                          / ref_x.abs().max()))
        flips += [(i, r, m) for r, m in gate_near_ties([(ref_x, ref_i)],
                                                       [(x, idx)])]
    return dist, flips


def ep_serve_stored(model, cfg, fsdp: bool, case=EP_SERVE) -> dict:
    """A served model's stored bytes on this rank, of them the experts',
    ``launch/dryrun.count_pair``'s stored params and caches for the same
    config, mesh and layout (``case``'s decode shape), one process's cache
    bytes and each layer's cache form."""
    from repro_torch.core.config import ShapeConfig
    from repro_torch.launch import dryrun, shard
    from repro_torch.launch.mesh import tree_paths
    L = case["prompt_len"] + case["gen"]
    rec = dryrun.count_pair(
        cfg, ShapeConfig("18e", L, case["batch"], "decode"),
        model.layout.mesh_shape, fsdp=fsdp, expert_tp=model.layout_key[1],
        rank=model.mesh.rank)
    lay = model.cache_layout(case["batch"], L)
    return dict(stored=model.stored_bytes(),
                dry_run=rec["stored_bytes"]["params"],
                experts=sum(t.numel() * t.element_size() for p, t in
                            tree_paths(model.tree()) if shard.is_expert(p)),
                layout=model.layout_key,
                caches_dry_run=rec["stored_bytes"]["caches"],
                caches_one_process=lay.whole_bytes,
                forms=sorted(set(lay.forms) - {None}))


def ep_serve_run(torch, rank, one_path):
    """18e on one rank (every plain version made to raise): dbrx-132b at
    2x2, stored by the serving rule, teacher-forced on one process's
    tokens, first with its own routes (the router logits against one
    process's, the routes that differ), then replaying one process's
    routes (each step's logits against that process's, argmax agreement
    where its top-2 margin clears the bound); then served greedy through
    ``launch.serve.run`` (the prefill's gathers counted); then the model
    stored under FSDP, a prefill and ``EP_SERVE_FSDP_STEPS - 1`` decode
    steps on the replayed routes; returns the distances, the tokens, rank
    0's launches, the stored bytes against the dry run's, the times and
    the peak memory."""
    import hashlib

    import numpy as np
    from repro_torch.kernels import topk_gate as K
    from repro_torch.launch import serve, shard
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import Transformer
    from repro_torch.serving import engine
    one = np.load(one_path)
    cfg = ep_serve_cfg()
    mesh = make_mesh(EP_SERVE["mesh"], backend="gloo")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = Transformer(cfg, mesh=mesh, seed=0)
    stored = ep_serve_stored(model, cfg, False)
    forced = torch.from_numpy(one["tokens"])
    S = EP_SERVE["prompt_len"]
    ref = torch.from_numpy(one["logits"])
    scale = ref.abs().amax(dim=(1, 2))                   # per step
    fused = K.fused_topk_gate
    info = {}
    try:
        K.fused_topk_gate = tape = GateTape(fused)
        _, free = greedy_with_logits(torch, model, forced[:, :S].cuda(),
                                     EP_SERVE["gen"], forced=forced,
                                     info=info)
        router_err, flips = ep_serve_routes(torch, rank, one, tape.calls)
        replayed = [torch.from_numpy(one[f"gate_idx_{i}"][rank * x.shape[0]:(
            rank + 1) * x.shape[0]]) for i, (x, _) in enumerate(tape.calls)]
        K.fused_topk_gate = GateTape(fused, replayed)
        _, logits = greedy_with_logits(torch, model, forced[:, :S].cuda(),
                                       EP_SERVE["gen"], forced=forced)
    finally:
        K.fused_topk_gate = fused
    free_err = ((free - ref).abs().amax(dim=(1, 2)) / scale).tolist()
    step_err = ((logits - ref).abs().amax(dim=(1, 2)) / scale).tolist()
    clear = torch.from_numpy(one["margin"]) > EP_SERVE_BOUND * scale[:, None]
    agree = logits.argmax(-1) == ref.argmax(-1)
    stored["caches"] = info["cache_bytes"]
    engine.clear_step_cache(model)
    del model
    release(torch)
    reset_counts()
    shard.gathers = 0
    stats = {}
    t0 = time.perf_counter()
    tokens = serve.run(EP_SERVE["arch"], smoke=False,
                       batch=EP_SERVE["batch"], prompt_len=S,
                       gen=EP_SERVE["gen"], mesh_shape=EP_SERVE["mesh"],
                       dispatch="grouped", stats=stats,
                       num_layers=EP_SERVE["layers"])
    wall = time.perf_counter() - t0
    counts = read_counts([k for k, _, _ in COUNTERS])
    gathers, peak = shard.gathers, torch.cuda.max_memory_allocated()
    # the FSDP case: the same weights stored under FSDP, the replayed routes
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    model = Transformer(cfg, mesh=mesh, seed=0, fsdp=True)
    fsdp = ep_serve_stored(model, cfg, True)
    shard.gathers = 0
    try:
        K.fused_topk_gate = GateTape(fused, replayed)
        _, flogits = greedy_with_logits(
            torch, model, forced[:, :S].cuda(), EP_SERVE_FSDP_STEPS,
            forced=forced, cache_len=S + EP_SERVE["gen"])
    finally:
        K.fused_topk_gate = fused
    fsdp.update(gathers=shard.gathers, s=time.perf_counter() - t1,
                bitwise=bool(torch.equal(flogits,
                                         logits[:EP_SERVE_FSDP_STEPS])),
                max_abs_diff=float((flogits - logits[:EP_SERVE_FSDP_STEPS]
                                    ).abs().max()),
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    engine.clear_step_cache(model)
    del model
    release(torch)
    return dict(step_err=step_err, free_step_err=free_err,
                router_err=max(router_err), route_flips=flips,
                gate_calls=len(router_err),
                disagree_clear=int((~agree & clear).sum()),
                disagree_near_tie=int((~agree & ~clear).sum()),
                near_ties=int((~clear).sum()),
                logits_digest=hashlib.sha256(logits.numpy().tobytes()
                                             ).hexdigest(),
                tokens=tokens.cpu().numpy().tolist(),
                generated_eq_one_process=int((tokens.cpu()[:, S:]
                                              == forced[:, S:]).sum()),
                counts=counts, prefill_s=stats["prefill_s"],
                decode_ms=1e3 * stats["decode_s"] / stats["decode_steps"],
                wall_s=wall, peak_gib=peak / 2 ** 30, stored=stored,
                gathers=gathers, fsdp=fsdp)


def ep_state_cfg(case):
    """An ``EP_SERVE_STATES`` case's config: the preset cut to its
    ``layers``."""
    from repro_torch import configs
    return configs.get_config(case["arch"]).replace(
        num_layers=case["layers"])


def state_key(when: str, path: str) -> str:
    """The npz key of a recurrent state leaf at ``path`` after ``when``."""
    return f"{when}.{path.replace('/', '.')}"


def state_bound(key: str) -> float:
    """The bound of the state leaf ``state_key`` names: ``EP_STATE_BOUND``
    after the prefill, the leaf's ``EP_STATE_LAST_BOUNDS`` after the last
    step."""
    if key.startswith("prefill."):
        return EP_STATE_BOUND
    return EP_STATE_LAST_BOUNDS[key.rsplit(".", 1)[1]]


def ep_state_reference(torch, path, case):
    """An ``EP_SERVE_STATES`` case's one process on the card: greedy over
    ``launch.serve.run``'s prompts with each step's logits (the eager
    decode step) and the recurrent states after the prefill and after
    the last step, saved for the ranks; returns its seconds."""
    import numpy as np
    from repro_torch.models.transformer import Transformer
    from repro_torch.serving import engine
    cfg = ep_state_cfg(case)
    t0 = time.perf_counter()
    model = Transformer(cfg, device="cuda", seed=0)
    info, states = {}, {}
    prompt = torch.randint(0, cfg.vocab_size,
                           (case["batch"], case["prompt_len"]),
                           generator=torch.Generator().manual_seed(0))
    tokens, logits = greedy_with_logits(torch, model, prompt.cuda(),
                                        case["gen"], graph=False,
                                        info=info, states=states)
    top2 = logits.topk(2, dim=-1).values
    np.savez(path, tokens=tokens.numpy(), logits=logits.numpy(),
             margin=(top2[..., 0] - top2[..., 1]).numpy(),
             cache_bytes=info["cache_bytes"],
             **{state_key(when, p): t.numpy()
                for when, leaves in states.items()
                for p, t in leaves.items()})
    engine.clear_step_cache(model)
    del model
    release(torch)
    return time.perf_counter() - t0


def ep_serve_state(torch, rank, name, one_path):
    """18e-p, 18e-r, 18e-z or 18e-c (``name``, ``EP_SERVE_STATES``) on one
    rank: the case's model at its mesh, every cache leaf stored by the
    reference's cache rule, teacher-forced on one process's tokens (each
    step's logits against that process's, argmax agreement where its
    top-2 margin clears the bound) and its recurrent states on this rank
    against their blocks of one process's after the prefill and after
    the last step; then served greedy through ``launch.serve.run`` (its
    tokens, prefill and decode times, this rank's launches); the cache
    bytes a rank against the dry run's, the forms and state cuts."""
    import hashlib

    import numpy as np
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import Transformer
    from repro_torch.serving import engine
    case = EP_SERVE_STATES[name][0]
    one = np.load(one_path)
    cfg = ep_state_cfg(case)
    mesh = make_mesh(case["mesh"], backend="gloo")
    model = Transformer(cfg, mesh=mesh, seed=0)
    S, gen = case["prompt_len"], case["gen"]
    forced = torch.from_numpy(one["tokens"])
    ref = torch.from_numpy(one["logits"])
    scale = ref.abs().amax(dim=(1, 2))
    info, states = {}, {}
    _, logits = greedy_with_logits(torch, model, forced[:, :S].cuda(), gen,
                                   forced=forced, info=info, states=states)
    step_err = ((logits - ref).abs().amax(dim=(1, 2)) / scale).tolist()
    clear = torch.from_numpy(one["margin"]) > EP_SERVE_BOUND * scale[:, None]
    agree = logits.argmax(-1) == ref.argmax(-1)
    stored = ep_serve_stored(model, cfg, False, case)
    lay = model.cache_layout(case["batch"], S + gen)
    state_err = {}
    for when, leaves in states.items():
        for path, t in leaves.items():
            whole = torch.from_numpy(one[state_key(when, path)])
            blk = whole[lay.layout.block(path, whole.shape)]
            state_err[state_key(when, path)] = float(
                (t.float() - blk).abs().max() / blk.abs().max())
    engine.clear_step_cache(model)
    del model
    release(torch)
    reset_counts()
    stats = {}
    t0 = time.perf_counter()
    tokens = serve.run(case["arch"], smoke=False, batch=case["batch"],
                       prompt_len=S, gen=gen, mesh_shape=case["mesh"],
                       stats=stats, num_layers=case["layers"])
    wall = time.perf_counter() - t0
    counts = read_counts([k for k, _, _ in COUNTERS])
    release(torch)
    return dict(step_err=step_err,
                disagree_clear=int((~agree & clear).sum()),
                near_ties=int((~clear).sum()),
                logits_digest=hashlib.sha256(logits.numpy().tobytes()
                                             ).hexdigest(),
                state_err=state_err, forms=list(lay.forms),
                dims=list(lay.dims),
                tokens=tokens.cpu().numpy().tolist(),
                generated_eq_one_process=int((tokens.cpu()[:, S:]
                                              == forced[:, S:]).sum()),
                cache_bytes=info["cache_bytes"],
                one_cache_bytes=int(one["cache_bytes"]), stored=stored,
                counts=counts, prefill_s=stats["prefill_s"],
                decode_ms=1e3 * stats["decode_s"] / stats["decode_steps"],
                wall_s=wall)


def ep_rank(rank, refs):
    """Phase 18 on one of four ranks sharing the card over one gloo group:
    18a-b at meshes 1x4 and 2x2 (``ep_layer_checks``), 18d (expert TP and
    the quantized wire, ``ep_tp_checks``), then, with every kernel's plain
    version made to raise, 18c's training runs and 18e's serving."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {f"{D}x{M}": ep_layer_checks(torch, rank, (D, M), refs["prefill"])
           for D, M in EP_LAYER_MESHES}
    t0 = time.perf_counter()
    out["18d"] = ep_tp_checks(torch, rank, refs)
    out["18d_s"] = time.perf_counter() - t0
    forbid_plain_versions()
    for dispatch, tune, fabric in EP_TRAIN_CELLS:
        out[f"{dispatch} 1x4"] = ep_train_run(torch, rank, EP_TRAIN["mesh"],
                                              dispatch, tune, fabric)
    t0 = time.perf_counter()
    out["18f"] = ep_fsdp_run(torch, rank, refs["fsdp"])
    out["18f_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["18e"] = ep_serve_run(torch, rank, refs["serve"])
    out["18e_s"] = time.perf_counter() - t0
    for name in EP_SERVE_STATES:
        t0 = time.perf_counter()
        out[name] = ep_serve_state(torch, rank, name, refs[name])
        out[f"{name}_s"] = time.perf_counter() - t0
    release(torch)
    out["18g-a"] = ep_cp_blocks(torch, rank, refs["cp"])
    t0 = time.perf_counter()
    out["18g-b"] = ep_cp_train(torch, rank)
    out["18g-b_s"] = time.perf_counter() - t0
    return out


def live_cuda_tensors(torch, least: int = 1 << 26):
    """The GiB this process has allocated on the card and its live CUDA
    tensors of at least ``least`` bytes (by storage, largest first:
    MiB, shape, dtype) — what earlier phases left alive."""
    gc.collect()
    seen, found = set(), []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # deprecated aliases' FutureWarning
        for o in gc.get_objects():
            try:
                if not (isinstance(o, torch.Tensor) and o.is_cuda):
                    continue
                st = o.untyped_storage()
                ptr, n = st.data_ptr(), st.nbytes()
            except Exception:  # objects that refuse the probe (fake tensors)
                continue
            if ptr in seen or n < least:
                continue
            seen.add(ptr)
            found.append((round(n / 2 ** 20, 1), tuple(o.shape),
                          str(o.dtype)))
    return (torch.cuda.memory_allocated() / 2 ** 30,
            sorted(found, reverse=True))


# 16x16 executes every pair: two worker processes beside the four ranks
DRYRUN_ARGS = (("--all", "--jobs", "2"), ("--all", "--multi-pod"))


# ``python -m repro_torch.launch.dryrun ARGS`` that prints its own seconds
DRYRUN_RUN = ("import runpy, sys, time; t = time.perf_counter(); "
              "sys.argv = ['dryrun', *sys.argv[1:]]; "
              "runpy.run_module('repro_torch.launch.dryrun', "
              "run_name='__main__'); "
              "print(f'seconds {time.perf_counter() - t:.3f}')")


def start_dry_runs():
    """``python -m repro_torch.launch.dryrun`` with each of
    ``DRYRUN_ARGS``, on the CPU (no card), started now; returns the
    processes."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    return [(args, subprocess.Popen(
        [sys.executable, "-c", DRYRUN_RUN, *args], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for args in DRYRUN_ARGS]


def finish_dry_runs(runs) -> dict:
    """Wait for :func:`start_dry_runs`' processes: each must exit 0 with
    a line for every (preset, shape) pair; their own seconds."""
    out = {}
    for args, proc in runs:
        text, err = proc.communicate(timeout=600)
        lines = [ln for ln in text.splitlines() if ln.strip()]
        secs = (float(lines.pop().split()[1]) if lines
                and lines[-1].startswith("seconds ") else float("nan"))
        key = " ".join(args)
        out[key] = dict(rc=proc.returncode, pairs=len(lines),
                        skipped=sum("SKIP:" in ln for ln in lines), s=secs)
        print(f"  dryrun {key}: exit {proc.returncode}, {len(lines)} pairs "
              f"({out[key]['skipped']} skipped), {out[key]['s']:.1f} s "
              f"(the CPU only, beside the ranks)")
        check(proc.returncode == 0 and len(lines) == 40,
              f"dryrun {key}: exit {proc.returncode}, {len(lines)} lines: "
              f"{err[-2000:]}")
    return out


def phase_ep(torch, smi, dry):
    """Phase 18: expert parallelism with four ranks sharing the one card
    over gloo (``launch.mesh.spawn``, one spawn for the whole phase; NCCL
    refuses two ranks on one device).  18a: flat ≡ hierarchical bitwise at
    1x4 on CUDA tensors and both the host permutation; 18b: the paper's
    layer (f32) at 1x4 and 2x2, sort / dense / grouped, card ranks against
    the same ranks on the CPU, grouped 1x4 against one process, kernels 3-6
    at the receive side; 18c: the paper model whole trained at 1x4, sort
    (``--tune calibrate``) and grouped, against one process's first loss;
    18d-18g (``ep_rank``; the parent first takes each one-process
    reference, 18g-b's by ``cp_one_process_run``); ``dry`` the dry runs
    ``main`` started (:func:`start_dry_runs`), awaited beside the ranks.
    Returns (rank 0's launches in 18c, results)."""
    import tempfile

    from repro_torch.launch import train
    from repro_torch.launch.mesh import spawn
    names = [k for k, _, _ in COUNTERS]
    B, S, steps = EP_TRAIN["batch"], EP_TRAIN["seq"], EP_TRAIN["steps"]
    world = 4
    out = {"label": ep_label(world), "card": smi}
    held, tensors = live_cuda_tensors(torch)
    print(f"  the parent holds {held:.2f} GiB of tensors from earlier "
          f"phases; live tensors of 64 MiB or more {tensors[:12]}")
    out["parent_held_gib"] = held
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ep_") as tmp:
        refs = {k: str(pathlib.Path(tmp) / f"{k}.npz")
                for k in ("prefill", "decode", "serve", *EP_SERVE_STATES)}
        refs["fsdp"] = str(pathlib.Path(tmp) / "fsdp_ckpt")
        refs["cp"] = str(pathlib.Path(tmp) / "cp_blocks")
        for tokens, n_glob in EP_TP_TOKENS:
            ep_one_process_reference(torch, refs[tokens], n_glob)
        state, one = train.run(ARCH, steps=1, batch=B, seq=S, smoke=False,
                               seed=0, log_every=1, dispatch="grouped",
                               device="cuda")
        del state                  # held through the ranks' run before
        release(torch)
        cp_one = cp_one_process_run(torch)
        cp_parent_s = cp_blocks_reference(torch, refs["cp"])
        out["18e_one_process_s"] = ep_serve_reference(torch, refs["serve"])
        out["18e_kernel3_fslice_max_abs_err"] = ep_fslice_kernel3(torch)
        print(f"  18e one process ({EP_SERVE}): "
              f"{out['18e_one_process_s']:.1f} s")
        for name, (case, *_) in EP_SERVE_STATES.items():
            out[f"{name}_one_process_s"] = ep_state_reference(
                torch, refs[name], case)
            print(f"  {name} one process ({case}): "
                  f"{out[f'{name}_one_process_s']:.1f} s")
        print(f"phase 18: backend=gloo ranks={world} on 1 device: 18a-b at "
              f"meshes {EP_LAYER_MESHES}, 18d expert TP at {EP_TP_MESHES} "
              f"x {EP_TP_TOKENS} x {EP_TP_CASES} and the wire {EP_QWIRE} at "
              f"1x4, then 18c: {ARCH} whole, batch {B} x seq {S}, {steps} "
              f"AdamW steps at mesh 1x4 for {EP_TRAIN_CELLS} (dispatch, "
              f"--tune, --fabric), then 18e: {EP_SERVE}")
        release(torch)
        free, total = torch.cuda.mem_get_info()
        out["parent_reserved_gib"] = torch.cuda.memory_reserved() / 2 ** 30
        print(f"  the parent holds {torch.cuda.memory_reserved() / 2 ** 30:.2f}"
              f" GiB of its allocator's; the card has {free / 2 ** 30:.2f} "
              f"of {total / 2 ** 30:.2f} GiB free for the ranks")
        t0 = time.perf_counter()
        # the ranks' allocators map memory in pages as they grow: four
        # ranks' cached blocks leave no free segment of a large size
        alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        try:
            ranks = spawn(ep_rank, world, backend="gloo", threads=2,
                          args=(refs,), timeout=900)
        finally:
            out["dryrun"] = finish_dry_runs(dry)
            if alloc is None:
                del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
            else:
                os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
        ranks_s = time.perf_counter() - t0
        fsdp_parent = fsdp_one_process_restore(torch, refs["fsdp"],
                                               EP_FSDP["mesh"])
        fsdp_parent["bytes"] = sum(
            f.stat().st_size for f in pathlib.Path(refs["fsdp"]).glob(
                f"ckpt_{EP_FSDP['steps']:08d}.npz"))
    print(f"  [{smi}; {ep_label(world)}] the ranks took {ranks_s:.1f} s")
    for D, M in EP_LAYER_MESHES:
        key = f"{D}x{M}"
        out[key] = [r[key] for r in ranks]
        print(f"  18{'a-' if M == 4 else ''}b, mesh {key}:")
        for r, res in enumerate(out[key]):
            if res["exchange"] is not None:
                ex = res["exchange"]
                print(f"    rank {r} 18a: flat == hierarchical "
                      f"{ex['flat_eq_hier']}, == host permutation "
                      f"{ex['eq_host_permutation']}, {ex['bytes']} bytes a "
                      f"rank: flat {ex['ms']['flat']:.2f} ms, hierarchical "
                      f"{ex['ms']['hierarchical']:.2f} ms")
                check(ex["flat_eq_hier"] and ex["eq_host_permutation"],
                      f"18a rank {r}: {ex}")
            for name, _ in EP_LAYER_CASES + (EP_RELU_CASE,):
                if name not in res:
                    continue                  # relu: 1x4 only
                cell = res[name]
                errs = {k: f"{v:.2e}" for k, v in cell["errs"].items()}
                print(f"    rank {r} {name}: card vs CPU {errs}, card "
                      f"fwd+bwd {cell['card_ms']:.1f} ms, CPU "
                      f"{cell['cpu_ms']:.1f} ms, launches "
                      f"{cell['launches']}")
                check(max(cell["errs"].values()) <= EP_TOL,
                      f"18b {key} rank {r} {name}: card vs CPU "
                      f"{cell['errs']} > {EP_TOL}")
                check(all(cell["launches"].get(k, 0) > 0
                          for k in EP_LAYER_KERNELS[name]),
                      f"18b {key} rank {r} {name}: a kernel of "
                      f"{EP_LAYER_KERNELS[name]} not launched: "
                      f"{cell['launches']}")
                if name != "grouped":
                    continue
                rs = cell["receive_side"]
                print(f"      receive side: kernels 3-6 vs plain {rs}")
                check(max(rs[k] for k in ("grouped_matmul",
                                          "grouped_matmul_t",
                                          "grouped_drhs")) <= EP_TOL
                      and rs["scatter_add_rows_bitwise"],
                      f"18b {key} rank {r}: receive-side kernels {rs}")
                if "vs_one_process" in cell:
                    print(f"      vs one process: {cell['vs_one_process']}")
                    check(max(cell["vs_one_process"].values()) <= EP_TOL,
                          f"18b 1x4 grouped rank {r} vs one process "
                          f"{cell['vs_one_process']}")
    totals = dict.fromkeys(names, 0)
    for dispatch, tune, _ in EP_TRAIN_CELLS:
        cell = f"{dispatch} 1x4"
        runs = [r[cell] for r in ranks]
        hist = [r["history"] for r in runs]
        losses = [h["loss"] for h in hist[0]]
        print(f"  18c {cell}, --tune {tune}: fabric {runs[0]['fabric']}")
        for r, res in enumerate(runs):
            print(f"    [{smi}; {ep_label(world)}] rank {r}: step s "
                  f"{[round(t, 3) for t in res['step_s']]}, peak memory "
                  f"{res['peak_gib']:.2f} GiB, launches {res['counts']}")
        print(f"    losses {losses}")
        check(all(math.isfinite(v) for h in hist for m in h
                  for v in m.values()), f"18c {cell}: non-finite metrics")
        check(all(m["skipped"] == 0 for h in hist for m in h),
              f"18c {cell}: a step was skipped")
        check(all([m["loss"] for m in h] == losses for h in hist),
              f"18c {cell}: the ranks' losses differ")
        check(len({r["digest"] for r in runs}) == 1,
              f"18c {cell}: replicated leaves differ across ranks")
        prof = runs[0]["profiled"]
        print(f"    rank 0 profiled step, port kernels: {prof}")
        if dispatch == "grouped":
            rel = abs(losses[0] - one[0]["loss"]) / abs(one[0]["loss"])
            print(f"    step 1 loss {losses[0]:.6f} vs one process "
                  f"{one[0]['loss']:.6f}: relative {rel:.2e}")
            check(rel <= 1e-3, f"18c grouped step 1 loss {losses[0]} vs one "
                               f"process {one[0]['loss']}")
            check(all(runs[0]["counts"][k] > 0 for k in names),
                  f"18c grouped: a kernel of the path was not launched "
                  f"{runs[0]['counts']}")
            check(all(any(k.startswith(p) for k in prof) for p in (
                "topk_gate_kernel", "gather_rows_kernel", "scatter_",
                "grouped_mm_", "grouped_drhs_", "flash_")),
                f"18c grouped: the profiler missed a port kernel: {prof}")
            out["one_process_step1_loss"] = one[0]["loss"]
        for k in names:
            totals[k] += runs[0]["counts"][k]
        out[cell] = dict(losses=losses, step_s=[r["step_s"] for r in runs],
                         peak_gib=[r["peak_gib"] for r in runs],
                         fabric=runs[0]["fabric"],
                         launches_rank0=runs[0]["counts"],
                         profiled_rank0=prof)
    out["18d"] = report_ep_tp(ranks, smi, world)
    out["18e"] = report_ep_serve(ranks, smi, world)
    for name in EP_SERVE_STATES:
        out[name] = report_ep_serve_state(ranks, smi, world, name)
    out["18f"] = report_ep_fsdp(ranks, smi, world, one[0]["loss"],
                                fsdp_parent)
    out["18g"] = report_ep_cp(ranks, smi, world, cp_one, cp_parent_s)
    return totals, out


def report_ep_tp(ranks, smi, world):
    """18d's checks and printout: every cell card vs CPU within ``EP_TOL``
    of each max, grouped vs one process likewise, kernels 3-6 at the
    f-slice shapes, the expert-TP collectives of a forward and backward
    (sort: 2 and 2; grouped: 3 and 2, the count matrices' gather having
    no gradient), the wire within its QWIRE budgets."""
    print(f"  18d, expert TP over the data group [{smi}; "
          f"{ep_label(world)}], {max(r['18d_s'] for r in ranks):.1f} s:")
    for key in ranks[0]["18d"]:
        for r, res in enumerate(ranks):
            cell = res["18d"][key]
            if "qwire" in key:
                q = key.split()[-1]
                _, tol_out, tol_grad = next(t for t in EP_QWIRE if t[0] == q)
                print(f"    rank {r} {key}: card vs CPU normwise "
                      f"{ {k: f'{v:.2e}' for k, v in cell['rel'].items()} } "
                      f"(budgets {tol_out} / {tol_grad}), card "
                      f"{cell['card_ms']:.1f} ms, CPU {cell['cpu_ms']:.1f} ms")
                check(cell["rel"]["y"] <= tol_out
                      and max(v for k, v in cell["rel"].items() if k != "y")
                      <= tol_grad, f"18d {key} rank {r}: {cell['rel']}")
                continue
            errs = {k: f"{v:.2e}" for k, v in cell["errs"].items()}
            print(f"    rank {r} {key}: card vs CPU {errs}, TP collectives "
                  f"{cell['tp_collectives']}, card fwd+bwd "
                  f"{cell['card_ms']:.1f} ms, CPU {cell['cpu_ms']:.1f} ms, "
                  f"launches {cell['launches']}")
            check(max(cell["errs"].values()) <= EP_TOL,
                  f"18d {key} rank {r}: card vs CPU {cell['errs']}")
            check(cell["tp_collectives"] == (5 if "grouped" in key else 4),
                  f"18d {key} rank {r}: {cell['tp_collectives']} expert-TP "
                  f"collectives")
            if "grouped" not in key:
                continue
            rs, one = cell["receive_side"], cell["vs_one_process"]
            print(f"      f-slice kernels 3-6 vs plain {rs}; vs one "
                  f"process {one}")
            check(max(rs[k] for k in ("grouped_matmul", "grouped_matmul_t",
                                      "grouped_drhs")) <= EP_TOL
                  and rs["scatter_add_rows_bitwise"],
                  f"18d {key} rank {r}: f-slice kernels {rs}")
            check(max(one.values()) <= EP_TOL,
                  f"18d {key} rank {r} vs one process {one}")
    return [r["18d"] for r in ranks]


def report_ep_serve(ranks, smi, world):
    """18e's checks and printout: the tokens bitwise equal on every rank,
    the teacher-forced logits of every rank bitwise equal and within
    ``EP_SERVE_BOUND`` of each step's largest |logit| from one process,
    the argmax equal wherever one process's top-2 margin clears that
    bound, rank 0's launches of kernels 1, 2, 3, 6 and 7."""
    res = [r["18e"] for r in ranks]
    r0 = res[0]
    print(f"  18e, {EP_SERVE} [{smi}; {ep_label(world)}: host-staged, not "
          f"a speed of expert parallelism], "
          f"{max(r['18e_s'] for r in ranks):.1f} s:")
    for r, x in enumerate(res):
        print(f"    rank {r}: own routes: router logits within "
              f"{x['router_err']:.2e} of each call's max over "
              f"{x['gate_calls']} gate calls, {len(x['route_flips'])} "
              f"routes differ (call, row, margin) {x['route_flips']}, step "
              f"err / max|logit| {[f'{e:.2e}' for e in x['free_step_err']]}")
        print(f"    rank {r}: one process's routes replayed: step err / "
              f"max|logit| {[f'{e:.2e}' for e in x['step_err']]} (bound "
              f"{EP_SERVE_BOUND}); argmax differs at {x['disagree_clear']} "
              f"positions past the margin, {x['disagree_near_tie']} of "
              f"{x['near_ties']} near-ties; served: prefill "
              f"{1e3 * x['prefill_s']:.1f} ms, eager decode "
              f"{x['decode_ms']:.1f} ms a step, {x['wall_s']:.1f} s whole, "
              f"peak {x['peak_gib']:.2f} GiB; generated tokens equal to one "
              f"process's {x['generated_eq_one_process']} of "
              f"{EP_SERVE['batch'] * EP_SERVE['gen']}")
    print(f"    rank 0 launches {r0['counts']}")
    gib = 2 ** 30
    moe_layers = EP_SERVE["layers"]
    for r, x in enumerate(res):
        st, fs = x["stored"], x["fsdp"]
        print(f"    rank {r}: stored {st['stored'] / gib:.3f} GiB (experts "
              f"{st['experts'] / gib:.3f}; the dry run counts "
              f"{st['dry_run'] / gib:.3f}; layout (fsdp, expert_tp) "
              f"{st['layout']}), {x['gathers']} expert gathers in the "
              f"served prefill, peak {x['peak_gib']:.2f} GiB; under FSDP "
              f"stored {fs['stored'] / gib:.3f} GiB (the dry run "
              f"{fs['dry_run'] / gib:.3f}), {fs['gathers']} gathers over a "
              f"prefill + {EP_SERVE_FSDP_STEPS - 1} decode steps in "
              f"{fs['s']:.1f} s, peak {fs['peak_gib']:.2f} GiB, logits "
              f"bitwise the stored-slice run's {fs['bitwise']} (max |diff| "
              f"{fs['max_abs_diff']:.3e})")
    for r, x in enumerate(res):
        st = x["stored"]
        print(f"    rank {r}: caches {st['caches']} bytes a rank, forms "
              f"{st['forms']} (the dry run counts {st['caches_dry_run']}; "
              f"one process {st['caches_one_process']}: "
              f"{st['caches_one_process'] / st['caches']:.3f}x)")
    check(all(x["stored"]["caches"] == x["stored"]["caches_dry_run"]
              and x["stored"]["forms"] == ["heads"] for x in res),
          f"18e: the cache bytes a rank differ from the dry run's, or the "
          f"form is not heads {[x['stored'] for x in res]}")
    check(all(x["stored"]["stored"] == x["stored"]["dry_run"]
              and x["fsdp"]["stored"] == x["fsdp"]["dry_run"] for x in res),
          f"18e: stored bytes a rank differ from the dry run's "
          f"{[(x['stored'], x['fsdp']['stored']) for x in res]}")
    check(all(x["gathers"] == 3 * moe_layers for x in res),
          f"18e: the prefill gathered {[x['gathers'] for x in res]} leaves, "
          f"not its 3 expert leaves in each of {moe_layers} blocks")
    check(all(x["fsdp"]["bitwise"] for x in res),
          f"18e: the FSDP case's logits are not the stored-slice run's "
          f"{[x['fsdp']['max_abs_diff'] for x in res]}")
    check(all(x["tokens"] == r0["tokens"] for x in res),
          "18e: the ranks' tokens differ")
    check(len({x["logits_digest"] for x in res}) == 1,
          "18e: the ranks' teacher-forced logits differ")
    check(all(x["router_err"] <= EP_SERVE_BOUND for x in res),
          f"18e: router logits past the bound "
          f"{[x['router_err'] for x in res]}")
    check(all(e <= EP_SERVE_BOUND for x in res for e in x["step_err"]),
          f"18e: teacher-forced logits past the bound {r0['step_err']}")
    check(all(x["disagree_clear"] == 0 for x in res),
          f"18e: a greedy token differs from one process's past the margin")
    check(all(r0["counts"][k] > 0 for k in SERVE_KERNELS),
          f"18e: a kernel of the serving path was not launched on rank 0: "
          f"{r0['counts']}")
    return {k: v for k, v in r0.items() if k != "tokens"} | {
        "stored": [x["stored"] for x in res],
        "fsdp": [x["fsdp"] for x in res],
        "peak_gib": [x["peak_gib"] for x in res],
        "prefill_s": [x["prefill_s"] for x in res],
        "decode_ms": [x["decode_ms"] for x in res],
        "launches_rank0": r0["counts"]}


def report_ep_serve_state(ranks, smi, world, name):
    """18e-p, 18e-r, 18e-z or 18e-c's checks and printout: each step's
    teacher-forced logits within ``EP_SERVE_BOUND`` of one process's,
    bitwise equal on the ranks, the argmax equal past the margin, rank
    0's recurrent states within ``state_bound`` of their blocks of one
    process's after the prefill and after the last step, ``generate``'s
    tokens equal on the ranks, the cache bytes a rank the dry run's and
    the case's, the case's forms and state cuts, kernel 7 launched on
    rank 0 where the case attends."""
    case, forms, dims, cache_bytes = EP_SERVE_STATES[name]
    res = [r[name] for r in ranks]
    r0 = res[0]
    print(f"  {name}, {case} [{smi}; {ep_label(world)}: host-staged], "
          f"{max(r[f'{name}_s'] for r in ranks):.1f} s:")
    for r, x in enumerate(res):
        print(f"    rank {r}: step err / max|logit| "
              f"{[f'{e:.2e}' for e in x['step_err']]} (bound "
              f"{EP_SERVE_BOUND}); argmax differs at {x['disagree_clear']} "
              f"positions past the margin ({x['near_ties']} near-ties); "
              f"generated tokens equal to one process's "
              f"{x['generated_eq_one_process']} of "
              f"{case['batch'] * case['gen']}; caches {x['cache_bytes']} "
              f"bytes a rank (the dry run {x['stored']['caches_dry_run']}, "
              f"one process {x['one_cache_bytes']}), forms "
              f"{sorted(set(x['forms']), key=str)}, state cuts "
              f"{sorted(set(x['dims']))}; prefill "
              f"{1e3 * x['prefill_s']:.1f} ms, eager decode "
              f"{x['decode_ms']:.1f} ms a step, {x['wall_s']:.1f} s whole")
    worst = {}                 # (after, leaf) -> (its worst key, error)
    for k, v in r0["state_err"].items():
        at = (k.split(".", 1)[0], k.rsplit(".", 1)[1])
        if v >= worst.get(at, ("", -1.0))[1]:
            worst[at] = (k, v)
    print(f"    rank 0: {len(r0['state_err'])} state leaves against one "
          f"process's blocks, the largest error / max "
          + ("; ".join(f"after the {when} {leaf} {v:.2e} ({k}; bound "
                       f"{state_bound(k)})"
                       for (when, leaf), (k, v) in sorted(worst.items()))
             or "none")
          + f"; kernel 7 launches {r0['counts']['flash_fwd']}; launches "
          f"{r0['counts']}")
    check(all(x["cache_bytes"] == x["stored"]["caches_dry_run"] == cache_bytes
              and x["cache_bytes"] < x["one_cache_bytes"] for x in res),
          f"{name}: the cache bytes a rank are not the dry run's and "
          f"{cache_bytes} {[x['stored'] for x in res]}")
    check(all(sorted(set(x["forms"]), key=str) == sorted(forms, key=str)
              and sorted(set(x["dims"])) == sorted(dims) for x in res),
          f"{name}: forms {r0['forms']} and state cuts {r0['dims']}, not "
          f"{forms} and {dims}")
    check(all(e <= EP_SERVE_BOUND for x in res for e in x["step_err"]),
          f"{name}: teacher-forced logits past the bound {r0['step_err']}")
    check(len({x["logits_digest"] for x in res}) == 1,
          f"{name}: the ranks' teacher-forced logits differ")
    check(all(x["disagree_clear"] == 0 for x in res),
          f"{name}: a greedy token differs from one process's past the "
          f"margin")
    check(all(x["tokens"] == r0["tokens"] for x in res),
          f"{name}: the ranks' tokens differ")
    check((len(r0["state_err"]) > 0) == any(dims)
          and all(v <= state_bound(k) for k, v in r0["state_err"].items()),
          f"{name}: rank 0's states against one process's {r0['state_err']}")
    if any(f is not None for f in forms):
        check(r0["counts"]["flash_fwd"] > 0,
              f"{name}: kernel 7 was not launched on rank 0: {r0['counts']}")
    return {k: v for k, v in r0.items() if k != "tokens"} | {
        "cache_bytes": [x["cache_bytes"] for x in res]}


def print_ptxas(report: str, most: int = 24) -> None:
    """Registers and spills of each kernel from the build's ptxas report;
    a source with more than ``most`` instances (the gate's one per k and
    row layout, the flash kernels' one per head dim) as one line:
    instances, registers at most, spill bytes; then the instances at head
    dim 80 (hubert-xlarge's, ``<80, ...>`` mangled as ``ILi80E``) on their
    own."""
    import re
    for block in report.split("== ")[1:]:
        name, _, body = block.partition("\n")
        entries = []
        for line in body.splitlines():
            if "Compiling entry" in line:
                entries.append([line.split(chr(39))[1][:100]])
            elif entries and ("Used" in line or "spill" in line):
                entries[-1].append(line.strip())
        print(f"      == {name}")
        if len(entries) <= most:
            for e in entries:
                print(f"    {e[0]}")
                for line in e[1:]:
                    print(f"      {line}")
            continue
        text = "\n".join(" ".join(e) for e in entries)
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
        spill = sum(int(x) for x in re.findall(r"(\d+) bytes spill", text))
        print(f"      {len(entries)} kernels: at most {max(regs, default=0)} "
              f"registers, {spill} bytes of spill stores and loads in all")
        for e in entries:
            if "ILi80E" in e[0]:
                print(f"    {e[0]}\n      " + "\n      ".join(e[1:]))


# ---------------------------------------------------------------------------
# phase 19: the graph-invariant linter on the card
# ---------------------------------------------------------------------------

# the grad graph whose backward's launches phase 19 prints and checks
LINT_GRAD = "grouped/r1/flat/P2"


def phase_lint(torch, smi):
    """Phase 19: ``repro_torch.analysis.lint`` on ``cuda``: ``lint_cell``
    over the one-device (``r1``) cells — each forward and, grouped, its
    gradient recorded as an op graph (aten ops, logged collectives and
    kernel calls) and every op-graph rule run over it — the decode cells
    (the serving step-build validation) and the probes at the paper
    model's published size (an f32 train state's aliasing; two identical
    ``generate`` calls, whose decode step is one captured CUDA graph: each
    step-cache key built once).  Any finding fails the phase.  From the
    launch counters read around the backward of ``LINT_GRAD``'s gradient:
    the forward grouped kernel does not launch there, dlhs and drhs do.
    Returns (every kernel's launches over the phase, results)."""
    from repro_torch.analysis import lint

    names = [k for k, _, _ in COUNTERS]
    cells = [c for c in lint.matrix_cells()
             if lint.parse_cell(c)["mesh"] == "r1" or c.startswith("decode/")]
    out = {"card": smi, "cells": {}}
    findings = []
    reset_counts()
    t0 = time.perf_counter()
    for cell in cells:
        graphs = {}
        t = time.perf_counter()
        found = lint.lint_cell(cell, device="cuda", graphs=graphs)
        torch.cuda.synchronize()
        findings += found
        out["cells"][cell] = {
            "s": time.perf_counter() - t, "findings": len(found),
            "sites": {k: len(g.sites()) for k, g in graphs.items()},
            "kernel_calls": {k: sum(s.kind == "kernel" for s in g.sites())
                             for k, g in graphs.items()}}
        if cell == LINT_GRAD:
            grad = graphs[cell + ":grad"]
        print(f"  19 {cell}: {len(found)} finding(s), "
              f"{out['cells'][cell]['sites']} sites, "
              f"{out['cells'][cell]['s']:.2f} s")
        for f in found:
            print(f"    [{f.level}] {f.rule} @ {f.location}: {f.message}")
    bwd = {k: grad.launches["bwd"][f"{mod}.{attr}"]
           for k, mod, attr in COUNTERS}
    bwd_calls = {k: sum(1 for s in grad.sites("bwd") if s.op == k)
                 for k in ("grouped_matmul", "grouped_matmul_t",
                           "grouped_drhs")}
    print(json.dumps({"lint_grad_bwd_launches": bwd,
                      "cell": LINT_GRAD + ":grad",
                      "bwd_kernel_calls": bwd_calls}))
    check(bwd["grouped_matmul"] == 0 and bwd["grouped_matmul_t"] > 0
          and bwd["grouped_drhs"] > 0,
          f"19: the backward of {LINT_GRAD}'s gradient launched {bwd}: the "
          f"forward grouped kernel must not launch there, dlhs and drhs "
          f"must")
    check(all(bwd[k] == n for k, n in bwd_calls.items()),
          f"19: the backward's kernel calls {bwd_calls} are not its "
          f"launches {bwd}")
    out["cells_s"] = time.perf_counter() - t0
    t = time.perf_counter()
    report = {}
    probes = lint.lint_probes("cuda", arch=ARCH, smoke=False, report=report)
    torch.cuda.synchronize()
    out["probes_s"] = time.perf_counter() - t
    counts = read_counts(names)
    findings += probes
    decode = [b for b in report["builds"] if b[0] == "decode"]
    print(f"  19 probes ({ARCH} published size, a train state of "
          f"{report['params'] / 1e6:.1f}M f32 parameters): {len(probes)} "
          f"finding(s); step-cache builds {report['builds']}; "
          f"{out['probes_s']:.1f} s")
    check(decode and all(g is True and n == 1 for _, g, n in decode),
          f"19: the probes' decode steps were not each captured once as "
          f"a CUDA graph: {report['builds']}")
    for f in findings:
        print(f"  19 FINDING [{f.level}] {f.rule} @ {f.location} "
              f"({f.config}): {f.message}")
    check(not findings, f"19: the lint found {len(findings)} finding(s)")
    out.update(findings=len(findings), launches=counts,
               lint_grad_bwd_launches=bwd,
               seconds=time.perf_counter() - t0)
    release(torch)
    return counts, out


T_START = time.perf_counter()


def stamp(what):
    """The seconds since the script started, printed after ``what`` (and
    of them, those spent reading profiles)."""
    print(f"  [{time.perf_counter() - T_START:.1f} s since the start, after "
          f"{what}; {PROFILE_READ_S[0]:.1f} s of it reading profiles]")


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Drive the PyTorch port on one "
                                 "NVIDIA GPU (see the module docstring).")
    ap.add_argument("--phases", choices=("all", "kernels", "trainer",
                                         "presets", "frontends", "serving",
                                         "recurrent", "ep", "lint",
                                         "analysis"),
                    default="all",
                    help="'kernels': only the build, the kernel checks and "
                         "the kernel timings (phases 1, 2 and 5), for "
                         "working on a kernel; 'trainer': the build and "
                         "phases 9-11 and 14 (remat, resume, gates, the "
                         "windowed presets' training); 'presets': the build "
                         "and phases 12 and 13; 'frontends': the build, "
                         "phases 2g-2i, 2o, phase 5's rows at the frontend "
                         "presets' shapes and phase 15; 'serving': the "
                         "build and phases 3 and 16 (generate, SlotServer and "
                         "the traffic replay); 'recurrent': the build, phase "
                         "2p (kernels 7-9 at head dim 112) and phase 17 "
                         "(rwkv6-1.6b and zamba2-7b); 'ep': the build, "
                         "phase 2 and phase 18 (expert parallelism, ranks "
                         "sharing the card over gloo); 'lint': the build "
                         "and phase 19 (the graph-invariant linter on the "
                         "card); 'analysis': the build, phase 3's eager "
                         "decode step against the executed-program "
                         "analysis and phase 6b (its train step there); "
                         "each ends with ok: false")
    phases = ap.parse_args(argv).phases
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false — this script "
              "needs a GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    # phases 2m, 2n and 2p compile flex_attention yardsticks: fill their
    # caches in a process of its own while the kernels build, under the
    # settings this process compiles with
    flex_compile_env(torch)
    warm = start_flex_warm() if phases in ("all", "kernels", "ep") else None

    smi = smi_line()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    print(f"phase 1: {smi} | torch.cuda.get_device_name: {name} | torch "
          f"{torch.__version__} CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("  TF32 off for matmuls and cuDNN (f32 products run in full f32)")
    t0 = time.perf_counter()
    build.load()
    print(f"  kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"({build.build_info.get('library', 'already built')})")
    print_ptxas(build.build_info.get("ptxas", ""))
    # phase 18's dry runs (the CPU only) run beside the card's phases from
    # here, after the build's nvcc jobs: beside phase 18's ranks they would
    # take their cores
    dry = start_dry_runs() if phases in ("all", "ep") else None

    if phases == "trainer":
        print(json.dumps({"remat": phase_remat(torch, smi)}))
        print(json.dumps({"resume": phase_resume(torch, smi)}))
        print(json.dumps({"gates": phase_gates(torch, smi)}))
        release(torch)
        print(json.dumps({"windowed_train": phase_windowed_train(
            torch, smi)[1]}))
        print(smi)
        print(json.dumps({"ok": False,
                          "partial": "phases 1, 9-11 and 14 only"}))
        return 0
    if phases == "frontends":
        errs = phase_flash_kernels(torch, dev)
        phase_flash_frontends(torch, dev, errs)
        frontend_timings(torch, dev, smi)
        print(json.dumps({"frontends": phase_frontends(torch, smi)[1]}))
        print(smi)
        print(json.dumps({"ok": False, "partial": "phases 1, 2g-2i, 2o, "
                                                  "5 (frontend rows), 15"}))
        return 0
    if phases == "serving":
        print(json.dumps({"serving": phase_serve(torch, smi)[1]}))
        release(torch)
        print(json.dumps({"traffic": phase_traffic(torch, smi)[1]}))
        print(smi)
        print(json.dumps({"ok": False, "partial": "phases 1, 3 and 16 only"}))
        return 0
    if phases == "recurrent":
        errs = {}
        stamp("phase 1")
        rows = phase_flash_zamba2(torch, dev, smi, errs)
        stamp("phase 2p")
        print(json.dumps({"zamba2_flash": {"errs": errs, "timings": rows}}))
        counts, recurrent = phase_recurrent(torch, smi)
        print(json.dumps({"recurrent": recurrent,
                          "recurrent_launches": counts}))
        print(smi)
        print(json.dumps({"ok": False, "partial": "phases 1, 2p and 17 "
                                                  "only"}))
        return 0
    if phases == "lint":
        lint_counts, lint_out = phase_lint(torch, smi)
        stamp("phase 19")
        print(json.dumps({"lint": lint_out}))
        print(smi)
        print(json.dumps({"ok": False, "partial": "phases 1 and 19 only"}))
        return 0
    if phases == "analysis":
        from repro_torch import configs
        from repro_torch.models.transformer import Transformer
        from repro_torch.serving import engine
        cfg = configs.get_config(ARCH)
        model = Transformer(cfg, device="cuda", seed=0)
        dec = decode_vs_analysis(torch, smi, model, engine.serve_config(
            cfg, dispatch="grouped"))
        del model
        release(torch)
        print(json.dumps({"decode_vs_analysis": dec,
                          "profile_train": phase_profile_train(torch, smi)}))
        print(smi)
        print(json.dumps({"ok": False, "partial": "phases 1, 3 (the eager "
                                                  "decode step) and 6b"}))
        return 0
    if phases == "presets":
        print(json.dumps({"presets": phase_presets(torch, smi)[1]}))
        release(torch)
        print(json.dumps({"windowed": phase_windowed(torch, smi)[1]}))
        print(smi)
        print(json.dumps({"ok": False,
                          "partial": "phases 1, 12 and 13 only"}))
        return 0
    stamp("phase 1")
    errs = phase_kernels(torch, dev)
    stamp("phases 2a-2f")
    preset_rows = phase_preset_kernels(torch, dev, smi, errs)
    stamp("phases 2j-2k")
    errs.update(phase_flash_kernels(torch, dev))
    stamp("phases 2g-2i")
    phase_flash_wide(torch, dev, errs)
    stamp("phase 2l")
    wide_rows = phase_windowed_flash(torch, dev, smi, errs)
    stamp("phase 2m")
    wide_rows += phase_flash_wide_bwd(torch, dev, smi, errs)
    wide_rows += phase_flash_cp(torch, dev, smi, errs)
    stamp("phase 2n")
    phase_flash_frontends(torch, dev, errs)
    stamp("phase 2o")
    wide_rows += phase_flash_zamba2(torch, dev, smi, errs)
    stamp("phase 2p")
    finish_flex_warm(warm)
    if phases == "kernels":
        phase_timings(torch, dev, smi)
        print(smi)
        print(json.dumps({"ok": False, "partial": "phases 1, 2 and 5 only"}))
        return 0
    if phases == "ep":
        release(torch)
        ep_counts, ep = phase_ep(torch, smi, dry)
        stamp("phase 18")
        print(json.dumps({"ep": ep, "ep_launches": ep_counts}))
        print(smi)
        print(json.dumps({"ok": False, "partial": "phases 1, 2 and 18 "
                                                  "only"}))
        return 0
    serve_counts, serving = phase_serve(torch, smi)
    phase_card_vs_cpu(torch)
    stamp("phases 3-4")
    counts, training = phase_train(torch, smi)
    grads = phase_train_card_vs_cpu(torch)
    stamp("phases 7-8")
    remat = phase_remat(torch, smi)
    print(json.dumps({"remat": remat}))
    resume = phase_resume(torch, smi)
    print(json.dumps({"resume": resume}))
    gates = phase_gates(torch, smi)
    print(json.dumps({"gates": gates}))
    stamp("phases 9-11")
    release(torch)
    preset_counts, presets = phase_presets(torch, smi)
    print(json.dumps({"presets": presets}))
    stamp("phase 12")
    release(torch)
    windowed_counts, windowed = phase_windowed(torch, smi)
    print(json.dumps({"windowed": windowed}))
    stamp("phase 13")
    release(torch)
    wtrain_counts, wtrain = phase_windowed_train(torch, smi)
    print(json.dumps({"windowed_train": wtrain}))
    stamp("phase 14")
    release(torch)
    front_counts, front = phase_frontends(torch, smi)
    print(json.dumps({"frontends": front}))
    stamp("phase 15")
    release(torch)
    traffic_counts, traffic = phase_traffic(torch, smi)
    print(json.dumps({"traffic": traffic}))
    stamp("phase 16")
    release(torch)
    recurrent_counts, recurrent = phase_recurrent(torch, smi)
    print(json.dumps({"recurrent": recurrent}))
    stamp("phase 17")
    release(torch)
    ep_counts, ep = phase_ep(torch, smi, dry)
    print(json.dumps({"ep": ep}))
    stamp("phase 18")
    release(torch)
    lint_counts, lint_out = phase_lint(torch, smi)
    print(json.dumps({"lint": lint_out}))
    stamp("phase 19")
    rows = (phase_timings(torch, dev, smi) + frontend_timings(torch, dev, smi)
            + preset_rows + wide_rows)
    stamp("phase 5")
    profile = phase_profile(torch, smi)
    profile.update(phase_profile_train(torch, smi))
    stamp("phases 6-6b")

    # launches: the counts of the main paths, the phase-7 training runs
    # (each driven with the counts set to 0 just before it and read just
    # after; all nine path kernels run there); kernel 10, on no serving or
    # training path, counts the phase-5 run of its own entry point
    kernels = []
    for r in rows:
        if any(k["name"] == r["name"] for k in kernels):
            continue          # the first row of each kernel is the main shape
        kernels.append({k: r[k] for k in (
            "name", "route", "source", "replaces", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")}
            | {"launches": r.get("launches", counts.get(r["name"])),
               "max_abs_err": errs[r["name"]]})
        if r["name"] in preset_counts:
            kernels[-1]["launches_presets"] = preset_counts[r["name"]]
        if windowed_counts.get(r["name"]):
            kernels[-1]["launches_windowed"] = windowed_counts[r["name"]]
        if wtrain_counts.get(r["name"]):
            kernels[-1]["launches_windowed_train"] = wtrain_counts[
                r["name"]]
        if r["name"] + "_wide" in errs:
            # phases 2l-2n: head dims 120 and 256, f32 and bf16
            kernels[-1]["max_abs_err_windowed"] = errs[r["name"] + "_wide"]
        if front_counts.get(r["name"]):
            kernels[-1]["launches_frontends_train"] = front_counts[r["name"]]
        if traffic_counts.get(r["name"]):
            kernels[-1]["launches_traffic"] = traffic_counts[r["name"]]
        if recurrent_counts.get(r["name"]):
            kernels[-1]["launches_recurrent"] = recurrent_counts[r["name"]]
        if ep_counts.get(r["name"]):
            # phase 18c: rank 0 of the 1x4 runs (sort + grouped)
            kernels[-1]["launches_ep"] = ep_counts[r["name"]]
        if ep["18e"]["launches_rank0"].get(r["name"]):
            # phase 18e: rank 0 of dbrx-132b served at 2x2
            kernels[-1]["launches_ep_serve"] = ep["18e"]["launches_rank0"][
                r["name"]]
        if ep["18f"]["launches_rank0"].get(r["name"]):
            # phase 18f: rank 0 of the paper model's 3 FSDP steps at 2x2
            kernels[-1]["launches_fsdp"] = ep["18f"]["launches_rank0"][
                r["name"]]
        if ep["18g"]["launches_rank0"].get(r["name"]):
            # phase 18g-b: rank 0 of gemma2-9b's 2 steps at 2x2, rows split
            kernels[-1]["launches_cp"] = ep["18g"]["launches_rank0"][
                r["name"]]
        if lint_counts.get(r["name"]):
            # phase 19: the lint's one-device cells and probes
            kernels[-1]["launches_lint"] = lint_counts[r["name"]]
        if r["name"] + "_cp" in errs:
            # phase 2n: the context-parallel shapes (q positions offset)
            kernels[-1]["max_abs_err_cp"] = errs[r["name"] + "_cp"]
        if r["name"] + "_zamba2" in errs:
            # phase 2p: zamba2's head dim 112, f32 and bf16
            kernels[-1]["max_abs_err_zamba2"] = errs[r["name"] + "_zamba2"]
        if r["name"] + "_frontends" in errs:
            # phase 2o: the frontend presets' training shapes
            kernels[-1]["max_abs_err_frontends"] = errs[
                r["name"] + "_frontends"]
        if r["name"] == "gather_rows_rowstep":
            kernels[-1]["path"] = ("benchmark baseline (bench_layout), not "
                                   "on a serving or training path")
    check(len(kernels) == len(COUNTERS) + 1 and all(k["launches"]
                                                    for k in kernels),
          f"a kernel was not launched on its path: "
          f"{[(k['name'], k['launches']) for k in kernels]}")
    check(all(preset_counts[k] for k in SERVE_KERNELS),
          f"a kernel of the presets' path was not launched there: "
          f"{preset_counts}")
    check(windowed_counts["flash_fwd"] > 0,
          f"the flash forward was not launched on the windowed presets' "
          f"path: {windowed_counts}")
    check(all(wtrain_counts[k] > 0 for k in ("flash_fwd", "flash_dq",
                                              "flash_dkv")),
          f"a flash kernel was not launched in the windowed presets' "
          f"training: {wtrain_counts}")
    check(all(front_counts[k] > 0 for k in FLASH_NAMES),
          f"a flash kernel was not launched in the frontend presets' "
          f"training: {front_counts}")
    check(all(traffic_counts[k] > 0 for k in SERVE_KERNELS),
          f"a kernel of the serving path was not launched in the traffic "
          f"replays: {traffic_counts}")
    print(json.dumps({"serving": serving, "serving_launches": serve_counts,
                      "training": training, "train_grads_card_vs_cpu": grads,
                      "remat": remat, "resume": resume, "gates": gates,
                      "presets": presets, "presets_launches": preset_counts,
                      "windowed": windowed,
                      "windowed_launches": windowed_counts,
                      "windowed_train": wtrain,
                      "windowed_train_launches": wtrain_counts,
                      "frontends": front, "frontends_launches": front_counts,
                      "traffic": traffic, "traffic_launches": traffic_counts,
                      "recurrent": recurrent,
                      "recurrent_launches": recurrent_counts,
                      "ep": ep, "ep_launches": ep_counts,
                      "lint": lint_out, "lint_launches": lint_counts,
                      "timings": rows, "profile": profile}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
