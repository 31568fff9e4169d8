#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`implicitglobalgrid_tpu_torch`).

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py

Phases (every check raises; the script exits non-zero on the first failure
and then prints no result line):

1. The card's name and power limit (``nvidia-smi``) and the ``nvcc`` build
   of every kernel source, one ``nvcc`` per source, all started together,
   with their times and ``-Xptxas -v`` reports.
2. Each kernel against its plain PyTorch version on the card, on seeded
   random inputs at 256^3: ``fused_diffusion_steps`` in float32 for
   k = 2, 4, 8 and float64 for k = 4; ``fused_leapfrog_steps`` and
   ``fused_pt_iterations`` (random read-only T) in float32 for k = 2, 4, 6
   and float64 for k = 4; and at the x-marching kernels' ragged edges:
   (37, 45, 70) in float32 for k = 2, 6 (staggered) or 4 (diffusion), 8 and
   float64 for k = 4, a block smaller than one window (12, 12, 12) at k = 6
   (staggered) or 4 (diffusion), an x extent shorter than the plane rings
   (5, 64, 96) at k = 4, and for the diffusion kernel an odd z window
   (9, 20, 37) at k = 4.  Tolerance: bit-exact (the
   kernels are built with ``--fmad=false`` and round like their plain
   versions); the frozen outer ring (diffusion) and frozen boundary faces
   (staggered kernels) are checked bit-exact separately, P/Pf must change on
   the array boundary, and T must come back unchanged.
3. Diffusion main path, 256^3 float32 local block, periodic in x, y and z
   with overlap 8: ``diffusion3d.setup`` ->
   ``make_multi_step(nsteps=16, fused_k=4)`` (kernel launches + width-4
   self-neighbour slab exchanges, no ``diffusion_update`` launch), held
   against the per-step kernel's cadence ``make_multi_step(nsteps=16,
   exchange_every=4)`` (``ops.diffusion_update``, bit for bit the plain
   update: phase 20) on the card (rtol = atol = 1e-5, the JAX package's
   fused-vs-XLA tolerance: the kernel folds the constants differently).
4. Diffusion 512^3 float32, non-periodic: ``make_multi_step(nsteps=8,
   fused_k=4)``, finite, 2 launches (none of ``diffusion_update``), matched
   to the per-step kernel's cadence; then
   ``gather`` of the final field to rank 0 (block layout).
5. Acoustic main path, the JAX package's benchmark config: 256^3 float32,
   periodic in z, overlap 12, ``acoustic3d.make_multi_step(24, fused_k=6)``
   (4 launches) against ``exchange_every=6`` (rtol = atol = 2e-5, the JAX
   package's kernel-vs-XLA tolerance); then 256^3 non-periodic, the kernel
   alone, against the per-step cadence.
6. Porous main path, the JAX package's benchmark config: 256^3 float32,
   npt=12, periodic in z, overlap 14, ``porous_convection3d.make_multi_step(2,
   fused_k=6)`` (2 launches per step) against ``exchange_every=6``
   (max |diff| / max(scale, 1) < 2e-5 per field); then the ragged npt=10
   (chunks [6, 4]), non-periodic, against the same plain cadence.

7. The overlap schedules, 256^3 float32.  (a) Each kernel at its main
   path's k (diffusion 4, leapfrog and PT 6) at 256^3 and at (37, 45, 70):
   the ring launch and the mid launch, on two streams after the same inputs,
   against one ``"all"`` launch at the same tile, bit for bit (ring01/mid01
   at 256^3; ring0, ring1 and ring01 at the ragged shape), then at 256^3 the
   times of the ``"all"`` launch (at its own tile and at the split tile),
   the ring launch alone, the mid launch alone, ring then mid on one stream,
   and ring and mid on two streams.  (b) Each model's pipelined
   cadence (``pipelined=True``, which must admit the split) against
   ``pipelined=False``, bit for bit, on x/y/z-periodic twins of the main
   configs: diffusion overlap 8 ``fused_k=4`` (16 steps), acoustic overlap
   12 ``fused_k=6`` (12 steps), porous npt=12 overlap 14 ``fused_k=6`` (1
   step, chunks [6, 6]); launch counts set to 0 before each and read after
   (a ring and a mid launch per group), ms per step of both schedules.
   (c) Diffusion ``make_step(hide_comm=True)`` against ``make_step``, 4
   steps, bit for bit, from zeroed launch counts (32 ``diffusion_update``:
   seven a hide_comm step, the six boundary windows and the interior, and
   one a ``make_step``; no other kernel), and the ms per step of both.  Phases 3, 5 and 6 run
   the default ``pipelined`` (auto), which on one card must resolve to the
   serialized schedule (one launch per group): every x/y partner is the
   block itself, so there is no transfer to hide.
8. Ensembles (``models._batched``, ``batch=True``).  (a) Each kernel's
   batched launch at 256^3 float32, B = 4, at its main path's k: one launch
   for the 4 members against 4 single launches and against the batched
   plain version, bit for bit; batched ring01 + mid01 at the split tile
   against the batched ``"all"`` launch at that tile, bit for bit; the
   batched launch's ms, 4 single launches' ms back to back, ms per member
   and the bound (4 single bounds); and a ragged batch (B = 3, (37, 45,
   70)) against singles and plain.  (b) The ensemble main paths, every
   member against an unbatched run of it on the card, bit for bit, launch
   counts set to 0 before each batched run and read after (one launch per
   group, whatever B): diffusion 128^3 float32 periodic x/y/z overlap 8, 16
   steps ``fused_k=4`` for B = 1, 2, 4, 8 (the JAX package's
   ``bench_batch`` shape: ms per step, member-steps/s and members/s of a
   100-step job, and the host's enqueue time per step); diffusion 256^3 B = 4 at the same cadence; acoustic 256^3
   B = 4 at phase 5's config, one group of 6 steps; porous 256^3 npt=12 B
   = 2 at phase 6's config, one step; and diffusion 256^3 B = 2 with
   ``pipelined=True`` against the batched serialized run, bit for bit.

9. Gradients (``torch.autograd``) at the main paths' configs, 256^3
   float32, of ``loss = 1e-6 * sum(out**2)`` over the evolving fields:
   diffusion (phase 3's config, 16 steps ``fused_k=4``) w.r.t. T and Cp,
   acoustic (phase 5's, one group of 6 steps ``fused_k=6``) w.r.t. P,
   porous (phase 6's, npt=12, 1 step ``fused_k=6``) w.r.t. T and Pf.  The
   fused cadence runs its kernel in the forward (launch counts set to 0
   before the forward, read after it and again after the backward, which
   launches nothing) and the ``exchange_every=k`` cadence's groups in the
   backward (``models._fused``); its gradient is held against the plain
   cadence's gradient on the card at rtol = atol = 1e-4 (the JAX package's
   fused-gradient tolerance) and at 1e-4 of the gradient's largest entry,
   and must be non-zero on the exchange's send planes.  Printed: ms of the
   forward alone (inference and under autograd), of forward + backward for
   both cadences, and ``torch.cuda.max_memory_allocated`` of each.  Then
   diffusion 128^3 B = 2 ``batch=True``: each member's gradient equals its
   unbatched gradient bit for bit; and diffusion 256^3 forced
   ``pipelined=True``: its gradient equals the serialized one bit for bit.

10. Resilience and the integrity plane (``utils.resilience``,
   ``utils.checkpoint``, ``integrity``) at phase 3's config.  (a)
   ``guarded_time_loop`` over 8 calls of ``make_multi_step(4, fused_k=4)``
   under ``guard_every=1`` rollback, ``checkpoint_every=4`` keep 2 and
   ``integrity_every=1``: 16 launches (8 committed, 8 audit re-runs), the
   final T bit for bit the unguarded loop's, generations 4 and 8 verified,
   the restore bit-exact; a second loop over the directory with nt=12
   resumes at step 8 and equals 12 uninterrupted calls bit for bit.
   Printed: ms per call of the plain loop and of the guarded loop with
   every hook off (interleaved), one ``check_fields`` probe in turns with
   its flags alone and their mask form (``mask_nonfinite``), one audit
   (replay + word compare), ``save_checkpoint`` and ``restore_checkpoint``
   of the 128 MiB state in ms and MiB/s.  (d) ``IGG_INTEGRITY=1``
   ``update_halo(T, Cp)`` (self-partner hops) bit-exact with the unchecked
   exchange, an armed ``arm_transport_flip(0)`` raising
   ``IntegrityError(detector="transport_checksum")`` naming rank 0, and
   both exchanges' ms.  (c) ``bit_flip:step2:T`` caught by the audit at
   step 2, invisible to ``guard_every=1`` alone; ``halo_corrupt:step2``
   tripping the guard, and under rollback ending bit for bit the clean
   run; ``ckpt_corrupt:step4`` making ``latest_checkpoint`` fall back to
   step 2.  (b) ``integrity_every=1`` over one fused group of diffusion,
   acoustic and porous npt=12: serialized at phases 3, 5 and 6's configs,
   and forced ``pipelined=True`` at phase 7b's periodic x/y/z configs
   (with z alone periodic there is no x/y exchange to split): each audit
   must find the re-run bit-identical (the kernels and the two-stream
   schedule are run-to-run deterministic); any mismatch fails, with no
   retry.

11. Serving (``serving.ServingLoop``, ``serving.FrontDoor``) over the batched
   kernels.  (a) A diffusion pool at phase 3's config (256^3 float32,
   periodic x/y/z, overlap 8), capacity 4, 4 steps a round
   (``fused_k=4``), 6 requests of distinct ``ic_scale`` and budgets 8, 12
   and 16 steps, so that 2 members are admitted mid-flight: one batched
   launch a round, every member bit for bit its standalone unbatched
   ``make_multi_step(budget, fused_k=4)`` run; then a full pool's steady
   state: ms per round (``run_round`` wall), the bare batched step, the
   select of a partial pool and the finite probe each alone (CUDA events;
   the probe in turns with its mask form),
   member-steps/s, p50/p99 of ``serving.round_seconds``, and the seconds of
   one member's ``state_digest`` (what the door pays at each retirement).
   Every pool's step must leave its input pool bit-unchanged.  (b) In that
   pool: a NaN member is evicted and the 6 others stay bit for bit 11a's;
   under ``"rollback"`` a slot poisoned between rounds is rolled back once and
   its member ends bit for bit 11a's; ``IGG_INTEGRITY_EVERY=1`` audits
   every round with 0 mismatches (two launches a round).  (c) A porous
   pool at phase 6's config (npt=12, periodic z, overlap 14), capacity 2,
   1 step a round (``fused_k=6``): one member converges (its ``tol`` set
   between two of its standalone steps' residuals; its residual equals the
   standalone fused run's, and the plain cadence's within 2e-5), one
   completes its budget of 2, both bit for bit their standalone runs, two
   launches a round; an acoustic pool at phase 5's config, capacity 4, one
   round of 6 steps (``fused_k=6``), one launch, every member bit for bit
   its standalone run.  (d) ``FrontDoor`` on 127.0.0.1 over an 11a pool:
   the 6 requests POSTed, ``serve_rounds``, the results fetched: every
   digest equals ``state_digest`` of 11a's member; request latency
   p50/p99; then ``_execute_resize`` to capacity 5 with members live and
   ``elastic_resume`` into a fresh loop and door: the same digests, and
   both times.

   A POST that the step-stall rule refuses with 429 ``slo`` (the newest
   progress record is the previous pool's last round, older than the rule's
   1 s floor: the JAX package's semantics) is posted again after one serving
   iteration of the door; any other refusal fails.

12. The host planes (``utils.telemetry``, ``utils.tracing``,
   ``utils.liveplane``) at their defaults over the main paths.  (a) Each
   model's ``run()`` at its main config (diffusion 256^3 periodic x/y/z
   overlap 8, nt=16, ``fused_k=4``; acoustic periodic z overlap 12, nt=24,
   ``fused_k=6``; porous npt=12 periodic z overlap 14, nt=2, ``fused_k=6``):
   ms per ``run()`` with ``IGG_TELEMETRY=0`` and with telemetry on, in turns;
   then one run under a temporary ``IGG_TELEMETRY_DIR`` with
   ``IGG_HEARTBEAT_EVERY`` at the steps of a loop call: ``<model>.steps``
   and the ``step_seconds`` count equal nt, the events are ``run.start``,
   nt/every heartbeats and ``run.complete``, the launches equal the
   ``IGG_TELEMETRY=0`` run's and the result is bit for bit; the step loop's
   ``T_eff`` beside the CUDA-event one of phases 3, 5 and 6.  (b)
   ``dump_trace`` of those runs is a valid Chrome trace with one ``igg.step``
   span per loop call and the halo spans; one POST with a ``traceparent``
   through a ``FrontDoor`` over 11a's pool: its request tree holds the door's
   spans, the rounds, the halo exchanges and the digest, and its critical
   path is printed; phase 10c's ``bit_flip`` under ``integrity_every=1``
   writes ``flight_0.json``, whose last bundle names the audit's detector and
   step and holds the open ``igg.step`` span.  (c) A pool at 11a's config
   under ``IGG_METRICS_PORT=0`` and ``IGG_HEARTBEAT_EVERY=1``: ``/metrics``
   and ``/healthz`` over HTTP from the rank's server; then the stall drill
   (``stall:step3`` wedges the serving thread for ``STALL_S``): a POST during
   the stall is refused 429 ``slo`` by the critical step-stall rule, the
   next is admitted, one ``alert.step_stall`` event; every alert fired in
   phases 10-12 is printed.  Events, traces and flight bundles go to a
   temporary directory that the phase removes, and every variable it sets is
   restored.
13. The device timeline (``utils.profiling`` over ``torch.profiler``).
   (a) ``IGG_PROFILE=steps:4-12`` (porous: ``steps:1-2``, its two steps) over
   each main path's ``run()`` at phase 12a's configs, telemetry on: the
   capture meta lands, the trace parses, it holds device ops, the model's
   ``fused_*_kernel`` is under ``kernels`` with its device seconds,
   ``igg_halo_exchange`` is attributed, and no ``profile.capture_failed``
   event is written; printed per model: the scope table, the kernel's share
   of the device's busy time (porous: and the T update's) beside the
   CUDA-event shares of phases 3, 5 and 6, the device-idle share under
   capture, 1 - |union of the device ops' intervals| / the capture window's
   wall time (the profiler's host cost included), and an uncaptured
   estimate, 1 - the profiled busy time per step / phases 3, 5 and 6's
   CUDA-event ms per step of the bare loop.
   (b) ``igg.profile_trace`` around one pipelined group of 7b's diffusion
   twin attributes ``igg_ring_pass`` and ``igg_interior_pass``, and its
   overlap fraction is None (no NCCL on one card).  (c) Two captures back to
   back, one left open by a guard trip (``halo_corrupt:step8`` under
   ``guard_policy="raise"``, closed by the guarded loop's exit path with
   reason ``scope_exit``), then a fourth capture that starts and parses.
14. The supervisor and the fleet over child processes on the card
   (``python -m implicitglobalgrid_tpu_torch._workers``).  (a) A
   ``RunSupervisor`` over one rank of diffusion ``run()`` at phase 3's config
   with ``checkpoint_every=4`` under ``worker_crash:step8:proc0``: the
   incident is a ``crash`` (exit status 17), the second incarnation resumes
   at step 8, its final T equals an uncrashed run's bit for bit, and the
   seconds from the crash to the resumed step are printed.  (b) A
   ``FleetController`` of two pools, each a child process with a
   ``FrontDoor`` over a capacity-2 diffusion pool at 11a's config on device
   0, behind a ``FleetRouter`` on 127.0.0.1: two requests through the router,
   then the pool holding the first is killed; the router fails over, one
   respawn, and every result's digest equals a direct ``ServingLoop`` run's;
   the failover seconds are printed.  Every child is stopped, and checked
   reaped, before the phase ends; its directories are removed.
15. The autotuner (``tuning``) over the three kernels, at the main paths'
   points (``MAIN_RUNS``: phases 3, 5 and 6's configs).  (a) With
   ``IGG_TUNE_CACHE`` a fresh directory, the committed seed layer pointed
   at an empty one, ``IGG_TUNE_TOPK=4`` and ``IGG_TUNE_STEPS=3``:
   ``make_multi_step(autotune=True)`` searches; printed per candidate: the
   config, the modeled bytes per step and shared memory per block, the
   rejection or pruning reason or the measured ms per chunk call; then the
   winner, the default's and the hand-picked main-path config's times.
   ``tune.candidates_measured`` grows by the survivors exactly, the search
   launched the model's kernel, and the stored entry passes
   ``validate_entry`` and ``admissibility_error``.  (b) A second
   ``make_multi_step(autotune=True)`` is a cache hit: ``tune.cache_hit`` + 1,
   nothing measured, built or launched.  (c) The tuned run's state matches
   the default config's within phases 3/5/6's tolerances; survivors that
   share a ``fused_k`` match bit for bit; every survivor's explicit tile (or
   the first ``tile_ladder`` tile where none survived) matches the default
   tile bit for bit; one kernel launch at the winner's and at those tiles
   is timed in turns against the default tile.  (d) ``python -m implicitglobalgrid_tpu_torch.analysis``
   exits 0.  The phase restores its variables, removes its directory and
   prints its wall time.  ``--tune-out DIR`` also writes the winners'
   entries to DIR.

16. The example twins, the chunked gather and the analysis twins.  (a)
   The three fused examples (``examples/torch_*_gpu_fused.py``) through
   their functions at phases 3, 5 and 6's configs (one warm-up chunk and
   one timed chunk: 32 diffusion steps, 48 acoustic steps, 4 porous
   steps), launch counts set to 0 before each and read after (the model's
   kernel > 0); each final field equals, bit for bit, the same cadence
   replayed with every kernel call replaced by its plain version (the
   wrappers' ``*_reference``); the examples' own ms per step is printed.
   Then ``torch_diffusion3d_multidevice_novis`` on one rank, 256^3 float32
   20 steps (finite, its ms per step), and at 24^3 float64 against the
   same example on the CPU (1e-12 relative).  (b) ``gather`` of a 512^3
   float32 field with signed zeros through the local path and the forced
   chunked path at ``IGG_GATHER_BATCH`` 1 and 8: bit for bit against
   ``A.cpu().numpy()``, ``last_gather_stats`` as the plan says, the
   device transient (``max_memory_allocated`` after a reset) at most
   ``batch`` blocks plus one, ms and MiB/s.  (c) ``ptxas-budget`` over
   phase 1's builds runs (not skipped) and is clean against
   ``analysis/ptxas_baseline.json``; each kernel entry's registers,
   spills, stack and static shared memory are printed.  (d) ``python -m
   implicitglobalgrid_tpu_torch.analysis`` runs every analyzer clean.
17. The operator tools (``implicitglobalgrid_tpu_torch.scripts``), the
   soak's single-rank drills on the card.  (a) ``soak baseline init_flake
   halo_corrupt worker_crash --device cuda --nx 256 --fused-k 4 --steps
   16``: diffusion ``run()`` at the main path's 256^3 float32 block in
   kernel groups of 4, every recovered field's sha256 equal to the
   baseline's, every child's ``fused_diffusion_steps`` launches > 0 (the
   crashed child reports on its way out), each scenario's wall seconds and
   ``worker_crash``'s crash-to-done seconds printed.  (b) Side by side with
   (a): ``soak serving fleet --device cuda --nx 32 --fused-k 4 --steps 8``:
   the porous serving pool (``fused_pt_iterations`` batched, launches > 0)
   and the fleet drill, one rank per pool on device 0 (pools' and oracle's
   ``fused_diffusion_steps`` launches > 0).  (c) ``igg_trace`` merge +
   validate of each of (a)'s span dumps (exit 0), the ``igg_top`` view
   over (b)'s two pool doors (two rows), and a 2-rank drill asked onto one
   card refused with its message.  The five 2-rank drills wait for two or
   more cards.  This process launches nothing in the phase (its counts
   stay 0): the children count their own launches.
18. The bench harness (``implicitglobalgrid_tpu_torch.benchmarks``), the
   reconcile join and the padded-face exchange.  (a) ``benchmarks.run`` at
   phases 3, 4, 5 and 6's exact configs (diffusion 256^3 periodic x, y, z
   overlap 8 ``fused_k=4``, 16 steps a call; 512^3 non-periodic, 8 steps;
   acoustic periodic z overlap 12 ``fused_k=6``, 24 steps; porous npt=12
   periodic z overlap 14 ``fused_k=6``, 2 steps), 20 timed calls each,
   three times per config in turns with three readings of the same config
   timed the phase's way (``phase_way_ms``; order ``HARNESS_TURNS``): each
   record's path is ``cuda-fused``, the kernel's launch count rose, and the
   median of the harness's ms per step is within 5% of the median of the
   phase's way's; the phase's own reading is printed beside them.  (b)
   ``benchmarks.bench`` with no record file (``IGG_TUNE_CACHE`` a fresh
   directory): one JSON line; every extra carries numbers or is one of the
   twin's named skips, none holds an error; the checkout's top level is
   unchanged; the headline T_eff, ``vs_baseline`` and each fused extra's
   ms per step are printed (``--bench-out DIR`` also writes the record
   there).  (c) The record's ``efficiency`` join has ``achieved_fraction``
   and ``modeled_actual_gbs`` for the three models, printed beside the
   card's 3.35 TB/s (a rate above it is flagged: the byte model counts
   re-reads that L2 serves), and the ``cost-model`` analyzer is clean
   against ``analysis/cost_baseline.json``.  (d)
   ``ops.halo.update_halo_padded_faces`` on acoustic 256^3 float32 fields
   (random, periodic in x, y and z, width 1): with every dimension, bit
   for bit as ``update_halo`` of the unpadded fields; with ``dims=(0, 1)``,
   as ``update_halo`` on a grid periodic in x and y only.  Each part's time
   is printed.  18a runs right after phase 6, in the process state that
   phases 3-6 measured in; 18b-d at the end.  (e) The host side of one
   diffusion chunk call at phase 3's config (`host_probe`: the launches
   alone, timed on the host's clock with the card idle before each call,
   beside the call's CUDA-event time, the live threads, the objects the
   collector tracks, the allocator's segments, the telemetry metrics and
   the span ring), read right after 18a and again at the end (beside
   18a's diffusion 256^3 harness run, repeated there): as is,
   with ``IGG_TELEMETRY=0``, after ``gc.collect()`` and
   ``torch.cuda.empty_cache()``, and after resetting telemetry and tracing
   as well.  It prints; it fails on nothing.
19. The perf gate, the seed layer and the tuner at the bench's key, on
   18b's record (no new bench run).  (a) ``analysis.perf.gate_summary`` of
   the record against the newest committed ``BENCH_H100_r<NN>.json``:
   checked, regressions, waived, missing and both records' ``device``
   blocks are printed; the phase fails if the record has no ``device``
   block, if it checked nothing against a record of the same card, power
   limit and headline metric, if the record's own ``extras.perf_gate``
   differs from it, or if ``scripts.check_perf -c`` exits otherwise than
   the verdict says (0 within tolerance, 1 a regression, 2 another card).
   A metric that dropped is printed and named, not failed: the verdict
   rides in the record.  (b) ``python -m implicitglobalgrid_tpu_torch.tuning
   seed --dry-run`` over the committed records: every ``SEEDABLE`` row
   yields an entry with the bench's hand-picked config, admissible under
   ``admissibility_error`` on this card and equal to the committed seed
   entry.  (c) ``benchmarks.run.bench_tuned_vs_default`` for diffusion at
   the bench's key (256^3 non-periodic, 24-step chunks) with an empty
   primary cache, so that the committed seed layer answers: whether it was
   a cache hit, its config and source, ``tuned_speedup``, and the tuned
   ms per step against 18b's hand-picked ``diffusion_pallas_fused4``; a
   miss on a key the seed layer holds fails, and the tuned chunk must
   launch ``fused_diffusion_steps``.
20. The per-step diffusion update's kernel (``ops.diffusion_update``,
   ``csrc/diffusion_update.cu``, which replaces XLA's fusion of the JAX
   package's plain update and no Pallas kernel) at 512^3 float32: its
   ``-Xptxas -v`` registers and spills per entry; the main path of the
   benchmark's per-step cell, ``diffusion3d.make_multi_step(params, 16)``
   on a 512^3 block periodic in x, y and z with overlap 2, from zeroed
   launch counts: 16 launches of the kernel and none of the others, bit
   for bit the same cadence built on ``diffusion3d._plain_update``, and
   the ms per step of both; then one launch on random fields with the
   model's 512^3 coefficients against ``diffusion_update_reference``
   (bit-exact), ms per launch beside its bound (T and Cp read once, T
   written once), and the plain version's ms.  Its record, with the main
   path's launch count, joins the last JSON line's kernels.
21. The leapfrog kernel at the 512^3 acoustic benchmark cell's own path
   (512 launch blocks, about four waves, against 128 at 256^3): the
   kernel's tile, launch grid, shared memory and resident blocks per SM at
   512^3 float32 and k = 6; ``acoustic3d.setup(512, 512, 512)`` periodic
   in z with overlap 12, seeded noise on every field (P 1, the velocities
   0.1, as the cell's inputs carry), ``make_multi_step(params, 24,
   fused_k=6, autotune=False)`` from zeroed launch counts: 4 launches of
   ``fused_leapfrog_steps`` and none of the others, against the
   ``exchange_every=6`` cadence (rtol = atol = 2e-5, as phase 5); then one
   launch on the same 512^3 inputs with the model's coefficients against
   ``fused_leapfrog_steps_reference``, bit-exact, boundary faces frozen
   and P moved on the boundary; ms per launch beside its bound, the plain
   version's ms and the main path's ms per step.  Its record joins the
   last JSON line's kernels.
22. The porous temperature update's kernel (``ops.temperature_update``,
   ``csrc/temperature_update.cu``, which replaces XLA's fusion of the JAX
   package's plain update and no Pallas kernel) on the 256^3 porous
   benchmark cell's own path: its ``-Xptxas -v`` registers and spills per
   entry; ``porous_convection3d.setup(256, 256, 256, npt=12)`` float32,
   periodic in y with overlap 14, seeded noise on T (0.01, as the cell's
   inputs carry), ``make_multi_step(params, 8, fused_k=6,
   autotune=False)`` from zeroed launch counts: 8 launches of the kernel
   and 16 of ``fused_pt_iterations``, bit for bit the same cadence built
   on ``temperature_update_reference``, and the ms per step of both; then
   one launch on the step's output fields with the model's coefficients
   against ``temperature_update_reference`` (bit-exact), ms per launch
   beside its bound (T and the three face fluxes read once, T written
   once), and the plain version's ms.  Its record joins the last JSON
   line's kernels.  Phase 6's "T update" split times the same kernel.

Before the timing lines of phases 3, 5 and 6, each x-marching kernel's
tile, shared memory per block and resident blocks per SM
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) at 256^3 float32 and
the main path's k; phase 3 also times the width-4 exchange of T.
Every main path, phase 11's pools included, runs with every launch count
set to 0 just before it and read just after.  Then the script's wall time,
one JSON line with every kernel's launches, error and
times (kernel, plain version, bound from the card's published HBM rate and
float32 peak), and as the last line ``{"ok": true, "device": {...}}``.
Every time is taken with CUDA events after a warm-up and printed beside the
card's name and power limit.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import statistics
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: Published H100 SXM peaks (NVIDIA data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

#: Floating-point operations per cell and step (iteration) of each kernel's
#: update, counted from its source.  Diffusion: 3 axes x [2*v, -, +, *c] +
#: 2 adds + lap*minv + v+ (and one reciprocal per cell per launch).
#: Leapfrog: 3 faces x [-, *, -] + div [3 -, 3 *, 2 +] + [*, -].  PT:
#: x and y faces [-, *, -, *, +], z faces [-, *, +, *, *, +, -, *, +],
#: div as leapfrog.
FLOPS_PER_CELL_STEP = {"fused_diffusion_steps": 16, "fused_leapfrog_steps": 19,
                       "fused_pt_iterations": 29}
#: Each kernel's CUDA source and the TPU kernel it replaces.
KERNELS = {
    "fused_diffusion_steps": ("fused_diffusion", "implicitglobalgrid_tpu/ops/pallas_stencil.py:241"),
    "fused_leapfrog_steps": ("fused_leapfrog", "implicitglobalgrid_tpu/ops/pallas_leapfrog.py:230"),
    "fused_pt_iterations": ("fused_pt", "implicitglobalgrid_tpu/ops/pallas_pt.py:131"),
}
SOURCES = tuple(src for src, _ in KERNELS.values())
#: The three main paths' ``run()`` at phases 3, 5 and 6's configs (256^3
#: float32), read by phases 12a, 13a and 14a and by ``chip_run_turns.py``:
#: model -> run kwargs, nt, its kernel, the kernel's name in a device trace,
#: launches in one ``run()``, steps a loop call, phase 13a's profile window.
MAIN_RUNS = {
    "diffusion3d": dict(
        kw=dict(fused_k=4, periodx=1, periody=1, periodz=1, overlapx=8, overlapy=8, overlapz=8),
        nt=16, kernel="fused_diffusion_steps", label="fused_diffusion_kernel", launches=4,
        per_call=4, window="steps:4-12"),
    "acoustic3d": dict(
        kw=dict(fused_k=6, periodz=1, overlapx=12, overlapy=12, overlapz=12),
        nt=24, kernel="fused_leapfrog_steps", label="fused_leapfrog_kernel", launches=4,
        per_call=6, window="steps:4-12"),
    "porous_convection3d": dict(
        kw=dict(npt=12, fused_k=6, periodz=1, overlapx=14, overlapy=14, overlapz=14),
        nt=2, kernel="fused_pt_iterations", label="fused_pt_kernel", launches=4, per_call=1,
        window="steps:1-2"),
}

#: the phase running now, and every live-plane alert fired since phase 10
#: with the phase it fired in
PHASE = ["1"]
ALERTS: list = []


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def mask_nonfinite(torch, fields, per_member: bool):
    """The finite probe's mask form, which the one-pass ``torch.aminmax``
    read replaced: a ``~isfinite`` bool tensor the size of each field,
    reduced to a flag per field (or per member), then one host read.  It is
    timed in turns with the probe the port runs (phases 10a, 11a)."""
    if per_member:
        bad = torch.zeros(fields[0].shape[0], dtype=torch.int32, device=fields[0].device)
        for A in fields:
            bad = torch.maximum(bad, (~torch.isfinite(A)).flatten(1).any(1).to(torch.int32))
        return bad.cpu().numpy() > 0
    return torch.stack([torch.isfinite(A).all().logical_not() for A in fields]).cpu().numpy()


def in_turns(torch, fns, reps: int, turns: int = 3) -> list[list[float]]:
    """ms per call of each of ``fns`` (CUDA events), ``turns`` times in
    turns (A, B, A, B, ...), so that both see the same card and host."""
    out = [[] for _ in fns]
    for _ in range(turns):
        for ms, fn in zip(out, fns):
            ms.append(cuda_ms(torch, fn, reps=reps))
    return out


def ring_equal(torch, out, inp) -> bool:
    return all(
        torch.equal(out.select(d, i), inp.select(d, i))
        for d in range(3)
        for i in (0, out.shape[d] - 1)
    )


def boundary_moved(torch, out, inp) -> bool:
    return all(not torch.equal(out.select(d, 0), inp.select(d, 0)) for d in range(3))


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    """The least time the card could take: bytes over the HBM rate or
    float32 operations over the float32 peak, whichever is larger."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_FLOPS * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def nbytes(*tensors) -> int:
    return sum(a.numel() * a.element_size() for a in tensors)


def main() -> None:
    import argparse

    parser = argparse.ArgumentParser(description="Chip smoke test of the PyTorch/CUDA port.")
    parser.add_argument("--tune-out", default=None, metavar="DIR",
                        help="also write phase 15a's winners' cache entries to DIR")
    parser.add_argument("--bench-out", default=None, metavar="DIR",
                        help="also write phase 18b's bench record to DIR")
    args = parser.parse_args()
    tune_out = args.tune_out
    t_start = time.perf_counter()
    if not (ROOT / "implicitglobalgrid_tpu_torch" / "__init__.py").is_file():
        fail(f"{ROOT} holds no implicitglobalgrid_tpu_torch package: run from a checkout")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import implicitglobalgrid_tpu_torch as igg
    from implicitglobalgrid_tpu_torch.models import acoustic3d, diffusion3d, porous_convection3d
    from implicitglobalgrid_tpu_torch.ops import _kernels
    from implicitglobalgrid_tpu_torch.ops import diffusion_update as du
    from implicitglobalgrid_tpu_torch.ops import fused_leapfrog as fl
    from implicitglobalgrid_tpu_torch.ops import fused_pt as fp
    from implicitglobalgrid_tpu_torch.ops import fused_stencil as fs

    modules = {"fused_diffusion_steps": fs, "fused_leapfrog_steps": fl,
               "fused_pt_iterations": fp, "diffusion_update": du}

    def reset_counts():
        for m in modules.values():
            m.launches = 0

    def counts():
        return {name: m.launches for name, m in modules.items()}

    # -- Phase 1: the card, and the builds ------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    card = f"[{smi}]"
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        for f in [pool.submit(_kernels.build, s) for s in SOURCES]:
            f.result()
    for s in SOURCES:
        _kernels.load(s)
        print(f"phase 1: {s}.cu nvcc {_kernels.build_seconds.get(s, 0.0):.2f} s")
        print(_kernels.build_logs.get(s, "(library already built)").strip())
    print(f"phase 1: built+loaded {len(SOURCES)} sources in parallel in "
          f"{time.perf_counter() - t0:.2f} s")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- Phase 2: every kernel vs its plain version at 256^3 -------------------
    n = 256
    shape = (n, n, n)
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = dict.fromkeys(modules, 0.0)

    def compare(name, fn, ref, ins, k, dtype, frozen, where="256^3"):
        """One launch against the plain version, bit for bit."""
        before = modules[name].launches
        out = fn(*ins, k)
        torch.cuda.synchronize()
        if modules[name].launches != before + 1:
            fail(f"{name}: launch counter did not advance")
        want = ref(*ins, k)
        out = out if isinstance(out, tuple) else (out,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(float((a - b).abs().max()) for a, b in zip(out, want))
        checks = frozen(out)
        print(f"phase 2: {name} {str(dtype)[6:]} k={k} {where}: max|kernel-plain| = {err!r} "
              f"(tolerance 0: bit-exact), {checks}")
        if err != 0.0 or not all(checks.values()):
            fail(f"{name} disagrees with its plain version ({dtype}, k={k}): {err!r}, {checks}")
        max_err[name] = max(max_err[name], err)

    cx, cy, cz = 1 / 8.1, 0.5 / 8.1, 0.25 / 8.1
    f32, f64 = torch.float32, torch.float64
    for sh, dtype, k in (*((shape, dt, k) for dt, k in ((f32, 2), (f32, 4), (f32, 8), (f64, 4))),
                         ((37, 45, 70), f32, 2), ((37, 45, 70), f32, 4), ((37, 45, 70), f32, 8),
                         ((37, 45, 70), f64, 4), ((12, 12, 12), f32, 4), ((5, 64, 96), f32, 4),
                         ((9, 20, 37), f32, 4)):
        T = torch.randn(sh, generator=gen, device=dev, dtype=dtype)
        Cp = 1 + torch.rand(sh, generator=gen, device=dev, dtype=dtype)
        compare("fused_diffusion_steps",
                lambda T, Cp, k: fs.fused_diffusion_steps(T, Cp, k, cx, cy, cz),
                lambda T, Cp, k: fs.fused_diffusion_steps_reference(T, Cp, k, cx, cy, cz),
                (T, Cp), k, dtype, lambda out: {"ring bit-exact": ring_equal(torch, out[0], T)},
                "256^3" if sh == shape else str(sh))
        del T, Cp

    lf = (0.05, 0.04, 0.03, 0.07, 10.0, 6.6, 5.0)  # cax, cay, caz, b, idx, idy, idz
    pt = (0.5, 10.0, 6.6, 5.0, 1.0, 3e-4)  # th, idx, idy, idz, ralam, bp
    ragged = ((37, 45, 70), f32, 2), ((37, 45, 70), f32, 6), ((37, 45, 70), f32, 8), \
        ((37, 45, 70), f64, 4), ((12, 12, 12), f32, 6), ((5, 64, 96), f32, 4)
    for sh, dtype, k in (*((shape, dt, k) for dt, k in ((f32, 2), (f32, 4), (f32, 6), (f64, 4))),
                         *ragged):
        where = "256^3" if sh == shape else str(sh)
        cells = [torch.randn(sh, generator=gen, device=dev, dtype=dtype) for _ in range(2)]
        faces = [0.1 * torch.randn(s, generator=gen, device=dev, dtype=dtype)
                 for s in fl.face_shapes(sh)]

        def staggered_checks(out, first, *, T=None):
            checks = {
                "faces bit-exact": all(ring_equal(torch, o, a) for o, a in zip(out[1:], faces)),
                f"{first} moved on the boundary": boundary_moved(torch, out[0], cells[1]),
            }
            if T is not None:
                checks["T unchanged"] = torch.equal(cells[0], T)
            return checks

        compare("fused_leapfrog_steps",
                lambda *a: fl.fused_leapfrog_steps(*a[:-1], a[-1], *lf),
                lambda *a: fl.fused_leapfrog_steps_reference(*a[:-1], a[-1], *lf),
                (cells[1], *faces), k, dtype, lambda out: staggered_checks(out, "P"), where)
        T0 = cells[0].clone()
        compare("fused_pt_iterations",
                lambda *a: fp.fused_pt_iterations(*a[:-1], a[-1], *pt),
                lambda *a: fp.fused_pt_iterations_reference(*a[:-1], a[-1], *pt),
                (*cells, *faces), k, dtype, lambda out: staggered_checks(out, "Pf", T=T0), where)
        del cells, faces, T0

    records = {}

    def plan(name, mod, k, blocks, tile=None):
        """An x-marching kernel's launch plan at 256^3 float32 (``mod``: its
        wrapper module; ``blocks``: resident blocks per SM)."""
        tile = tile or mod.tile_for(shape, k, 4)
        print(f"{name}: tile (bx, by, bz) = {tile}, grid {mod.grid(shape, tile)}, "
              f"{mod.window_bytes(shape, k, tile, 4)} B shared memory per block, "
              f"{blocks} resident blocks per SM "
              f"({torch.cuda.get_device_properties(0).multi_processor_count} SMs) {card}")

    def record(name, launches, ms, plain_ms, bound_ms, bound_by):
        """The kernel's line of the JSON record (no PyTorch call computes the
        same function, so no library time)."""
        src, tpu = KERNELS[name]
        records[name] = {
            "name": name, "route": "cuda", "source": f"implicitglobalgrid_tpu_torch/csrc/{src}.cu",
            "replaces": tpu, "launches": launches, "max_abs_err": max_err[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        }

    # -- Phase 3: diffusion main path, 256^3 periodic, overlap 8 --------------
    (T0, Cp), params = diffusion3d.setup(
        n, n, n, periodx=1, periody=1, periodz=1, overlapx=8, overlapy=8,
        overlapz=8, dtype=torch.float32, quiet=True,
    )
    nsteps, k = 16, 4
    fused = diffusion3d.make_multi_step(params, nsteps, fused_k=k)
    plain = diffusion3d.make_multi_step(params, nsteps, exchange_every=k)
    fused(T0, Cp)  # warm-up (allocator)
    torch.cuda.synchronize()
    reset_counts()
    T_f, _ = fused(T0, Cp)
    torch.cuda.synchronize()
    diffusion_counts = counts()
    if (diffusion_counts["fused_diffusion_steps"] != nsteps // k
            or diffusion_counts["diffusion_update"] != 0):
        fail(f"diffusion main path launched {diffusion_counts}, expected {nsteps // k} diffusion "
             "and no diffusion_update (the serialized schedule: auto on one card)")
    T_p, _ = plain(T0, Cp)
    torch.cuda.synchronize()
    if not torch.isfinite(T_f).all():
        fail("diffusion main path produced non-finite values")
    torch.testing.assert_close(T_f, T_p, rtol=1e-5, atol=1e-5)
    main_err = float((T_f - T_p).abs().max())
    print(f"phase 3: diffusion 256^3 f32 periodic, 16 steps fused_k=4: launches {diffusion_counts}; "
          f"max|fused-per-step kernel cadence| = {main_err!r} (rtol=atol=1e-5)")

    c3 = [params.dt * params.lam / (d * d) for d in (params.dx, params.dy, params.dz)]
    out = fs.fused_diffusion_steps(T0, Cp, k, *c3)
    ref = fs.fused_diffusion_steps_reference(T0, Cp, k, *c3)
    max_err["fused_diffusion_steps"] = max(max_err["fused_diffusion_steps"],
                                           float((out - ref).abs().max()))
    plan("phase 3: fused_diffusion_steps", fs, k, fs.resident_blocks(shape, k, 4),
         fs.launch_tile(shape, k, 4, dev))
    kernel_ms = cuda_ms(torch, lambda: fs.fused_diffusion_steps(T0, Cp, k, *c3), reps=20)
    plain_ms = cuda_ms(torch, lambda: fs.fused_diffusion_steps_reference(T0, Cp, k, *c3), reps=3)
    bound_ms, bound_by = bound(nbytes(T0, Cp, T0),
                               k * (n - 2) ** 3 * FLOPS_PER_CELL_STEP["fused_diffusion_steps"]
                               + n**3)
    step_ms = cuda_ms(torch, lambda: fused(T0, Cp), reps=5) / nsteps
    plain_step_ms = cuda_ms(torch, lambda: plain(T0, Cp), reps=2, warmup=1) / nsteps
    teff = 2 * nbytes(T0) / (step_ms * 1e-3) / 1e9
    plain_teff = 2 * nbytes(T0) / (plain_step_ms * 1e-3) / 1e9
    main_teff = {"diffusion3d": teff}  # phase 12a prints the step loop's beside these
    # phase 13a prints the profiled device split beside these CUDA-event shares
    main_split = {"diffusion3d": {"fused_diffusion_kernel": kernel_ms / (k * step_ms)}}
    main_step_ms = {"diffusion3d": step_ms}  # phase 13a sets the profiled busy time beside it
    buf = T0.clone()
    exchange_ms = cuda_ms(torch, lambda: igg.update_halo(buf, width=k), reps=10)
    del buf
    copy_src = torch.empty(256 * 2**20, dtype=torch.float32, device=dev)
    copy_dst = torch.empty_like(copy_src)
    copy_ms = cuda_ms(torch, lambda: copy_dst.copy_(copy_src), reps=10)
    copy_gbs = 2 * copy_src.numel() * 4 / (copy_ms * 1e-3) / 1e9
    del copy_src, copy_dst
    print(f"phase 3: fused_diffusion_steps 256^3 f32 k=4: {kernel_ms!r} ms/launch, plain version "
          f"{plain_ms!r} ms, bound {bound_ms!r} ms ({bound_by}) {card}")
    print(f"phase 3: fused_k=4 {step_ms!r} ms/step, T_eff {teff!r} GB/s; per-step kernel "
          f"cadence exchange_every=4 {plain_step_ms!r} ms/step, T_eff {plain_teff!r} GB/s {card}")
    print(f"phase 3: width-4 exchange of T (periodic x, y, z): {exchange_ms!r} ms (one per 4 "
          f"steps) {card}")
    print(f"phase 3: device-to-device copy of 1 GiB: {copy_gbs!r} GB/s (read+write) {card}")
    record("fused_diffusion_steps", diffusion_counts["fused_diffusion_steps"], kernel_ms,
           plain_ms, bound_ms, bound_by)
    igg.finalize_global_grid()
    del T0, Cp, T_f, T_p, out, ref

    # -- Phase 4: diffusion 512^3 non-periodic, and gather ---------------------
    n4, nsteps4 = 512, 8
    (T0, Cp), params = diffusion3d.setup(n4, n4, n4, dtype=torch.float32, quiet=True)
    fused4 = diffusion3d.make_multi_step(params, nsteps4, fused_k=k)
    reset_counts()
    T_f, _ = fused4(T0, Cp)
    torch.cuda.synchronize()
    if counts()["fused_diffusion_steps"] != nsteps4 // k or counts()["diffusion_update"] != 0:
        fail(f"512^3 run launched {counts()}, expected {nsteps4 // k} diffusion and no "
             "diffusion_update")
    if not torch.isfinite(T_f).all():
        fail("512^3 run produced non-finite values")
    T_p, _ = diffusion3d.make_multi_step(params, nsteps4)(T0, Cp)
    torch.testing.assert_close(T_f, T_p, rtol=1e-5, atol=1e-5)
    err4 = float((T_f - T_p).abs().max())
    del T_p
    step4_ms = cuda_ms(torch, lambda: fused4(T0, Cp), reps=3, warmup=1) / nsteps4
    teff4 = 2 * n4**3 * 4 / (step4_ms * 1e-3) / 1e9
    print(f"phase 4: diffusion 512^3 f32 non-periodic, 8 steps fused_k=4: {nsteps4 // k} "
          f"launches, max|fused-per-step kernel cadence| = {err4!r}; {step4_ms!r} ms/step, T_eff "
          f"{teff4!r} GB/s "
          f"{card}")
    gg = igg.get_global_grid()
    G = igg.gather(T_f)
    want = tuple(d * s for d, s in zip(gg.dims, T_f.shape))
    if G is None or G.shape != want:
        fail(f"gather returned {None if G is None else G.shape}, expected {want}")
    if not (G == T_f.cpu().numpy()).all():
        fail("gathered field differs from the block")
    print(f"phase 4: gather -> {G.shape} {G.dtype}")
    igg.finalize_global_grid()
    del T0, Cp, T_f, G

    # -- Phase 5: acoustic main path, 256^3 periodic z, overlap 12 -------------
    ov = dict(overlapx=12, overlapy=12, overlapz=12)
    state, params = acoustic3d.setup(n, n, n, periodz=1, dtype=torch.float32, quiet=True, **ov)
    nsteps, k = 24, 6
    fused = acoustic3d.make_multi_step(params, nsteps, fused_k=k)
    plain = acoustic3d.make_multi_step(params, nsteps, exchange_every=k)
    fused(*state)  # warm-up (allocator)
    torch.cuda.synchronize()
    reset_counts()
    got = fused(*state)
    torch.cuda.synchronize()
    acoustic_counts = counts()
    if acoustic_counts["fused_leapfrog_steps"] != nsteps // k:
        fail(f"acoustic main path launched {acoustic_counts}, expected {nsteps // k} leapfrog")
    want = plain(*state)
    torch.cuda.synchronize()
    for name, g, w in zip(("P", "Vx", "Vy", "Vz"), got, want):
        if not torch.isfinite(g).all():
            fail(f"acoustic main path produced non-finite {name}")
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5, msg=lambda m: f"{name}: {m}")
    ac_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    print(f"phase 5: acoustic 256^3 f32 periodic z overlap 12, 24 steps fused_k=6: launches "
          f"{acoustic_counts}; max|fused-plain cadence| = {ac_err!r} (rtol=atol=2e-5)")
    co = (*(params.dt / params.rho / d for d in (params.dx, params.dy, params.dz)),
          params.dt * params.K, *(1.0 / d for d in (params.dx, params.dy, params.dz)))
    out = fl.fused_leapfrog_steps(*state, k, *co)
    ref = fl.fused_leapfrog_steps_reference(*state, k, *co)
    max_err["fused_leapfrog_steps"] = max(
        max_err["fused_leapfrog_steps"], *(float((a - b).abs().max()) for a, b in zip(out, ref)))
    plan("phase 5: fused_leapfrog_steps", fl, k, fl.resident_blocks("fused_leapfrog", shape, k, 4))
    kernel_ms = cuda_ms(torch, lambda: fl.fused_leapfrog_steps(*state, k, *co), reps=20)
    plain_ms = cuda_ms(torch, lambda: fl.fused_leapfrog_steps_reference(*state, k, *co), reps=3)
    bound_ms, bound_by = bound(2 * nbytes(*state),
                               k * n**3 * FLOPS_PER_CELL_STEP["fused_leapfrog_steps"])
    step_ms = cuda_ms(torch, lambda: fused(*state), reps=3) / nsteps
    plain_step_ms = cuda_ms(torch, lambda: plain(*state), reps=2, warmup=1) / nsteps
    teff = 2 * nbytes(*state) / (step_ms * 1e-3) / 1e9
    plain_teff = 2 * nbytes(*state) / (plain_step_ms * 1e-3) / 1e9
    main_teff["acoustic3d"] = teff
    main_split["acoustic3d"] = {"fused_leapfrog_kernel": kernel_ms / (k * step_ms)}
    main_step_ms["acoustic3d"] = step_ms
    bufs = [a.clone() for a in state]
    exchange_ms = cuda_ms(torch, lambda: igg.update_halo(*bufs, width=k), reps=10)
    del bufs
    print(f"phase 5: fused_leapfrog_steps 256^3 f32 k=6: {kernel_ms!r} ms/launch, plain version "
          f"{plain_ms!r} ms, bound {bound_ms!r} ms ({bound_by}) {card}")
    print(f"phase 5: width-6 exchange of the 4 fields (periodic z): {exchange_ms!r} ms {card}")
    print(f"phase 5: acoustic fused_k=6 {step_ms!r} ms/step, T_eff {teff!r} GB/s; plain cadence "
          f"exchange_every=6 {plain_step_ms!r} ms/step, T_eff {plain_teff!r} GB/s {card}")
    record("fused_leapfrog_steps", acoustic_counts["fused_leapfrog_steps"], kernel_ms, plain_ms,
           bound_ms, bound_by)
    igg.finalize_global_grid()
    del state, got, want, out, ref

    state, params = acoustic3d.setup(n, n, n, dtype=torch.float32, quiet=True)
    fused = acoustic3d.make_multi_step(params, nsteps, fused_k=k)
    reset_counts()
    got = fused(*state)
    torch.cuda.synchronize()
    if counts()["fused_leapfrog_steps"] != nsteps // k:
        fail(f"non-periodic acoustic run launched {counts()}, expected {nsteps // k} leapfrog")
    want = acoustic3d.make_multi_step(params, nsteps)(*state)
    for name, g, w in zip(("P", "Vx", "Vy", "Vz"), got, want):
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5, msg=lambda m: f"{name}: {m}")
    alone_ms = cuda_ms(torch, lambda: fused(*state), reps=3) / nsteps
    print(f"phase 5: acoustic 256^3 f32 non-periodic (kernel alone), 24 steps fused_k=6: "
          f"{nsteps // k} launches, max|fused-per-step cadence| = "
          f"{max(float((g - w).abs().max()) for g, w in zip(got, want))!r}; {alone_ms!r} ms/step, "
          f"T_eff {2 * nbytes(*state) / (alone_ms * 1e-3) / 1e9!r} GB/s {card}")
    igg.finalize_global_grid()
    del state, got, want

    # -- Phase 6: porous main path, 256^3, npt=12 periodic z and npt=10 -------
    def porous_run(npt, grid_kwargs, label, main):
        state, params = porous_convection3d.setup(n, n, n, npt=npt, dtype=torch.float32,
                                                  quiet=True, **grid_kwargs)
        nsteps, w = 2, 6
        fused = porous_convection3d.make_multi_step(params, nsteps, fused_k=w)
        plain = porous_convection3d.make_multi_step(params, nsteps, exchange_every=w)
        fused(*state)  # warm-up (allocator)
        torch.cuda.synchronize()
        reset_counts()
        got = fused(*state)
        torch.cuda.synchronize()
        c = counts()
        chunks = porous_convection3d._pt_schedule(npt, w)[1]
        if c["fused_pt_iterations"] != 2 * nsteps:
            fail(f"porous {label} launched {c}, expected 2 PT launches per step")
        want = plain(*state)
        torch.cuda.synchronize()
        errs = {}
        for name, g, wv in zip(("T", "Pf", "qDx", "qDy", "qDz"), got, want):
            if not torch.isfinite(g).all():
                fail(f"porous {label} produced non-finite {name}")
            errs[name] = float((g - wv).abs().max()) / max(float(wv.abs().max()), 1.0)
            if not errs[name] < 2e-5:
                fail(f"porous {label}: {name} max|fused-plain|/max(scale,1) = {errs[name]!r}")
        step_ms = cuda_ms(torch, lambda: fused(*state), reps=3, warmup=1) / nsteps
        plain_step_ms = cuda_ms(torch, lambda: plain(*state), reps=2, warmup=1) / nsteps
        teff = 2 * nbytes(*state) / (step_ms * 1e-3) / 1e9
        pt_gbs = 2 * nbytes(*state[1:]) / (step_ms / npt * 1e-3) / 1e9
        print(f"phase 6: porous {label}, 2 steps fused_k=6 (chunks {chunks}): launches {c}; "
              f"max|fused-plain cadence|/max(scale,1) = {max(errs.values())!r} (< 2e-5)")
        print(f"phase 6: porous {label}: {step_ms!r} ms/step, {step_ms / npt!r} ms/PT iteration, "
              f"T_eff {teff!r} GB/s, PT-loop {pt_gbs!r} GB/s (4 PT fields in+out per iteration); "
              f"plain cadence exchange_every=6 {plain_step_ms!r} ms/step {card}")
        if main:
            main_teff["porous_convection3d"] = teff
            main_step_ms["porous_convection3d"] = step_ms
            T, *s = state
            p = params
            co = (p.theta_q, 1.0 / p.dx, 1.0 / p.dy, 1.0 / p.dz, p.Ra * p.lam_T, p.beta_p)
            out = fp.fused_pt_iterations(T, *s, w, *co)
            ref = fp.fused_pt_iterations_reference(T, *s, w, *co)
            max_err["fused_pt_iterations"] = max(
                max_err["fused_pt_iterations"],
                *(float((a - b).abs().max()) for a, b in zip(out, ref)))
            plan("phase 6: fused_pt_iterations", fl, w, fl.resident_blocks("fused_pt", shape, w, 4))
            kernel_ms = cuda_ms(torch, lambda: fp.fused_pt_iterations(T, *s, w, *co), reps=20)
            plain_ms = cuda_ms(torch, lambda: fp.fused_pt_iterations_reference(T, *s, w, *co),
                               reps=3)
            bound_ms, bound_by = bound(nbytes(*state) + nbytes(*s),
                                       w * n**3 * FLOPS_PER_CELL_STEP["fused_pt_iterations"])
            print(f"phase 6: fused_pt_iterations 256^3 f32 k=6: {kernel_ms!r} ms/launch, plain "
                  f"version {plain_ms!r} ms, bound {bound_ms!r} ms ({bound_by}) {card}")
            t_update = porous_convection3d._temperature_update(params)
            t_ms = cuda_ms(torch, lambda: t_update(T, *s[1:]), reps=5)
            main_split["porous_convection3d"] = {"fused_pt_kernel": 2 * kernel_ms / step_ms,
                                                 "T update": t_ms / step_ms}
            bufs = [a.clone() for a in s]
            exchange_ms = cuda_ms(torch, lambda: igg.update_halo(*bufs, width=w), reps=10)
            t_exchange_ms = cuda_ms(torch, lambda: igg.update_halo(bufs[0]), reps=10)
            del bufs
            print(f"phase 6: per step: T update (temperature_update kernel) {t_ms!r} ms; "
                  f"width-6 exchange of "
                  f"the 4 PT fields {exchange_ms!r} ms (2 per step); width-1 exchange of one "
                  f"cell field (T's) {t_exchange_ms!r} ms {card}")
            record("fused_pt_iterations", c["fused_pt_iterations"], kernel_ms, plain_ms,
                   bound_ms, bound_by)
        igg.finalize_global_grid()

    porous_run(12, dict(periodz=1, overlapx=14, overlapy=14, overlapz=14),
               "256^3 f32 npt=12 periodic z overlap 14", main=True)
    porous_run(10, {}, "256^3 f32 npt=10 non-periodic", main=False)
    # phase 18a runs here, in the process state phases 3-6 measured in
    harness = phase18a(torch, reset_counts, counts, card,
                       {**main_step_ms, "diffusion3d_512": step4_ms})
    early = host_probe(torch, "right after phase 18a", card)

    phase7(torch, igg, modules, reset_counts, counts, card)
    phase8(torch, igg, modules, reset_counts, counts, card, records)
    phase9(torch, igg, reset_counts, counts, card)
    # Every alert the live plane's rule engine fires from here on, with the
    # phase it fired in (phase 12c prints them).
    from implicitglobalgrid_tpu_torch.utils import liveplane

    liveplane.subscribe(lambda alert: ALERTS.append((PHASE[0], alert)))
    PHASE[0] = "10"
    phase10(torch, igg, reset_counts, counts, card)
    PHASE[0] = "11"
    phase11(torch, igg, reset_counts, counts, card)
    PHASE[0] = "12"
    phase12(torch, igg, reset_counts, counts, card, main_teff)
    PHASE[0] = "13"
    phase13(torch, igg, reset_counts, counts, card, main_split, main_step_ms)
    PHASE[0] = "14"
    phase14(torch, igg, reset_counts, counts, card)
    PHASE[0] = "15"
    phase15(torch, igg, reset_counts, counts, card, tune_out=tune_out)
    PHASE[0] = "16"
    phase16(torch, igg, reset_counts, counts, card)
    PHASE[0] = "17"
    phase17(torch, reset_counts, counts, card)
    PHASE[0] = "18"
    bench_record = phase18(torch, igg, card, harness, bench_out=args.bench_out)
    phase18e(torch, card, early, main_step_ms["diffusion3d"])
    PHASE[0] = "19"
    phase19(reset_counts, counts, card, bench_record)
    PHASE[0] = "20"
    update_record = phase20(torch, igg, reset_counts, counts, card)
    PHASE[0] = "21"
    leapfrog512_record = phase21(torch, igg, reset_counts, counts, card)
    PHASE[0] = "22"
    t_update_record = phase22(torch, igg, reset_counts, counts, card)

    print(f"chip_smoke: phases 1-22 passed in {time.perf_counter() - t_start!r} s {card}")
    print(json.dumps({"kernels": [*(records[name] for name in KERNELS), update_record,
                                  leapfrog512_record, t_update_record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


def phase7(torch, igg, modules, reset_counts, counts, card) -> None:
    """Phase 7: the overlap schedules at 256^3 f32 (see the module docstring)."""
    from implicitglobalgrid_tpu_torch.models import _fused, acoustic3d, diffusion3d
    from implicitglobalgrid_tpu_torch.models import porous_convection3d
    from implicitglobalgrid_tpu_torch.ops import overlap

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(7)
    f32 = torch.float32
    side = torch.cuda.Stream(dev)
    n = 256

    # -- 7a: ring + mid (concurrent) against one "all" launch, bit for bit ----
    lf = (0.05, 0.04, 0.03, 0.07, 10.0, 6.6, 5.0)
    pt = (0.5, 10.0, 6.6, 5.0, 1.0, 3e-4)
    diff = (1 / 8.1, 0.5 / 8.1, 0.25 / 8.1)
    fs, fl, fp = (modules[m] for m in ("fused_diffusion_steps", "fused_leapfrog_steps",
                                        "fused_pt_iterations"))

    def inputs(name, sh):
        cells = [torch.randn(sh, generator=gen, device=dev, dtype=f32) for _ in range(2)]
        if name == "fused_diffusion_steps":
            return (cells[0], 1 + cells[1].abs())
        faces = [0.1 * torch.randn(s, generator=gen, device=dev, dtype=f32)
                 for s in fl.face_shapes(sh)]
        return (*cells[name == "fused_leapfrog_steps":], *faces)

    calls = {
        "fused_diffusion_steps": (fs, 4, lambda ins, k, **kw: (fs.fused_diffusion_steps(
            *ins, k, *diff, **kw),)),
        "fused_leapfrog_steps": (fl, 6, lambda ins, k, **kw: fl.fused_leapfrog_steps(
            *ins, k, *lf, **kw)),
        "fused_pt_iterations": (fl, 6, lambda ins, k, **kw: fp.fused_pt_iterations(
            *ins, k, *pt, **kw)),
    }

    def split(call, ins, k, tile, sel, concurrent=True):
        """Ring on the current stream, mid on ``side`` (both after the
        inputs), or both in order on the current stream."""
        main = torch.cuda.current_stream()
        side.wait_stream(main)
        ring = call(ins, k, tile=tile, tile_sel="ring" + sel)
        if not concurrent:
            return call(ins, k, tile=tile, tile_sel="mid" + sel, carry_in=ring)
        with torch.cuda.stream(side):
            out = call(ins, k, tile=tile, tile_sel="mid" + sel, carry_in=ring)
        main.wait_stream(side)
        return out

    for name, (mod, k, call) in calls.items():
        for sh, sels in (((n, n, n), ("01",)), ((37, 45, 70), ("0", "1", "01"))):
            ins = inputs(name, sh)
            _, by, bz = mod.tile_for(sh, k, 4)
            tile = (-(-sh[0] // _fused.PIPELINED_X_SEGMENTS), by, bz)
            ncx, ncy = overlap.tile_grid(sh[:2], tile)
            want = call(ins, k, tile=tile)
            for sel in sels:
                got = split(call, ins, k, tile, sel)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(got, want))
                segs = [min(tile[0], sh[0] - i * tile[0]) for i in range(ncx)]
                print(f"phase 7a: {name} f32 k={k} {sh} tile {tile}: ring{sel} "
                      f"{overlap.tile_subset_count('ring' + sel, ncx, ncy)} + mid{sel} "
                      f"{overlap.tile_subset_count('mid' + sel, ncx, ncy)} of {ncx * ncy} "
                      f"(x segments {segs}, {-(-sh[2] // bz)} z tiles each), concurrent: "
                      f"{'bit-exact' if same else 'DIFFERS'} against one 'all' launch")
                if not same:
                    fail(f"{name} {sh}: ring{sel} + mid{sel} differs from the 'all' launch")
            if sh[0] == n:
                ms = {
                    "all": cuda_ms(torch, lambda: call(ins, k), reps=10),
                    "all at the split tile": cuda_ms(torch, lambda: call(ins, k, tile=tile),
                                                     reps=10),
                    "ring alone": cuda_ms(torch, lambda: call(ins, k, tile=tile,
                                                              tile_sel="ring01"), reps=10),
                    "mid alone": cuda_ms(torch, lambda: call(ins, k, tile=tile, tile_sel="mid01",
                                                             carry_in=want), reps=10),
                    "ring then mid, one stream": cuda_ms(
                        torch, lambda: split(call, ins, k, tile, "01", False), reps=10),
                    "ring || mid, two streams": cuda_ms(
                        torch, lambda: split(call, ins, k, tile, "01"), reps=10),
                }
                print(f"phase 7a: {name} 256^3 f32 k={k} ms per launch: "
                      + ", ".join(f"{key} {v!r}" for key, v in ms.items()) + f" {card}")
            del ins, want, got

    # -- 7b: the pipelined cadences against the serialized ones ---------------
    def cadence(label, model, kmod, setup_kw, nsteps, k, stagger):
        state, params = model.setup(n, n, n, dtype=f32, quiet=True, periodx=1, periody=1,
                                    periodz=1, **setup_kw)
        shape = tuple(state[0].shape)
        err = model.pipelined_support_error(shape, k, f32, device=dev)
        if err is not None:
            fail(f"{label}: the pipelined split is not admissible: {err}")
        _, _, tile = _fused.split_selector(kmod, shape, k, k, f32, None, None, (0, 1), stagger,
                                           device=dev)
        piped = model.make_multi_step(params, nsteps, fused_k=k, pipelined=True)
        serial = model.make_multi_step(params, nsteps, fused_k=k, pipelined=False)
        piped(*state)  # warm-up (allocator, streams)
        torch.cuda.synchronize()
        reset_counts()
        got = piped(*state)
        torch.cuda.synchronize()
        c = counts()
        want = serial(*state)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        p_ms = cuda_ms(torch, lambda: piped(*state), reps=3, warmup=1) / nsteps
        s_ms = cuda_ms(torch, lambda: serial(*state), reps=3, warmup=1) / nsteps
        print(f"phase 7b: {label}: tile {tile}, launches {c} (ring + mid per group); "
              f"pipelined vs serialized {'bit-exact' if same else 'DIFFERS'}; pipelined "
              f"{p_ms!r} ms/step, serialized {s_ms!r} ms/step {card}")
        if not (same and finite):
            fail(f"{label}: pipelined cadence differs from the serialized one (finite {finite})")
        igg.finalize_global_grid()
        return c

    ov = lambda o: dict(overlapx=o, overlapy=o, overlapz=o)  # noqa: E731
    c = cadence("diffusion 256^3 f32 periodic x/y/z overlap 8, 16 steps fused_k=4",
                diffusion3d, fs, ov(8), 16, 4, 0)
    if c["fused_diffusion_steps"] != 2 * 4:
        fail(f"pipelined diffusion launched {c}, expected 2 per group")
    c = cadence("acoustic 256^3 f32 periodic x/y/z overlap 12, 12 steps fused_k=6",
                acoustic3d, fl, ov(12), 12, 6, 1)
    if c["fused_leapfrog_steps"] != 2 * 2:
        fail(f"pipelined acoustic launched {c}, expected 2 per group")
    c = cadence("porous 256^3 f32 npt=12 periodic x/y/z overlap 14, 1 step fused_k=6 "
                "(chunks [6, 6])", porous_convection3d, fp, dict(npt=12, **ov(14)), 1, 6, 1)
    if c["fused_pt_iterations"] != 2 * 2:
        fail(f"pipelined porous launched {c}, expected 2 per chunk")

    # -- 7c: hide_comm against make_step -------------------------------------
    (T0, Cp), params = diffusion3d.setup(n, n, n, dtype=f32, quiet=True, periodx=1,
                                         periody=1, periodz=1, hide_comm=True, **ov(8))
    hidden = diffusion3d.make_step(params)
    serial = diffusion3d.make_step(diffusion3d.Params(**{**params.__dict__, "hide_comm": False}))
    T_h, T_p = T0, T0
    reset_counts()
    for _ in range(4):
        T_h, _ = hidden(T_h, Cp)
        T_p, _ = serial(T_p, Cp)
    torch.cuda.synchronize()
    c = counts()
    same = torch.equal(T_h, T_p)
    h_ms = cuda_ms(torch, lambda: hidden(T0, Cp), reps=10)
    p_ms = cuda_ms(torch, lambda: serial(T0, Cp), reps=10)
    # hide_comm updates six boundary windows and the interior a step
    print(f"phase 7c: diffusion 256^3 f32 periodic x/y/z, 4 steps make_step(hide_comm=True) vs "
          f"make_step: {'bit-exact' if same else 'DIFFERS'}, launches {c} (4 x 7 + 4); "
          f"hide_comm {h_ms!r} ms/step, make_step {p_ms!r} ms/step {card}")
    if not same:
        fail("diffusion hide_comm step differs from make_step")
    if c != {**{name: 0 for name in c}, "diffusion_update": 4 * 7 + 4}:
        fail(f"7c: launched {c}, expected 32 diffusion_update and no other kernel")
    igg.finalize_global_grid()



def phase8(torch, igg, modules, reset_counts, counts, card, records) -> None:
    """Phase 8: ensembles, the batched launch and the batched cadences (see
    the module docstring)."""
    from implicitglobalgrid_tpu_torch.models import _batched, _fused, acoustic3d, diffusion3d
    from implicitglobalgrid_tpu_torch.models import porous_convection3d

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(8)
    f32 = torch.float32
    fs, fl, fp = (modules[m] for m in ("fused_diffusion_steps", "fused_leapfrog_steps",
                                        "fused_pt_iterations"))
    lf = (0.05, 0.04, 0.03, 0.07, 10.0, 6.6, 5.0)
    pt = (0.5, 10.0, 6.6, 5.0, 1.0, 3e-4)
    diff = (1 / 8.1, 0.5 / 8.1, 0.25 / 8.1)
    # Per kernel: tile module, main-path k, kernel call, plain call (both
    # return tuples), and the inputs of one member.
    calls = {
        "fused_diffusion_steps": (fs, 4, lambda ins, k, **kw: (fs.fused_diffusion_steps(
            *ins, k, *diff, **kw),), lambda ins, k: (fs.fused_diffusion_steps_reference(
                *ins, k, *diff),)),
        "fused_leapfrog_steps": (fl, 6, lambda ins, k, **kw: fl.fused_leapfrog_steps(
            *ins, k, *lf, **kw), lambda ins, k: fl.fused_leapfrog_steps_reference(*ins, k, *lf)),
        "fused_pt_iterations": (fl, 6, lambda ins, k, **kw: fp.fused_pt_iterations(
            *ins, k, *pt, **kw), lambda ins, k: fp.fused_pt_iterations_reference(*ins, k, *pt)),
    }

    def inputs(name, nb, sh):
        cells = [torch.randn((nb, *sh), generator=gen, device=dev, dtype=f32) for _ in range(2)]
        if name == "fused_diffusion_steps":
            return (cells[0], 1 + cells[1].abs())
        faces = [0.1 * torch.randn((nb, *s), generator=gen, device=dev, dtype=f32)
                 for s in fl.face_shapes(sh)]
        return (*cells[name == "fused_leapfrog_steps":], *faces)

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    # -- 8a: the batched launch ------------------------------------------------
    n, nb = 256, 4
    for name, (mod, k, call, plain) in calls.items():
        for sh, b in (((37, 45, 70), 3), ((n, n, n), nb)):
            ins = inputs(name, b, sh)
            before = modules[name].launches
            got = call(ins, k)
            torch.cuda.synchronize()
            if modules[name].launches != before + 1:
                fail(f"{name}: a batched call of {b} members launched "
                     f"{modules[name].launches - before} times, expected once")
            singles = [call(tuple(a[m] for a in ins), k) for m in range(b)]
            torch.cuda.synchronize()
            vs_singles = all(same([g[m] for g in got], s) for m, s in enumerate(singles))
            vs_plain = same(got, plain(ins, k))
            print(f"phase 8a: {name} f32 k={k} B={b} {sh}: one batched launch vs {b} single "
                  f"launches {'bit-exact' if vs_singles else 'DIFFERS'}, vs the batched plain "
                  f"version {'bit-exact' if vs_plain else 'DIFFERS'}")
            if not (vs_singles and vs_plain):
                fail(f"{name} B={b} {sh}: the batched launch differs (singles {vs_singles}, "
                     f"plain {vs_plain})")
            del singles
            if sh[0] != n:
                continue
            _, by, bz = mod.tile_for(sh, k, 4)
            tile = (-(-n // _fused.PIPELINED_X_SEGMENTS), by, bz)
            want = call(ins, k, tile=tile)
            ring = call(ins, k, tile=tile, tile_sel="ring01")
            split = call(ins, k, tile=tile, tile_sel="mid01", carry_in=ring)
            torch.cuda.synchronize()
            ok = same(split, want)
            print(f"phase 8a: {name} B={nb} 256^3 tile {tile}: batched ring01 + mid01 vs the "
                  f"batched 'all' launch {'bit-exact' if ok else 'DIFFERS'}")
            if not ok:
                fail(f"{name}: batched ring01 + mid01 differs from the batched 'all' launch")
            del want, ring, split
            bound_ms, bound_by = bound(nbytes(*ins, *got),
                                       k * nb * n**3 * FLOPS_PER_CELL_STEP[name])
            members = [tuple(a[m].clone() for a in ins) for m in range(nb)]
            batched_ms = cuda_ms(torch, lambda: call(ins, k), reps=10)
            singles_ms = cuda_ms(torch, lambda: [call(mb, k) for mb in members], reps=10)
            print(f"phase 8a: {name} 256^3 f32 k={k} B={nb}: batched launch {batched_ms!r} ms, "
                  f"{nb} single launches {singles_ms!r} ms, {batched_ms / nb!r} ms per member, "
                  f"bound {bound_ms!r} ms ({bound_by}) {card}")
            records[name]["batched"] = {"members": nb, "ms": batched_ms, "singles_ms": singles_ms,
                                        "ms_per_member": batched_ms / nb, "bound_ms": bound_ms,
                                        "bound_by": bound_by}
            del members
        del ins, got

    # -- 8b: the ensemble main paths ---------------------------------------------
    def ensemble(label, model, kmod, nb, nxyz, setup_kw, nsteps, step_kw, want_launches,
                 reps=3):
        """One batched run against each member's unbatched run, bit for bit;
        returns the batched run's ms per step (over ``reps`` runs)."""
        state, params = _batched.batched_setup(model, *nxyz, batch=nb, dtype=f32, quiet=True,
                                               **setup_kw)
        batched = model.make_multi_step(params, nsteps, batch=True, **step_kw)
        alone = model.make_multi_step(params, nsteps, **step_kw)
        batched(*state)  # warm-up (allocator)
        torch.cuda.synchronize()
        reset_counts()
        got = batched(*state)
        torch.cuda.synchronize()
        c = counts()
        for b in range(nb):
            want = alone(*_batched.member_state(state, b))
            if not all(torch.isfinite(g[b]).all() and torch.equal(g[b], w)
                       for g, w in zip(got, want)):
                fail(f"{label} B={nb}: member {b} differs from its unbatched run")
        if c[kmod] != want_launches:
            fail(f"{label} B={nb} launched {c}, expected {want_launches} {kmod}")
        ms = cuda_ms(torch, lambda: batched(*state), reps=reps, warmup=1) / nsteps
        # The host's enqueue of one run, from an idle device (no wait inside).
        host = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batched(*state)
            host.append((time.perf_counter() - t0) * 1e3 / nsteps)
        torch.cuda.synchronize()
        host_ms = sorted(host)[len(host) // 2]
        igg.finalize_global_grid()
        print(f"phase 8b: {label} B={nb}: launches {c} ({want_launches} groups: one launch each); "
              f"every member bit-exact with its unbatched run; {ms!r} ms per step back to back "
              f"(CUDA events, {reps} runs), host enqueue {host_ms!r} ms per step (median) {card}")
        return ms

    ov = lambda o: dict(overlapx=o, overlapy=o, overlapz=o)  # noqa: E731
    xyz = dict(periodx=1, periody=1, periodz=1)
    for nb in (1, 2, 4, 8):
        ms = ensemble("diffusion 128^3 f32 periodic x/y/z overlap 8, 16 steps fused_k=4",
                      diffusion3d, "fused_diffusion_steps", nb, (128,) * 3, {**xyz, **ov(8)}, 16,
                      dict(fused_k=4), 4, reps=20)
        print(f"phase 8b: diffusion 128^3 B={nb}: {nb / ms * 1e3!r} member-steps/s, "
              f"{nb / (ms * 1e-3 * 100)!r} members/s (100-step jobs) {card}")
    ensemble("diffusion 256^3 f32 periodic x/y/z overlap 8, 16 steps fused_k=4", diffusion3d,
             "fused_diffusion_steps", 4, (n,) * 3, {**xyz, **ov(8)}, 16, dict(fused_k=4), 4)
    ensemble("acoustic 256^3 f32 periodic z overlap 12, 6 steps fused_k=6", acoustic3d,
             "fused_leapfrog_steps", 4, (n,) * 3, dict(periodz=1, **ov(12)), 6,
             dict(fused_k=6), 1)
    ensemble("porous 256^3 f32 npt=12 periodic z overlap 14, 1 step fused_k=6",
             porous_convection3d, "fused_pt_iterations", 2, (n,) * 3,
             dict(npt=12, periodz=1, **ov(14)), 1, dict(fused_k=6), 2)

    state, params = _batched.batched_setup(diffusion3d, n, n, n, batch=2, dtype=f32, quiet=True,
                                           **xyz, **ov(8))
    piped = diffusion3d.make_multi_step(params, 16, batch=True, fused_k=4, pipelined=True)
    serial = diffusion3d.make_multi_step(params, 16, batch=True, fused_k=4, pipelined=False)
    reset_counts()
    got = piped(*state)
    torch.cuda.synchronize()
    c = counts()
    ok = same(got, serial(*state))
    print(f"phase 8b: diffusion 256^3 f32 B=2 periodic x/y/z, 16 steps fused_k=4 pipelined=True: "
          f"launches {c} (ring + mid per group); vs the batched serialized run "
          f"{'bit-exact' if ok else 'DIFFERS'}")
    if not ok or c["fused_diffusion_steps"] != 2 * 4:
        fail(f"batched pipelined diffusion: bit-exact {ok}, launches {c} (expected 8)")
    igg.finalize_global_grid()



def phase9(torch, igg, reset_counts, counts, card) -> None:
    """Phase 9: gradients through the fused cadences (see the module
    docstring)."""
    from implicitglobalgrid_tpu_torch.models import _batched, acoustic3d, diffusion3d
    from implicitglobalgrid_tpu_torch.models import porous_convection3d

    f32, n, scale = torch.float32, 256, 1e-6
    xyz = dict(periodx=1, periody=1, periodz=1)
    ov = lambda o: dict(overlapx=o, overlapy=o, overlapz=o)  # noqa: E731

    def leaves_of(state, wrt):
        return [a.clone().requires_grad_(i in wrt) for i, a in enumerate(state)]

    def loss_of(out, loss_idx):
        return scale * sum((out[i] ** 2).sum() for i in loss_idx)

    def grads(fn, state, wrt, loss_idx):
        leaves = leaves_of(state, wrt)
        return torch.autograd.grad(loss_of(fn(*leaves), loss_idx), [leaves[i] for i in wrt])

    def peak_mib(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() / 2**20

    def model_grad(label, model, kernel, setup_kw, nsteps, k, wrt, loss_idx, want_launches,
                   send_planes):
        """The fused cadence's gradient against the plain cadence's; returns
        the fused gradients and the state."""
        state, params = model.setup(n, n, n, dtype=f32, quiet=True, **setup_kw)
        fused = model.make_multi_step(params, nsteps, fused_k=k)
        plain = model.make_multi_step(params, nsteps, exchange_every=k)
        with torch.no_grad():
            fused(*state)  # warm-up (allocator)
        leaves = leaves_of(state, wrt)
        torch.cuda.synchronize()
        reset_counts()
        out = fused(*leaves)
        torch.cuda.synchronize()
        fwd_counts = counts()
        got = torch.autograd.grad(loss_of(out, loss_idx), [leaves[i] for i in wrt])
        torch.cuda.synchronize()
        if fwd_counts[kernel] != want_launches:
            fail(f"{label}: the forward under autograd launched {fwd_counts}, expected "
                 f"{want_launches} {kernel}")
        if counts() != fwd_counts:
            fail(f"{label}: the backward launched a kernel ({fwd_counts} -> {counts()})")
        del out
        want = grads(plain, state, wrt, loss_idx)
        errs = []
        for i, g, w in zip(wrt, got, want):
            if not torch.isfinite(g).all():
                fail(f"{label}: non-finite gradient w.r.t. input {i}")
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4,
                                       msg=lambda m: f"{label} d/d input {i}: {m}")
            err, top = float((g - w).abs().max()), float(w.abs().max())
            if not (top > 0 and err <= 1e-4 * top):
                fail(f"{label} d/d input {i}: max|fused-plain| {err!r} > 1e-4 * max|plain| "
                     f"{top!r}")
            a, o, w_ = send_planes
            for start in (o - w_, g.shape[a] - o):
                if not bool((g.narrow(a, start, w_) != 0).any()):
                    fail(f"{label} d/d input {i}: zero on the send planes [{start}, "
                         f"{start + w_}) of axis {a}")
            errs.append((err, top))
        with torch.no_grad():
            inf_ms = cuda_ms(torch, lambda: fused(*state), reps=3, warmup=1)
        fwd_ms = cuda_ms(torch, lambda: fused(*leaves), reps=3, warmup=1)
        both_ms = cuda_ms(torch, lambda: grads(fused, state, wrt, loss_idx), reps=3, warmup=1)
        plain_ms = cuda_ms(torch, lambda: grads(plain, state, wrt, loss_idx), reps=2, warmup=1)
        fused_mib = peak_mib(lambda: grads(fused, state, wrt, loss_idx))
        plain_mib = peak_mib(lambda: grads(plain, state, wrt, loss_idx))
        print(f"phase 9: {label}: forward launches {fwd_counts} (backward: none); gradient vs "
              f"the exchange_every={k} cadence's: max|diff| / max|plain| = "
              + ", ".join(f"{e!r} / {t!r}" for e, t in errs)
              + " (rtol=atol=1e-4), non-zero on the send planes")
        print(f"phase 9: {label}: forward {inf_ms!r} ms (inference), {fwd_ms!r} ms (under "
              f"autograd); forward + backward {both_ms!r} ms (plain cadence {plain_ms!r} ms); "
              f"max_memory_allocated {fused_mib!r} MiB (plain cadence {plain_mib!r} MiB) {card}")
        igg.finalize_global_grid()
        return got

    model_grad("diffusion 256^3 f32 periodic x/y/z overlap 8, 16 steps fused_k=4",
               diffusion3d, "fused_diffusion_steps", {**xyz, **ov(8)}, 16, 4, (0, 1), (0,), 4,
               (0, 8, 4))
    model_grad("acoustic 256^3 f32 periodic z overlap 12, 6 steps fused_k=6", acoustic3d,
               "fused_leapfrog_steps", dict(periodz=1, **ov(12)), 6, 6, (0,), (0, 1, 2, 3), 1,
               (2, 12, 6))
    model_grad("porous 256^3 f32 npt=12 periodic z overlap 14, 1 step fused_k=6",
               porous_convection3d, "fused_pt_iterations", dict(npt=12, periodz=1, **ov(14)), 1,
               6, (0, 1), (0, 1, 2, 3, 4), 2, (2, 14, 6))

    # Ensemble members against their unbatched gradients.
    state, params = _batched.batched_setup(diffusion3d, 128, 128, 128, batch=2, dtype=f32,
                                           quiet=True, **xyz, **ov(8))
    reset_counts()
    got = grads(diffusion3d.make_multi_step(params, 16, fused_k=4, batch=True), state, (0, 1),
                (0,))
    c = counts()
    alone = diffusion3d.make_multi_step(params, 16, fused_k=4)
    for b in range(2):
        want = grads(alone, _batched.member_state(state, b), (0, 1), (0,))
        diff = [float((g[b] - w).abs().max()) for g, w in zip(got, want)]
        print(f"phase 9: diffusion 128^3 f32 B=2 batch=True, 16 steps fused_k=4: member {b}'s "
              f"gradient (T, Cp) vs its unbatched gradient: max|diff| {diff} (launches {c})")
        if any(diff) or c["fused_diffusion_steps"] != 4:
            fail(f"batched gradient of member {b} differs from its unbatched one ({diff}), or "
                 f"launches {c} != 4")
    igg.finalize_global_grid()
    del state, got, want

    # The forced pipelined schedule against the serialized one.
    state, params = diffusion3d.setup(n, n, n, dtype=f32, quiet=True, **xyz, **ov(8))
    reset_counts()
    piped = grads(diffusion3d.make_multi_step(params, 16, fused_k=4, pipelined=True), state,
                  (0, 1), (0,))
    c = counts()
    serial = grads(diffusion3d.make_multi_step(params, 16, fused_k=4, pipelined=False), state,
                   (0, 1), (0,))
    same = all(torch.equal(p, s) for p, s in zip(piped, serial))
    print(f"phase 9: diffusion 256^3 f32 periodic x/y/z, 16 steps fused_k=4 pipelined=True: "
          f"launches {c} (ring + mid per group); gradient vs the serialized schedule's "
          f"{'bit-exact' if same else 'DIFFERS'}")
    if not same or c["fused_diffusion_steps"] != 2 * 4:
        fail(f"pipelined gradient: bit-exact {same}, launches {c} (expected 8)")
    igg.finalize_global_grid()


@contextlib.contextmanager
def fault_env(res, **env):
    """Set ``IGG_*`` variables for one case (None unsets) and re-arm the
    fault injector around it."""
    saved = {k: os.environ.get(k) for k in env}
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    res.reset_fault_injector()
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        res.reset_fault_injector()


def phase10(torch, igg, reset_counts, counts, card) -> None:
    from implicitglobalgrid_tpu_torch.integrity import IntegrityError, audit_fields
    from implicitglobalgrid_tpu_torch.models import acoustic3d, diffusion3d, porous_convection3d
    from implicitglobalgrid_tpu_torch.ops import halo
    from implicitglobalgrid_tpu_torch.utils import checkpoint as ck
    from implicitglobalgrid_tpu_torch.utils import resilience as res
    from implicitglobalgrid_tpu_torch.utils import telemetry as tele

    n, f32 = 256, torch.float32
    ov = lambda o: dict(overlapx=o, overlapy=o, overlapz=o)  # noqa: E731
    work = Path(tempfile.mkdtemp(prefix="igg_phase10_"))

    def counter(name):
        return tele.snapshot()["counters"].get(name, 0)

    def clones(state):
        return tuple(a.clone() for a in state)

    def loop(step, state, calls):
        for _ in range(calls):
            state = step(*state)
        return state

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    try:
        # -- 10a: the guarded diffusion main path ------------------------------
        (T0, Cp), params = diffusion3d.setup(n, n, n, periodx=1, periody=1, periodz=1,
                                             dtype=f32, quiet=True, **ov(8))
        state0 = (T0, Cp)
        step = diffusion3d.make_multi_step(params, 4, fused_k=4)
        ref8 = loop(step, clones(state0), 8)
        ref12 = loop(step, ref8, 4)
        ckdir = work / "a"

        def guard():
            return res.RunGuard(guard_every=1, policy="rollback", checkpoint_every=4,
                                checkpoint_dir=str(ckdir), checkpoint_keep=2,
                                integrity_every=1, names=("T", "Cp"))

        audits, mismatches = counter("integrity.audits"), counter("integrity.audit_mismatches")
        torch.cuda.synchronize()
        reset_counts()
        got = res.guarded_time_loop(step, clones(state0), 8, guard=guard())
        torch.cuda.synchronize()
        c = counts()
        steps = [s for s, _ in ck.checkpoint_steps(ckdir)]
        verified = [ck.verify_checkpoint(p) for _, p in ck.checkpoint_steps(ckdir)]
        restored, rstep, _ = ck.restore_checkpoint(ck.latest_checkpoint(ckdir))
        print(f"phase 10a: diffusion 256^3 f32 periodic x/y/z overlap 8, 8 calls of "
              f"make_multi_step(4, fused_k=4) under guard_every=1 rollback, checkpoint_every=4 "
              f"keep 2, integrity_every=1: launches {c} (8 committed + 8 audit re-runs); "
              f"final T vs the unguarded loop {'bit-exact' if same(got, ref8) else 'DIFFERS'}; "
              f"audits {counter('integrity.audits') - audits}, mismatches "
              f"{counter('integrity.audit_mismatches') - mismatches}; generations {steps}, "
              f"verify {verified}; restore (step {rstep}) "
              f"{'bit-exact' if same(restored, got) else 'DIFFERS'}")
        if not (same(got, ref8) and same(restored, got) and rstep == 8):
            fail("the guarded diffusion loop or its checkpoint differs from the unguarded loop")
        if c["fused_diffusion_steps"] != 16 or steps != [4, 8] or any(verified):
            fail(f"guarded loop: launches {c}, generations {steps}, verify {verified}")
        reset_counts()
        resumed = res.guarded_time_loop(step, clones(state0), 12, guard=guard())
        torch.cuda.synchronize()
        c = counts()
        print(f"phase 10a: a second loop over the same directory with nt=12 resumes at step 8: "
              f"launches {c} (4 committed + 4 audit re-runs); vs 12 uninterrupted calls "
              f"{'bit-exact' if same(resumed, ref12) else 'DIFFERS'}")
        if not same(resumed, ref12) or c["fused_diffusion_steps"] != 8:
            fail(f"resumed loop: launches {c}, bit-exact {same(resumed, ref12)}")

        # Costs: the idle guard against the plain loop (A, B, A, B, ...), one
        # probe, one audit's compare and replay, a save and a restore.
        calls = 20
        idle = lambda: res.guarded_time_loop(step, state0, calls, guard=res.RunGuard())  # noqa: E731
        plain = lambda: loop(step, state0, calls)  # noqa: E731
        plain_ms, idle_ms = [], []
        for _ in range(3):
            plain_ms.append(cuda_ms(torch, plain, reps=2, warmup=1) / calls)
            idle_ms.append(cuda_ms(torch, idle, reps=2, warmup=1) / calls)
        probe_ms, flag_ms, mask_ms = in_turns(torch, [
            lambda: res.check_fields(*got),
            lambda: torch.stack([res.nonfinite_flags(A) for A in got]).cpu(),
            lambda: mask_nonfinite(torch, got, False),
        ], reps=10)
        if res.check_fields(*got).bad_blocks or mask_nonfinite(torch, got, False).any():
            fail("the finite probe flags the clean state")
        redone = step(*state0)
        compare_ms = cuda_ms(torch, lambda: audit_fields(redone, redone), reps=10)
        replay_ms = cuda_ms(torch, lambda: step(*res.snapshot_state(state0)), reps=10)
        mib = sum(a.numel() * a.element_size() for a in got) / 2**20
        t0 = time.perf_counter()
        path = ck.save_checkpoint(work / "timing", got, 8)
        save_s = time.perf_counter() - t0
        like = clones(got)
        t0 = time.perf_counter()
        ck.restore_checkpoint(path, like=like)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        print(f"phase 10a: ms per call of 20 calls, interleaved: plain loop {plain_ms!r}, "
              f"guarded loop with every hook off {idle_ms!r} {card}")
        print(f"phase 10a: one check_fields probe of T, Cp {probe_ms!r} ms; in turns with it, "
              f"its flags and one host read {flag_ms!r} ms, the mask form's {mask_ms!r} ms; "
              f"one audit = one "
              f"replayed call from a snapshot {replay_ms!r} ms + the word compare "
              f"{compare_ms!r} ms {card}")
        print(f"phase 10a: save_checkpoint of the {mib!r} MiB state {save_s * 1e3!r} ms "
              f"({mib / save_s!r} MiB/s); restore_checkpoint into the state {restore_s * 1e3!r} "
              f"ms ({mib / restore_s!r} MiB/s) {card}")
        if not same(like, got):
            fail("the timed restore differs from the saved state")

        # -- 10d: transport checksums on the self-partner hops -----------------
        T1 = got[0].clone()
        want = halo.update_halo(T1.clone(), Cp.clone())
        with fault_env(res, IGG_INTEGRITY="1"):
            checked = halo.update_halo(T1.clone(), Cp.clone())
            halo.arm_transport_flip(0)
            try:
                halo.update_halo(T1.clone(), Cp.clone())
                caught = None
            except IntegrityError as e:
                caught = e
            checked_ms = cuda_ms(torch, lambda: halo.update_halo(T1, Cp), reps=10)
        plain_ms = cuda_ms(torch, lambda: halo.update_halo(T1, Cp), reps=10)
        print(f"phase 10d: IGG_INTEGRITY=1 update_halo(T, Cp) 256^3 f32 periodic x/y/z: vs the "
              f"unchecked exchange {'bit-exact' if same(checked, want) else 'DIFFERS'}; armed "
              f"flip on rank 0 -> {type(caught).__name__} detector "
              f"{getattr(caught, 'detector', None)} implicating rank "
              f"{getattr(caught, 'implicated_rank', None)}; checked {checked_ms!r} ms, "
              f"unchecked {plain_ms!r} ms {card}")
        if not same(checked, want) or caught is None or caught.detector != "transport_checksum" \
                or caught.implicated_rank != 0:
            fail("the checksummed exchange differs or missed the armed flip")

        # -- 10c: faults on the card ---------------------------------------------
        def guarded(nt, spec, **kw):
            with fault_env(res, IGG_FAULT_INJECT=spec):
                return res.guarded_time_loop(step, clones(state0), nt,
                                             guard=res.RunGuard(names=("T", "Cp"), **kw))

        try:
            guarded(3, "bit_flip:step2:T", integrity_every=1)
            fail("bit_flip:step2:T passed the shadow audit")
        except IntegrityError as e:
            flip = (e.detector, e.step)
        passed = guarded(3, "bit_flip:step2:T", guard_every=1)
        finite = all(bool(torch.isfinite(a).all()) for a in passed)
        try:
            guarded(3, "halo_corrupt:step2", guard_every=1)
            fail("halo_corrupt:step2 passed the guard")
        except res.GuardError as e:
            trip = e.step
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            rolled = guarded(3, "halo_corrupt:step2", guard_every=1, policy="rollback")
        ref3 = loop(step, clones(state0), 3)
        guarded(4, "ckpt_corrupt:step4", checkpoint_every=2, checkpoint_dir=str(work / "c"))
        fallback = ck.latest_checkpoint(work / "c")
        print(f"phase 10c: bit_flip:step2:T under integrity_every=1 -> IntegrityError {flip}; "
              f"under guard_every=1 alone it runs through, finite {finite}; halo_corrupt:step2 "
              f"trips the guard at step {trip}, and under rollback ends "
              f"{'bit-exact with the clean run' if same(rolled, ref3) else 'DIFFERENT'}; "
              f"ckpt_corrupt:step4 -> latest_checkpoint falls back to {Path(fallback).name}")
        if flip != ("shadow_audit", 2) or not finite or trip != 2 or not same(rolled, ref3) \
                or not fallback.endswith("step_00000002"):
            fail("a fault on the card was not caught as expected")
        igg.finalize_global_grid()

        # -- 10b: the kernels are run-to-run deterministic ---------------------
        # (label, model, setup kwargs, steps per call, k, names, kernel,
        # launches per call serialized; the pipelined schedule doubles them).
        # Serialized at the main paths' configs (phases 3, 5, 6); pipelined
        # at phase 7b's periodic x/y/z twins, since with z alone periodic
        # one block has no x/y exchange to split and pipelined=True runs
        # the serialized schedule.
        xyz = dict(periodx=1, periody=1, periodz=1)
        cases = (
            ("diffusion 256^3 f32 periodic x/y/z overlap 8, one group of 4 steps fused_k=4",
             diffusion3d, dict(**xyz, **ov(8)), 4, 4, ("T", "Cp"), "fused_diffusion_steps", 1,
             (False, True)),
            ("acoustic 256^3 f32 periodic z overlap 12, one group of 6 steps fused_k=6",
             acoustic3d, dict(periodz=1, **ov(12)), 6, 6, ("P", "Vx", "Vy", "Vz"),
             "fused_leapfrog_steps", 1, (False,)),
            ("acoustic 256^3 f32 periodic x/y/z overlap 12, one group of 6 steps fused_k=6",
             acoustic3d, dict(**xyz, **ov(12)), 6, 6, ("P", "Vx", "Vy", "Vz"),
             "fused_leapfrog_steps", 1, (True,)),
            ("porous 256^3 f32 npt=12 periodic z overlap 14, 1 step fused_k=6",
             porous_convection3d, dict(npt=12, periodz=1, **ov(14)), 1, 6,
             ("T", "Pf", "qDx", "qDy", "qDz"), "fused_pt_iterations", 2, (False,)),
            ("porous 256^3 f32 npt=12 periodic x/y/z overlap 14, 1 step fused_k=6",
             porous_convection3d, dict(npt=12, **xyz, **ov(14)), 1, 6,
             ("T", "Pf", "qDx", "qDy", "qDz"), "fused_pt_iterations", 2, (True,)),
        )
        for label, model, kw, nsteps, k, names, kname, per_call, schedules in cases:
            state, params = model.setup(n, n, n, dtype=f32, quiet=True, **kw)
            for pipelined in schedules:
                want_launches = 2 * per_call * (2 if pipelined else 1)
                s = model.make_multi_step(params, nsteps, fused_k=k, pipelined=pipelined)
                audits = counter("integrity.audits")
                mismatches = counter("integrity.audit_mismatches")
                reset_counts()
                try:
                    out = res.guarded_time_loop(
                        s, clones(state), 1, guard=res.RunGuard(integrity_every=1, names=names))
                except IntegrityError as e:
                    fail(f"{label} pipelined={pipelined}: the audit found a mismatch: {e}")
                torch.cuda.synchronize()
                c = counts()
                mismatches = counter("integrity.audit_mismatches") - mismatches
                print(f"phase 10b: {label}, {'pipelined' if pipelined else 'serialized'}: "
                      f"integrity_every=1 audits {counter('integrity.audits') - audits}, "
                      f"mismatches {mismatches}, launches {c} (committed + re-run)")
                if counter("integrity.audits") - audits != 1 or mismatches \
                        or c[kname] != want_launches \
                        or not all(bool(torch.isfinite(a).all()) for a in out):
                    fail(f"{label} pipelined={pipelined}: audits, launches {c} or finiteness")
            igg.finalize_global_grid()
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase11(torch, igg, reset_counts, counts, card) -> None:
    """Phase 11: serving (``serving.ServingLoop``, ``serving.FrontDoor``)
    over the batched kernels (see the module docstring)."""
    import urllib.error
    import urllib.request

    import numpy as np

    from implicitglobalgrid_tpu_torch.models import _batched, acoustic3d, diffusion3d
    from implicitglobalgrid_tpu_torch.models import porous_convection3d
    from implicitglobalgrid_tpu_torch.serving import FrontDoor, Request, ServingLoop
    from implicitglobalgrid_tpu_torch.serving import admission as adm
    from implicitglobalgrid_tpu_torch.serving import frontdoor as fdm
    from implicitglobalgrid_tpu_torch.utils import liveplane
    from implicitglobalgrid_tpu_torch.utils import resilience as res
    from implicitglobalgrid_tpu_torch.utils import telemetry as tele

    n, f32 = 256, torch.float32
    ov = lambda o: dict(overlapx=o, overlapy=o, overlapz=o)  # noqa: E731
    xyz = dict(periodx=1, periody=1, periodz=1)
    work = Path(tempfile.mkdtemp(prefix="igg_phase11_"))
    #: 11a's requests: (ic_scale, budget); budgets 8, 12, 16 admit 2 members mid-flight
    specs = [(1.0 + 0.1 * i, (8, 12, 16)[i % 3]) for i in range(6)]

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    def member(model, scale, **kw):
        return model.setup(n, n, n, init_grid=False, dtype=f32, ic_scale=scale, **kw)[0]

    def drive(loop):
        """Rounds until the pool drains; the wall ms of each ``run_round``."""
        walls = []
        while loop.queue or loop.active_members:
            t0 = time.perf_counter()
            loop.run_round()
            walls.append((time.perf_counter() - t0) * 1e3)
            if loop.rounds > 100:
                fail(f"{loop.model_name} pool did not drain in 100 rounds")
        return walls

    def pool_intact(step, pool, label):
        """A step must leave its input pool intact (the select and the
        audit re-use it): one step of a clone, compared bit for bit."""
        before = tuple(a.clone() for a in pool)
        step(*pool)
        torch.cuda.synchronize()
        if not same(pool, before):
            fail(f"{label}: the batched step wrote into its input pool")

    def hist(name):
        h = tele.snapshot()["histograms"].get(name, {})
        return h.get("p50"), h.get("p99"), h.get("count", 0)

    try:
        # -- 11a: the diffusion pool ----------------------------------------------
        _, params = diffusion3d.setup(n, n, n, dtype=f32, quiet=True, **xyz, **ov(8))
        step_kw = {"fused_k": 4}

        def diffusion_loop(**kw):
            return ServingLoop(diffusion3d, params, capacity=4, steps_per_round=4,
                               step_kwargs=step_kw, **kw)

        standalone = {}
        for scale, budget in specs:
            standalone[scale, budget] = diffusion3d.make_multi_step(params, budget, fused_k=4)(
                *member(diffusion3d, scale))
        loop = diffusion_loop()
        ids = {loop.submit(Request(state=member(diffusion3d, s), max_steps=b)): (s, b)
               for s, b in specs}
        tele.reset()
        torch.cuda.synchronize()
        reset_counts()
        walls = drive(loop)
        torch.cuda.synchronize()
        c = counts()
        if c["fused_diffusion_steps"] != loop.rounds:
            fail(f"11a: {loop.rounds} rounds launched {c}, expected one batched launch a round")
        results_a = {}
        for m, key in ids.items():
            r = loop.results[m]
            if r.status != "completed" or r.steps != key[1] or not same(r.state, standalone[key]):
                fail(f"11a: member {m} {key}: {r.status} after {r.steps} steps, bit-exact with "
                     f"its standalone run: {same(r.state, standalone[key]) if r.state else None}")
            results_a[key] = r.state
        del standalone
        t0 = time.perf_counter()
        want = {key: fdm.state_digest(state) for key, state in results_a.items()}
        digest_s = (time.perf_counter() - t0) / len(want)
        p50, p99, cnt = hist("serving.round_seconds")
        print(f"phase 11a: diffusion 256^3 f32 periodic x/y/z overlap 8, capacity 4, 4 steps a "
              f"round (fused_k=4), 6 requests (budgets 8/12/16): {loop.rounds} rounds, launches "
              f"{c} (one batched launch a round); every member completed bit-exact with its "
              f"standalone make_multi_step(fused_k=4) run; round wall ms {walls!r}; "
              f"serving.round_seconds p50 {p50!r} s, p99 {p99!r} s over {cnt} rounds; "
              f"state_digest of one member (T, Cp: gather + sha256) {digest_s!r} s {card}")

        # Steady state at a full pool, and the parts of a round timed alone.
        loop = diffusion_loop()
        for s, _ in specs[:4]:
            loop.submit(Request(state=member(diffusion3d, s), max_steps=10**6))
        pool = loop._state
        pool_intact(loop._step, pool, "11a diffusion")
        for _ in range(3):
            loop.run_round()
        tele.reset()
        torch.cuda.synchronize()
        reps = 30
        t0 = time.perf_counter()
        for _ in range(reps):
            loop.run_round()
        round_ms = (time.perf_counter() - t0) * 1e3 / reps
        p50, p99, _ = hist("serving.round_seconds")
        pool = loop._state
        step_ms = cuda_ms(torch, lambda: loop._step(*pool), reps=20)
        new = loop._step(*pool)
        partial = np.array([True, True, False, True])
        select_ms = cuda_ms(torch, lambda: _batched.select_members(partial, new, pool), reps=20)
        probe_ms, mask_ms = in_turns(torch, [lambda: _batched.check_members_finite(pool),
                                             lambda: mask_nonfinite(torch, pool, True)], reps=20)
        if _batched.check_members_finite(pool).any() or mask_nonfinite(torch, pool, True).any():
            fail("the finite probe flags the clean pool")
        del new
        print(f"phase 11a: full pool (B=4) steady state over {reps} rounds: {round_ms!r} ms per "
              f"round (run_round wall), bare batched step {step_ms!r} ms, loop overhead "
              f"{round_ms - step_ms!r} ms ({round_ms / step_ms!r}x the step); the select of a "
              f"partial pool alone {select_ms!r} ms (skipped at a full pool), the finite probe "
              f"alone {probe_ms!r} ms, in turns with its mask form {mask_ms!r} ms; "
              f"{16e3 / round_ms!r} member-steps/s served against "
              f"{16e3 / step_ms!r} by the bare step; serving.round_seconds p50 {p50!r} s, p99 "
              f"{p99!r} s {card}")
        del loop, pool

        # -- 11b: guards and the audit ------------------------------------------
        loop = diffusion_loop(guard_policy="evict")
        T, Cp = member(diffusion3d, 0.95)
        T[n // 2, n // 2, n // 2] = float("nan")
        bad = loop.submit(Request(state=(T, Cp), max_steps=8))
        ids = {loop.submit(Request(state=member(diffusion3d, s), max_steps=b)): (s, b)
               for s, b in specs}
        drive(loop)
        r = loop.results[bad]
        ok = all(same(loop.results[m].state, results_a[k]) for m, k in ids.items())
        print(f"phase 11b: evict: the NaN member {r.status} after {r.steps} steps; the 6 others "
              f"bit-exact with 11a: {ok}")
        if r.status != "evicted" or r.state is not None or not ok:
            fail(f"11b evict: NaN member {r.status}, others bit-exact {ok}")

        key = specs[2]
        loop = diffusion_loop(guard_policy="rollback")
        m = loop.submit(Request(state=member(diffusion3d, key[0]), max_steps=key[1]))
        loop.run_round()
        T = _batched.member_field(loop._state[0], 0)
        T[n // 2, n // 2, n // 2] = float("nan")  # a poisoned slot between rounds
        loop._state[0][0].copy_(T)
        loop.run_round()
        rolled = (loop.slots[0].rollbacks, loop.slots[0].steps)
        drive(loop)
        r = loop.results[m]
        ok = r.status == "completed" and same(r.state, results_a[key])
        print(f"phase 11b: rollback: a poisoned slot after round 1 -> rollbacks, steps "
              f"{rolled} after round 2; the member {r.status} after {r.steps} steps, bit-exact "
              f"with 11a: {ok}")
        if rolled != (1, 4) or not ok:
            fail(f"11b rollback: {rolled}, completed bit-exact {ok}")

        with fault_env(res, IGG_INTEGRITY_EVERY="1"):
            tele.reset()
            loop = diffusion_loop()
            ids = {loop.submit(Request(state=member(diffusion3d, s), max_steps=b)): (s, b)
                   for s, b in specs}
            torch.cuda.synchronize()
            reset_counts()
            drive(loop)
            torch.cuda.synchronize()
            c = counts()
            snap = tele.snapshot()["counters"]
            audits, bad_audits = snap.get("integrity.audits", 0), snap.get(
                "integrity.audit_mismatches", 0)
            ok = all(same(loop.results[m].state, results_a[k]) for m, k in ids.items())
            print(f"phase 11b: IGG_INTEGRITY_EVERY=1: {audits} audits in {loop.rounds} rounds, "
                  f"{bad_audits} mismatches, launches {c} (committed + re-run); members "
                  f"bit-exact with 11a: {ok}")
            if audits != loop.rounds or bad_audits or not ok \
                    or c["fused_diffusion_steps"] != 2 * loop.rounds:
                fail(f"11b audit: {audits} audits, {bad_audits} mismatches, launches {c}")
        del loop
        igg.finalize_global_grid()

        # -- 11c: the porous pool, then acoustic ---------------------------------
        pkw = dict(npt=12)
        _, pparams = porous_convection3d.setup(n, n, n, dtype=f32, quiet=True, periodz=1,
                                               **ov(14), **pkw)
        residual = porous_convection3d.make_batched_residual(pparams)
        one = porous_convection3d.make_multi_step(pparams, 1, fused_k=6)
        state, r_seq, states = member(porous_convection3d, 1.0, **pkw), [], []
        for _ in range(6):
            state = one(*state)
            states.append(state)
            r_seq.append(float(residual(*_batched.stack_states([state]))[0]))
        j = next((j for j in range(2, 6) if r_seq[j] < min(r_seq[:j]) * (1 - 1e-3)), None)
        if j is None:
            fail(f"11c: the porous residual did not fall in 6 steps: {r_seq}")
        tol = (min(r_seq[:j]) * r_seq[j]) ** 0.5
        conv_state = states[j]
        done_state = porous_convection3d.make_multi_step(pparams, 2, fused_k=6)(
            *member(porous_convection3d, 0.8, **pkw))
        del states
        loop = ServingLoop(porous_convection3d, pparams, capacity=2, steps_per_round=1,
                           step_kwargs={"fused_k": 6})
        mc = loop.submit(Request(state=member(porous_convection3d, 1.0, **pkw), max_steps=50,
                                 tol=tol))
        mb = loop.submit(Request(state=member(porous_convection3d, 0.8, **pkw), max_steps=2))
        pool_intact(loop._step, loop._state, "11c porous")
        torch.cuda.synchronize()
        reset_counts()
        walls = drive(loop)
        torch.cuda.synchronize()
        c = counts()
        rc, rb = loop.results[mc], loop.results[mb]
        plain = porous_convection3d.make_multi_step(pparams, j + 1, exchange_every=6)(
            *member(porous_convection3d, 1.0, **pkw))
        plain_res = float(residual(*_batched.stack_states([plain]))[0])
        print(f"phase 11c: porous 256^3 f32 npt=12 periodic z overlap 14, capacity 2, 1 step a "
              f"round (fused_k=6): residuals of the tol member's standalone steps {r_seq!r}, tol "
              f"{tol!r}; member {mc} {rc.status} after {rc.steps} steps at residual "
              f"{rc.residual!r} (the standalone fused run's {r_seq[j]!r}, the plain cadence's "
              f"{plain_res!r}); member {mb} {rb.status} after {rb.steps} steps; launches {c} "
              f"in {loop.rounds} rounds; round wall ms {walls!r} {card}")
        if rc.status != "converged" or rc.steps != j + 1 or rc.residual != r_seq[j] \
                or not same(rc.state, conv_state):
            fail(f"11c: the tol member {rc.status} after {rc.steps} steps, residual "
                 f"{rc.residual!r} vs {r_seq[j]!r}")
        if abs(plain_res - r_seq[j]) > 2e-5 * max(abs(r_seq[j]), 1.0):
            fail(f"11c: the residual {r_seq[j]!r} disagrees with the plain cadence's {plain_res!r}")
        if rb.status != "completed" or rb.steps != 2 or not same(rb.state, done_state):
            fail(f"11c: the budget member {rb.status} after {rb.steps} steps")
        if c["fused_pt_iterations"] != 2 * loop.rounds:
            fail(f"11c: launches {c} in {loop.rounds} rounds, expected 2 a round")
        del loop, plain, conv_state, done_state, rc, rb
        igg.finalize_global_grid()

        _, aparams = acoustic3d.setup(n, n, n, dtype=f32, quiet=True, periodz=1, **ov(12))
        loop = ServingLoop(acoustic3d, aparams, capacity=4, steps_per_round=6,
                           step_kwargs={"fused_k": 6})
        scales = (1.0, 1.1, 1.2, 1.3)
        ids = {loop.submit(Request(state=member(acoustic3d, s), max_steps=6)): s for s in scales}
        pool_intact(loop._step, loop._state, "11c acoustic")
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        loop.run_round()
        wall = (time.perf_counter() - t0) * 1e3
        c = counts()
        alone = acoustic3d.make_multi_step(aparams, 6, fused_k=6)
        ok = all(loop.results[m].status == "completed"
                 and same(loop.results[m].state, alone(*member(acoustic3d, s)))
                 for m, s in ids.items())
        print(f"phase 11c: acoustic 256^3 f32 periodic z overlap 12, capacity 4, one round of 6 "
              f"steps (fused_k=6): launches {c}; every member completed bit-exact with its "
              f"standalone run: {ok}; round wall {wall!r} ms {card}")
        if not ok or c["fused_leapfrog_steps"] != 1:
            fail(f"11c acoustic: bit-exact {ok}, launches {c}")
        del loop
        igg.finalize_global_grid()

        # -- 11d: the front door over HTTP ---------------------------------------
        del results_a

        def door(capacity, **kw):
            _, p = diffusion3d.setup(n, n, n, dtype=f32, quiet=True, **xyz, **ov(8))
            lp = ServingLoop(diffusion3d, p, capacity=capacity, steps_per_round=4,
                             step_kwargs=step_kw)
            return lp, FrontDoor(lp, port=0, host="127.0.0.1", setup_kwargs={"dtype": f32},
                                 checkpoint_dir=str(work / "resize"), **kw)

        refusals = []

        def post(fd, scale, budget):
            """POST one request.  The front door keeps the JAX package's
            step-stall rule (critical, 1 s floor) and ticks it at every
            admission view: when the newest progress record is a PREVIOUS
            pool's last round, older than the deadline (its final digests,
            the GETs and this pool's set-up came after it), the JAX
            semantics refuse the POST with 429 ``slo``.  The refusal must be
            exactly that; the client then waits, as a client does on
            ``Retry-After``, while the door's serving thread runs one
            iteration (idle: it marks the pool's progress done, which clears
            the rule at the next view), and posts again."""
            data = json.dumps({"tenant": "chip", "model": "diffusion3d", "params": {
                "max_steps": budget, "ic_scale": scale}}).encode()
            for _ in range(2):
                req = urllib.request.Request(
                    f"http://127.0.0.1:{fd.port}/v1/submit",
                    headers={"Content-Type": "application/json"}, data=data)
                try:
                    with urllib.request.urlopen(req, timeout=30) as r:
                        return json.loads(r.read())["request_id"]
                except urllib.error.HTTPError as e:
                    doc = json.loads(e.read() or b"{}")
                    stall = [a for a in liveplane.get_engine().active_alerts()
                             if a["rule"] == "step_stall"]
                    if e.code != 429 or doc.get("reason") != "slo" or not stall:
                        fail(f"11d: POST refused {e.code} {doc} with no step_stall alert active")
                    refusals.append(stall[0]["evidence"])
                fd.serve_rounds(max_rounds=1)
                time.sleep(2 * adm.VIEW_TTL_S)  # past the admission view's cache
            fail("11d: a POST was refused again after the door's serving iteration")

        def get(fd, rid):
            with urllib.request.urlopen(f"http://127.0.0.1:{fd.port}/v1/result/{rid}",
                                        timeout=30) as r:
                return json.loads(r.read())

        def serve_until_done(fd, rids):
            for _ in range(60):
                fd.serve_rounds(max_rounds=1)
                if all(fd.result_view(rid)["status"] == "done" for rid in rids):
                    return
            fail("11d: the front door did not finish its requests in 60 iterations")

        def check_digests(fd, rids, what):
            for rid, key in zip(rids, specs):
                view = get(fd, rid)
                if view["status"] != "done" or view["steps"] != key[1] \
                        or view["digest"] != want[key]:
                    fail(f"11d {what}: {rid} {key}: {view}")

        tele.reset()
        reset_counts()
        loop, fd = door(4)
        try:
            rids = [post(fd, s, b) for s, b in specs]
            serve_until_done(fd, rids)
            check_digests(fd, rids, "HTTP")
        finally:
            fd.close()
        c = counts()
        p50, p99, cnt = hist("frontdoor.request_seconds")
        print(f"phase 11d: FrontDoor on 127.0.0.1 over the 11a pool: 6 POSTs, serve_rounds, 6 "
              f"GETs: every digest equals state_digest of 11a's member; launches {c} in "
              f"{loop.rounds} rounds; request latency p50 {p50!r} s, p99 {p99!r} s over {cnt} "
              f"requests {card}")
        if c["fused_diffusion_steps"] != loop.rounds:
            fail(f"11d: launches {c} in {loop.rounds} rounds")
        del loop
        igg.finalize_global_grid()

        loop, fd = door(4)
        try:
            rids = [post(fd, s, b) for s, b in specs]
            fd.serve_rounds(max_rounds=3)
            live = (loop.active_members, len(loop.queue))
            t0 = time.perf_counter()
            fd._execute_resize({"nproc": 1, "capacity": 5, "rung": 1, "reason": "up"})
            resize_s = time.perf_counter() - t0
        finally:
            fd.close()
        del loop
        igg.finalize_global_grid()
        loop, fd = door(5)
        try:
            t0 = time.perf_counter()
            if not fd.elastic_resume():
                fail("11d: elastic_resume found no checkpoint")
            resume_s = time.perf_counter() - t0
            adopted = sorted(s.steps for s in loop.slots if s.active)
            serve_until_done(fd, rids)
            check_digests(fd, rids, "resize + elastic_resume")
        finally:
            fd.close()
        print(f"phase 11d: _execute_resize to capacity 5 with {live[0]} members live and "
              f"{live[1]} queued: {resize_s!r} s; elastic_resume into a fresh loop and door: "
              f"{resume_s!r} s (members at steps {adopted}); every digest after the resize "
              f"equals 11a's {card}")
        print(f"phase 11d: POSTs refused 429 slo by the step_stall rule (then admitted after "
              f"the door's serving iteration): {len(refusals)}; evidence {refusals}")
        del loop
        igg.finalize_global_grid()
    finally:
        shutil.rmtree(work, ignore_errors=True)



def phase12(torch, igg, reset_counts, counts, card, main_teff) -> None:
    """Phase 12: the host planes (step telemetry, spans and the flight
    recorder, the live plane) over the main paths (see the module
    docstring)."""
    import threading
    import urllib.error
    import urllib.request

    from implicitglobalgrid_tpu_torch.integrity import IntegrityError
    from implicitglobalgrid_tpu_torch.models import acoustic3d, diffusion3d, porous_convection3d
    from implicitglobalgrid_tpu_torch.serving import FrontDoor, ServingLoop
    from implicitglobalgrid_tpu_torch.serving import admission as adm
    from implicitglobalgrid_tpu_torch.utils import liveplane, tracing
    from implicitglobalgrid_tpu_torch.utils import resilience as res
    from implicitglobalgrid_tpu_torch.utils import telemetry as tele

    n, f32 = 256, torch.float32
    ov = lambda o: dict(overlapx=o, overlapy=o, overlapz=o)  # noqa: E731
    xyz = dict(periodx=1, periody=1, periodz=1)
    modules = {"diffusion3d": diffusion3d, "acoustic3d": acoustic3d,
               "porous_convection3d": porous_convection3d}
    #: (model name, module, run kwargs, nt, kernel, launches, steps a loop call)
    runs = [(name, modules[name], r["kw"], r["nt"], r["kernel"], r["launches"], r["per_call"])
            for name, r in MAIN_RUNS.items()]
    work = Path(tempfile.mkdtemp(prefix="igg_phase12_"))

    def run(model, kw, nt, **env):
        with fault_env(res, **env):
            return model.run(nt, n, n, n, dtype=f32, quiet=True, **kw)

    def http(port, path, doc=None, headers=None):
        data = None if doc is None else json.dumps(doc).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                     headers={"Content-Type": "application/json",
                                              **(headers or {})})
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.status, r.read(), dict(r.headers)
        except urllib.error.HTTPError as e:
            return e.code, e.read(), dict(e.headers)

    def pool():
        _, params = diffusion3d.setup(n, n, n, dtype=f32, quiet=True, **xyz, **ov(8))
        loop = ServingLoop(diffusion3d, params, capacity=4, steps_per_round=4,
                           step_kwargs={"fused_k": 4})
        return loop, FrontDoor(loop, port=0, host="127.0.0.1", setup_kwargs={"dtype": f32})

    try:
        # -- 12a: step telemetry over each model's run() --------------------------
        for name, model, kw, nt, kernel, launches, per_call in runs:
            tele.reset()
            off_ms, on_ms = in_turns(torch, [lambda: run(model, kw, nt, IGG_TELEMETRY="0"),
                                             lambda: run(model, kw, nt)], reps=2)
            teff = tele.snapshot()["histograms"][f"{name}.t_eff_gbs"]
            print(f"phase 12a: {name} 256^3 f32 run({nt}, {kw}): ms per run() in turns, "
                  f"IGG_TELEMETRY=0 {off_ms!r}, telemetry on (defaults) {on_ms!r}; the on "
                  f"runs' step loop T_eff (host time per step, no sync, no heartbeat) p50 "
                  f"{teff['p50']!r} GB/s over {teff['count']} steps, the CUDA-event T_eff of "
                  f"phases 3/5/6 {main_teff[name]!r} GB/s {card}")
        tracing.reset()
        for name, model, kw, nt, kernel, launches, per_call in runs:
            tdir = work / name
            tele.reset()
            reset_counts()
            off = run(model, kw, nt, IGG_TELEMETRY="0")
            c_off = counts()
            reset_counts()
            t0 = time.perf_counter()
            on = run(model, kw, nt, IGG_TELEMETRY_DIR=str(tdir),
                     IGG_HEARTBEAT_EVERY=str(per_call))
            on_s = time.perf_counter() - t0
            c_on = counts()
            snap = tele.snapshot()
            kinds = [e["type"] for e in tele.read_events(tdir / "events.jsonl")
                     if e["type"] in ("run.start", "heartbeat", "run.complete")]
            steps = snap["counters"].get(f"{name}.steps")
            step_s = snap["histograms"][f"{name}.step_seconds"]
            teff = snap["histograms"][f"{name}.t_eff_gbs"]
            same = torch.equal(on, off)
            print(f"phase 12a: {name} checked run, IGG_HEARTBEAT_EVERY={per_call}: "
                  f"{on_s * 1e3!r} ms; {name}.steps {steps}, step_seconds count "
                  f"{step_s['count']}, events {kinds.count('run.start')} run.start, "
                  f"{kinds.count('heartbeat')} heartbeat, {kinds.count('run.complete')} "
                  f"run.complete; launches {c_on} (IGG_TELEMETRY=0: {c_off}); bit-identical to "
                  f"IGG_TELEMETRY=0: {same} {card}")
            print(f"phase 12a: {name} checked run's step loop T_eff (a heartbeat each call) "
                  f"p50 {teff['p50']!r} GB/s, min {teff['min']!r}, max {teff['max']!r}; "
                  f"step_seconds p50 {step_s['p50']!r} s {card}")
            want_kinds = ["run.start"] + ["heartbeat"] * (nt // per_call) + ["run.complete"]
            if steps != nt or step_s["count"] != nt or kinds != want_kinds or not same \
                    or c_on != c_off or c_on[kernel] != launches:
                fail(f"12a: {name}: steps {steps}, step_seconds {step_s['count']}, events "
                     f"{kinds}, launches {c_on} vs {c_off}, bit-identical {same}")
            del on, off

        # -- 12b: spans, a request trace, the flight recorder -------------------
        path = tracing.dump_trace(work / "trace")
        doc = tracing.merge_trace_files([path])
        problems = tracing.validate_chrome_trace(doc)
        xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
        per_model = {}
        for name, model, kw, nt, kernel, launches, per_call in runs:
            per_model[name] = [e["args"]["step"] for e in xs
                               if e["name"] == "igg.step" and e["args"]["model"] == name]
            if per_model[name] != list(range(per_call, nt + 1, per_call)):
                fail(f"12b: {name}'s igg.step spans end on steps {per_model[name]}")
        names = sorted({e["name"] for e in xs})
        halo = sum(e["name"] == "igg_halo_exchange" for e in xs)
        print(f"phase 12b: dump_trace of 12a's three checked runs: a valid Chrome trace "
              f"({len(xs)} spans, problems {problems}); igg.step spans (one a loop call, tagged "
              f"with the step it ends on) {per_model}; {halo} igg_halo_exchange spans; span "
              f"names {names}")
        if problems or not halo:
            fail(f"12b: trace problems {problems}, {halo} halo spans")

        tele.reset()
        tracing.reset()
        tid, sid = "12b0" * 8, "b0b1b2b3b4b5b6b7"
        loop, fd = pool()
        try:
            code, body, hdrs = http(fd.port, "/v1/submit", {
                "tenant": "chip", "model": "diffusion3d",
                "params": {"max_steps": 8, "ic_scale": 1.2}},
                headers={"traceparent": f"00-{tid}-{sid}-01"})
            if code != 202:
                fail(f"12b: the traced POST was refused: {code} {body}")
            rid = json.loads(body)["request_id"]
            reset_counts()
            for _ in range(10):
                fd.serve_rounds(max_rounds=1)
                if fd.result_view(rid)["status"] == "done":
                    break
            c = counts()
        finally:
            fd.close()
        tree = tracing.request_tree([tracing._load_rank_trace(tracing.dump_trace(work / "req"))],
                                    tid)
        flat = []

        def walk(nodes):
            for node in nodes:
                flat.append(node)
                walk(node["children"])

        walk(tree["roots"])
        got = {node["name"] for node in flat}
        need = {"igg.frontdoor.request", "igg.frontdoor.submit", "igg.frontdoor.admit",
                "igg.serving.admission", "igg.serving.round", "igg_halo_exchange",
                "igg.frontdoor.digest"}
        cp = tracing.critical_path(tree)
        seg = {k: v["s"] for k, v in cp["segments"].items()}
        digest_s = sum(node["dur_s"] for node in flat if node["name"] == "igg.frontdoor.digest")
        print(f"phase 12b: one POST with a traceparent through a FrontDoor over 11a's pool: "
              f"{loop.rounds} rounds, launches {c}; request tree of trace {tid}: {tree['spans']} "
              f"spans, {sorted(got)}, incomplete {tree['incomplete']}")
        print(f"phase 12b: the request's critical path: total {cp['total_s']!r} s; queue wait "
              f"{seg['queue_wait']!r} s, admission {seg['admission']!r} s, rounds "
              f"{seg['rounds']!r} s, halo exchange {seg['exchange']!r} s, other "
              f"{seg['other']!r} s, of which its digest span {digest_s!r} s {card}")
        if not need <= got or tree["incomplete"] or c["fused_diffusion_steps"] != loop.rounds:
            fail(f"12b: the request tree lacks {need - got} (or launches {c})")
        del loop
        igg.finalize_global_grid()

        (T0, Cp), params = diffusion3d.setup(n, n, n, dtype=f32, quiet=True, **xyz, **ov(8))
        step = diffusion3d.make_multi_step(params, 4, fused_k=4)
        fdir = work / "flight"
        caught = None
        with fault_env(res, IGG_FAULT_INJECT="bit_flip:step2:T", IGG_TELEMETRY_DIR=str(fdir)):
            try:
                res.guarded_time_loop(step, (T0, Cp), 3, model="diffusion3d",
                                      guard=res.RunGuard(integrity_every=1, names=("T", "Cp")))
            except IntegrityError as e:
                caught = e
        if caught is None:
            fail("12b: bit_flip:step2:T passed the shadow audit")
        bundle = tracing.read_flight_bundles(fdir / "flight_0.json")[-1]
        open_ = [(s["name"], s.get("args")) for s in bundle["spans"] if s.get("open")]
        print(f"phase 12b: bit_flip:step2:T under integrity_every=1 -> IntegrityError "
              f"({caught.detector}, step {caught.step}); flight_0.json's last bundle: reason "
              f"{bundle['reason']}, info {bundle['info']}, open spans {open_}, "
              f"{len(bundle['spans'])} spans, {len(bundle['metrics']['counters'])} counters")
        if bundle["reason"] != "sdc" or bundle["info"].get("detector") != caught.detector \
                or bundle["info"].get("step") != caught.step \
                or ("igg.step", {"model": "diffusion3d", "step": caught.step}) not in open_:
            fail("12b: the flight bundle does not name the IntegrityError's audit and step")
        igg.finalize_global_grid()
        del T0, Cp, step

        # -- 12c: the live plane, and the step-stall drill ------------------------
        tele.reset()
        ldir = work / "live"
        verdicts = []
        with fault_env(res, IGG_METRICS_PORT="0", IGG_HEARTBEAT_EVERY="1",
                       IGG_TELEMETRY_DIR=str(ldir), IGG_FAULT_INJECT="stall:step3"):
            loop, fd = pool()
            port = liveplane.server_port()

            def post():
                code, body, _ = http(fd.port, "/v1/submit", {
                    "tenant": "chip", "model": "diffusion3d", "params": {"max_steps": 64}})
                verdicts.append((code, json.loads(body).get("reason")))

            try:
                if port is None:
                    fail("12c: IGG_METRICS_PORT=0 brought up no scrape server")
                post()
                fd.serve_rounds(max_rounds=3)
                metrics = http(port, "/metrics")[1].decode()
                health = json.loads(http(port, "/healthz")[1])
                deadline = liveplane.StepStallRule()._deadline({"snapshot": tele.snapshot()},
                                                                "serving.round")
                stalled = threading.Thread(target=fd.serve_rounds, kwargs={"max_rounds": 1},
                                           daemon=True)
                t0 = time.perf_counter()
                stalled.start()
                while tele.last_progress()["age_s"] < deadline + 0.5 and stalled.is_alive():
                    time.sleep(0.02)
                post()
                during = json.loads(http(port, "/healthz")[1])
                stalled.join(timeout=120)
                stall_s = time.perf_counter() - t0
                time.sleep(2 * adm.VIEW_TTL_S)  # past the admission view's cache
                post()
                after = json.loads(http(port, "/healthz")[1])
            finally:
                fd.close()
                liveplane.stop_server()
        events = tele.read_events(ldir / "events.jsonl")
        stall_alerts = [e for e in events if e["type"] == "alert.step_stall"]
        escalations = [e for e in events if e["type"] == "serving.alert_escalation"]
        print(f"phase 12c: live plane on 127.0.0.1:{port}: /metrics carries "
              f"serving.round_seconds {'igg_serving_round_seconds' in metrics}; /healthz "
              f"sections {sorted(health)}, ok {health['ok']}")
        print(f"phase 12c: stall drill (stall:step3, {res.FaultInjector.STALL_S} s, step-stall "
              f"deadline {deadline!r} s): verdicts {verdicts}; /healthz during the stall ok "
              f"{during['ok']}, active {[a['rule'] for a in during['alerts']['active']]}; after "
              f"ok {after['ok']}; alert.step_stall events {len(stall_alerts)} "
              f"({[e['evidence'] for e in stall_alerts]}); serving escalations "
              f"{len(escalations)}; the stalled iteration took {stall_s!r} s {card}")
        want = [(202, None), (429, "slo"), (202, None)]
        if "igg_serving_round_seconds" not in metrics \
                or not {"serving", "frontdoor", "slo"} <= set(health) \
                or verdicts != want or len(stall_alerts) != 1 or during["ok"] is not False \
                or after["ok"] is not True:
            fail(f"12c: the live plane or the stall drill differs: verdicts {verdicts} (want "
                 f"{want}), {len(stall_alerts)} step_stall events")
        del loop
        igg.finalize_global_grid()
        print(f"phase 12c: alerts fired in phases 10-12: "
              f"{[(ph, a['rule'], a['severity'], a['source'], a['evidence']) for ph, a in ALERTS]}")
    finally:
        tele.reset()  # closes the event logs under the temporary directory
        shutil.rmtree(work, ignore_errors=True)


def phase13(torch, igg, reset_counts, counts, card, main_split, main_step_ms) -> None:
    """Phase 13: the device timeline over `torch.profiler` (see the module
    docstring)."""
    from implicitglobalgrid_tpu_torch.models import diffusion3d, acoustic3d, porous_convection3d
    from implicitglobalgrid_tpu_torch.utils import profiling
    from implicitglobalgrid_tpu_torch.utils import resilience as res
    from implicitglobalgrid_tpu_torch.utils import telemetry as tele

    n, f32 = 256, torch.float32
    ov = lambda o: dict(overlapx=o, overlapy=o, overlapz=o)  # noqa: E731
    xyz = dict(periodx=1, periody=1, periodz=1)
    work = Path(tempfile.mkdtemp(prefix="igg_phase13_"))
    failed = []  # every profile.capture_failed event of the phase

    def capture_events(tdir):
        evs = tele.read_events(Path(tdir) / "events.jsonl") \
            if (Path(tdir) / "events.jsonl").is_file() else []
        failed.extend(e for e in evs if e["type"] == "profile.capture_failed")
        return evs

    def show(label, rec):
        for line in profiling.render_attribution_table(rec).splitlines():
            print(f"phase 13{label}: {line}")

    try:
        # -- 13a: IGG_PROFILE over each main path's run() ---------------------
        modules = {"diffusion3d": diffusion3d, "acoustic3d": acoustic3d,
                   "porous_convection3d": porous_convection3d}
        for name, r in MAIN_RUNS.items():
            model, kw, nt, window = modules[name], r["kw"], r["nt"], r["window"]
            kernel, label = r["kernel"], r["label"]
            tdir = work / name
            tele.reset()
            profiling.reset()
            reset_counts()
            t0 = time.perf_counter()
            with fault_env(res, IGG_PROFILE=window, IGG_TELEMETRY_DIR=str(tdir),
                           IGG_PROFILE_DIR=None):
                out = model.run(nt, n, n, n, dtype=f32, quiet=True, **kw)
            run_s = time.perf_counter() - t0
            c = counts()
            capture_events(tdir)
            meta_path = tdir / "profile.p0.json"
            if not meta_path.is_file():
                fail(f"13a: {name}: no capture meta (events: {failed})")
            meta = json.loads(meta_path.read_text())
            rec = profiling.attribute_trace(meta["trace_path"])  # parses, or raises
            wall = meta["t_stop_perf"] - meta["t_start_perf"]
            idle = 1.0 - rec["busy_seconds"] / wall
            kern_s = rec["op_seconds"].get("kernels", {}).get(label, 0.0)
            shares = {label: kern_s / rec["busy_seconds"]} if rec["busy_seconds"] else {}
            if name == "porous_convection3d":
                shares["T update"] = (rec["scope_seconds"].get("igg_temperature_update", 0.0)
                                      / rec["busy_seconds"])
            steps = meta["stopped_at_step"] - meta["started_at_step"] + 1
            busy_ms = rec["busy_seconds"] / steps * 1e3
            print(f"phase 13a: {name} 256^3 f32 run({nt}, {kw}) under IGG_PROFILE={window}: "
                  f"{run_s * 1e3!r} ms (first capture pays the profiler's start-up); launches "
                  f"{c}; capture steps {meta['started_at_step']}-{meta['stopped_at_step']} "
                  f"({meta['reason']}), {rec['n_device_ops']} device ops, device busy "
                  f"{rec['busy_seconds'] * 1e3!r} ms of a {wall * 1e3!r} ms window "
                  f"({busy_ms!r} of {wall / steps * 1e3!r} ms a step): device-idle share "
                  f"under capture {idle!r}; uncaptured estimate 1 - busy / the bare loop's "
                  f"CUDA-event ms per step of phases 3/5/6 ({main_step_ms[name]!r}): "
                  f"{1.0 - busy_ms / main_step_ms[name]!r} {card}")
            show("a", rec)
            print(f"phase 13a: {name} device split in the window: {shares!r} of the busy time "
                  f"(profiled) vs the CUDA-event shares of phases 3/5/6 "
                  f"{main_split.get(name)!r}; ops by bucket "
                  f"{ {b: sorted(v) for b, v in rec['op_seconds'].items()} } {card}")
            if rec["n_device_ops"] <= 0 or kern_s <= 0 \
                    or rec["scope_seconds"].get("igg_halo_exchange", 0.0) <= 0 \
                    or not torch.isfinite(out).all() or c[kernel] <= 0 or failed:
                fail(f"13a: {name}: {rec['n_device_ops']} device ops, {label} {kern_s!r} s, "
                     f"scopes {rec['scope_seconds']}, launches {c}, failed captures {failed}")
            del out

        # -- 13b: profile_trace around one pipelined group -------------------
        state, params = diffusion3d.setup(n, n, n, dtype=f32, quiet=True, **xyz, **ov(8))
        piped = diffusion3d.make_multi_step(params, 4, fused_k=4, pipelined=True)
        piped(*state)  # warm-up (allocator, streams)
        reset_counts()
        with igg.profile_trace(work / "group"):
            piped(*state)
        c = counts()
        rec = profiling.attribute_capture(work / "group")
        show("b", rec)
        print(f"phase 13b: one pipelined group of 7b's diffusion twin (256^3 f32 periodic x/y/z "
              f"overlap 8, fused_k=4) under profile_trace: launches {c}, scopes "
              f"{sorted(rec['scope_seconds'])}, overlap fraction {rec['overlap']['fraction']!r}, "
              f"ops by bucket { {b: sorted(v) for b, v in rec['op_seconds'].items()} } {card}")
        if not {"igg_ring_pass", "igg_interior_pass"} <= set(rec["scope_seconds"]) \
                or rec["overlap"]["fraction"] is not None or c["fused_diffusion_steps"] != 2:
            fail(f"13b: scopes {rec['scope_seconds']}, overlap {rec['overlap']}, launches {c}")
        igg.finalize_global_grid()
        del state, piped

        # -- 13c: captures back to back, one left open by a guard trip -------
        (T0, Cp), params = diffusion3d.setup(64, 64, 64, dtype=f32, quiet=True, **xyz, **ov(8))
        step = diffusion3d.make_multi_step(params, 4, fused_k=4)
        parsed = []
        for i in (1, 2):
            with igg.profile_trace(work / f"c{i}"):
                step(T0, Cp)
            parsed.append(profiling.attribute_capture(work / f"c{i}")["n_device_ops"])
        igg.finalize_global_grid()
        tdir = work / "trip"
        tele.reset()
        profiling.reset()
        trip = None
        with fault_env(res, IGG_PROFILE="steps:1-16", IGG_TELEMETRY_DIR=str(tdir),
                       IGG_PROFILE_DIR=None, IGG_FAULT_INJECT="halo_corrupt:step8"):
            try:
                diffusion3d.run(16, 64, 64, 64, dtype=f32, quiet=True, fused_k=4, guard_every=4,
                                guard_policy="raise", **xyz, **ov(8))
            except res.GuardError as e:
                trip = e.step
        capture_events(tdir)
        meta = json.loads((tdir / "profile.p0.json").read_text())
        tripped = profiling.attribute_trace(meta["trace_path"])["n_device_ops"]
        (T0, Cp), params = diffusion3d.setup(64, 64, 64, dtype=f32, quiet=True, **xyz, **ov(8))
        step = diffusion3d.make_multi_step(params, 4, fused_k=4)
        with igg.profile_trace(work / "c4"):
            step(T0, Cp)
        fourth = profiling.attribute_capture(work / "c4")["n_device_ops"]
        igg.finalize_global_grid()
        print(f"phase 13c: two profile_trace captures back to back: {parsed} device ops; a "
              f"guard trip (halo_corrupt:step8, guard_policy=raise) at step {trip} inside "
              f"IGG_PROFILE=steps:1-16: capture closed with reason {meta['reason']!r} at step "
              f"{meta['stopped_at_step']}, {tripped} device ops; a fourth capture after it: "
              f"{fourth} device ops; capture_failed events in phase 13: {len(failed)}")
        if min(parsed) <= 0 or trip != 8 or meta["reason"] != "scope_exit" or tripped <= 0 \
                or fourth <= 0 or failed or profiling._capturing:
            fail(f"13c: captures {parsed}, trip {trip}, meta {meta['reason']}, {tripped}, "
                 f"fourth {fourth}, failed {failed}")
    finally:
        profiling.reset()
        tele.reset()
        shutil.rmtree(work, ignore_errors=True)


def phase14(torch, igg, reset_counts, counts, card, n=256, device="cuda") -> None:
    """Phase 14: the supervisor and the fleet over processes on the card
    (see the module docstring).  ``n`` and ``device`` exist for a rehearsal
    of the phase at a small size on the CPU."""
    import threading
    import urllib.request

    import numpy as np

    from implicitglobalgrid_tpu_torch.fleet import FleetController, FleetRouter, PoolSpec
    from implicitglobalgrid_tpu_torch.models import diffusion3d
    from implicitglobalgrid_tpu_torch.serving import Request, ServingLoop
    from implicitglobalgrid_tpu_torch.serving import frontdoor as fdm
    from implicitglobalgrid_tpu_torch.supervisor import RecoveryPolicy, RunSupervisor
    from implicitglobalgrid_tpu_torch.utils import resilience as res
    from implicitglobalgrid_tpu_torch.utils import telemetry as tele

    f32 = torch.float32
    grid = dict(periodx=1, periody=1, periodz=1, overlapx=8, overlapy=8, overlapz=8)
    work = Path(tempfile.mkdtemp(prefix="igg_phase14_"))
    child_env = {"PYTHONPATH": str(ROOT)}
    children = []  # every process the phase started, checked reaped at its end

    def task_file(name, task):
        d = work / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "task.json").write_text(json.dumps(dict(task, workdir=str(d))))
        return d

    def command(d):
        return [sys.executable, "-m", "implicitglobalgrid_tpu_torch._workers",
                str(d / "task.json")]

    fc = None
    try:
        # -- 14a: RunSupervisor over one rank of diffusion run() -------------
        kw = dict(MAIN_RUNS["diffusion3d"]["kw"], checkpoint_every=4)
        d = task_file("run", {"kind": "run", "model": "diffusion3d", "args": [16, n, n, n],
                              "kw": dict(kw, checkpoint_dir=str(work / "run" / "ckpt")),
                              "device": device, "dtype": "float32"})
        tdir = work / "run-tele"
        rsup = RunSupervisor(lambda rank, nranks, rung, gen: command(d), ladder=[1],
                             workdir=str(d), telemetry_dir=str(tdir),
                             policy=RecoveryPolicy(max_restarts=1, backoff_s=0.5),
                             fault_spec="worker_crash:step8:proc0", env=child_env,
                             poll_s=0.1, name="diffusion")
        launch = rsup.launch

        def tracked_launch():
            inc = launch()
            children.extend(inc.procs)
            return inc

        rsup.launch = tracked_launch
        t0 = time.perf_counter()
        report = rsup.run(timeout=300)
        sup_s = time.perf_counter() - t0
        events = tele.read_events(tdir / "events.jsonl")
        crash = [e for e in events if e["type"] == "fault.worker_crash"]
        starts = [e for e in events if e["type"] == "run.start"]
        resumed = [e for e in starts if e.get("gen") == 1]
        got = np.load(d / "out_rank0.npz")["out"] if (d / "out_rank0.npz").is_file() else None
        want = diffusion3d.run(16, n, n, n, dtype=f32, quiet=True, device=device,
                               **MAIN_RUNS["diffusion3d"]["kw"])
        same = got is not None and np.array_equal(got, want.cpu().numpy())
        legs = [(i["kind"], i["rcs"], i["decision"]["action"]) for i in report.incidents]
        recovery_s = resumed[0]["ts"] - crash[0]["ts"] if crash and resumed else None
        print(f"phase 14a: RunSupervisor over one port rank, diffusion {n}^3 f32 run(16, "
              f"{kw}) under worker_crash:step8:proc0: {report.summary()}; incidents {legs}; "
              f"incident detail {report.incidents[0]['detail'] if report.incidents else None}; "
              f"run.start steps by generation {[(e.get('gen'), e['start_step']) for e in starts]}; "
              f"final T bit for bit the uncrashed run's: {same}; crash to resumed step "
              f"{recovery_s!r} s (supervised run {sup_s!r} s) {card}")
        if not report.ok or legs[:1] != [("crash", [17], "restart")] or len(crash) != 1 \
                or crash[0]["step"] != 8 or [e["start_step"] for e in resumed] != [8] \
                or not same:
            fail(f"14a: {report.summary()}, {legs}, crash {crash}, starts {starts}, "
                 f"bit-identical {same}; logs "
                 f"{[p.read_text()[-1500:] for p in sorted(d.glob('*.log'))]}")
        del want

        # -- 14b: a FleetController of two pools behind a FleetRouter --------
        pool_task = {"kind": "pool", "nxyz": [n, n, n], "grid": grid, "capacity": 2,
                     "steps_per_round": 4, "step_kwargs": {"fused_k": 4}, "device": device,
                     "dtype": "float32"}
        specs = []
        for name in ("a", "b"):
            pd = task_file(f"pool-{name}", pool_task)
            specs.append(PoolSpec(name=name, command_for=lambda spec, gen, pd=pd: command(pd),
                                  workdir=str(pd), telemetry_dir=str(pd / "telemetry"),
                                  key={"model": "diffusion3d"}, devices="0",
                                  env=dict(child_env)))
        ftele = work / "fleet-tele"
        router = FleetRouter(port=0, host="127.0.0.1")
        with fault_env(res, IGG_TELEMETRY_DIR=str(ftele)):
            fc = FleetController(specs, router=router, poll_s=0.1)
            spawn = fc.spawn

            def tracked_spawn(argv, env, log_path):
                proc = spawn(argv, env, log_path)
                children.append(proc)
                return proc

            fc.spawn = tracked_spawn
            t0 = time.perf_counter()
            fc.launch(wait_s=120.0)
            up_s = time.perf_counter() - t0
            if sorted(router.pools) != ["a", "b"]:
                fail(f"14b: pools up {sorted(router.pools)}; logs "
                     f"{[p.read_text()[-1500:] for p in sorted(work.glob('pool-*/*.log'))]}")

            def http(path, doc=None):
                req = urllib.request.Request(
                    f"http://127.0.0.1:{router.port}{path}",
                    data=None if doc is None else json.dumps(doc).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=30) as r:
                    return json.loads(r.read())

            asks = [(1.1, 8), (1.2, 8)]
            fids = [http("/v1/submit", {"tenant": "chip", "model": "diffusion3d", "params": {
                "max_steps": b, "ic_scale": s}})["request_id"] for s, b in asks]
            owners = [router.routes[f]["pool"] for f in fids]
            victim = owners[0]
            t_kill = time.time()
            fc.handles[victim].proc.kill()
            fc.handles[victim].proc.wait(timeout=30)
            sweep = threading.Thread(target=lambda: decisions.extend(fc.poll_once()),
                                     daemon=True)
            decisions = []
            sweep.start()
            views, t_done = {}, {}
            deadline = time.monotonic() + 180
            while len(t_done) < len(fids) and time.monotonic() < deadline:
                for f in fids:
                    if f not in t_done:
                        view = http(f"/v1/result/{f}")
                        if view.get("status") == "done":
                            views[f], t_done[f] = view, time.time()
                time.sleep(0.05)
            sweep.join(timeout=180)
            respawns = fc.state.respawns.get(victim, 0)
            fevents = tele.read_events(ftele / "events.jsonl")
        reroute = [e for e in fevents if e["type"] == "fleet.reroute"]
        recovered = [e for e in fevents if e["type"] == "fleet.recovered"]
        # the direct run: one ServingLoop in this process, the same requests
        _, params = diffusion3d.setup(n, n, n, dtype=f32, quiet=True, device=device, **grid)
        loop = ServingLoop(diffusion3d, params, capacity=2, steps_per_round=4,
                           step_kwargs={"fused_k": 4})
        ids = [loop.submit(Request(state=diffusion3d.setup(
            n, n, n, init_grid=False, dtype=f32, ic_scale=s)[0], max_steps=b)) for s, b in asks]
        while loop.queue or loop.active_members:
            loop.run_round()
        direct = [fdm.state_digest(loop.results[m].state) for m in ids]
        del loop
        igg.finalize_global_grid()
        moved = [f for f, o in zip(fids, owners) if o == victim]
        agree = [views.get(f, {}).get("digest") == dg for f, dg in zip(fids, direct)]
        print(f"phase 14b: FleetController of two diffusion pools ({n}^3 f32 periodic x/y/z "
              f"overlap 8, capacity 2, 4 steps a round, one process each on device 0) behind "
              f"a FleetRouter on 127.0.0.1:{router.port}: up in {up_s!r} s; requests "
              f"{dict(zip(fids, owners))}; pool {victim} killed; decisions "
              f"{[(x.action, x.pool) for x in decisions]}; failover: reroute "
              f"{reroute[0]['ts'] - t_kill if reroute else None!r} s after the kill, results "
              f"done {[t_done[f] - t_kill for f in fids if f in t_done]!r} s after it, pool "
              f"{victim} back {recovered[0]['ts'] - t_kill if recovered else None!r} s after it; "
              f"respawns {respawns}; moved requests {moved}; digests equal the direct "
              f"ServingLoop run's: {agree} {card}")
        if [x.action for x in decisions] != ["respawn"] or not reroute or not recovered \
                or not all(agree) or respawns != 1 or not moved:
            fail(f"14b: decisions {decisions}, reroute {reroute}, recovered {recovered}, "
                 f"digests {agree}, respawns {respawns}; logs "
                 f"{[p.read_text()[-1500:] for p in sorted(work.glob('pool-*/*.log'))]}")
    finally:
        if fc is not None:
            fc.shutdown()
        for proc in children:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        tele.reset()
        shutil.rmtree(work, ignore_errors=True)
    alive = [p.pid for p in children if p.poll() is None]
    print(f"phase 14: {len(children)} child processes started, {len(alive)} alive after the "
          f"phase")
    if alive:
        fail(f"14: children outlived the phase: {alive}")


def kernel_launch(model, params, state, k):
    """``tile -> outputs``: one launch of ``model``'s kernel on ``state`` at
    ``k``, with the constants phases 3, 5 and 6 fold from ``params``."""
    from implicitglobalgrid_tpu_torch.ops import fused_leapfrog as fl
    from implicitglobalgrid_tpu_torch.ops import fused_pt as fp
    from implicitglobalgrid_tpu_torch.ops import fused_stencil as fs

    p = params
    inv = tuple(1.0 / d for d in (p.dx, p.dy, p.dz))
    if model == "diffusion3d":
        c3 = [p.dt * p.lam / (d * d) for d in (p.dx, p.dy, p.dz)]
        return lambda tile: fs.fused_diffusion_steps(*state, k, *c3, tile=tile)
    if model == "acoustic3d":
        co = (*(p.dt / p.rho / d for d in (p.dx, p.dy, p.dz)), p.dt * p.K, *inv)
        return lambda tile: fl.fused_leapfrog_steps(*state, k, *co, tile=tile)
    co = (p.theta_q, *inv, p.Ra * p.lam_T, p.beta_p)
    return lambda tile: fp.fused_pt_iterations(*state, k, *co, tile=tile)


def phase15(torch, igg, reset_counts, counts, card, tune_out=None, n=256, device="cuda") -> None:
    """Phase 15: the autotuner on the card (see the module docstring).
    ``tune_out``: a directory to write the three winners' entries to (the
    committed seed layer's source).  ``n`` and ``device`` exist for a
    rehearsal of the phase at a small size on the CPU."""
    import importlib

    from implicitglobalgrid_tpu_torch import tuning
    from implicitglobalgrid_tpu_torch.tuning import cache as tcache
    from implicitglobalgrid_tpu_torch.tuning import search, space
    from implicitglobalgrid_tpu_torch.utils import telemetry as tele

    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="igg_phase15_"))
    knobs = ("IGG_TUNE_CACHE", "IGG_TUNE_TOPK", "IGG_TUNE_STEPS")
    saved_env = {k: os.environ.get(k) for k in knobs}
    saved_seed, measure_model = tcache.SEED_DIR, search._measure_model
    log = []  # (config, seconds) of every measurement the search makes

    def recording(module, params, nsteps, batch, config, *a, **kw):
        t = measure_model(module, params, nsteps, batch, config, *a, **kw)
        log.append((json.dumps(config, sort_keys=True), t))
        return t

    def tuned_counters():
        return {k: v for k, v in tele.snapshot()["counters"].items() if k.startswith("tune.")}

    def close(model, got, want, tol):
        """The tolerance phases 3, 5 and 6 hold the kernel against the plain
        cadence to (porous: relative to each field's scale)."""
        for g, w in zip(got, want):
            if not torch.isfinite(g).all():
                fail(f"15c {model}: non-finite output")
            err = float((g - w).abs().max())
            if model == "porous_convection3d":
                err /= max(float(w.abs().max()), 1.0)
            if not err <= tol:
                fail(f"15c {model}: tuned vs default differ by {err!r} > {tol}")
        return max(float((g - w).abs().max()) for g, w in zip(got, want))

    tols = {"diffusion3d": 1e-5, "acoustic3d": 2e-5, "porous_convection3d": 2e-5}
    try:
        # The committed seed layer must not answer: every point is measured.
        tcache.SEED_DIR = str(work / "no-seed")
        search._measure_model = recording
        os.environ.update(IGG_TUNE_TOPK="4", IGG_TUNE_STEPS="3")
        for model, spec in MAIN_RUNS.items():
            module = importlib.import_module(f"implicitglobalgrid_tpu_torch.models.{model}")
            kw = dict(spec["kw"])
            hand = {"fused_k": kw.pop("fused_k")}
            nsteps, kernel = spec["nt"], spec["kernel"]
            os.environ["IGG_TUNE_CACHE"] = str(work / model)
            cache = tuning.TuneCache(primary=str(work / model), fallbacks=())
            state, params = module.setup(n, n, n, dtype=torch.float32, quiet=True,
                                         device=device, **kw)
            gg = igg.get_global_grid()
            npt = getattr(params, "npt", None) if model == "porous_convection3d" else None
            key = tuning.make_key(model, gg.nxyz, params.dtype, gg=gg, nsteps=nsteps,
                                  extra={"npt": npt} if npt is not None else None)
            if cache.lookup(key) is not None or tuning.TuneCache().lookup(key) is not None:
                fail(f"15a {model}: the fresh cache already answers {key}")
            cands, rejected = space.candidate_space(model, gg.nxyz, params.dtype,
                                                    nsteps=nsteps, gg=gg, npt=npt)
            survivors, cut = space.prune(cands, 4)

            # -- 15a: the search, through the model's entry point ----------
            c0, n_log = tuned_counters(), len(log)
            reset_counts()
            t0 = time.perf_counter()
            tuned = module.make_multi_step(params, nsteps, autotune=True)
            search_s = time.perf_counter() - t0
            out = tuned(*state)
            if device == "cuda":
                torch.cuda.synchronize()
            launched = counts()
            c1 = tuned_counters()
            measured = dict(log[n_log:])
            d_measured = c1.get("tune.candidates_measured", 0) - c0.get(
                "tune.candidates_measured", 0)
            if d_measured != len(survivors) or len(log) - n_log != len(survivors):
                fail(f"15a {model}: measured {d_measured} (logged {len(log) - n_log}), "
                     f"survivors {len(survivors)}")
            if device == "cuda" and not launched[kernel]:
                fail(f"15a {model}: the search launched {launched}, no {kernel}")
            entry = cache.lookup(key)
            if entry is None:
                fail(f"15a {model}: no entry stored at {cache.path_for(key)}")
            got_key, winner = tuning.validate_entry(entry)
            err = tuning.admissibility_error(got_key, winner)
            if got_key != key or err is not None:
                fail(f"15a {model}: stored entry {entry} is not admissible: {err}")
            ms = {cfg: t * 1e3 for cfg, t in measured.items()}
            rows = [(c["config"], c["modeled"],
                     f"measured {ms[json.dumps(c['config'], sort_keys=True)]!r} ms per chunk call")
                    for c in survivors]
            rows += [(c["config"], c["modeled"], f"pruned: {c['error']}") for c in cut]
            rows += [(c["config"], None, f"rejected: {c['error']}") for c in rejected]
            for cfg, m, what in rows:
                print(f"phase 15a: {model} {json.dumps(cfg)}: "
                      + (f"modeled {m['bytes_per_step']!r} B/step, {m['smem_bytes']} B shared "
                         f"memory per block, " if m else "")
                      + what)
            t_hand = measure_model(module, params, nsteps, 0, dict(hand))
            print(f"phase 15a: {model} {n}^3 f32 nsteps={nsteps}: winner {json.dumps(winner)} "
                  f"{ms[json.dumps(winner, sort_keys=True)]!r} ms per chunk call; "
                  f"default {{}} {ms['{}']!r} ms; the main path's {json.dumps(hand)} "
                  f"{t_hand * 1e3!r} ms; search {search_s!r} s, {len(survivors)} measured of "
                  f"{len(cands)} candidates ({len(rejected)} rejected); launches {launched} "
                  f"{card}")
            if tune_out:
                Path(tune_out).mkdir(parents=True, exist_ok=True)
                tuning.TuneCache(primary=tune_out, fallbacks=()).store(key, tuning.new_entry(
                    key, winner, source=f"search: chip_smoke.py phase 15a on {card[1:-1]}",
                    modeled=entry["modeled"], measured=entry["measured"],
                    tuner=entry["tuner"]))

            # -- 15b: the second resolve is a cache hit --------------------
            c0, n_log = tuned_counters(), len(log)
            reset_counts()
            again = module.make_multi_step(params, nsteps, autotune=True)
            c1 = tuned_counters()
            hit = c1.get("tune.cache_hit", 0) - c0.get("tune.cache_hit", 0)
            moved = c1.get("tune.candidates_measured", 0) - c0.get("tune.candidates_measured", 0)
            if hit != 1 or moved or len(log) != n_log or any(counts().values()):
                fail(f"15b {model}: hit {hit}, measured {moved}, builds {len(log) - n_log}, "
                     f"launches {counts()}")
            same = all(torch.equal(a, b) for a, b in zip(again(*state), out))
            print(f"phase 15b: {model}: cache hit, 0 candidates measured or launched; the hit's "
                  f"step equals the first's bit for bit: {same}")
            if not same:
                fail(f"15b {model}: the cache hit's step differs from the searched one")

            # -- 15c: a tuned config changes the schedule, not the result --
            err = close(model, out, module.make_multi_step(params, nsteps)(*state),
                        tols[model])
            by_k: dict = {}
            for c in survivors:
                k = c["config"].get("fused_k")
                if k:
                    by_k.setdefault(k, []).append(
                        (c["config"], module.make_multi_step(params, nsteps, **c["config"])(
                            *state)))
            for k, runs in by_k.items():
                for cfg, got in runs[1:]:
                    if not all(torch.equal(a, b) for a, b in zip(got, runs[0][1])):
                        fail(f"15c {model}: {cfg} differs from {runs[0][0]} at fused_k={k}")
            tiled = [c["config"] for c in survivors if "fused_tile" in c["config"]]
            if not tiled:
                k = hand["fused_k"]
                tile = space.tile_ladder(model, gg.nxyz, k, params.dtype, gg.device)[1][0]
                tiled = [{"fused_k": k, "fused_tile": list(tile)}]
            for cfg in tiled:
                k = cfg["fused_k"]
                got = module.make_multi_step(params, nsteps, **cfg)(*state)
                want = module.make_multi_step(params, nsteps, fused_k=k)(*state)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    fail(f"15c {model}: tile {cfg['fused_tile']} differs from the default "
                         f"tile at fused_k={k}")
            kernel_tiles = [space.launch_tile(model, gg.nxyz, c["fused_k"], params.dtype,
                                              c["fused_tile"]) for c in tiled]
            print(f"phase 15c: {model}: tuned vs default max|diff| = {err!r} (tolerance "
                  f"{tols[model]}); survivors per fused_k, bit for bit: "
                  f"{ {k: len(r) for k, r in by_k.items()} }; non-default tiles (bx, by, bz) "
                  f"{kernel_tiles} bit for bit against the default tile")
            if device == "cuda":
                # one launch at the main path's k: the winner's tile and every
                # checked tile against the default one, in turns
                k = winner.get("fused_k", hand["fused_k"])
                auto = space.launch_tile(model, gg.nxyz, k, params.dtype, device=gg.device)
                win = space.launch_tile(model, gg.nxyz, k, params.dtype, winner.get("fused_tile"),
                                        gg.device)
                tiles = list(dict.fromkeys([auto, win, *kernel_tiles]))
                launch = kernel_launch(model, params, state, k)
                turns = in_turns(torch, [lambda t=t: launch(t) for t in tiles], reps=10, turns=2)
                print(f"phase 15c: {kernel} {n}^3 f32 k={k}, ms per launch (2 turns of 10): "
                      + "; ".join(f"tile {t}{' (default)' if t == auto else ''}"
                                  f"{' (winner)' if t == win else ''} {ms!r}"
                                  for t, ms in zip(tiles, turns)) + f" {card}")
            igg.finalize_global_grid()
            del state, out, by_k

        # -- 15d: the analysis suite on the machine with the card ----------
        lint = subprocess.run([sys.executable, "-m", "implicitglobalgrid_tpu_torch.analysis"],
                              cwd=ROOT, capture_output=True, text=True, timeout=120)
        print(f"phase 15d: python -m implicitglobalgrid_tpu_torch.analysis exited "
              f"{lint.returncode}: {lint.stdout.strip().splitlines()[-1:]}")
        if lint.returncode != 0:
            fail(f"15d: the analysis suite failed:\n{lint.stdout}\n{lint.stderr}")
    finally:
        tcache.SEED_DIR, search._measure_model = saved_seed, measure_model
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        if igg.grid_is_initialized():
            igg.finalize_global_grid()
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase 15: {time.perf_counter() - t_phase!r} s {card}")



@contextlib.contextmanager
def plain_kernels():
    """The models' kernel calls replaced by their plain versions (each
    wrapper's ``*_reference``, same signature): the same cadence, with the
    kernels' rounding, and no launch."""
    from implicitglobalgrid_tpu_torch.models import acoustic3d, diffusion3d, porous_convection3d
    from implicitglobalgrid_tpu_torch.ops import fused_leapfrog as fl
    from implicitglobalgrid_tpu_torch.ops import fused_pt as fp
    from implicitglobalgrid_tpu_torch.ops import fused_stencil as fs

    swaps = ((diffusion3d, "fused_diffusion_steps", fs.fused_diffusion_steps_reference),
             (acoustic3d, "fused_leapfrog_steps", fl.fused_leapfrog_steps_reference),
             (porous_convection3d, "fused_pt_iterations", fp.fused_pt_iterations_reference))
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    try:
        for mod, name, ref in swaps:
            setattr(mod, name, ref)
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)


def load_example(name: str):
    """``examples/<name>.py`` of this checkout, as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: Phase 16a: each fused example twin at its main path's config (phases 3,
#: 5 and 6), steps cut: example, function, kwargs, model module, its
#: kernel, the steps of one chunk call, chunk calls (a warm-up and the
#: timed ones).
EXAMPLE_RUNS = {
    "diffusion3d": ("torch_diffusion3d_gpu_fused", "diffusion3d_fused",
                    dict(nt=16, k=4, periodx=1, periody=1, periodz=1), "fused_diffusion_steps",
                    16, 2),
    "acoustic3d": ("torch_acoustic3d_gpu_fused", "acoustic3d_fused",
                   dict(nt=24, k=6, periodz=1), "fused_leapfrog_steps", 24, 2),
    "porous_convection3d": ("torch_porous_convection3d_gpu_fused", "porous_convection3d_fused",
                            dict(nt=2, w=6, npt=12, periodz=1, overlapx=14, overlapy=14,
                                 overlapz=14), "fused_pt_iterations", 2, 2),
}


def phase16(torch, igg, reset_counts, counts, card, n=256, ngather=512, device="cuda") -> None:
    """Phase 16: the example twins, the chunked gather, the ptxas budget
    and the full analysis suite (see the module docstring).  ``n``,
    ``ngather`` and ``device`` exist for a rehearsal on the CPU."""
    import importlib
    import io

    import numpy as np

    from implicitglobalgrid_tpu_torch.analysis import core as acore
    from implicitglobalgrid_tpu_torch.analysis import ptxas
    from implicitglobalgrid_tpu_torch.ops import gather as gmod

    t_phase = time.perf_counter()
    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    # -- 16a: the fused example twins, bit for bit with the plain cadence --
    for model, (example, func, kw, kernel, chunk, calls) in EXAMPLE_RUNS.items():
        module = importlib.import_module(f"implicitglobalgrid_tpu_torch.models.{model}")
        run = getattr(load_example(example), func)
        reset_counts()
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            got = run(nx=n, device=device, **kw)
        sync()
        launched = counts()
        if cuda and not launched[kernel]:
            fail(f"16a {example}: no {kernel} launch counted ({launched})")
        if igg.grid_is_initialized():
            fail(f"16a {example}: the example left its grid initialized")
        setup_kw = {k: v for k, v in kw.items() if k not in ("nt", "k", "w")}
        k = kw.get("k", kw.get("w"))
        setup_kw = {"overlapx": 2 * k, "overlapy": 2 * k, "overlapz": 2 * k, **setup_kw}
        state, params = module.setup(n, n, n, dtype=torch.float32, quiet=True, device=device,
                                     **setup_kw)
        with plain_kernels():
            step = module.make_multi_step(params, chunk, fused_k=k)
            for _ in range(calls):
                state = step(*state)
        sync()
        igg.finalize_global_grid()
        want = state[0]
        if not torch.isfinite(got).all():
            fail(f"16a {example}: non-finite output")
        same = torch.equal(got, want)
        print(f"phase 16a: {example}.{func}(nx={n}, {kw}): launches {launched}; final field "
              f"vs the same cadence with the plain versions: bit for bit {same}; "
              f"{' | '.join(said.getvalue().split(chr(10))).strip(' |')} {card}")
        if not same:
            fail(f"16a {example}: max|kernel-plain| = {float((got - want).abs().max())!r}")
        del got, want, state
    novis = load_example("torch_diffusion3d_multidevice_novis").diffusion3d
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        T = novis(nx=n, nt=20, device=device, dtype=torch.float32)
    if not (torch.isfinite(T).all() and float(T.max()) > 0):
        fail("16a torch_diffusion3d_multidevice_novis: output not finite or zeroed")
    small = [novis(nx=24, nt=8, device=d, dtype=torch.float64, quiet=True).cpu()
             for d in (device, "cpu")]
    rel = float((small[0] - small[1]).abs().max() / small[1].abs().max())
    print(f"phase 16a: torch_diffusion3d_multidevice_novis on one rank, {n}^3 f32 20 steps: "
          f"{' | '.join(said.getvalue().split(chr(10))).strip(' |')}; 24^3 f64 8 steps vs the CPU: max rel diff {rel!r} "
          f"(< 1e-12) {card}")
    if not rel < 1e-12:
        fail(f"16a novis: {device} vs cpu differ by {rel!r}")
    del T, small

    # -- 16b: gather through the local and the chunked path ----------------
    igg.init_global_grid(ngather, ngather, ngather, quiet=True, device=device)
    gen = torch.Generator(device=device).manual_seed(16)
    A = torch.randn((ngather,) * 3, generator=gen, device=device)
    A[::7, ::5, ::3] = -0.0
    want = A.cpu().numpy()
    block = want.nbytes
    saved = os.environ.get("IGG_GATHER_BATCH")
    try:
        for label, batch, force in (("local", None, False), ("chunked", 1, True),
                                    ("chunked", 8, True)):
            if batch is not None:
                os.environ["IGG_GATHER_BATCH"] = str(batch)
            sync()
            if cuda:
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            G = igg.gather(A, _force_chunked=force)
            secs = time.perf_counter() - t0
            transient = torch.cuda.max_memory_allocated() - base if cuda else 0
            stats = gmod.last_gather_stats
            plan = {"path": "local", "host_bytes": block, "fetches": 0, "block_bytes": block}
            if force:
                plan = {"path": "chunked", "host_bytes": block, "fetches": 1, "blocks": 1,
                        "batch": 1, "block_bytes": block}
            exact = G.shape == want.shape and np.array_equal(G.view(np.uint32),
                                                             want.view(np.uint32))
            print(f"phase 16b: gather {ngather}^3 f32 ({block / 2**20!r} MiB) {label}"
                  f"{'' if batch is None else f' IGG_GATHER_BATCH={batch}'}: {secs * 1e3!r} ms, "
                  f"{block / 2**20 / secs!r} MiB/s; bit for bit {exact}; stats {stats}; "
                  f"device transient {transient} B (bound {(batch or 0) * block + block} B) "
                  f"{card}")
            if not exact or stats != plan:
                fail(f"16b {label}: bit for bit {exact}, stats {stats} (plan {plan})")
            if transient > (batch or 0) * block + block:
                fail(f"16b {label}: device transient {transient} B over the bound")
            del G
    finally:
        if saved is None:
            os.environ.pop("IGG_GATHER_BATCH", None)
        else:
            os.environ["IGG_GATHER_BATCH"] = saved
        igg.finalize_global_grid()
    del A, want

    # -- 16c: the ptxas budget over phase 1's builds --------------------
    report = acore.run(["ptxas-budget"], baseline=None)
    if cuda:
        if report.ran != ["ptxas-budget"] or report.findings or report.errors:
            fail(f"16c: ptxas-budget is not clean:\n{report.human()}")
        for src, entries in ptxas.census().items():
            for entry, m in entries.items():
                print(f"phase 16c: {src} {entry}: {m['registers']} registers, "
                      f"{m['spill_stores']}/{m['spill_loads']} B spill stores/loads, "
                      f"{m['stack_bytes']} B stack, {m['smem_bytes']} B static shared memory")
    print(f"phase 16c: ptxas-budget: {report.human().splitlines()[-1]}")

    # -- 16d: the full analysis suite --------------------------------------
    lint = subprocess.run([sys.executable, "-m", "implicitglobalgrid_tpu_torch.analysis"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    last = lint.stdout.strip().splitlines()[-1:]
    print(f"phase 16d: python -m implicitglobalgrid_tpu_torch.analysis exited "
          f"{lint.returncode}: {last}")
    if lint.returncode != 0 or (cuda and last != [
            f"analysis: {len(acore.REGISTRY)} analyzer(s) ran — clean"]):
        fail(f"16d: the analysis suite is not clean with every analyzer:\n{lint.stdout}\n"
             f"{lint.stderr}")
    print(f"phase 16: {time.perf_counter() - t_phase!r} s {card}")


#: phase 17's soak runs: (part, soak arguments)
SOAK_RUNS = (
    ("17a", ["baseline", "init_flake", "halo_corrupt", "worker_crash", "--nx", "256",
             "--fused-k", "4", "--steps", "16"]),
    ("17b", ["serving", "fleet", "--nx", "32", "--fused-k", "4", "--steps", "8"]),
)


def phase17(torch, reset_counts, counts, card, device="cuda", sizes=None) -> None:
    """Phase 17: the operator tools on the card (see the module docstring).
    ``device`` and ``sizes`` (``{part: [--nx, --steps]}``) exist for a
    rehearsal on the CPU."""
    import io

    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="igg_phase17_"))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    tool = [sys.executable, "-m", "implicitglobalgrid_tpu_torch.scripts."]
    cuda = device == "cuda"
    refused = None
    print("phase 17: the five 2-rank drills (elastic_failover, live_plane, frontdoor, chaos, "
          "sdc) wait for two or more cards: NCCL puts no two ranks on one device (ROADMAP "
          "leftover 3); on the CPU they pass in tier-1")
    try:
        # 17a and 17b run side by side: two soak processes, each starting its
        # children one after another (most of a child's time is its start);
        # beside them, a 2-rank drill asked onto one card, which must raise
        # (no quiet CPU fallback; 17c reads it)
        reset_counts()
        if cuda and torch.cuda.device_count() < 2:
            refused = subprocess.Popen(
                tool[:-1] + [tool[-1] + "soak", "elastic_failover", "--device", "cuda",
                             "--workdir", str(work / "refused")],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        runs = {}
        for part, argv in SOAK_RUNS:
            if sizes is not None:
                argv = argv[:argv.index("--nx")] + ["--nx", str(sizes[part][0]), "--fused-k",
                                                     "2", "--steps", str(sizes[part][1])]
            log = open(work / f"{part}.log", "w+")
            proc = subprocess.Popen(
                tool[:-1] + [tool[-1] + "soak", *argv, "--device", device, "--workdir",
                             str(work / part), "--timeout", "300"],
                env=env, stdout=log, stderr=subprocess.STDOUT, text=True)
            runs[part] = (argv, proc, log, time.perf_counter())
        summaries = {}
        for part, (argv, proc, log, t0) in runs.items():
            try:
                proc.wait(timeout=900)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            secs = time.perf_counter() - t0
            log.seek(0)
            out = log.read()
            log.close()
            for line in out.splitlines():
                if not line.startswith("[W"):  # c10d's hostname warnings
                    print(f"phase {part}: {line}")
            # the soak's children launch the kernels; this process launches none
            if proc.returncode != 0 or any(counts().values()):
                fail(f"{part}: soak exited {proc.returncode} (this process's launches "
                     f"{counts()}):\n{out[-8000:]}")
            workdir = work / part
            summary = json.loads((workdir / "soak_summary.json").read_text())["scenarios"]
            summaries[part] = summary
            for name, rec in summary.items():
                launches = [r and {k: v for k, v in r.items() if v}
                            for r in rec.get("launches", [])]
                extra = "".join(f", {key} {rec[key]!r}" for key in (
                    "crash_step", "crash_to_done_s", "rounds", "kill_to_all_done_s", "leg1_s",
                    "canary_legs_s") if key in rec)
                print(f"phase {part}: {name}: {'PASS' if rec['ok'] else 'FAIL'} in "
                      f"{rec['seconds']!r} s; children's kernel launches {launches}{extra} {card}")
                if not rec["ok"]:
                    fail(f"{part}: {name} failed")
            print(f"phase {part}: soak {' '.join(argv)} --device {device}: {secs!r} s, side "
                  f"by side with the other part {card}")

        # 17a: every recovered field is the baseline's, and every child ran the kernel
        a = summaries["17a"]
        want = a["baseline"]["sha256"]
        for name in ("init_flake", "halo_corrupt", "worker_crash"):
            if a[name]["sha256"] != want:
                fail(f"17a: {name}'s field sha256 {a[name]['sha256']} != the baseline's {want}")
        for part, summary in summaries.items():
            for name, rec in summary.items():
                k = "fused_pt_iterations" if name == "serving" else "fused_diffusion_steps"
                got = [r[k] for r in rec["launches"]]
                if cuda and (not got or min(got) <= 0):
                    fail(f"{part}: {name}'s children launched {k} {got} times")
        print(f"phase 17a: init_flake, halo_corrupt, worker_crash: sha256 of each saved field "
              f"== the baseline's {want[:16]}...; worker_crash crash (step "
              f"{a['worker_crash']['crash_step']}) to done {a['worker_crash']['crash_to_done_s']!r}"
              f" s {card}")

        # 17c: the trace CLI over 17a's span dumps, the cluster view over 17b's pools
        from implicitglobalgrid_tpu_torch.scripts import igg_trace

        t0 = time.perf_counter()
        for name in ("baseline", "init_flake", "halo_corrupt", "worker_crash"):
            merged = work / f"merged_{name}.json"
            rcs = []
            for cmd in (["merge", str(work / "17a" / f"telemetry_{name}"), "-o", str(merged)],
                        ["validate", str(merged)]):
                said = io.StringIO()
                with contextlib.redirect_stderr(said):
                    rcs.append(igg_trace.main(cmd))
                if rcs[-1] != 0:
                    fail(f"17c: igg_trace {cmd[0]} of {name}'s dump exited {rcs[-1]}:\n"
                         f"{said.getvalue()}")
            doc = json.loads(merged.read_text())
            spans = sum(1 for e in doc["traceEvents"] if e["ph"] == "X")
            print(f"phase 17c: igg_trace merge + validate of 17a {name}'s span dump: exit "
                  f"codes {rcs}, {spans} spans")
        view = summaries["17b"]["fleet"].get("view", "")
        rows = [line for line in view.splitlines()[2:] if line.strip()]
        print(f"phase 17c: igg_top view over 17b's two pool doors ({len(rows)} rows):")
        for line in view.splitlines():
            print(f"phase 17c:   {line}")
        if len(rows) != 2:
            fail(f"17c: the igg_top view has {len(rows)} rows, not one per pool")
        if refused is not None:
            out, err = refused.communicate(timeout=120)
            last = (err.strip().splitlines() or [""])[-1]
            print(f"phase 17c: soak elastic_failover --device cuda on one card: exit "
                  f"{refused.returncode}: {last}")
            if refused.returncode == 0 or "two CUDA cards" not in last:
                fail(f"17c: the 2-rank drill on one card did not raise: {out}")
        print(f"phase 17c: {time.perf_counter() - t0!r} s {card}")
    finally:
        if refused is not None and refused.poll() is None:
            refused.kill()
            refused.wait()
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase 17: {time.perf_counter() - t_phase!r} s {card}")


#: Phase 18a's harness runs at phases 3, 4, 5 and 6's configs: (key of the
#: phase's ms per step, `benchmarks.run` function, its kwargs, the kernel,
#: the model module, and the phase's `cuda_ms` reps and warm-up calls).
HARNESS_RUNS = (
    ("diffusion3d", "bench_diffusion",
     dict(n=256, chunk=16, fused_k=4, overlap=8, period="xyz"), "fused_diffusion_steps",
     "diffusion3d", 5, 2),
    ("acoustic3d", "bench_acoustic",
     dict(n=256, chunk=24, fused_k=6, overlap=12, period="z"), "fused_leapfrog_steps",
     "acoustic3d", 3, 2),
    ("porous_convection3d", "bench_porous",
     dict(n=256, chunk=2, npt=12, fused_k=6, overlap=14, period="z"), "fused_pt_iterations",
     "porous_convection3d", 3, 1),
    ("diffusion3d_512", "bench_diffusion", dict(n=512, chunk=8, fused_k=4),
     "fused_diffusion_steps", "diffusion3d", 3, 1),
)

#: The order in which 18a takes its readings of one config: "p" the
#: phase's way of timing it (`phase_way_ms`), "h" the harness.
HARNESS_TURNS = "phhpph"


def phase_way_ms(torch, model, kw, reps, warmup) -> float:
    """Ms per step of ``kw``'s config timed as phases 3-6 time it: a fresh
    grid, ``model.make_multi_step(chunk, fused_k=...)`` called on the same
    inputs each time after one warm-up call, `cuda_ms` over the phase's
    ``reps`` and ``warmup``."""
    import importlib

    import implicitglobalgrid_tpu_torch as igg
    from implicitglobalgrid_tpu_torch.benchmarks import run

    mod = importlib.import_module(f"implicitglobalgrid_tpu_torch.models.{model}")
    setup_kw = run._grid_kwargs(kw.get("overlap"), kw.get("period"))
    if "npt" in kw:
        setup_kw["npt"] = kw["npt"]
    n, chunk = kw["n"], kw["chunk"]
    state, params = mod.setup(n, n, n, dtype=torch.float32, quiet=True, **setup_kw)
    fused = mod.make_multi_step(params, chunk, fused_k=kw["fused_k"])
    fused(*state)  # warm-up (allocator), as in the phases
    torch.cuda.synchronize()
    ms = cuda_ms(torch, lambda: fused(*state), reps=reps, warmup=warmup) / chunk
    igg.finalize_global_grid()
    return ms


def phase18a(torch, reset_counts, counts, card, phase_ms) -> list:
    """Phase 18a, run right after phase 6: the harness at phases 3-6's
    configs, in turns (`HARNESS_TURNS`) with the phase's way of timing the
    same config, so that both read the host as it is at that moment (the
    diffusion 256^3 chunk is host-paced: PERF.md).  The medians of each
    way's three readings are compared; the phase's own reading
    (``phase_ms``, by `HARNESS_RUNS` key) is printed beside them.  Returns
    its lines, which phase 18 prints again."""
    from implicitglobalgrid_tpu_torch.benchmarks import run

    t0 = time.perf_counter()
    lines = []
    for key, func, kw, kernel, model, reps, warmup in HARNESS_RUNS:
        recs, phase_way, launches = [], [], {}
        for turn in HARNESS_TURNS:
            if turn == "p":
                phase_way.append(phase_way_ms(torch, model, kw, reps, warmup))
                continue
            reset_counts()
            recs.append(getattr(run, func)(reps=20, dtype="float32", emit=False, device="cuda",
                                           **kw))
            for name, c in counts().items():
                launches[name] = launches.get(name, 0) + c
        harness_ms = statistics.median(r["t_it_ms"] for r in recs)
        phase_way_med = statistics.median(phase_way)
        ratio = harness_ms / phase_way_med
        metric = recs[0]["metric"]
        lines.append(
            f"phase 18a: benchmarks.run {func}({', '.join(f'{k}={v}' for k, v in kw.items())}):"
            f" {metric} {[r['t_it_ms'] for r in recs]} ms/step, median {harness_ms!r} (spreads "
            f"{[r['spread'] for r in recs]}), T_eff {[r['value'] for r in recs]} GB/s, paths "
            f"{[r['path'] for r in recs]}, launches {launches}; the phase's way in turns with "
            f"it ({HARNESS_TURNS}) {phase_way!r} ms/step, median {phase_way_med!r}, ratio "
            f"{ratio!r}; the phase's own reading {phase_ms[key]!r} ms/step, ratio "
            f"{harness_ms / phase_ms[key]!r} {card}")
        print(lines[-1])
        if any(r["path"] != "cuda-fused" for r in recs) or launches[kernel] <= 0:
            fail(f"18a: {func} did not run {kernel} on the card: paths "
                 f"{[r['path'] for r in recs]}, {launches}")
        if not 0.95 <= ratio <= 1.05:
            fail(f"18a: {metric} {harness_ms!r} ms/step (median of the harness's {len(recs)}) "
                 f"is not within 5% of the phase's way's {phase_way_med!r} (median of "
                 f"{len(phase_way)}, taken in turns with it)")
    lines.append(f"phase 18a: {time.perf_counter() - t0!r} s {card}")
    print(lines[-1])
    return lines


def phase18(torch, igg, card, harness=(), bench_out=None) -> dict:
    """Phase 18b-d: the bench twin, the reconcile join and the padded-face
    exchange on the card (see the module docstring); first 18a's lines
    (``harness``: it ran after phase 6) again.  Returns 18b's record."""
    import io

    from implicitglobalgrid_tpu_torch.analysis import core as acore
    from implicitglobalgrid_tpu_torch.benchmarks import bench
    from implicitglobalgrid_tpu_torch.models import acoustic3d
    from implicitglobalgrid_tpu_torch.ops import fused_leapfrog as fl
    from implicitglobalgrid_tpu_torch.ops.halo import update_halo_padded_faces

    t_phase = time.perf_counter()
    for line in harness:
        print(f"{line} (after phase 6)")

    # -- 18b: the bench twin, no record file -------------------------------------
    t0 = time.perf_counter()
    before = sorted(os.listdir(ROOT))
    work = Path(tempfile.mkdtemp(prefix="igg_phase18_"))
    saved = os.environ.get("IGG_TUNE_CACHE")
    os.environ["IGG_TUNE_CACHE"] = str(work / "tune")
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            bench.main(out=None, device="cuda")
    finally:
        if saved is None:
            os.environ.pop("IGG_TUNE_CACHE", None)
        else:
            os.environ["IGG_TUNE_CACHE"] = saved
        shutil.rmtree(work, ignore_errors=True)
    lines = [line for line in out.getvalue().splitlines() if line.strip()]
    if len(lines) != 1:
        fail(f"18b: the bench twin printed {len(lines)} lines, not one")
    record = json.loads(lines[0])
    if bench_out:
        Path(bench_out).mkdir(parents=True, exist_ok=True)
        (Path(bench_out) / "bench_record.json").write_text(json.dumps(record, indent=1))
    after = sorted(os.listdir(ROOT))
    if after != before:
        fail(f"18b: the bench twin changed the checkout: {sorted(set(after) ^ set(before))}")
    extras = record["extras"]
    for name, extra in extras.items():
        if not isinstance(extra, dict):
            continue
        if "error" in extra or any(isinstance(v, dict) and "error" in v for v in extra.values()):
            fail(f"18b: extra {name} failed: {json.dumps(extra)[:2000]}")
        if "skipped" in extra and extra["skipped"] != bench.SKIPPED.get(name):
            fail(f"18b: extra {name} skipped for a reason the twin does not name: {extra}")
    skipped = sorted(k for k, v in extras.items() if isinstance(v, dict) and "skipped" in v)
    print(f"phase 18b: {record['metric']}: T_eff {record['value']!r} GB/s, vs_baseline "
          f"{record['vs_baseline']!r} (154 GB/s), headline path {extras['headline_path']}; "
          f"{len(extras)} extras, skipped {skipped} {card}")
    for name, extra in extras.items():
        fused = [(name, extra)] if "pallas_fused" in name else (
            [(f"{name}.{k}", v) for k, v in extra.items()] if name.endswith("pipelined_ab")
            else [])
        for label, r in fused:
            print(f"phase 18b: {label}: {r['t_it_ms']!r} ms/step, T_eff {r['teff']!r} GB/s, "
                  f"path {r['path']}, pipelined {r.get('pipelined')} {card}")
    print(f"phase 18b: no record written, the checkout unchanged; {time.perf_counter() - t0!r} s "
          f"{card}")

    # -- 18c: the reconcile join, and the cost model -------------------------------
    t0 = time.perf_counter()
    eff = extras["efficiency"]["models"]
    card_gbs = HBM_BYTES_PER_S / 1e9
    for model in ("diffusion", "acoustic", "porous"):
        rec = eff[model]
        if rec.get("achieved_fraction") is None or rec.get("modeled_actual_gbs") is None:
            fail(f"18c: the efficiency join lacks {model}: {rec}")
        flag = ("ABOVE the card's rate: the byte model counts re-reads that L2 serves"
                if rec["modeled_actual_gbs"] > card_gbs else "below the card's rate")
        print(f"phase 18c: {model}: achieved_fraction {rec['achieved_fraction']!r}, measured "
              f"fused T_eff {rec['measured_teff_gbs']!r} GB/s, modeled_actual_gbs "
              f"{rec['modeled_actual_gbs']!r} ({flag}, {card_gbs!r} GB/s) {card}")
    report = acore.run(["cost-model"], baseline=None)
    if report.ran != ["cost-model"] or report.findings or report.errors:
        fail(f"18c: cost-model is not clean:\n{report.human()}")
    print(f"phase 18c: cost-model: {report.human().splitlines()[-1]}; "
          f"{time.perf_counter() - t0!r} s {card}")

    # -- 18d: update_halo_padded_faces, bit for bit ----------------------------
    t0 = time.perf_counter()
    n = 256
    gen = torch.Generator(device="cuda").manual_seed(18)
    periods = dict(periodx=1, periody=1, periodz=1)
    for dims, ref_periods in ((None, periods), ((0, 1), dict(periodx=1, periody=1))):
        state, _ = acoustic3d.setup(n, n, n, dtype=torch.float32, quiet=True, **periods)
        fields = [torch.randn(A.shape, generator=gen, device=A.device) for A in state]
        C = fields[0].clone()
        padded = fl.pad_faces(*fields[1:])
        update_halo_padded_faces(C, *padded, width=1, dims=dims)
        got = (C, *fl.unpad_faces(*padded))
        igg.finalize_global_grid()
        # the reference: unpad -> update_halo -> pad, on a grid whose halo
        # activity is ``dims``' (x and y only for dims=(0, 1))
        igg.init_global_grid(n, n, n, quiet=True, **ref_periods)
        want = [A.clone() for A in fields]
        igg.update_halo(*want)
        igg.finalize_global_grid()
        torch.cuda.synchronize()
        for name, g, w in zip(("P", "Vx", "Vy", "Vz"), got, want):
            if not torch.equal(g, w):
                fail(f"18d: update_halo_padded_faces(dims={dims}) {name} differs from unpad -> "
                     f"update_halo -> pad: max {float((g - w).abs().max())!r}")
        print(f"phase 18d: update_halo_padded_faces acoustic {n}^3 f32 periodic x, y, z, "
              f"width=1, dims={dims}: bit for bit with unpad -> update_halo -> pad "
              f"({'x, y, z' if dims is None else 'a grid periodic in x and y'})")
        del state, fields, C, padded, got, want
    print(f"phase 18d: {time.perf_counter() - t0!r} s {card}")
    print(f"phase 18: {time.perf_counter() - t_phase!r} s {card}")
    return record


def host_probe(torch, label: str, card: str, reps: int = 30) -> dict:
    """Phase 18e's reading: the host side of one diffusion chunk call at
    phase 3's config (256^3 float32, periodic x, y, z, overlap 8, 16 steps
    ``fused_k=4``).  Each call is timed on the host's clock from an idle
    card (synchronised before, not after), so the reading is the launches
    alone; beside it the call's CUDA-event time and what might grow with
    the process: live threads, objects the collector tracks, the caching
    allocator's segments, telemetry metrics and spans in the ring."""
    import gc
    import threading

    from implicitglobalgrid_tpu_torch import finalize_global_grid, telemetry_snapshot
    from implicitglobalgrid_tpu_torch.models import diffusion3d
    from implicitglobalgrid_tpu_torch.utils import tracing

    n, nsteps = 256, 16
    state, params = diffusion3d.setup(
        n, n, n, periodx=1, periody=1, periodz=1, overlapx=8, overlapy=8, overlapz=8,
        dtype=torch.float32, quiet=True)
    fused = diffusion3d.make_multi_step(params, nsteps, fused_k=4)
    state = fused(*fused(*state))
    host = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = fused(*state)
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    device_ms = cuda_ms(torch, lambda: fused(*state), reps=reps, warmup=1)
    finalize_global_grid()
    del state
    snap = telemetry_snapshot()
    out = {
        "host_ms": statistics.median(host), "host_min_ms": min(host),
        "host_max_ms": max(host), "device_ms": device_ms,
        "threads": sorted(t.name for t in threading.enumerate()),
        "gc_objects": len(gc.get_objects()),
        "segments": torch.cuda.memory_stats().get("segment.all.current", 0),
        "metrics": sum(len(snap[k]) for k in ("counters", "gauges", "histograms")),
        "spans": len(tracing.span_records()),
    }
    print(f"phase 18e: host probe {label}: host {out['host_ms']!r} ms per 16-step call "
          f"(min {out['host_min_ms']!r}, max {out['host_max_ms']!r}, {reps} calls from an idle "
          f"card), device {device_ms!r} ms per call ({device_ms / nsteps!r} ms/step); "
          f"{len(out['threads'])} threads {out['threads']}, {out['gc_objects']} gc objects, "
          f"{out['segments']} allocator segments, {out['metrics']} telemetry metrics, "
          f"{out['spans']} spans {card}")
    return out


def phase18e(torch, card, early: dict, phase3_ms: float) -> None:
    """Phase 18e at the end: 18a's diffusion 256^3 harness run again,
    beside phase 3's ms per step (``phase3_ms``); the host probe as the
    process stands, then with telemetry off, after a collection and an
    emptied allocator cache, and after resetting telemetry and tracing as
    well (see the module docstring); each beside the reading right after
    18a."""
    import gc

    from implicitglobalgrid_tpu_torch.benchmarks import run
    from implicitglobalgrid_tpu_torch.utils import telemetry, tracing

    t0 = time.perf_counter()
    _, func, kw, *_ = HARNESS_RUNS[0]
    rec = getattr(run, func)(reps=20, dtype="float32", emit=False, device="cuda", **kw)
    print(f"phase 18e: at the end, benchmarks.run {func} at phase 3's config: {rec['t_it_ms']!r} "
          f"ms/step (spread {rec['spread']}); phase 3's {phase3_ms!r}, ratio "
          f"{rec['t_it_ms'] / phase3_ms!r} {card}")
    late = {"at the end": host_probe(torch, "at the end", card)}
    saved = os.environ.get("IGG_TELEMETRY")
    os.environ["IGG_TELEMETRY"] = "0"
    try:
        late["IGG_TELEMETRY=0"] = host_probe(torch, "at the end, IGG_TELEMETRY=0", card)
    finally:
        if saved is None:
            os.environ.pop("IGG_TELEMETRY", None)
        else:
            os.environ["IGG_TELEMETRY"] = saved
    gc.collect()
    torch.cuda.empty_cache()
    late["gc + empty_cache"] = host_probe(
        torch, "at the end, after gc.collect() and torch.cuda.empty_cache()", card)
    telemetry.reset()
    tracing.reset()
    late["+ telemetry/tracing reset"] = host_probe(
        torch, "at the end, after gc, empty_cache and a telemetry and tracing reset", card)
    for label, r in late.items():
        print(f"phase 18e: {label}: host {r['host_ms'] / early['host_ms']!r}x, device "
              f"{r['device_ms'] / early['device_ms']!r}x the reading right after 18a {card}")
    print(f"phase 18e: {time.perf_counter() - t0!r} s {card}")


def phase19(reset_counts, counts, card, record) -> None:
    """Phase 19: the perf gate over 18b's ``record``, ``seed --dry-run`` on
    the committed records, and the tuner at the bench's diffusion key
    against the committed seed layer (see the module docstring)."""
    import io

    from implicitglobalgrid_tpu_torch import tuning
    from implicitglobalgrid_tpu_torch.analysis import perf
    from implicitglobalgrid_tpu_torch.benchmarks import run
    from implicitglobalgrid_tpu_torch.scripts import check_perf
    from implicitglobalgrid_tpu_torch.tuning.__main__ import main as tuning_main

    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="igg_phase19_"))
    try:
        # -- 19a: the gate verdict, and the CLI's exit code --------------------
        dev = record.get("device")
        if not isinstance(dev, dict) or not dev.get("name"):
            fail(f"19a: the bench record has no device block: {dev!r}")
        records, skipped = perf.load_bench_records(str(ROOT))
        if not records or skipped:
            fail(f"19a: committed BENCH_H100 records {[r for r, _ in records]}, unparseable "
                 f"{skipped}")
        ref_round, ref = records[-1]
        mismatch = perf.comparability_error(record, ref)
        verdict = perf.gate_summary(record, str(ROOT))
        print(f"phase 19a: gate vs {perf.record_name(ref_round)}: ok {verdict['ok']}, checked "
              f"{verdict.get('checked')}, regressions "
              f"{[(r['metric'], r['drop']) for r in verdict.get('regressions', [])]}, waived "
              f"{[(r['metric'], r['drop']) for r in verdict.get('waived', [])]}, missing "
              f"{verdict.get('missing', [])}; note {verdict.get('note')}; device {dev}, "
              f"reference device {ref.get('device')} {card}")
        if mismatch is None and not verdict.get("checked"):
            fail(f"19a: nothing checked against a record of the same card: {verdict}")
        embedded = record["extras"].get("perf_gate", {})
        if [embedded.get(k) for k in ("ok", "checked", "regressions")] != [
                verdict.get(k) for k in ("ok", "checked", "regressions")]:
            fail(f"19a: the record's own perf_gate {embedded} is not the verdict {verdict}")
        cand = work / "candidate.json"
        cand.write_text(json.dumps(record))
        out = io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
            rc = check_perf.main(["-c", str(cand), "--json"])
        want = 2 if mismatch is not None else (0 if verdict["ok"] else 1)
        print(f"phase 19a: check_perf -c exit {rc} (the verdict says {want}) {card}")
        if rc != want:
            fail(f"19a: check_perf exited {rc}, the verdict says {want}:\n{out.getvalue()}")

        # -- 19b: seed --dry-run over the committed records --------------------
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = tuning_main(["seed", "--dry-run", "--json", "--cache", str(work / "seed")])
        entries = json.loads(out.getvalue()) if rc == 0 else None
        if entries is None or len(entries) != len(tuning.SEEDABLE):
            fail(f"19b: seed --dry-run exit {rc} gave {entries!r}, not one entry per row")
        committed = {tuning.entry_filename(doc["key"]): doc for _, doc in tuning.TuneCache(
            primary=tuning.SEED_DIR, fallbacks=()).entries() if doc}
        for row, entry in zip(tuning.SEEDABLE, entries):
            key, config = entry["key"], entry["config"]
            err = tuning.admissibility_error(key, config)
            ours = committed.get(tuning.entry_filename(key))
            same = ours is not None and all(ours[f] == entry[f] for f in (
                "key", "config", "source", "measured"))
            print(f"phase 19b: {row['path']}: {key['model']} {key['size']} {config} from "
                  f"{entry['source']}, {entry['measured']}, admissible {err is None}, the "
                  f"committed entry {'equal' if same else 'DIFFERENT'} {card}")
            if config != row["config"] or err is not None or not same:
                fail(f"19b: {row['path']}: config {config}, admissibility {err!r}, committed "
                     f"{ours}")

        # -- 19c: the tuner at the bench's diffusion key -----------------------
        saved = os.environ.get("IGG_TUNE_CACHE")
        os.environ["IGG_TUNE_CACHE"] = str(work / "primary")
        try:
            reset_counts()
            rec = run.bench_tuned_vs_default(model="diffusion", n=256, chunk=24, reps=3,
                                             emit=False, device="cuda")
            c = counts()
        finally:
            if saved is None:
                os.environ.pop("IGG_TUNE_CACHE", None)
            else:
                os.environ["IGG_TUNE_CACHE"] = saved
        key = tuning.make_key("diffusion3d", (256, 256, 256), "float32", backend="cuda",
                              topology=tuning.BENCH_TOPOLOGY, nsteps=24)
        held = tuning.entry_filename(key) in committed
        hand = record["extras"]["diffusion_pallas_fused4"]["t_it_ms"]
        print(f"phase 19c: diffusion 256^3 24-step tuned_vs_default: cache {rec['cache']}, "
              f"config {rec['config']} from {rec['source']}, tuned_speedup "
              f"{rec['tuned_speedup']!r} (default {rec['t_default_ms']!r}, tuned "
              f"{rec['t_tuned_ms']!r} ms/step); the hand-picked fused_k=4 in 18b "
              f"{hand!r} ms/step, tuned / hand-picked {rec['t_tuned_ms'] / hand!r}; launches "
              f"{c} {card}")
        if held and rec["cache"] != "hit":
            fail(f"19c: the seed layer holds the bench key, but the tuner missed: {rec}")
        if c["fused_diffusion_steps"] <= 0:
            fail(f"19c: the tuned chunk launched no fused_diffusion_steps: {c}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase 19: {time.perf_counter() - t_phase!r} s {card}")


def phase20(torch, igg, reset_counts, counts, card, n=512, nsteps=16) -> dict:
    """Phase 20: the per-step diffusion update's kernel at n^3 float32 (see
    the module docstring); returns its record."""
    from implicitglobalgrid_tpu_torch.analysis import ptxas
    from implicitglobalgrid_tpu_torch.models import diffusion3d
    from implicitglobalgrid_tpu_torch.ops import _kernels
    from implicitglobalgrid_tpu_torch.ops import diffusion_update as du

    _kernels.build("diffusion_update")
    regs = ptxas.parse_report(_kernels.build_log("diffusion_update") or "")
    if not regs:
        fail("phase 20: no -Xptxas -v report of diffusion_update.cu")
    for entry, m in regs.items():
        print(f"phase 20: diffusion_update.cu {entry}: {m['registers']} registers, spills "
              f"{m['spill_stores']} B stored / {m['spill_loads']} B loaded, "
              f"{m['smem_bytes']} B static shared memory")
    f32 = torch.float32

    # The per_step cell's main path: one update and one update_halo a step.
    (T0, Cp), params = diffusion3d.setup(n, n, n, periodx=1, periody=1, periodz=1, overlapx=2,
                                         overlapy=2, overlapz=2, dtype=f32, quiet=True)
    step = diffusion3d.make_multi_step(params, nsteps)
    plain = diffusion3d._plain_update(params)

    def plain_cadence(T, Cp):
        for _ in range(nsteps):
            T = igg.update_halo(plain(T, Cp))
        return T, Cp

    torch.cuda.synchronize()
    reset_counts()
    T_k, _ = step(T0, Cp)
    torch.cuda.synchronize()
    c = counts()
    if c != {**{name: 0 for name in c}, "diffusion_update": nsteps}:
        fail(f"phase 20: make_multi_step(params, {nsteps}) launched {c}, expected {nsteps} "
             "diffusion_update and no other kernel")
    T_p, _ = plain_cadence(T0, Cp)
    torch.cuda.synchronize()
    main_err = float((T_k - T_p).abs().max())
    if not torch.equal(T_k, T_p):
        fail(f"phase 20: the per-step cadence differs from it built on _plain_update: {main_err!r}")
    del T_k, T_p
    step_ms = cuda_ms(torch, lambda: step(T0, Cp), reps=5) / nsteps
    plain_step_ms = cuda_ms(torch, lambda: plain_cadence(T0, Cp), reps=2, warmup=1) / nsteps
    print(f"phase 20: diffusion {n}^3 f32 periodic x/y/z overlap 2, make_multi_step(params, "
          f"{nsteps}): launches {c}, bit-exact with the cadence on _plain_update; "
          f"{step_ms!r} ms/step (the plain cadence {plain_step_ms!r} ms/step) {card}")
    igg.finalize_global_grid()
    del T0, Cp

    # One launch on random fields, with the model's coefficients at n^3.
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(20)
    T = torch.randn((n,) * 3, generator=gen, device=dev, dtype=f32)
    Cp = 1 + torch.rand((n,) * 3, generator=gen, device=dev, dtype=f32)
    coeffs = (params.lam, params.dt, params.dx, params.dy, params.dz)
    err = float((du.diffusion_update(T, Cp, *coeffs)
                 - du.diffusion_update_reference(T, Cp, *coeffs)).abs().max())
    if err != 0.0:
        fail(f"phase 20: diffusion_update differs from its plain version: {err!r}")
    ms = cuda_ms(torch, lambda: du.diffusion_update(T, Cp, *coeffs), reps=50)
    plain_ms = cuda_ms(torch, lambda: du.diffusion_update_reference(T, Cp, *coeffs), reps=5)
    bound_ms, bound_by = bound(nbytes(T, Cp, T), 17 * (n - 2) ** 3)
    print(f"phase 20: diffusion_update {n}^3 f32: {ms!r} ms/launch, bound {bound_ms!r} ms "
          f"({bound_by}, {100 * bound_ms / ms:.2f}%); plain version {plain_ms!r} ms; "
          f"max|kernel-plain| = {err!r} {card}")
    return {
        "name": "diffusion_update", "route": "cuda",
        "source": "implicitglobalgrid_tpu_torch/csrc/diffusion_update.cu",
        "replaces": "XLA's fusion of implicitglobalgrid_tpu/models/diffusion3d.py "
                    "_diffusion_update (no Pallas kernel)",
        "launches": c["diffusion_update"], "max_abs_err": max(err, main_err), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "ptxas": regs,
    }


def phase21(torch, igg, reset_counts, counts, card, n=512, nsteps=24, k=6) -> dict:
    """Phase 21: the leapfrog kernel on the acoustic cell's own path at n^3
    float32 (see the module docstring); returns its record there."""
    from implicitglobalgrid_tpu_torch.models import acoustic3d
    from implicitglobalgrid_tpu_torch.ops import fused_leapfrog as fl

    f32 = torch.float32
    shape = (n, n, n)
    tile = fl.tile_for(shape, k, 4)
    blocks = fl.resident_blocks("fused_leapfrog", shape, k, 4)
    print(f"phase 21: fused_leapfrog_steps {n}^3 f32 k={k}: tile (bx, by, bz) = {tile}, grid "
          f"{fl.grid(shape, tile)}, {fl.window_bytes(shape, k, tile, 4)} B shared memory per "
          f"block, {blocks} resident blocks per SM "
          f"({torch.cuda.get_device_properties(0).multi_processor_count} SMs) {card}")
    if blocks < 1:
        fail(f"phase 21: no block of fused_leapfrog fits an SM at {n}^3 k={k} tile {tile}")

    ov = dict(overlapx=12, overlapy=12, overlapz=12)
    state, params = acoustic3d.setup(n, n, n, periodz=1, dtype=f32, quiet=True, **ov)
    gen = torch.Generator(device=state[0].device).manual_seed(21)
    state = tuple(a + s * torch.randn(a.shape, generator=gen, device=a.device, dtype=f32)
                  for a, s in zip(state, (1.0, 0.1, 0.1, 0.1)))
    step = acoustic3d.make_multi_step(params, nsteps, fused_k=k, autotune=False)
    plain = acoustic3d.make_multi_step(params, nsteps, exchange_every=k, autotune=False)
    step(*state)  # warm-up (allocator)
    torch.cuda.synchronize()
    reset_counts()
    got = step(*state)
    torch.cuda.synchronize()
    c = counts()
    if c != {**{name: 0 for name in c}, "fused_leapfrog_steps": nsteps // k}:
        fail(f"phase 21: make_multi_step(params, {nsteps}, fused_k={k}) launched {c}, expected "
             f"{nsteps // k} fused_leapfrog_steps and no other kernel")
    want = plain(*state)
    torch.cuda.synchronize()
    for name, g, w in zip(("P", "Vx", "Vy", "Vz"), got, want):
        if not torch.isfinite(g).all():
            fail(f"phase 21: the acoustic main path produced non-finite {name}")
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5, msg=lambda m: f"{name}: {m}")
    main_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    del got, want
    step_ms = cuda_ms(torch, lambda: step(*state), reps=3) / nsteps
    print(f"phase 21: acoustic {n}^3 f32 periodic z overlap 12, noisy fields, make_multi_step("
          f"params, {nsteps}, fused_k={k}): launches {c}; max|fused-plain cadence| = "
          f"{main_err!r} (rtol=atol=2e-5); {step_ms!r} ms/step {card}")

    h = (params.dx, params.dy, params.dz)
    co = (*(params.dt / params.rho / d for d in h), params.dt * params.K, *(1.0 / d for d in h))
    out = fl.fused_leapfrog_steps(*state, k, *co)
    ref = fl.fused_leapfrog_steps_reference(*state, k, *co)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    checks = {"faces bit-exact": all(ring_equal(torch, o, a) for o, a in zip(out[1:], state[1:])),
              "P moved on the boundary": boundary_moved(torch, out[0], state[0])}
    if err != 0.0 or not all(checks.values()):
        fail(f"phase 21: fused_leapfrog_steps at {n}^3 disagrees with its plain version: "
             f"{err!r}, {checks}")
    del out, ref
    ms = cuda_ms(torch, lambda: fl.fused_leapfrog_steps(*state, k, *co), reps=10)
    plain_ms = cuda_ms(torch, lambda: fl.fused_leapfrog_steps_reference(*state, k, *co), reps=2,
                       warmup=1)
    bound_ms, bound_by = bound(2 * nbytes(*state),
                               k * n**3 * FLOPS_PER_CELL_STEP["fused_leapfrog_steps"])
    print(f"phase 21: fused_leapfrog_steps {n}^3 f32 k={k}: {ms!r} ms/launch, bound {bound_ms!r} "
          f"ms ({bound_by}, {100 * bound_ms / ms:.2f}%); plain version {plain_ms!r} ms; "
          f"max|kernel-plain| = {err!r} (tolerance 0: bit-exact), {checks} {card}")
    igg.finalize_global_grid()
    src, tpu = KERNELS["fused_leapfrog_steps"]
    return {
        "name": "fused_leapfrog_steps", "block": list(shape), "route": "cuda",
        "source": f"implicitglobalgrid_tpu_torch/csrc/{src}.cu", "replaces": tpu,
        "launches": c["fused_leapfrog_steps"], "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }


def phase22(torch, igg, reset_counts, counts, card, n=256, nsteps=8, k=6) -> dict:
    """Phase 22: the porous temperature update's kernel on the porous cell's
    own path at n^3 float32 (see the module docstring); returns its record."""
    from implicitglobalgrid_tpu_torch.analysis import ptxas
    from implicitglobalgrid_tpu_torch.models import porous_convection3d
    from implicitglobalgrid_tpu_torch.ops import _kernels
    from implicitglobalgrid_tpu_torch.ops import temperature_update as tu

    _kernels.build("temperature_update")
    regs = ptxas.parse_report(_kernels.build_log("temperature_update") or "")
    if not regs:
        fail("phase 22: no -Xptxas -v report of temperature_update.cu")
    for entry, m in regs.items():
        print(f"phase 22: temperature_update.cu {entry}: {m['registers']} registers, spills "
              f"{m['spill_stores']} B stored / {m['spill_loads']} B loaded, "
              f"{m['smem_bytes']} B static shared memory")
    f32 = torch.float32

    # The porous cell's main path: 2 PT chunks and one T update a step.
    ov = dict(overlapx=14, overlapy=14, overlapz=14)
    state, params = porous_convection3d.setup(n, n, n, npt=12, periody=1, dtype=f32,
                                              quiet=True, **ov)
    gen = torch.Generator(device=state[0].device).manual_seed(22)
    state = (state[0] + 0.01 * torch.randn(state[0].shape, generator=gen,
                                           device=state[0].device, dtype=f32), *state[1:])
    step = porous_convection3d.make_multi_step(params, nsteps, fused_k=k, autotune=False)
    built = porous_convection3d._temperature_update
    coeffs = (params.lam_T, 1.0 / params.phi, params.dt, params.dx, params.dy, params.dz)
    porous_convection3d._temperature_update = lambda p: lambda *f: (
        tu.temperature_update_reference(*f, *coeffs))
    try:
        plain = porous_convection3d.make_multi_step(params, nsteps, fused_k=k, autotune=False)
    finally:
        porous_convection3d._temperature_update = built
    step(*state)  # warm-up (allocator)
    torch.cuda.synchronize()
    reset_counts()
    tu.launches = 0
    got = step(*state)
    torch.cuda.synchronize()
    c, launched = counts(), tu.launches
    if (c != {**{name: 0 for name in c}, "fused_pt_iterations": 2 * nsteps}
            or launched != nsteps):
        fail(f"phase 22: make_multi_step(params, {nsteps}, fused_k={k}) launched {c} and "
             f"{launched} temperature_update, expected {2 * nsteps} fused_pt_iterations and "
             f"{nsteps} temperature_update")
    want = plain(*state)
    torch.cuda.synchronize()
    main_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        fail(f"phase 22: the porous cadence differs from it built on the plain T update: "
             f"{main_err!r}")
    del want
    step_ms = cuda_ms(torch, lambda: step(*state), reps=5) / nsteps
    plain_step_ms = cuda_ms(torch, lambda: plain(*state), reps=3, warmup=1) / nsteps
    print(f"phase 22: porous {n}^3 f32 npt=12 periodic y overlap 14, make_multi_step(params, "
          f"{nsteps}, fused_k={k}): launches {c}, temperature_update {launched}; bit-exact with "
          f"the cadence on temperature_update_reference; {step_ms!r} ms/step (the plain T "
          f"update's cadence {plain_step_ms!r} ms/step) {card}")
    igg.finalize_global_grid()

    # One launch on the step's fields, with the model's coefficients.
    T, _, qDx, qDy, qDz = got
    del got, state
    err = float((tu.temperature_update(T, qDx, qDy, qDz, *coeffs)
                 - tu.temperature_update_reference(T, qDx, qDy, qDz, *coeffs)).abs().max())
    if err != 0.0:
        fail(f"phase 22: temperature_update differs from its plain version: {err!r}")
    ms = cuda_ms(torch, lambda: tu.temperature_update(T, qDx, qDy, qDz, *coeffs), reps=50)
    plain_ms = cuda_ms(torch, lambda: tu.temperature_update_reference(T, qDx, qDy, qDz, *coeffs),
                       reps=5)
    bound_ms, bound_by = bound(nbytes(T, qDx, qDy, qDz, T), 50 * n**3)
    print(f"phase 22: temperature_update {n}^3 f32: {ms!r} ms/launch, bound {bound_ms!r} ms "
          f"({bound_by}, {100 * bound_ms / ms:.2f}%); plain version {plain_ms!r} ms; "
          f"max|kernel-plain| = {err!r}; vector width {tu.vector_width(T, qDx, qDy)} {card}")
    return {
        "name": "temperature_update", "block": [n] * 3, "route": "cuda",
        "source": "implicitglobalgrid_tpu_torch/csrc/temperature_update.cu",
        "replaces": "XLA's fusion of implicitglobalgrid_tpu/models/porous_convection3d.py "
                    "_temperature_update (no Pallas kernel)",
        "launches": launched, "max_abs_err": max(err, main_err), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "ptxas": regs,
    }


if __name__ == "__main__":
    main()
