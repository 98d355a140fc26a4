"""Smoke run of the PyTorch port on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It uses ``vae_mdl_tpu_torch``, torch and numpy only, and fails (exit code
not 0, no result line) on the first phase that fails; there is no CPU path
and nothing falls back to a plain version.

1. device: prints ``nvidia-smi``'s name and power limit; needs CUDA and a
   card whose published peaks ``utils/flops.py`` knows;
2. build: compiles the four sources under ``vae_mdl_tpu_torch/csrc/``
   (``mdl_log_prob.cu``, ``dl_log_prob.cu``, ``sfu_probe.cu``,
   ``io_probe.cu``) with nvcc, all at once, and prints ptxas's registers and
   spills of the kernels the paths launch; then reads off the strides in
   which layout model05's and model03's heads hand their output to the
   likelihood kernels (that layout's case goes into the kernels line);
3. the special-function probe kernel (K6) against its plain version at a
   depth of 2 and 3 iterations, inputs in [0.5, 1.5], for the five ops, the
   cascade and the re-ranging alone, with and without re-ranging, at every
   shape the roofline launches it at (2560 blocks x 256 threads x 1, 2, 4, 8
   and 16 chains; 20480 blocks x 8 chains); then the first part of this
   slice's main path, ``probes.roofline`` on model05, batch 128, k = 5, f32,
   through ``utils/timing.py``, with all launch counts set to 0 just before
   it and read just after (rates at the kernel geometry and at the larger
   grid, the sweep over chains, the additive-model check on the cascade, the
   floors of the MoDL forward at k = 5 and k = 100 and of forward + backward
   at k = 5, the mixture's cost in the step, the kernels' share of their
   floor): its SM clock under load and per-op rates price every later bound
   and attainable time, and the MUFU instructions per evaluation in the SASS
   are held against what the bound charges;
4. the MoDL forward kernel against its plain PyTorch version on the card, at
   the four forward contracts of the TPU kernels it replaces (f32 and bf16
   parameters at k = 5 and k = 100 samples of a batch of 128), each in the
   NHWC-contiguous layout (what the model's head hands on: its convs run
   channels-last), where it takes the tile path, and the NCHW layout, where
   it takes the direct path, with kernel and plain times from CUDA events;
   on NHWC the direct path forced on the same operands, held to the tile
   path bit for bit and timed in turns with it (CUDA events, and device
   time from a CUDA graph of the launches); both paths on the device in
   turns on model05's own head output at initialisation (f32 and bf16, k = 5
   and 100), which takes almost no branch divergence where the contract
   inputs take much; then a ragged case (k = 3, B = 7, 31 x 31) on the tile
   path and a misaligned view, which takes the direct path, gives the same
   bits and is refused on the tile path;
5. the MoDL backward kernel at the three backward contracts (f32 and bf16 at
   k = 5, bf16 at k = 100; batch 128) on both memory paths: the tile path on
   NHWC (what ``backward_path`` picks there), the direct path on NCHW, and
   the direct path forced on NHWC (the same fused body through the
   strides), the other side of the A/B: each against the analytic plain version
   element by element, the two NHWC results against each other bit for bit,
   and the path taken against autograd of the plain forward by the
   float64-accuracy rule; CUDA-event times of the backward alone, on NHWC
   taken in turns (direct, tiled, tiled, direct), with the blocks an SM
   holds of the tile path, and of forward + backward (through the kernels vs
   autograd of the plain version); then, on either
   dtype, a ragged case (k = 3, B = 7, 31 x 31: 20,181 pixels, no multiple of
   the 128-pixel tile), a view one element off a 16-byte boundary (must take
   the direct path and agree, and be refused on the tile path) and a
   cotangent expanded with zero strides on the tile path;
6. the discretized-logistic (DL) forward kernel against its plain version at
   the model's train shape (k = 5, batch 128, 32x32x3) and eval-chunk shape
   (k = 100), x broadcast over k, for contiguous operands and for the two
   channel halves of a head tensor in NCHW memory (both on the direct path)
   and in channels-last memory (the model's: the tile path), every branch
   hit; on the channels-last halves the direct path forced on the same
   operands, held to the tile path bit for bit and timed in turns with it
   (CUDA events, and device time from a CUDA graph); the DL backward kernel
   at k = 5 the same way, against its analytic plain version element by
   element and against float64 autograd by the accuracy rule, with the times
   of the backward alone and of forward + backward through the kernels (the
   head tensor as the leaf, through ``dl_log_prob_head``: on the tile path
   the two DL kernels and nothing else on the device) against autograd of
   the plain version; then model03's own head output at initialisation (k =
   5 and 100): both paths on the device in turns and the bound on this
   data; and a ragged case (k
   = 3, B = 7, 31 x 31) on the tile path and a misaligned copy of the head,
   which takes the direct path, gives the same bits and is refused on the
   tile path;
7. the memory-path probes at full size: the channel sum (P1, P2) of a
   ``[100, 102400, 50]`` and a ``[100, 50, 102400]`` float32 tensor (2.05 GB
   each) through the direct and the staged path against ``sum`` (tolerance
   stated at ``SUM_ATOL``; timed in phase 10c), every kernel equal bit for
   bit to the strided kernel: P1 staged on the read walk of
   ``csrc/mdl_tile.cuh``, P2 on its vec4 kernel (timed in turns with the
   strided one); P1 staged refuses a sliced, a misaligned and a 300-channel
   view before any launch; and the null-body MoDL kernels (P3), forward and backward, direct
   (``dma``) and staged, at the model05 train shape (k = 5) and eval-chunk
   shape (k = 100), f32 and bf16, both layouts, against their plain
   versions (the sums within tolerance and the staged forward equal to the
   dma one bit for bit, ``0.5 p + g`` exactly); the staged pair takes the
   MoDL kernels' tile paths on NHWC and their direct paths on NCHW, and each
   direction's two variants are timed in turns (dma, staged, staged, dma;
   the forward also on the device); the ragged and the misaligned case as
   in phase 5, forward and backward;
8. model05 and model03, float32 config, batch 128, k = 5: the IWAE bound
   through the kernel (``use_pallas=None``) and through the plain version
   (``use_pallas=False``) on the same weights and noise;
9. one train step's loss and every gradient leaf through the kernels and
   through the plain version, from one state, batch and noise: model05,
   model03, model04 (GLU stacks) and model06 (two stochastic layers); a
   train step of model01 (MLP, Bernoulli) and model02 (Gaussian head) with a
   finite, falling loss, model01's rate through the timing harness at 100
   steps per call, and model01's 200-IS evaluation, whose Bernoulli sees one
   binarisation of the batch, equal per image to the evaluator fed that
   draw's binary batch;
10. the main paths, each with all launch counts set to 0 just before it and
   read just after: (a) the 5000-importance-sample ``evaluate_llh`` on one
   batch of 128 images (k-chunks of 100) of model05 and of model03, in the
   float32 config and the bfloat16 config, timed with CUDA events, and a
   200-sample evaluation through the kernel and the plain version agreeing
   per image; (b) training of model05 and of model03 at batch 128, k = 5,
   through ``make_multi_train_step`` with 10 steps per call on seeded
   synthetic uint8 images, in both configs through the kernels and in
   float32 through the plain version: the median imgs/s of 5 timed calls
   after a warm-up, the peak memory, and a finite loss that falls; every
   MoDL forward of model05's evaluation and training and every MoDL
   backward of its training must have taken the tile path, and every DL
   forward and backward of model03's (whose DL head launches no MoDL
   kernel) the DL kernels' tile path; (c) the
   rest of the measurement path on model05, batch 128, k = 5, f32, through
   ``utils/timing.py``: ``probes.kernel_structure`` (the four-way step:
   the null kernels must launch in ``dma`` (both on the direct path) and
   ``staged`` (both on the tile path), the DL pair in ``dl_head`` (on its
   tile path), the MoDL pair in ``full`` (both on the tile path), and no
   other) and ``probes.kernel_isolate`` / ``kernel_isolate2`` (every
   channel-first launch on the vec4 kernel, every staged one on the read
   walk);
11. a ``torch.profiler`` breakdown of device time by kernel class over 5
   train steps of each config of model05 and model03, with each kernel's
   device time per launch;
12. the ladder families, ``ladder_svhn`` and ``biladder_svhn`` (float32) and
   ``biladder_celeba`` (its bf16 body), each at full width with seeded
   weights and seeded uint8 images of its shape: one train step's loss and
   every gradient leaf through the DL kernels against the plain version
   (rezero gates opened; phase 9's tolerances, but ``GRAD_RTOL_BF16`` for
   the gradients of biladder_celeba's bf16 body, which is also held to
   phase 9's with a float32 body); the main paths with
   every count set to 0 just before and read just after: the
   5000-importance-sample evaluation (k-chunks of 100, 128 images; 32 for
   biladder_celeba) timed with CUDA events, with a 200-sample evaluation
   through the kernel and the plain version agreeing per image, and training
   at batch 128, k = 5, 10 steps a call (median imgs/s of 5 calls, peak
   memory, a finite falling loss), every DL forward and backward on the
   tile path; the profile of phase 11; and the DL pair on each ladder's own
   head output at the train shape (forward and backward) and at the eval
   chunk's (forward), both paths in turns against the plain version and
   the bound;
13. the training run as users start it, model05 at full width (f32) on
   ``synthetic:svhn_cropped`` (batch 128, validation 500, so the whole
   256-image split), with every count set to 0 before (a) and read after
   (f), every MoDL launch on the tile path, under cuDNN's deterministic
   algorithms (set for this phase and put back after it): (a)
   ``Trainer(cfg).fit()`` to step 40, evaluating every 20 steps with EMA
   (0.999), report grids and a snapshot every 20 steps, one kept; (b) in a
   second directory a fit to 20 and a new ``Trainer`` resuming it to 40,
   its params, optimizer state and EMA bit-equal to (a); (c) 40 steps of
   ``make_train_step`` from the same initial weights over the pipeline's
   batches copied synchronously, bit-equal to (a) (``device_prefetch``'s
   stream ordering); ``make_multi_train_step``'s rate on the same model
   under the same flags; (d) ``latest``, ``best`` and the snapshot restored
   (``latest`` equal to (a)'s state, its best validation loss in it, one
   snapshot on disk), the ms of a save and of a restore; (e) ``report``'s
   three 256x256x3 grids, finite and in [0, 1]; (f) ``Trainer.test`` with
   the PSIS k-hat and the convergence curve over 5000 samples (the best
   checkpoint's EMA weights, the 256 test images), ``evaluate_llh`` on 128
   of them with and without the extras (the per-image llh bit-identical,
   the curve ending on the mean, every k-hat summary finite), and 20 more
   training steps from the live state, bit-equal to the resumed trainer
   of (b) doing the same. It prints one ``trainer:`` JSON line.
14. the CLI as users start it (``vae_mdl_tpu_torch.cli.run.main``), in a
   fresh temporary directory made the working directory (the CLI writes
   ``./assets/``; the repository's own ``assets/`` is never touched), under
   phase 13's cuDNN flags, every count set to 0 before (a) and read after
   (f), every MoDL and DL launch on the tile path: (a) ``train model05`` at
   batch 128 on ``synthetic:svhn_cropped``, 40 steps, EMA 0.999, the final
   5000-IS eval with k-hat and curve; its printed LLH equal to
   ``evaluate_llh`` on the best checkpoint's EMA weights, its ``latest``
   state equal to ``Trainer(cfg).fit()``'s, bit for bit; (b) ``eval`` of the
   same weights printing the same LLH, then the bf16 eval (bf16 body and
   head output: the MoDL kernel's bf16 instantiation on the tile path); (c)
   ``sample --n 64`` and ``export`` of the sampler, reconstructor and encoder
   at n = 64, each program loaded with ``load_exported`` and equal to the
   live function on the same draws (uint8 equal, floats within
   ``EXPORT_ATOL``), the live sampler and its program timed at n = 64 and
   1024, no likelihood launch; (d) ``train model03 --bf16`` (the DL pair)
   and ``train model01`` (the output-bias init, the Bernoulli head), 20
   steps each, the loss finite and falling; (e) ``describe model05 --json``:
   the live model's parameter count, the card's own peak; (f) ``parity
   model05 --allow-synthetic``: a strict JSON report with the JAX report's
   keys. It prints one ``cli:`` JSON line.
15. the parallel paths (``vae_mdl_tpu_torch/parallel/``), model05 at full
   width (f32, batch 128, k = 5), every MoDL launch on the tile path: (a) a
   world of one over NCCL (``init_distributed`` on a FileStore,
   ``make_mesh(MeshConfig())``): one step each of ``make_train_step``,
   ``make_shard_map_train_step`` and ``make_zero1_train_step`` from one
   state, batch and injected noise under phase 13's cuDNN flags, the loss,
   every parameter and both Adam moments (ZeRO-1's unflattened) within
   ``PARALLEL_RTOL``; then 10 steps a call of each (over NCCL CUDA graphs
   with their collectives, phase 19), in turns, with every count set to 0
   just before each call and read just after (the ``model05 dp`` and
   ``model05 zero1`` paths): median imgs/s of 5 calls,
   peak memory and the gap against the plain step's rate; and
   ``evaluate_llh(mesh=)`` at 5000 samples on 256 images, through
   ``make_batch_evaluator(mesh=)`` (``model05 sharded eval``); (b) two
   processes of this script (``--rank``) on the one card over gloo, which
   takes CUDA tensors where NCCL refuses two ranks a device (and runs the
   steps' eager bodies, by ``train.capture.captures``): the
   data-parallel and ZeRO-1 steps on 64 rows and the matching half of the
   noise each, held against (a)'s one-rank step on all 128 (the loss within
   ``SUM_RTOL``, the moments within ``GRAD_RTOL``, the parameters within
   ``TWO_RANK_PARAM_ATOL`` and ``TWO_RANK_PARAM_SHARE`` of them within
   ``TWO_RANK_PARAM_CLOSE``) and bit-equal across the ranks; one step of
   the tensor-parallel layout (``make_tp_mesh(1, ranks)``,
   ``shard_state_tp``: model05's wide convs and dense layer keep their
   share of the output channels, their outputs gathered over the ranks) on
   all 128 rows, held against the one-rank step the same way (its moments
   within ``TP_GRAD_RTOL``), its MoDL
   launches on the tile path (``model05 tp``); then ``evaluate_llh``
   striped over them (``model05 striped eval``), its per-image LLH
   bit-equal to (a)'s; where there are two cards or more the same checks at
   min(cards, 4) ranks over NCCL, one card each, and the data-parallel and
   ZeRO-1 rates with a batch of 128 on every rank; (c) ``Trainer(cfg,
   mesh=make_mesh(...))`` at a world of one (``model05 mesh trainer``) on
   ``synthetic:svhn_cropped``, 20 steps with EMA, the loss finite and
   falling, checkpointed, and a resumed ``Trainer`` whose state equals it
   bit for bit. It prints one ``parallel:`` JSON line.
16. sharded serving (``models/export.py`` ``mesh=``), model05 f32 at full
   width with phase 14's seeded glorot weights, every count set to 0
   before and read after (no likelihood kernel may launch: the programs
   hold aten operations and the functional all-gather only): (a) a world
   of one over NCCL (``make_mesh(MeshConfig())``): the sampler at n = 1024
   and the reconstructor and encoder at batch 128 exported single-device
   and sharded, each loaded with ``load_exported`` and run on the same seed
   (and seeded images) under phase 13's cuDNN flags, the sharded outputs
   bit-equal to the single-device ones; the two samplers timed in turns
   (CUDA events, median of ``SERVE_REPS`` calls), export and load seconds
   and MB a file; (b) two processes of this script (``--task export``,
   then fresh ones with ``--task serve``) on the one card over gloo: both
   ranks export, the fresh ranks load the files and run them, each rank's
   outputs against (a)'s single-device ones (floats within ``SERVE_TOL``,
   the sampler's uint8 images equal but for one level on at most
   ``SERVE_PIXEL_SHARE`` of the pixels) and bit-equal across the ranks;
   where there are two cards or more the same at min(cards, 4) ranks over
   NCCL, one card each (``move_to_device_pass`` takes rank 0's program to
   each rank's card). NCCL runs the programs' traced all-gather as it is;
   over gloo ``load_exported`` runs it as the eager collective, which takes
   CUDA tensors where the functional one crashes. It prints one
   ``export_mesh:`` JSON line. Phase 16
   alone, from the repository's root on the card's machine: ``python3 -c
   "import chip_smoke as c; smi = c.phase_device();
   c.phase_export_mesh(smi)"``.
17. the measurement entry points, at model05's (and the ladders') full
   width: (a) ``python -m vae_mdl_tpu_torch.bench`` in a fresh process at
   ``bench.py``'s settings, its last line printed on a line of its own, its
   keys exactly ``bench.KEYS`` and every number in it finite, and its
   launches (the ``launches:`` line of its progress; every MoDL and DL
   launch on the tile path, the probe kernel for the SFU floor) into the
   kernels line as the ``bench`` path; (b) the MoDL forward on model05's
   own head output at ``MEASURE_SHAPES``, the shapes the bench and the
   probes launch that phases 4 and 10 do not (the bench's eval ``[200,
   128]`` with the bf16 boundary, the k-chunk sweep's 50 and 250, the eval
   grid's, the k-hat probe's and kernel_bench's batches with the float32
   boundary), against the plain version over slices of the samples
   (``ATOL``, ``RTOL``), each on the tile path, timed beside its bound; (c)
   every probe of the measurement entry points (``probes/``: prod_attribution
   to kernel_bench) once, at full width with fewer repeats (and
   ``PROBE_SAMPLES`` samples where it evaluates: a cut in depth, the
   k-chunks keep their shapes; kernel_bench without its ``torch.compile``
   arm, a comparison its own run times), its output's structure and every
   attribution difference finite, the eval grid at ``GRID_POINTS``, each
   probe's launches counted from 0 into the kernels line as ``probe
   <name>``; (d) ``scripts.dump_assets`` on a checkpoint of 4 training
   steps, which writes the three grids. It prints one ``measurement:`` JSON
   line (the bench's line, the shapes' cases, each probe's numbers).
18. the compiled train step (``train/capture.py``), under cuDNN's
   deterministic flags (set for the phase and put back): on the card every
   step factory returns a CUDA graph of the step or of its whole window, so
   every training path above (phases 9-17) already ran captured steps, and
   their kernels' launches were counted at each replay. Here (a) for each of
   ``CAPTURE_CASES`` (model05 f32 and bf16, model03 f32, model01, the
   device-data step, model05 with beta warm-up, skip, clip, EMA and
   gradient accumulation 2; batch 128 and full width), a captured window
   of ``CAPTURE_STEPS`` steps against as many eager steps from the same
   seed (single steps through the step's eager body; the device-data step's
   eager window): params, optimizer state, EMA, the step and the window's
   metrics bit for bit, where two eager runs repeat each other bit for bit
   (else within their own gap, printed with the config); (b) exact resume:
   5 captured steps, ``state_dict()``, a state of another model loaded, 5
   more through the same step and through one captured afresh, against 10
   straight, and the first state continued; (c) replays draw for the
   state's step: from one state, the replay at step s twice equal, at s + 1
   not, each bit-equal to the eager step there; (d) the main path: one
   replay of a captured window of model05 f32 and bf16 and of model03 f32
   under ``torch.profiler`` with every count set to 0 just before: the
   MoDL (model03: DL) forward and backward ``CAPTURE_STEPS`` times each
   inside the graph, all on the tile path, the host's calls that put work
   on the card fewer than the kernels of one step, and the wrappers'
   counts a replay equal to what the graph holds; (e) ``Trainer.fit`` on
   model05 f32 at 1 and 10 steps a call: one capture of each step, no
   guard warning, the windows' imgs/s; (f) the eager and the captured
   window in turns (eager, captured, captured, eager) for ``CAPTURE_AB``
   (model05 and model03 in f32 and bf16 at 10 steps a call, model01 at
   100): imgs/s (median, min, sd), device-busy ms, idle share, host launch
   calls and device kernels a step. It prints one ``capture:`` JSON line.
19. the mesh steps as one program (``parallel/spmd.py``, ``train/steps.py``
   with ``mesh=``, ``train/capture.py``), under phase 18's cuDNN flags: (a)
   at a world of one over NCCL (``"cpu:gloo,cuda:nccl"``), for each of
   ``MESH_CASES`` (model05 f32 and bf16 and model01 in a window of
   ``MESH_STEPS`` steps of ``make_multi_train_step(mesh=)``, the device-data
   window, ``make_shard_map_train_step``, ZeRO-1 in f32 and bf16, the
   tensor-parallel layout as single steps and as a window; batch 128 a rank,
   full width), the captured steps against as many eager steps of the
   one-step body from the same seed: params, optimizer state (ZeRO-1's flat
   slices), EMA, the step and the metrics bit for bit, where two eager runs
   repeat each other (else within their gap), one capture each; ZeRO-1's
   exact resume: 5 captured steps, ``state_dict()`` with the moments
   gathered whole and re-sharded (``reshard_zero1_opt_state``) into a state
   of another model, 5 more through the same step, against 10 straight; a
   traced call of the captured and the eager data-parallel window (f32,
   bf16), ZeRO-1 and the tensor-parallel window, with every count set to 0
   before: the MoDL pair ``MESH_STEPS`` times each inside the graph on the
   tile path, host launch calls, device and NCCL kernels a step; the eager
   and captured rates in turns (eager, captured, captured, eager) for
   ``MESH_AB``; (b) the same on min(cards, 4) ranks over NCCL, a card each
   (``--task mesh_capture``), where there are two cards or more, the ranks'
   parameters bit-equal across ranks and the slowest rank's rates; (c)
   ``graft_entry.dryrun_multichip(min(cards, 4))`` over NCCL. It prints one
   ``mesh capture:`` JSON line; its launches go into the kernels line as the
   ``mesh capture`` path. Phase 19 alone: ``python3 -c "import chip_smoke
   as c; smi = c.phase_device(); c.phase_build(); c.phase_mesh_capture(smi)"``.
20. the eval as one program (``evaluation/harness.py`` ``BatchEvaluator``:
   on the card a batch's whole evaluation, every k-chunk included, is one
   CUDA graph a model and key, so every evaluation above already ran
   captured), under cuDNN's deterministic flags with TF32 off: (a) for each
   of ``EVAL_CAPTURE_CASES`` (model05 f32 and bf16, model03 bf16, model01,
   ladder_svhn; full width, seeded uint8 images of the bench's eval batch,
   5000 samples, the ladder 500, k-chunks of 100, with the k-hat top set
   and the curve), the captured batch against the eager loop bit for bit
   (llh, top set, curve) with the caller's generator left at the same
   offset, at two seeds (the capturing call and two replays); the peak
   memory of the eager call and of the capturing call and
   what the graph's pool holds after it; the capture's seconds; imgs/s in
   turns (``EVAL_AB``: eager, captured, captured, eager); one traced batch
   of each (device-busy ms, idle share, host launch calls, device kernels);
   a second ``evaluate_llh`` that captures nothing; with every count set to
   0 before (a) and read after it, the MoDL forward on the tile path and
   the DL forward; (b) the EMA copy through ``params=`` and the model's own
   weights after a captured, an eager and a captured train step, captured
   equal to eager (model05 f32, 200 samples); (c) model05 with
   ``head_pad=64``: phase 10b's train step check and a 200-IS eval through
   the kernels against the plain version, every MoDL launch by memory path
   (the 50 of 64 channels are no dense tensor: the direct path); (d)
   ``PolyphaseConvTranspose``'s function against ``F.conv_transpose2d`` at
   model05's three decoder shapes, k = 5 and 100 at batch 128, f32 and bf16:
   the largest difference, forward and forward+backward ms of both in
   turns. ``make_batch_evaluator(mesh=)`` at ``sample = 2`` over NCCL needs
   two cards: at one it prints that it was not measured. It prints one
   ``eval capture:`` JSON line; its launches go into the kernels line as
   the ``eval capture`` path. Phase 20 alone: ``python3 -c "import
   chip_smoke as c; smi = c.phase_device(); c.phase_build();
   c.phase_eval_capture(smi)"``.

Each phase prints the seconds it took. The last three lines: the kernels'
JSON record, the card's name and power limit, and ``{"ok": true, "device":
{...}}``. In the record, ``launches``
counts the main paths' launches (``launches_by_path`` splits them), ``ms``
and ``plain_ms`` are CUDA-event times per call through the wrapper at the
shape named in ``shape``, ``bound_ms`` is the least time the card could take
for that call: the largest of its bytes, each input read and each output
written once, over 3.35 TB/s; its float32 operations, counted per cascade by
the branch this run's data takes, over 67 TFLOP/s; and, for the likelihood
kernels and the probe kernel, the special-function bound ("sfu"): the fewest
MUFU instructions the transcendental calls that the CUDA source makes on this
run's data need (``utils/flops.py`` ``MUFU_PER_CALL``) over the card's 16
results a clock and SM at the clock phase 3 measured under load.
``attainable_ms`` stands beside it and is no bound: the same calls priced at
the rates phase 3 measured for the accurate functions the kernels call,
which another instruction sequence could beat. ``library_ms`` is the
time of the one PyTorch call that computes the same function where there is
one (``sum`` for the channel sums, ``torch.add(g, p, alpha=0.5)`` for the
null backward), else null: no single PyTorch call computes a discretized
logistic's or a MoDL's log-prob or its gradient. The kernels with a tile
path carry ``path`` (the memory path of the timed case), ``ms_direct`` (the
direct path on the same operands, timed in turns with ``ms``) and
``blocks_per_sm`` (the tile path's blocks an SM, as the occupancy query
sizes its grid); the MoDL forward and the DL pair also ``device_ms`` and
``device_ms_direct`` (the two paths' device times) and the same on the
model's own head output (model05's at k = 100 for the MoDL forward,
model03's at k = 100 for the DL forward and k = 5 for its backward:
``model_head_device_ms``, ``model_head_device_ms_direct``, with the DL
pair's ``model_head_bound_ms``), the MoDL forward's ``measurement_shapes``
(phase 17's cases: ms, plain_ms, bound_ms a shape), and the DL pair's ``ladder_heads`` the
same on each ladder's head (phase 12, with ``plain_ms``); the DL and null
pairs' ``launches_by_memory_path`` splits their main-path launches by memory
path;
P2 carries ``ms_strided``, its strided kernel timed in turns with the vec4
one; P1 staged ``tile_pixels`` and ``blocks_per_sm``; the null forwards
``device_ms``, the staged one also ``device_ms_direct`` (its dma
variant's, in turns). The MoDL backward's
``max_abs_err`` is over its float32 contract; ``max_abs_err_bf16`` (one bf16
ulp of gradients of a few hundred) is over the bf16 ones, and
``tolerance_excess``, the largest |kernel - plain| less its per-element
tolerance over all cases, is at most 0. Weights are the port's own
glorot-uniform init from a seed; no checkpoint or dataset is read.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import glob
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from vae_mdl_tpu_torch.distributions.discretized import discretized_logistic_log_prob
from vae_mdl_tpu_torch.distributions.mixture import mixture_log_prob
from vae_mdl_tpu_torch.data.preprocess import binarize
from vae_mdl_tpu_torch.evaluation.harness import (
    _batch_seed,
    clear_cache,
    evaluate_llh,
    make_batch_evaluator,
)
from vae_mdl_tpu_torch.models.objective import compute_loss, training_loss_fn
from vae_mdl_tpu_torch.models.vae import build_model, latent_shapes, prior_for
from vae_mdl_tpu_torch.cli.run import main as cli_main
from vae_mdl_tpu_torch.config import DataConfig, TrainConfig
from vae_mdl_tpu_torch.config_io import load_config
from vae_mdl_tpu_torch.data.pipeline import iterators_from_splits, make_splits
from vae_mdl_tpu_torch.models.export import load_exported
from vae_mdl_tpu_torch.models.inference import make_encoder_fn, make_reconstructor, make_sampler
from vae_mdl_tpu_torch.models.zoo import MODELS, experiment
from vae_mdl_tpu_torch.ops.cuda import build, dl_kernel, io_probe, mdl_kernel, mdl_null, sfu_probe
from vae_mdl_tpu_torch.probes import kernel_isolate, kernel_isolate2, kernel_structure, roofline
from vae_mdl_tpu_torch.train.checkpoint import Checkpointer
from vae_mdl_tpu_torch.train.state import (
    create_train_state,
    eval_params,
    make_optimizer,
    tree_map,
)
from vae_mdl_tpu_torch.train.steps import (
    make_device_data_train_step,
    make_multi_train_step,
    make_train_step,
    reduce_scan_metrics,
)
from vae_mdl_tpu_torch.train.trainer import Trainer
from vae_mdl_tpu_torch.utils.flops import (
    branch_counts,
    cascade_transcendentals,
    device_peaks,
    MUFU_PER_CALL,
    mdl_cuda_sass_ex2,
    mdl_cuda_transcendentals,
    modl_branch_counts,
    mufu_instructions,
)
from vae_mdl_tpu_torch.utils.logging import MetricLogger
from vae_mdl_tpu_torch.utils.timing import (
    cuda_ms,
    device_times,
    graph_ms,
    in_turns,
    kernel_class,
    setup_scanned_step,
    time_scanned_step,
)

SEED = 0
BATCH = 128
N_MIX = 5
# Kernel vs plain version, per pixel: |kernel - plain| <= ATOL + RTOL * |plain|.
# Both evaluate the same float32 formula with the same libdevice functions
# and no fused multiply-adds; they differ in the order of the two
# logsumexps' sums, which moves an O(1) value by a few ulps (ATOL), and
# far-off locations give values up to ~1e4 nats whose float32 spacing is
# ~1e-3 (RTOL). The DL forward kernel has no sums and is held to the same.
ATOL, RTOL = 2e-4, 1e-5
# The bound and per-image log-likelihoods sum 3072 such per-pixel terms:
# relative tolerance on the sum.
SUM_RTOL = 1e-5
# Backward kernel vs its analytic plain version, per element:
# |kernel - plain| <= BWD_ATOL + BWD_RTOL[dtype] * |plain|. Same float32
# formula, same libdevice functions, no fused multiply-adds; the MoDL's two
# softmaxes sum in another order, which moves each gradient by a few float32
# ulps (RTOL f32) and d logits = g * (s - softmax(logits)), a difference of
# O(1) terms, by a few ulps of 1 (ATOL). A bf16 gradient rounds once more:
# one bf16 ulp is 2^-8 of the value (RTOL bf16). The DL backward kernel
# (float32 only) is held to the float32 pair.
BWD_ATOL = 2e-5
BWD_RTOL = {torch.float32: 2e-4, torch.bfloat16: 8e-3}
# Against autograd of the plain forward (different formulas, so no
# per-element bound): the kernel's RMS error against a float64 autograd
# truth is at most 1.2x that of float32 autograd rounded to the same dtype,
# elements at a clamp's tie (raw MoDL logscale exactly -7) left out: there
# the kernel passes 0 and autograd half the gradient.
F64_RATIO = 1.2
# One train step, kernel vs plain: the loss within SUM_RTOL, each parameter
# gradient within GRAD_RTOL of the plain one in norm. The analytic and the
# autograd likelihood gradients differ in float32 rounding, most where a CDF
# difference cancels; summed through the decoder's backward this measured
# 6.6e-5 on model05's decoder.Dense_0.weight (H100, cuDNN deterministic), the
# largest of all leaves; the bound is 3x that.
GRAD_RTOL = 2e-4
# The same in a bf16 body (biladder_celeba): the float32 head's gradients,
# equal to a few float32 ulps, round to bf16 on their way into the body's
# backward, and where the two straddle a rounding boundary they differ by one
# bf16 ulp, 2^-8 of the value, from there on; the tolerance is two of those
# (measured 5.0e-3 on enc_0.ResidualBlock_0.gate, a sum that cancels, and
# 1.1e-3 on stem.weight at batch 16; H100). The same model with a float32
# body is held to GRAD_RTOL.
GRAD_RTOL_BF16 = 8e-3
MODL_SOURCE = "vae_mdl_tpu_torch/csrc/mdl_log_prob.cu"
DL_SOURCE = "vae_mdl_tpu_torch/csrc/dl_log_prob.cu"
REPLACES = "vae_mdl_tpu/ops/pallas/mdl_kernel.py:227"
REPLACES_BACKWARD = "vae_mdl_tpu/ops/pallas/mdl_kernel.py:334"
# the DL backward replaces no Pallas kernel: the jnp vjp (_bwd) of this one
REPLACES_DL = "vae_mdl_tpu/ops/pallas/dl_kernel.py:61"
REPLACES_DL_BACKWARD_NOTE = "the jnp vjp _bwd at vae_mdl_tpu/ops/pallas/dl_kernel.py:96"
TRAIN_STEPS_PER_CALL = 10
TRAIN_BLOCKS = 5
# the ladder families, each in its own config (biladder_celeba's body bf16)
LADDERS = ("ladder_svhn", "biladder_svhn", "biladder_celeba")
# images a batch of the 5000-IS evaluation where it is not BATCH: one bf16
# activation of biladder_celeba's k-chunk of 100 is 1.7 GB at 32 images
EVAL_BATCH = {"biladder_celeba": 32}
# the model's discretized-logistic head: 256 levels on [0, 1]
DL_BIN = (0.0, 1.0, 1.0 / 255.0)

SFU_SOURCE = "vae_mdl_tpu_torch/csrc/sfu_probe.cu"
IO_SOURCE = "vae_mdl_tpu_torch/csrc/io_probe.cu"
REPLACES_K6 = "vae_mdl_tpu/ops/pallas/vpu_probe.py:57"
REPLACES_P1 = "scripts/kernel_isolate.py:31"
REPLACES_P2 = "scripts/kernel_isolate2.py:29"
REPLACES_P3 = "scripts/kernel_structure_probe.py:38"
# The probe kernel against its plain version: the same libdevice functions on
# the same float32 values with no fused multiply-adds, so they agree to the
# last bit on this card; the tolerance leaves room for a toolkit whose expf or
# logf differs from PyTorch's by an ulp, compounded over 3 iterations.
PROBE_RTOL, PROBE_ATOL = 1e-5, 1e-6
# A channel sum of 50 (or 53) standard-normal float32 values in another order
# than the library's: each partial sum is O(10) and rounds to 1e-6 of itself.
SUM_ATOL = 1e-4
# The card's published peaks (device memory, float32 outside the tensor
# cores): set by phase_device from utils/flops.py's table. The measured
# special-function rates and ceiling: set by roofline_path.
PEAKS: dict = {}
SFU: dict = {}
# Float32 operations of one cascade by the branch it takes, each add,
# multiply, compare and each exp, log, log1p or divide counted once (the
# cascade of csrc/dl_cascade.cuh read line by line); the backward's include
# the two multiplies by the cotangent.
DL_FWD_OPS = {"right": 14, "left": 14, "cdf": 19, "pdf": 31}
DL_BWD_OPS = {"right": 15, "left": 18, "cdf": 31, "pdf": 33}
# imgs/s of each model's training main path (phase 10b), by config; phase
# 13's Trainer window under "model05 trainer"
TRAIN_RATES: dict = {}


def say(line: str) -> None:
    print(line, flush=True)


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[1]


# -- the least time the card could take ------------------------------------------


def distinct_bytes(*tensors: torch.Tensor) -> int:
    """Bytes of the distinct elements the tensors address: a dimension
    expanded with stride 0 counts once."""
    total = 0
    for t in tensors:
        n = 1
        for size, stride in zip(t.shape, t.stride()):
            n *= size if stride else 1
        total += n * t.element_size()
    return total


def modl_ops(counts: dict, pixels: int, n_mix: int, backward: bool) -> int:
    """Float32 operations of a MoDL kernel call: the cascades by branch,
    and per pixel the rescaling of x (6), per mixture the clamps, tanh and
    autoregression (11), the weight's sums (4) and the two logsumexps
    (8 n + 4). The backward runs the forward's weights again, then each
    cascade's derivative and per mixture the softmax weights and the nine
    gradients' products (30)."""
    forward = sum(DL_FWD_OPS[b] * n for b, n in counts.items()) + pixels * (10 + 23 * n_mix)
    if not backward:
        return forward
    return forward + sum(DL_BWD_OPS[b] * n for b, n in counts.items()) + pixels * 30 * n_mix


def bound(n_bytes: int, n_ops: int = 0, calls: dict = None):
    """(bound_ms, bound_by, {"bytes", "operations", "sfu": ms}): the largest
    of bytes over the memory rate, operations over the float32 rate and, where
    the transcendental ``calls`` by op are given, the fewest MUFU instructions
    they need over the card's special-function results per second at the
    clock the roofline measured under load."""
    by = {"bytes": n_bytes / PEAKS["bytes_per_s"] * 1e3,
          "operations": n_ops / PEAKS["float32"] * 1e3}
    if calls is not None:
        by["sfu"] = mufu_instructions(calls) / SFU["peak"] * 1e3
    which = max(by, key=by.get)
    return by[which], which, by


def attainable(calls: dict) -> float:
    """Milliseconds the transcendental ``calls`` take at the rates the probe
    kernel measured for the accurate functions the kernels call: what these
    instruction sequences attain, beside the bound and not one itself."""
    return sfu_probe.sfu_floor_seconds({op: n for op, n in calls.items() if n},
                                       SFU["rates"]) * 1e3


def bounds_text(by: dict) -> str:
    return ", ".join(f"{which} {ms:.4f}" for which, ms in by.items())


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    say(f"device: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    say(f"nvidia-smi: {smi}")
    PEAKS.update(device_peaks())  # raises on a part whose peaks it does not know
    # the float32 config means float32 convolutions: cuDNN defaults to TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return smi


def phase_build() -> None:
    sources = [mdl_kernel.SOURCE, dl_kernel.SOURCE, sfu_probe.SOURCE, io_probe.SOURCE]
    fresh = [not build.library_path(source).exists() for source in sources]
    t0 = time.perf_counter()
    libs = build.build_all(sources)  # one nvcc per source, started together
    seconds = time.perf_counter() - t0
    for lib, new in zip(libs, fresh):
        say(f"build: {'compiled' if new else 'found'} {lib.name}")
    say(f"build: {seconds:.1f} s for the {len(sources)} sources")
    # the instantiations the paths launch: MoDL at n_mix = 5, the DL kernels'
    # direct path at four merged dimensions with 32-bit indices and their
    # tile path, the probe at the default chains, every kernel of io_probe.cu
    wanted = (("Li5E",), ("IjLi4E", "kernel_tiled"), (f"Li{sfu_probe.DEFAULT_CHAINS}EE",),
              ("",))
    for lib, family, want in zip(libs, ("MoDL n_mix=5", "DL", "probe", "io"), wanted):
        lines = lib.with_suffix(".log").read_text().splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and any(w in line for w in want):
                mangled = line.split("'")[1]
                if family in ("MoDL n_mix=5", "DL"):
                    entry = "backward" if "backward_kernel" in line else "forward"
                    entry += ", tile path" if "kernel_tiled" in line else ", direct path"
                    dtype = "" if family == "DL" else (" bf16" if "bfloat16" in line else " f32")
                    what = f"{family}{dtype} {entry}"
                else:  # the kernel's name and template arguments, unmangled by eye
                    what = f"{family} {re.search(r'_cu_[0-9a-f]{8}[0-9]+([A-Za-z_0-9]+)', mangled).group(1)[:48]}"
                used = [ln.split(":", 1)[-1].strip() for ln in lines[i + 1:i + 4]
                        if "Used" in ln or "spill" in ln]
                say(f"ptxas {what}: {'; '.join(used)}")


def phase_sfu_check() -> float:
    """K6 against its plain version at every shape the roofline launches it
    at: the kernel geometry with each number of chains a thread, and the
    larger grid with the default chains. -> max |kernel - plain|."""
    worst = 0.0
    shapes = [(sfu_probe.DEFAULT_BLOCKS, chains) for chains in sfu_probe.CHAINS]
    shapes.append((sfu_probe.CONTROL_BLOCKS, sfu_probe.DEFAULT_CHAINS))
    for blocks, chains in shapes:
        x = sfu_probe.probe_input(blocks, chains, "cuda")
        for op in ("none", *sfu_probe.OPS, "cascade"):
            for iters, (scale, shift) in ((2, (1.0, 0.0)), (3, (1.0, 0.0)),
                                          (3, sfu_probe.RERANGE[op])):
                got = sfu_probe.loop_probe(x, op, iters, chains, scale, shift)
                want = sfu_probe.loop_probe_plain(x, op, iters, scale, shift)
                # log(log(x)) is nan below 1 in both; nan must meet nan
                torch.testing.assert_close(got, want, rtol=PROBE_RTOL, atol=PROBE_ATOL,
                                           equal_nan=True)
                err = torch.where(torch.isfinite(want), (got - want).abs(), 0.0)
                worst = max(worst, float(err.max()))
        say(f"kernel K6 probe, {blocks} blocks x {sfu_probe.BLOCK_THREADS} threads x {chains} "
            f"chains: 7 ops x 3 depths agree with the plain version, max|d| so far "
            f"{worst:.3e} (rtol {PROBE_RTOL}, atol {PROBE_ATOL})")
    return worst


def roofline_path(smi: str) -> dict:
    """This slice's main path, first part: ``probes.roofline`` on model05,
    batch 128, k = 5, f32, with every count set to 0 just before it and read
    just after. Its clock, rates and MUFU counts price every later bound.
    -> the path's launch counts."""
    say(f"-- probes.roofline on {smi}")
    reset_probe_counts()
    roof = roofline.run(repeats=3, n_iters=3, n_repeats=4, say=say)
    counts = probe_counts()
    say(f"roofline main path: kernel launches {counts}")
    _only(counts, ("sfu_probe", "mdl_log_prob", "mdl_log_prob_backward", "dl_log_prob",
                   "dl_log_prob_backward"), "the roofline")
    _took(mdl_kernel.launches_by_path, "tiled", "the roofline's MoDL forward")
    _took(mdl_kernel.backward_launches_by_path, "tiled", "the roofline's MoDL backward")
    _took(dl_kernel.launches_by_path, "tiled", "the roofline's DL forward")
    _took(dl_kernel.backward_launches_by_path, "tiled", "the roofline's DL backward")
    counts.update({f"dl_log_prob {p}": n for p, n in dl_kernel.launches_by_path.items()})
    counts.update({f"dl_log_prob_backward {p}": n
                   for p, n in dl_kernel.backward_launches_by_path.items()})
    for value in (*roof["rates"].values(), roof["additive"]["measured"],
                  *(f["cuda"] for f in roof["floors"].values())):
        if not np.isfinite(value) or value <= 0:
            raise AssertionError(f"the roofline gave a rate or floor of {value}")
    if roof["sfu_peak"] is None:
        raise RuntimeError("nvidia-smi gave no SM clock")
    SFU.update(clock_mhz=roof["clock_mhz"], peak=roof["sfu_peak"], rates=roof["rates"])

    # the bound's MUFU per call against the SASS, which lists every path of a
    # function once and so can only show more
    for op, kinds in (roof["mufu_per_eval"] or {}).items():
        if op in MUFU_PER_CALL and sum(kinds.values()) < MUFU_PER_CALL[op]:
            raise AssertionError(f"the SASS of {op} holds {kinds} MUFU an evaluation, fewer "
                                 f"than the {MUFU_PER_CALL[op]} the bound charges")
    say(f"MUFU per evaluation in the probe's SASS, every path counted once: "
        f"{roof['mufu_per_eval']}; the bound charges {MUFU_PER_CALL}")
    modl = build.mufu_counts(build.library_path(mdl_kernel.SOURCE)) or {}
    for kernel, kinds in modl.items():
        if "Li5E" in kernel and "IfL" in kernel:  # float32, n_mix = 5
            backward = "backward_kernel" in kernel
            path = "tile" if "kernel_tiled" in kernel else "direct"
            entry = f"{'backward' if backward else 'forward'}, {path} path"
            counted = mdl_cuda_sass_ex2(N_MIX, backward)
            say(f"SASS MoDL f32 n_mix=5 {entry}: MUFU instructions {kinds} (every branch of "
                f"every cascade counted once); the census counts {counted} EX2")
            if kinds.get("EX2") != counted:
                raise AssertionError(f"the SASS of the MoDL {entry} holds {kinds.get('EX2')} "
                                     f"MUFU.EX2, the census of utils/flops.py {counted}")
    return counts


def k6_record(worst: float) -> dict:
    """The kernels-line record of the probe kernel: one launch of exp (one
    MUFU.EX2 an evaluation) at the kernel geometry and the deeper of the two
    timed depths, one of the shapes ``phase_sfu_check`` held."""
    x = sfu_probe.probe_input(sfu_probe.DEFAULT_BLOCKS, sfu_probe.DEFAULT_CHAINS, "cuda")
    iters, (scale, shift) = 2200, sfu_probe.RERANGE["exp"]
    ms = cuda_ms(lambda: sfu_probe.loop_probe(x, "exp", iters, scale=scale, shift=shift), 5)
    plain_ms = cuda_ms(lambda: sfu_probe.loop_probe_plain(x, "exp", iters, scale, shift), 1)
    by = {"bytes": 2 * x.numel() * 4 / PEAKS["bytes_per_s"] * 1e3,
          # exp, multiply, add per evaluation, a transcendental as one
          "operations": 3 * x.numel() * iters / PEAKS["float32"] * 1e3,
          "sfu": x.numel() * iters * MUFU_PER_CALL["exp"] / SFU["peak"] * 1e3}
    which = max(by, key=by.get)
    name = f"K6 exp x{iters}, {sfu_probe.DEFAULT_BLOCKS} blocks x 256 x {sfu_probe.DEFAULT_CHAINS}"
    say(f"kernel {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {by[which]:.4f} ms "
        f"({which}; {bounds_text(by)})")
    return dict(max_abs_err=worst, shape=name, ms=ms, plain_ms=plain_ms, bound_ms=by[which],
                bound_by=which,
                bound_note="special-function results at 16 a clock and SM, measured clock",
                bounds=by)


def _nchw(p: torch.Tensor) -> torch.Tensor:
    """``[k, B, H, W, C]`` with the strides of an NCHW conv output."""
    return p.permute(0, 1, 4, 2, 3).contiguous().permute(0, 1, 3, 4, 2)


def modl_inputs(k: int, dtype: torch.dtype, nchw: bool, gen: torch.Generator,
                batch: int = BATCH, side: int = 32):
    """x ``[B, side, side, 3]`` with 0 and 255 in it; MoDL parameters hitting
    every branch: logscales below the -7 clamp, far-off locations (the PDF *
    width approximation), edge bins."""
    dev = gen.device
    x = torch.randint(0, 256, (batch, side, side, 3), generator=gen, device=dev).float() / 255.0
    x[:, 0, :, :] = 0.0
    x[:, -1, :, :] = 1.0
    sub = (k, batch, side, side, N_MIX)

    def normal(mean, std):
        return torch.randn(sub, generator=gen, device=dev) * std + mean

    groups = [normal(0.0, 2.0)]  # mixture logits
    for _ in range(3):
        far = (torch.rand(sub, generator=gen, device=dev) < 0.2).float()
        low = torch.rand(sub, generator=gen, device=dev) < 0.1
        loc = normal(0.0, 0.5) + 4.0 * far
        logscale = torch.where(low, torch.full(sub, -9.0, device=dev), normal(-3.0, 1.0))
        groups += [loc, logscale, normal(0.0, 1.0)]
    p = torch.cat(groups, dim=-1).to(dtype)  # [k, B, H, W, 10n] contiguous
    if nchw:
        p = _nchw(p)
    return x, p


def phase_kernel_vs_plain():
    """-> (max |kernel - plain| over all cases, {case: record})."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst, cases = 0.0, {}
    for contract, k, dtype in (("K1f", 5, torch.float32), ("K2f", 5, torch.bfloat16),
                               ("K3f/K1f eval", 100, torch.float32),
                               ("K4f", 100, torch.bfloat16)):
        for nchw in (False, True):
            x, p = modl_inputs(k, dtype, nchw, gen)
            path = "direct" if nchw else "tiled"
            layout = "nchw" if nchw else "nhwc"
            name = f"{contract} {dtype_name(dtype)} k={k} B={BATCH} {layout}"
            if mdl_kernel.forward_path(p) != path:
                raise AssertionError(f"{name}: forward_path chose {mdl_kernel.forward_path(p)}")
            with torch.inference_mode():
                before = dict(mdl_kernel.launches_by_path)
                got = mdl_kernel.mdl_log_prob(x, p)
                if mdl_kernel.launches_by_path[path] != before[path] + 1:
                    raise AssertionError(f"{name}: the wrapper did not count a {path} launch")
                want = mixture_log_prob(x, p.float())
                torch.cuda.synchronize()
                if got.shape != want.shape or got.dtype != torch.float32:
                    raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
                if not torch.isfinite(got).all():
                    raise AssertionError(f"{name}: non-finite kernel output")
                err = (got - want).abs()
                excess = float((err - (ATOL + RTOL * want.abs())).max())
                max_err = float(err.max())
                more, ab = {}, ""
                if nchw:
                    ms = cuda_ms(lambda: mdl_kernel.mdl_log_prob(x, p), 20)
                else:  # the direct path on the same operands, in turns
                    equal = bool(torch.equal(got, mdl_kernel.mdl_log_prob(x, p, path="direct")))
                    fns = {"tiled": lambda: mdl_kernel.mdl_log_prob(x, p),
                           "direct": lambda: mdl_kernel.mdl_log_prob(x, p, path="direct")}
                    turns = in_turns(fns, ("direct", "tiled", "tiled", "direct"), 20)
                    # under 0.15 ms an event time is mostly the wrapper's host
                    # time: the device's, from a CUDA graph of the launches
                    device = in_turns(fns, ("direct", "tiled", "tiled", "direct"), 20, graph_ms)
                    ms = turns["tiled"]
                    blocks = mdl_kernel.tile_blocks_per_sm(dtype, N_MIX, forward=True)
                    more = dict(ms_direct=turns["direct"], bit_equal_to_direct=equal,
                                blocks_per_sm=blocks, device_ms=device["tiled"],
                                device_ms_direct=device["direct"])
                    ab = (f" at {blocks} blocks an SM (direct path on the same operands, in "
                          f"turns: {turns['direct']:.4f} ms; on the device {device['tiled']:.4f} "
                          f"ms, direct {device['direct']:.4f}; the two paths bit-equal: {equal})")
                    if not equal:
                        raise AssertionError(f"{name}: the tile path's bits differ from the "
                                             f"direct path's")
                plain_ms = cuda_ms(lambda: mixture_log_prob(x, p.float()), 5)
            counts = modl_branch_counts(x, p)
            calls = mdl_cuda_transcendentals(counts, got.numel(), N_MIX)
            bound_ms, bound_by, by = bound(
                distinct_bytes(x, p, got), modl_ops(counts, got.numel(), N_MIX, backward=False),
                calls)
            say(f"kernel {name}, {path} path: max|d|={max_err:.3e} (tolerance excess "
                f"{excess:.3e}), kernel {ms:.4f} ms{ab}, plain {plain_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by}; {bounds_text(by)}); attainable at the "
                f"measured rates {attainable(calls):.4f} ms")
            if excess > 0:
                raise AssertionError(f"{name}: kernel and plain version differ beyond tolerance")
            worst = max(worst, max_err)
            cases[name] = dict(shape=name, path=path, ms=ms, plain_ms=plain_ms,
                               bound_ms=bound_ms, bound_by=bound_by, bounds=by,
                               attainable_ms=attainable(calls), **more)
            del x, p, got, want, err
    torch.cuda.empty_cache()

    # the model's own head output at initialisation (the eval's data, almost
    # no branch divergence): both paths on the device, in turns
    batch = torch.as_tensor(images(BATCH), device="cuda")
    for which, cfg in configs_of("model05", plain=False).items():
        for k in (5, 100):
            x, p = roofline.head_parameters(experiment("model05", model=cfg), batch, k)
            with torch.inference_mode():
                device = in_turns({"tiled": lambda: mdl_kernel.mdl_log_prob(x, p),
                                   "direct": lambda: mdl_kernel.mdl_log_prob(x, p, path="direct")},
                                  ("direct", "tiled", "tiled", "direct"), 20 if k == 5 else 5,
                                  graph_ms)
            say(f"model05 head {which} k={k} {dtype_name(p.dtype)} ({mdl_kernel.forward_path(p)} "
                f"path), forward on the device in turns: {device['tiled']:.4f} ms, direct path "
                f"{device['direct']:.4f}")
            cases[f"model05 head {which} k={k}"] = dict(device_ms=device["tiled"],
                                                        device_ms_direct=device["direct"])
            del x, p

    # off the contracts' shapes: a ragged last tile and a misaligned view (k = 3, B = 7)
    for dtype in (torch.float32, torch.bfloat16):
        tag = f"{dtype_name(dtype)} k=3 B=7"
        x, p = modl_inputs(3, dtype, False, gen, batch=7, side=31)
        if p.shape[:4].numel() % mdl_kernel.TILE_PIXELS == 0:
            raise AssertionError("the pixels are whole tiles: no ragged case")
        got = mdl_kernel.mdl_log_prob(x, p)
        want = mixture_log_prob(x, p.float())
        excess = float(((got - want).abs() - (ATOL + RTOL * want.abs())).max())
        equal = bool(torch.equal(got, mdl_kernel.mdl_log_prob(x, p, path="direct")))
        off = misaligned_copy(p)
        refused = refuses(lambda: mdl_kernel.mdl_log_prob(x, off, path="tiled"))
        off_equal = bool(torch.equal(got, mdl_kernel.mdl_log_prob(x, off)))
        say(f"kernel ragged {tag} 31x31 ({p.shape[:4].numel()} pixels), tile path: tolerance "
            f"excess {excess:.3e}; equal to the direct path bit for bit: {equal}; a misaligned "
            f"copy takes the direct path ({mdl_kernel.forward_path(off)}), gives the same bits "
            f"({off_equal}) and is refused on the tile path ({refused})")
        if excess > 0 or not (equal and off_equal and refused):
            raise AssertionError(f"ragged or misaligned {tag}: the forward's paths disagree")
        del x, p, got, want, off
    return worst, cases


def _autograd_grad(x, p, g, dtype):
    """Autograd of the plain forward: d(sum g * mixture_log_prob(x, p))/dp,
    all in ``dtype``."""
    leaf = p.detach().to(dtype).requires_grad_(True)
    (grad,) = torch.autograd.grad(mixture_log_prob(x.to(dtype), leaf), leaf, g.to(dtype))
    return grad


def _at_ties(p):
    """Parameters at a clamp's tie: raw logscales of exactly -7."""
    n = p.shape[-1] // 10
    tie = torch.zeros(p.shape, dtype=torch.bool, device=p.device)
    for lo in (2 * n, 5 * n, 8 * n):
        tie[..., lo:lo + n] = p[..., lo:lo + n].float() == -7.0
    return tie


def misaligned_copy(p: torch.Tensor) -> torch.Tensor:
    """A dense copy of ``p`` that starts one element past a 16-byte boundary."""
    flat = torch.empty(p.numel() + 16, device=p.device, dtype=p.dtype)
    lead = (-flat.data_ptr() % 16) // flat.element_size() + 1
    view = flat[lead:lead + p.numel()].view(p.shape)
    view.copy_(p)
    return view


def backward_excess(name: str, got, want, p) -> tuple:
    """(max |kernel - plain|, the largest excess over the per-element
    tolerance); fails on a gradient of another dtype, shape or layout, on a
    non-finite one and on an excess above 0."""
    if got.dtype != p.dtype or got.shape != p.shape or got.stride() != p.stride():
        raise AssertionError(f"{name}: gradient {got.dtype} {tuple(got.stride())}, "
                             f"parameters {p.dtype} {tuple(p.stride())}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite gradient")
    err = (got.float() - want.float()).abs()
    excess = float((err - (BWD_ATOL + BWD_RTOL[p.dtype] * want.float().abs())).max())
    if excess > 0:
        raise AssertionError(f"{name}: backward kernel and plain version differ beyond "
                             f"tolerance (excess {excess:.3e})")
    return float(err.max()), excess


def refuses(launch) -> bool:
    """Whether ``launch()`` raises the wrapper's error for a refused launch
    (here: the tile path asked for on operands that do not fit it)."""
    try:
        launch()
    except RuntimeError as err:
        return "CUDA error" in str(err)
    return False


def expect_path(name: str, p: torch.Tensor, want: str) -> None:
    got = mdl_kernel.backward_path(p, torch.empty_like(p))
    if got != want:
        raise AssertionError(f"{name}: backward_path chose {got}, not {want}")


def phase_backward():
    """-> ({dtype: max |kernel - plain|}, the largest excess over the
    per-element tolerance (at most 0), {case: record})."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    worst, worst_excess, cases = {}, -float("inf"), {}
    for contract, k, dtype in (("K1b/K3b", 5, torch.float32), ("K2b", 5, torch.bfloat16),
                               ("K4b", 100, torch.bfloat16)):
        for nchw in (False, True):
            layout = "nchw" if nchw else "nhwc"
            name = f"{contract} {dtype_name(dtype)} k={k} B={BATCH} {layout}"
            x, p = modl_inputs(k, dtype, nchw, gen)
            g = torch.randn((k, BATCH, 32, 32, 1), generator=gen, device="cuda")
            path = "direct" if nchw else "tiled"
            expect_path(name, p, path)
            before = dict(mdl_kernel.backward_launches_by_path)
            got = mdl_kernel.mdl_backward(x, p, g)
            if mdl_kernel.backward_launches_by_path[path] != before[path] + 1:
                raise AssertionError(f"{name}: the wrapper did not count a {path} launch")
            want = mdl_kernel.mdl_backward_plain(x, p, g)
            torch.cuda.synchronize()
            max_err, excess = backward_excess(name, got, want, p)
            equal = None
            if not nchw:  # the direct path on the same operands
                direct = mdl_kernel.mdl_backward(x, p, g, path="direct")
                torch.cuda.synchronize()
                direct_err, direct_excess = backward_excess(f"{name}, direct path forced",
                                                            direct, want, p)
                max_err, excess = max(max_err, direct_err), max(excess, direct_excess)
                equal = bool(torch.equal(got, direct))
                del direct
            del want

            # the float64-accuracy rule, on at most 10 samples of k
            ks = slice(0, min(k, 10))
            truth = _autograd_grad(x, p[ks], g[ks], torch.float64)
            ref = _autograd_grad(x, p[ks], g[ks], torch.float32).to(dtype)
            keep = ~_at_ties(p[ks])

            def rms(grad):
                return float(((grad.double() - truth)[keep] ** 2).mean().sqrt())

            rms_kernel, rms_ref = rms(got[ks]), rms(ref)
            del truth, ref

            def fwd_bwd_kernel():
                leaf = p.detach().requires_grad_(True)
                return torch.autograd.grad(mdl_kernel.mdl_log_prob(x, leaf), leaf, g)

            def fwd_bwd_plain():
                leaf = p.detach().requires_grad_(True)
                return torch.autograd.grad(mixture_log_prob(x, leaf.float()), leaf, g)

            reps = 3 if k > 5 else 10
            if nchw:
                ms, ms_direct = cuda_ms(lambda: mdl_kernel.mdl_backward(x, p, g), 20), None
            else:
                turns = in_turns({"tiled": lambda: mdl_kernel.mdl_backward(x, p, g),
                                  "direct": lambda: mdl_kernel.mdl_backward(x, p, g, path="direct")},
                                 ("direct", "tiled", "tiled", "direct"), 20)
                ms, ms_direct = turns["tiled"], turns["direct"]
                blocks = mdl_kernel.tile_blocks_per_sm(dtype, N_MIX)
            plain_ms = cuda_ms(lambda: mdl_kernel.mdl_backward_plain(x, p, g), reps)
            fb_ms = cuda_ms(fwd_bwd_kernel, 20)
            fb_plain_ms = cuda_ms(fwd_bwd_plain, reps)
            counts = modl_branch_counts(x, p)
            calls = mdl_cuda_transcendentals(counts, g.numel(), N_MIX, backward=True)
            bound_ms, bound_by, by = bound(
                distinct_bytes(x, p, g, got), modl_ops(counts, g.numel(), N_MIX, backward=True),
                calls)
            ab = ("" if nchw else f" at {blocks} blocks an SM (direct path on the same "
                  f"operands, in turns: {ms_direct:.4f} ms; the two paths bit-equal: {equal})")
            say(f"backward {name}, {path} path: max|d|={max_err:.3e} (tolerance excess "
                f"{excess:.3e}); rms vs f64 kernel {rms_kernel:.3e} autograd {rms_ref:.3e} "
                f"({int((~keep).sum())} ties left out); backward kernel {ms:.4f} ms{ab}, "
                f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
                f"{bounds_text(by)}); attainable at the measured rates {attainable(calls):.4f} ms; "
                f"fwd+bwd kernels {fb_ms:.4f} ms, autograd of plain {fb_plain_ms:.4f} ms")
            if rms_kernel > F64_RATIO * rms_ref + 1e-9:
                raise AssertionError(f"{name}: backward kernel less accurate than autograd")
            key = dtype_name(dtype)
            worst[key] = max(worst.get(key, 0.0), max_err)
            worst_excess = max(worst_excess, excess)
            cases[name] = dict(shape=name, path=path, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by, bounds=by, attainable_ms=attainable(calls))
            if not nchw:
                cases[name].update(ms_direct=ms_direct, bit_equal_to_direct=equal,
                                   blocks_per_sm=blocks)
            del x, p, g, got
    torch.cuda.empty_cache()

    # off the contracts' shapes: a ragged last tile, a misaligned view, an
    # expanded cotangent (k = 3, B = 7)
    for dtype in (torch.float32, torch.bfloat16):
        tag = f"{dtype_name(dtype)} k=3 B=7"
        x, p = modl_inputs(3, dtype, False, gen, batch=7, side=31)
        g = torch.randn((3, 7, 31, 31, 1), generator=gen, device="cuda")
        wide = torch.randn((3, 7, 1, 1, 1), generator=gen, device="cuda").expand(3, 7, 31, 31, 1)
        pixels = g.numel()
        if pixels % mdl_kernel.TILE_PIXELS == 0:
            raise AssertionError(f"{pixels} pixels are whole tiles: no ragged case")
        expect_path(f"ragged {tag}", p, "tiled")
        for what, cot in (("ragged", g), ("expanded cotangent", wide)):
            got = mdl_kernel.mdl_backward(x, p, cot)
            want = mdl_kernel.mdl_backward_plain(x, p, cot)
            max_err, excess = backward_excess(f"{what} {tag}", got, want, p)
            equal = bool(torch.equal(got, mdl_kernel.mdl_backward(x, p, cot, path="direct")))
            say(f"backward {what} {tag} 31x31 ({pixels} pixels, strides of g {cot.stride()}), "
                f"tile path: max|d|={max_err:.3e} (tolerance excess {excess:.3e}); equal to "
                f"the direct path bit for bit: {equal}")
            worst_excess = max(worst_excess, excess)
        off = misaligned_copy(p)
        expect_path(f"misaligned {tag}", off, "direct")
        got = mdl_kernel.mdl_backward(x, off, g)
        want = mdl_kernel.mdl_backward_plain(x, off, g)
        max_err, excess = backward_excess(f"misaligned {tag}", got, want, off)
        refused = refuses(lambda: mdl_kernel.mdl_backward(x, off, g, path="tiled"))
        say(f"backward misaligned {tag} (address % 16 = {off.data_ptr() % 16}), direct path: "
            f"max|d|={max_err:.3e} (tolerance excess {excess:.3e}); the tile path refuses it: "
            f"{refused}")
        if not refused:
            raise AssertionError(f"misaligned {tag}: the tile path took operands that do not fit")
        worst_excess = max(worst_excess, excess)
        del x, p, g, wide, off, got, want
    torch.cuda.empty_cache()
    return worst, worst_excess, cases


DL_LAYOUTS = ("contiguous", "nchw halves", "nhwc halves")
# the memory path each layout's operands take: the halves of a channels-last
# head the tile path, everything else the direct one
DL_PATHS = {"contiguous": "direct", "nchw halves": "direct", "nhwc halves": "tiled"}
TURNS = ("direct", "tiled", "tiled", "direct")


def dl_inputs(k: int, layout: str, gen: torch.Generator, batch: int = BATCH, side: int = 32):
    """The DL head's operands at the model's shapes: x ``[B, 32, 32, 3]`` in
    [0, 1] with 0 and 1 in it, loc and logscale ``[k, B, 32, 32, 3]`` hitting
    every branch (logscales down to -9, far-off locations): contiguous, or
    the two channel halves of a head tensor ``[k * B, 6, 32, 32]`` in NCHW or
    in channels-last (NHWC) memory. -> (x, loc, logscale, the head as the
    decoder hands it on, ``[k, B, 32, 32, 6]``)."""
    dev = gen.device
    x = torch.randint(0, 256, (batch, side, side, 3), generator=gen, device=dev).float() / 255.0
    x[:, 0, :, :] = 0.0
    x[:, -1, :, :] = 1.0
    half = (k * batch, 3, side, side)
    far = (torch.rand(half, generator=gen, device=dev) < 0.2).float()
    low = torch.rand(half, generator=gen, device=dev) < 0.1
    loc = torch.randn(half, generator=gen, device=dev) * 0.25 + 0.5 + 2.0 * far
    logscale = torch.where(low, torch.full(half, -9.0, device=dev),
                           torch.randn(half, generator=gen, device=dev) - 3.0)
    head = torch.cat([loc, logscale], dim=1)  # NCHW
    if layout == "nhwc halves":  # as cuDNN writes it for a channels-last input
        head = head.contiguous(memory_format=torch.channels_last)
    del far, low, loc, logscale
    view = head_view(head, k)
    loc, logscale = torch.chunk(view, 2, dim=-1)
    if layout == "contiguous":
        loc, logscale = loc.contiguous(), logscale.contiguous()
    return x, loc, logscale, view


def head_view(head: torch.Tensor, k: int) -> torch.Tensor:
    """The head conv's output ``[k * B, 6, H, W]`` as the decoder hands it to
    the likelihood: an ``[k, B, H, W, 6]`` view."""
    n, c, h, w = head.shape
    return head.reshape(k, n // k, c, h, w).permute(0, 1, 3, 4, 2)


def model_head(name: str, k: int, batch: int = BATCH):
    """A DL model's own head output at initialisation (its config, seeded
    weights and noise) on one seeded batch: (x in [0, 1], the head ``[k, B,
    H, W, 6]`` as the decoder hands it on)."""
    cfg = MODELS[name]
    model = seeded_model(cfg)
    x = torch.as_tensor(images(batch, cfg.image_shape), device="cuda").float() / 255.0
    with torch.no_grad():
        dist = model(x, k, generator=torch.Generator("cuda").manual_seed(SEED))[2].dist
    if not dist._halves_of_head():
        raise AssertionError(f"{name}'s observation does not carry its head")
    return x, dist.head


def dl_fwd(x, loc, logscale, path=None):
    low, high, width = DL_BIN
    return dl_kernel.dl_log_prob(x, loc, logscale, low, high, width, path=path)


def dl_bwd(x, loc, logscale, g, path=None):
    low, high, width = DL_BIN
    return dl_kernel.dl_backward(x, loc, logscale, g, low, high, width, path=path)


def dl_plain(x, loc, logscale):
    low, high, width = DL_BIN
    return discretized_logistic_log_prob(x, loc, logscale, low=low, high=high,
                                         interval_width=width)


def dl_forward_bound(x, loc, logscale, out, counts):
    calls = cascade_transcendentals(counts)
    return bound(distinct_bytes(x, loc, logscale, out),
                 sum(DL_FWD_OPS[b] * n for b, n in counts.items()), calls) + (calls,)


def dl_backward_bound(x, loc, logscale, g, grads, counts):
    calls = cascade_transcendentals(counts, backward=True)
    return bound(distinct_bytes(x, loc, logscale, g, *grads),
                 sum(DL_BWD_OPS[b] * n for b, n in counts.items()), calls) + (calls,)


def head_cases(label: str, x, head, gen: torch.Generator, backward: bool, reps: int):
    """Both DL paths on a model's own head output, in turns (CUDA events, and
    the device's time from CUDA graphs), against the plain version and the
    bound on this data; the backward with the cotangent the sum over an
    image's axes gives. -> (forward case, backward case or None)."""
    low, high, width = DL_BIN
    k, batch = head.shape[:2]
    loc, logscale = torch.chunk(head, 2, dim=-1)
    if dl_kernel.forward_path(x, loc, logscale) != "tiled":
        raise AssertionError(f"{label}: not on the tile path")
    counts = branch_counts(x, loc, logscale, low, high, width)
    with torch.inference_mode():
        got = dl_fwd(x, loc, logscale)
        equal = bool(torch.equal(got, dl_fwd(x, loc, logscale, "direct")))
        fns = {"tiled": lambda: dl_fwd(x, loc, logscale),
               "direct": lambda: dl_fwd(x, loc, logscale, "direct")}
        turns = in_turns(fns, TURNS, reps)
        device = in_turns(fns, TURNS, reps, graph_ms)
        plain_ms = cuda_ms(lambda: dl_plain(x, loc, logscale), 5)
    bound_ms, bound_by, by, _ = dl_forward_bound(x, loc, logscale, got, counts)
    say(f"{label} forward (tiled path): "
        f"{turns['tiled']:.4f} ms, direct {turns['direct']:.4f} ms in turns; on the "
        f"device {device['tiled']:.4f} ms, direct {device['direct']:.4f}; plain "
        f"{plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}; {bounds_text(by)}), share "
        f"{bound_ms / device['tiled']:.1%}; bit-equal {equal}; branches {counts}")
    if not equal:
        raise AssertionError(f"{label}: the forward's paths differ")
    fwd = dict(shape=list(head.shape), ms=turns["tiled"], ms_direct=turns["direct"],
               device_ms=device["tiled"], device_ms_direct=device["direct"], plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by)
    del got
    if not backward:
        return fwd, None
    g = torch.randn((k, batch, 1, 1, 1), generator=gen, device="cuda").expand(loc.shape)
    d_got = dl_bwd(x, loc, logscale, g)
    equal = all(torch.equal(a, b) for a, b in zip(d_got, dl_bwd(x, loc, logscale, g, "direct")))
    fns = {"tiled": lambda: dl_bwd(x, loc, logscale, g),
           "direct": lambda: dl_bwd(x, loc, logscale, g, "direct")}
    turns = in_turns(fns, TURNS, reps)
    device = in_turns(fns, TURNS, reps, graph_ms)
    plain_ms = cuda_ms(
        lambda: dl_kernel.dl_backward_plain(x, loc, logscale, g, low, high, width), 5)
    bound_ms, bound_by, by, _ = dl_backward_bound(x, loc, logscale, g, d_got, counts)
    say(f"{label} backward (tiled path): {turns['tiled']:.4f} ms, direct "
        f"{turns['direct']:.4f} ms in turns; on the device {device['tiled']:.4f} ms, "
        f"direct {device['direct']:.4f}; plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms "
        f"({bound_by}; {bounds_text(by)}), share {bound_ms / device['tiled']:.1%}; "
        f"bit-equal {equal}")
    if not equal:
        raise AssertionError(f"{label}: the backward's paths differ")
    bwd = dict(shape=list(head.shape), ms=turns["tiled"], ms_direct=turns["direct"],
               device_ms=device["tiled"], device_ms_direct=device["direct"], plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by)
    return fwd, bwd


def phase_dl_kernels():
    """The DL kernels against their plain versions, the tile path against
    the direct one. -> (max |kernel - plain| forward, the same backward,
    {case: record} forward, the same backward)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    low, high, width = DL_BIN
    fwd_err = bwd_err = 0.0
    fwd_cases, bwd_cases = {}, {}
    plain, forward_bound, backward_bound = dl_plain, dl_forward_bound, dl_backward_bound

    for k in (5, 100):
        for layout in DL_LAYOUTS:
            path = DL_PATHS[layout]
            name = f"K5 f32 k={k} B={BATCH} {layout}"
            x, loc, logscale, view = dl_inputs(k, layout, gen)
            if dl_kernel.forward_path(x, loc, logscale) != path:
                raise AssertionError(f"{name}: forward_path chose "
                                     f"{dl_kernel.forward_path(x, loc, logscale)}, not {path}")
            counts = branch_counts(x, loc, logscale, low, high, width)
            if min(counts.values()) == 0:
                raise AssertionError(f"{name}: a branch is not hit: {counts}")
            with torch.inference_mode():
                before = dict(dl_kernel.launches_by_path)
                got = dl_fwd(x, loc, logscale)
                if dl_kernel.launches_by_path[path] != before[path] + 1:
                    raise AssertionError(f"{name}: the wrapper did not count a {path} launch")
                want = plain(x, loc, logscale)
                torch.cuda.synchronize()
                if got.shape != want.shape or got.dtype != torch.float32:
                    raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
                if not torch.isfinite(got).all():
                    raise AssertionError(f"{name}: non-finite kernel output")
                err = (got - want).abs()
                excess = float((err - (ATOL + RTOL * want.abs())).max())
                max_err = float(err.max())
                fns = {"tiled": lambda: dl_fwd(x, loc, logscale),
                       "direct": lambda: dl_fwd(x, loc, logscale, "direct")}
                if path == "tiled":  # the direct path on the same operands, in turns
                    equal = bool(torch.equal(got, dl_fwd(x, loc, logscale, "direct")))
                    turns = in_turns(fns, TURNS, 20)
                    # under 0.15 ms an event time is mostly the wrapper's host
                    # time: the device's, from a CUDA graph of the launches
                    device = in_turns(fns, TURNS, 20, graph_ms)
                    blocks = dl_kernel.tile_blocks_per_sm()
                    more = dict(path=path, ms_direct=turns["direct"], bit_equal_to_direct=equal,
                                blocks_per_sm=blocks,
                                device_ms=device["tiled"], device_ms_direct=device["direct"])
                    ms = turns["tiled"]
                    ab = (f" at {blocks} blocks an SM (direct path on the same operands, "
                          f"in turns: {turns['direct']:.4f} ms; on the device {device['tiled']:.4f} ms, "
                          f"direct {device['direct']:.4f}; the two paths bit-equal: {equal})")
                    if not equal:
                        raise AssertionError(f"{name}: the tile path's bits differ from the "
                                             f"direct path's")
                else:
                    ms = cuda_ms(fns["direct"], 20)
                    more = dict(path=path, device_ms=graph_ms(fns["direct"], 20))
                    ab = f" (on the device {more['device_ms']:.4f} ms)"
                plain_ms = cuda_ms(lambda: plain(x, loc, logscale), 5)
            bound_ms, bound_by, by, calls = forward_bound(x, loc, logscale, got, counts)
            say(f"kernel {name}, {path} path: max|d|={max_err:.3e} (tolerance excess "
                f"{excess:.3e}), kernel {ms:.4f} ms{ab}, plain {plain_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by}; {bounds_text(by)}); attainable at the measured "
                f"rates {attainable(calls):.4f} ms; branches {counts}")
            if excess > 0:
                raise AssertionError(f"{name}: kernel and plain version differ beyond tolerance")
            fwd_err = max(fwd_err, max_err)
            fwd_cases[name] = dict(shape=name, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                   bound_by=bound_by, bounds=by, attainable_ms=attainable(calls),
                                   **more)
            del got, want, err
            if k > 5:
                continue

            # the backward, at the train shape: the cotangent as the sum over
            # the image's axes expands it
            g = torch.randn((k, BATCH, 1, 1, 1), generator=gen, device="cuda").expand(loc.shape)
            before = dict(dl_kernel.backward_launches_by_path)
            got = dl_bwd(x, loc, logscale, g)
            if dl_kernel.backward_launches_by_path[path] != before[path] + 1:
                raise AssertionError(f"{name}: the backward did not count a {path} launch")
            want = dl_kernel.dl_backward_plain(x, loc, logscale, g, low, high, width)
            torch.cuda.synchronize()
            excess = -float("inf")
            for a, b in zip(got, want):
                if a.shape != b.shape or not torch.isfinite(a).all():
                    raise AssertionError(f"{name}: gradient of shape {tuple(a.shape)}, finite "
                                         f"{bool(torch.isfinite(a).all())}")
                err = (a - b).abs()
                excess = max(excess, float((err - (BWD_ATOL + BWD_RTOL[torch.float32] * b.abs())).max()))
                bwd_err = max(bwd_err, float(err.max()))
            max_err = max(float((a - b).abs().max()) for a, b in zip(got, want))

            def autograd(dtype):
                leaves = [loc.detach().to(dtype).requires_grad_(True),
                          logscale.detach().to(dtype).requires_grad_(True)]
                out = plain(x.to(dtype), *leaves)
                return torch.cat(torch.autograd.grad(out, leaves, g.to(dtype)), dim=-1)

            truth = autograd(torch.float64)
            rms_ref = float(((autograd(torch.float32).double() - truth) ** 2).mean().sqrt())
            rms_kernel = float(((torch.cat(got, dim=-1).double() - truth) ** 2).mean().sqrt())
            del truth, want

            def fwd_bwd_kernel():
                """As the model differentiates it: the head conv's output is
                the leaf and the likelihood takes its view whole, where loc
                and logscale are its halves."""
                if layout == "contiguous":
                    leaves = [loc.detach().requires_grad_(True),
                              logscale.detach().requires_grad_(True)]
                    return torch.autograd.grad(dl_fwd(x, *leaves), leaves, g)
                leaf = view.detach().requires_grad_(True)
                return torch.autograd.grad(
                    dl_kernel.dl_log_prob_head(x, leaf, low, high, width), [leaf], g)

            def fwd_bwd_plain():
                if layout == "contiguous":
                    leaves = [loc.detach().requires_grad_(True),
                              logscale.detach().requires_grad_(True)]
                    return torch.autograd.grad(plain(x, *leaves), leaves, g)
                leaf = view.detach().requires_grad_(True)
                return torch.autograd.grad(plain(x, *torch.chunk(leaf, 2, dim=-1)), [leaf], g)

            bwd_fns = {"tiled": lambda: dl_bwd(x, loc, logscale, g),
                       "direct": lambda: dl_bwd(x, loc, logscale, g, "direct")}
            if path == "tiled":
                equal = all(torch.equal(a, b) for a, b in zip(got, bwd_fns["direct"]()))
                turns = in_turns(bwd_fns, TURNS, 20)
                device = in_turns(bwd_fns, TURNS, 20, graph_ms)
                blocks = dl_kernel.tile_blocks_per_sm(backward=True)
                ms = turns["tiled"]
                more = dict(path=path, ms_direct=turns["direct"], bit_equal_to_direct=equal,
                            blocks_per_sm=blocks,
                            device_ms=device["tiled"], device_ms_direct=device["direct"])
                ab = (f" at {blocks} blocks an SM (direct path on the same operands, in turns: "
                      f"{turns['direct']:.4f} ms; on the device {device['tiled']:.4f} ms, direct "
                      f"{device['direct']:.4f}; the two paths bit-equal: {equal})")
                if not equal:
                    raise AssertionError(f"{name}: the backward's tile path differs from the "
                                         f"direct path")
            else:
                ms = cuda_ms(bwd_fns["direct"], 20)
                more = dict(path=path, device_ms=graph_ms(bwd_fns["direct"], 20))
                ab = f" (on the device {more['device_ms']:.4f} ms)"
            plain_ms = cuda_ms(
                lambda: dl_kernel.dl_backward_plain(x, loc, logscale, g, low, high, width), 10)
            fb_ms = cuda_ms(fwd_bwd_kernel, 20)
            fb_plain_ms = cuda_ms(fwd_bwd_plain, 10)
            n_kernels, by_class = device_profile(fwd_bwd_kernel, 10)
            n_plain, by_class_plain = device_profile(fwd_bwd_plain, 10)
            bound_ms, bound_by, by, calls = backward_bound(x, loc, logscale, g, got, counts)
            say(f"backward {name}, {path} path: max|d|={max_err:.3e} (tolerance excess "
                f"{excess:.3e}); rms vs f64 kernel {rms_kernel:.3e} autograd {rms_ref:.3e}; "
                f"backward kernel {ms:.4f} ms{ab}, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} "
                f"ms ({bound_by}; {bounds_text(by)}); attainable at the measured rates "
                f"{attainable(calls):.4f} ms; fwd+bwd kernels {fb_ms:.4f} ms, autograd of plain "
                f"{fb_plain_ms:.4f} ms")
            # device time of the same forward + backward, from the profiler:
            # what autograd adds around the two kernels, with the head tensor
            # as the leaf where the operands are its halves
            say(f"fwd+bwd {name}, device: {n_kernels:.1f} kernels a call, "
                f"{sum(by_class.values()):.4f} ms ("
                + ", ".join(f"{c} {v:.4f}" for c, v in sorted(by_class.items())) + "); "
                f"autograd of plain {n_plain:.1f} kernels, {sum(by_class_plain.values()):.4f} ms")
            if excess > 0:
                raise AssertionError(f"{name}: backward kernel and plain version differ beyond tolerance")
            if rms_kernel > F64_RATIO * rms_ref + 1e-9:
                raise AssertionError(f"{name}: backward kernel less accurate than autograd")
            # (the profiler may miss a launch now and then: the classes, not
            # the count, show that nothing ran beside the two kernels)
            if path == "tiled" and set(by_class) != {"DL forward", "DL backward"}:
                raise AssertionError(f"{name}: forward + backward on the head ran "
                                     f"{sorted(by_class)} on the device, not the two DL "
                                     f"kernels alone")
            bwd_cases[name] = dict(shape=name, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                   bound_by=bound_by, bounds=by, attainable_ms=attainable(calls),
                                   fwd_bwd_kernels=n_kernels,
                                   fwd_bwd_device_ms=sum(by_class.values()),
                                   profiled_device_ms=by_class["DL backward"], **more)
            fwd_cases[name]["profiled_device_ms"] = by_class["DL forward"]
            del got, g
        del x, loc, logscale, view
    torch.cuda.empty_cache()

    # model03's own head output at initialisation (what the model's paths
    # hand the kernels): both paths on the device in turns, forward at k = 5
    # and 100, backward at k = 5
    for k in (5, 100):
        x, head = model_head("model03", k)
        fwd, bwd = head_cases(f"model03 head k={k}", x, head, gen, backward=k == 5,
                              reps=20 if k == 5 else 10)
        fwd_cases[f"model03 head k={k}"] = fwd
        if bwd is not None:
            bwd_cases[f"model03 head k={k}"] = bwd
        del x, head
    torch.cuda.empty_cache()

    # off the model's shapes: a ragged last tile (k = 3, B = 7, 31 x 31:
    # 20,181 pixels) on the tile path, and a misaligned copy of the head,
    # which takes the direct path and is refused on the tile path
    x, loc, logscale, view = dl_inputs(3, "nhwc halves", gen, batch=7, side=31)
    g = torch.randn((3, 7, 1, 1, 1), generator=gen, device="cuda").expand(loc.shape)
    ragged = loc.shape[:4].numel()
    if ragged % dl_kernel.TILE_THREADS == 0:
        raise AssertionError("the pixels are whole tiles: no ragged case")
    got, d_got = dl_fwd(x, loc, logscale), dl_bwd(x, loc, logscale, g)
    want, d_want = plain(x, loc, logscale), dl_kernel.dl_backward_plain(x, loc, logscale, g,
                                                                         low, high, width)
    excess = max([float(((got - want).abs() - (ATOL + RTOL * want.abs())).max())]
                 + [float(((a - b).abs() - (BWD_ATOL + BWD_RTOL[torch.float32] * b.abs())).max())
                    for a, b in zip(d_got, d_want)])
    equal = bool(torch.equal(got, dl_fwd(x, loc, logscale, "direct"))) and all(
        torch.equal(a, b) for a, b in zip(d_got, dl_bwd(x, loc, logscale, g, "direct")))
    off = misaligned_copy(view)
    off_loc, off_ls = torch.chunk(off, 2, dim=-1)
    off_path = dl_kernel.forward_path(x, off_loc, off_ls)
    refused = (refuses(lambda: dl_fwd(x, off_loc, off_ls, "tiled"))
               and refuses(lambda: dl_bwd(x, off_loc, off_ls, g, "tiled")))
    off_equal = bool(torch.equal(got, dl_fwd(x, off_loc, off_ls))) and all(
        torch.equal(a, b) for a, b in zip(d_got, dl_bwd(x, off_loc, off_ls, g)))
    say(f"K5 ragged k=3 B=7 31x31 ({ragged} pixels), tile path: tolerance excess {excess:.3e}; "
        f"forward and backward equal to the direct path bit for bit: {equal}; a misaligned copy "
        f"of the head takes the {off_path} path, gives the same bits ({off_equal}) and is "
        f"refused on the tile path ({refused})")
    if excess > 0 or not (equal and off_equal and refused) or off_path != "direct":
        raise AssertionError("ragged or misaligned DL case: the paths disagree")
    del x, loc, logscale, view, g, got, d_got, off
    torch.cuda.empty_cache()
    return fwd_err, bwd_err, fwd_cases, bwd_cases


def phase_io_probes():
    """P1, P2 and both P3 pairs against their plain versions at full size.
    -> {record name: kernels-line record}."""
    records = {}

    # P1 and P2: K = 100, P = 102400, C = 50, one 2.05 GB layout at a time;
    # their times are the memory-path probes' own (structure_path)
    for layout in io_probe.LAYOUTS:
        params = kernel_isolate.probe_params(layout)
        want = io_probe.channel_sum_plain(params, layout)
        bound_ms, bound_by, _ = bound(distinct_bytes(params, want), params.numel())
        # the strided kernel, which every other kernel's bits must equal
        strided = io_probe.channel_sum(params, layout, kernel="strided")
        paths = ("direct", "staged") if layout == "channel_minor" else ("direct",)
        for path in paths:
            got = io_probe.channel_sum(params, layout, path)
            torch.cuda.synchronize()
            if got.shape != want.shape or not torch.isfinite(got).all():
                raise AssertionError(f"channel_sum {layout} {path}: shape {tuple(got.shape)}")
            err = float((got - want).abs().max())
            which = "P1" if layout == "channel_minor" else "P2"
            name = f"{which} {layout} {path}"
            kernel = "tiled" if path == "staged" else io_probe.direct_kernel(params, layout)
            if not torch.equal(got, strided):
                raise AssertionError(f"{name}: the {kernel} kernel's bits differ from the "
                                     f"strided kernel's")
            more = {}
            if layout == "channel_first":  # the strided kernel it replaced, in turns
                more = dict(ms_strided=in_turns(
                    {"vec4": lambda: io_probe.channel_sum(params, layout),
                     "strided": lambda: io_probe.channel_sum(params, layout, kernel="strided")},
                    ("strided", "vec4", "vec4", "strided"), 5)["strided"])
            elif path == "staged":
                more = dict(blocks_per_sm=io_probe.tile_blocks_per_sm(kernel_isolate.CH),
                            tile_pixels=io_probe.SUM_TILE)
            say(f"kernel {name} K={kernel_isolate.K} P={kernel_isolate.P} C={kernel_isolate.CH} "
                f"({kernel} kernel): max|d|={err:.3e} (atol {SUM_ATOL}), bound {bound_ms:.4f} ms "
                f"({bound_by}); equal to the strided kernel bit for bit" +
                (f", which takes {more['ms_strided']:.4f} ms" if "ms_strided" in more else "") +
                (f"; tiles of {io_probe.SUM_TILE} pixels, {more['blocks_per_sm']} blocks an SM"
                 if "blocks_per_sm" in more else ""))
            if err > SUM_ATOL:
                raise AssertionError(f"{name}: kernel and plain version differ beyond tolerance")
            records[name] = dict(max_abs_err=err, shape=name, bound_ms=bound_ms,
                                 bound_by=bound_by, kernel=kernel, **more)
        del params, want, got, strided
    torch.cuda.empty_cache()

    # P1 staged off its layout: refused before any launch, never sent elsewhere
    whole = torch.randn((3, 1000, 60), device="cuda")
    views = (("sliced", whole[..., :50]), ("misaligned", misaligned_copy(whole[..., :50])),
             ("300-channel", torch.randn((3, 1000, 300), device="cuda")))
    for what, view in views:
        before = io_probe.launches
        try:
            io_probe.channel_sum(view, path="staged")
        except ValueError:
            pass
        else:
            raise AssertionError(f"P1 staged took a {what} view")
        if io_probe.launches != before:
            raise AssertionError(f"P1 staged launched on a {what} view")
    say("kernel P1 staged refuses a sliced, a misaligned and a 300-channel view (its tile "
        "would not fit shared memory) before any launch")
    del whole, views

    # P3: the MoDL kernels' train (k = 5) and eval-chunk (k = 100) shapes
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    for k in (5, 100):
        for dtype in (torch.float32, torch.bfloat16):
            for nchw in (False, True):
                x = torch.rand((BATCH, 32, 32, 3), generator=gen, device="cuda")
                p = torch.randn((k, BATCH, 32, 32, 10 * N_MIX), generator=gen,
                                device="cuda").to(dtype)
                if nchw:
                    p = _nchw(p)
                # the cotangent as the sum over the image's axes expands it
                g = torch.randn((k, BATCH, 1, 1, 1), generator=gen,
                                device="cuda").expand(k, BATCH, 32, 32, 1)
                fwd_want = mdl_null.mdl_null_forward_plain(x, p)
                bwd_want = mdl_null.mdl_null_backward_plain(x, p, g)
                layout = "nchw" if nchw else "nhwc"
                # the staged variant has the MoDL kernels' dispatch
                paths = {"dma": "direct", "staged": "direct" if nchw else "tiled"}
                # each direction's two variants in turns, in one stretch
                order = ("dma", "staged", "staged", "dma")
                fwd_ms = in_turns(
                    {variant: (lambda v=variant: mdl_null.mdl_null_forward(x, p, v))
                     for variant in mdl_null.VARIANTS}, order, 10)
                fwd_device = in_turns(
                    {variant: (lambda v=variant: mdl_null.mdl_null_forward(x, p, v))
                     for variant in mdl_null.VARIANTS}, order, 10, graph_ms)
                bwd_ms = in_turns(
                    {variant: (lambda v=variant: mdl_null.mdl_null_backward(x, p, g, v))
                     for variant in mdl_null.VARIANTS}, order, 10)
                fwd = {}
                for variant in mdl_null.VARIANTS:
                    tag = f"{variant} {dtype_name(dtype)} k={k} B={BATCH} {layout}"
                    before = (dict(mdl_null.launches_by_path),
                              dict(mdl_null.backward_launches_by_path))
                    fwd[variant] = mdl_null.mdl_null_forward(x, p, variant)
                    bwd = mdl_null.mdl_null_backward(x, p, g, variant)
                    torch.cuda.synchronize()
                    path = paths[variant]
                    if mdl_null.forward_path(p, variant) != path \
                            or mdl_null.launches_by_path[path] != before[0][path] + 1:
                        raise AssertionError(f"P3 forward {tag}: no {path} launch counted")
                    if mdl_null.backward_launches_by_path[path] != before[1][path] + 1:
                        raise AssertionError(f"P3 backward {tag}: no {path} launch counted")
                    err = float((fwd[variant] - fwd_want).abs().max())
                    if fwd[variant].shape != fwd_want.shape or err > SUM_ATOL:
                        raise AssertionError(f"P3 forward {tag}: max|d|={err:.3e}")
                    if not torch.equal(fwd[variant], fwd["dma"]):
                        raise AssertionError(f"P3 forward {tag}: not the dma variant's bits")
                    if bwd.dtype != p.dtype or bwd.stride() != p.stride() \
                            or not torch.equal(bwd, bwd_want):
                        raise AssertionError(f"P3 backward {tag}: not equal to 0.5 p + g")
                    fwd_plain = cuda_ms(lambda: mdl_null.mdl_null_forward_plain(x, p), 3)
                    bwd_plain = cuda_ms(lambda: mdl_null.mdl_null_backward_plain(x, p, g), 3)
                    fb, fby, _ = bound(distinct_bytes(x, p, fwd[variant]),
                                       fwd[variant].numel() * (10 * N_MIX + 3))
                    bb, bby, _ = bound(distinct_bytes(x, p, g, bwd), 2 * p.numel())
                    tiled = path == "tiled"
                    fwd_blocks = mdl_null.tile_blocks_per_sm(dtype, N_MIX, forward=True) \
                        if tiled else None
                    blocks = mdl_null.tile_blocks_per_sm(dtype, N_MIX) if tiled else None
                    library_ms = None
                    if dtype == torch.float32:  # one call, the same function
                        library_ms = cuda_ms(lambda: torch.add(g, p, alpha=0.5), 5)
                    say(f"kernel P3 {tag} ({path} path"
                        + (f", {fwd_blocks} / {blocks} blocks an SM" if tiled else "")
                        + f"): forward max|d|={err:.3e} (atol {SUM_ATOL}), the dma variant's "
                        f"bits, {fwd_ms[variant]:.4f} ms, device {fwd_device[variant]:.4f} ms "
                        f"(dma, staged, staged, dma in turns), plain {fwd_plain:.4f} ms, "
                        f"bound {fb:.4f} ms ({fby}); backward equal, {bwd_ms[variant]:.4f} ms "
                        f"(in turns), plain {bwd_plain:.4f} ms, library "
                        f"{'%.4f ms' % library_ms if library_ms else 'none'}, bound {bb:.4f} ms "
                        f"({bby})")
                    records[f"P3 forward {tag}"] = dict(
                        max_abs_err=err, shape=f"P3 forward {tag}", path=path,
                        ms=fwd_ms[variant], device_ms=fwd_device[variant], plain_ms=fwd_plain,
                        bound_ms=fb, bound_by=fby, library_ms=None)
                    records[f"P3 backward {tag}"] = dict(
                        max_abs_err=0.0, shape=f"P3 backward {tag}", path=path,
                        ms=bwd_ms[variant], plain_ms=bwd_plain, bound_ms=bb, bound_by=bby,
                        library_ms=library_ms)
                    if tiled:
                        records[f"P3 forward {tag}"].update(blocks_per_sm=fwd_blocks)
                        records[f"P3 backward {tag}"].update(blocks_per_sm=blocks)
                del x, p, g, fwd, bwd, fwd_want, bwd_want
        torch.cuda.empty_cache()

    # off the main shapes: a ragged last tile on the tile path, and a view one
    # element off a 16-byte boundary, which staged must take directly
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.rand((7, 31, 31, 3), generator=gen, device="cuda")
        p = torch.randn((3, 7, 31, 31, 10 * N_MIX), generator=gen, device="cuda").to(dtype)
        g = torch.randn((3, 7, 31, 31, 1), generator=gen, device="cuda")
        for what, params, path in (("ragged", p, "tiled"),
                                   ("misaligned", misaligned_copy(p), "direct")):
            before = (dict(mdl_null.launches_by_path), dict(mdl_null.backward_launches_by_path))
            fwd = mdl_null.mdl_null_forward(x, params, "staged")
            bwd = mdl_null.mdl_null_backward(x, params, g, "staged")
            torch.cuda.synchronize()
            if mdl_null.launches_by_path[path] != before[0][path] + 1:
                raise AssertionError(f"P3 forward {what}: staged did not take the {path} path")
            if mdl_null.backward_launches_by_path[path] != before[1][path] + 1:
                raise AssertionError(f"P3 backward {what}: staged did not take the {path} path")
            if not torch.equal(fwd, mdl_null.mdl_null_forward(x, params, "dma")):
                raise AssertionError(f"P3 forward {what} {dtype_name(dtype)}: not the dma bits")
            if not torch.equal(bwd, mdl_null.mdl_null_backward_plain(x, params, g)):
                raise AssertionError(f"P3 backward {what} {dtype_name(dtype)}: not 0.5 p + g")
            if path == "direct":  # the C entry point asked for the tile path refuses it
                err = io_probe.library().mdl_null_forward(
                    x.data_ptr(), params.data_ptr(), fwd.data_ptr(), int(dtype == torch.bfloat16),
                    N_MIX, 1, *params.shape[:4], *x.stride(), *params.stride(),
                    torch.cuda.current_stream().cuda_stream)
                if err != 1:  # cudaErrorInvalidValue
                    raise AssertionError(f"P3 forward {what}: the tile path returned {err}")
            say(f"kernel P3 staged {what} {dtype_name(dtype)} k=3 B=7 31x31 "
                f"({g.numel()} pixels), {path} path: forward the dma variant's bits, "
                f"backward equal to 0.5 p + g")
    return records


def phase_small_models(smi: str) -> None:
    """model01 (MLP, Bernoulli) and model02 (Gaussian head): train steps with
    a finite, falling loss, and model01's rate through the timing harness at
    100 steps per call."""
    for name in ("model01", "model02"):
        cfg = experiment(name)
        model = seeded_model(cfg.model)
        state = create_train_state(model, cfg.train)
        step = make_train_step(model, cfg, make_optimizer(cfg.train))
        shape = cfg.model.image_shape
        batch = torch.as_tensor(np.random.default_rng(SEED).integers(
            0, 256, (BATCH,) + shape, dtype=np.uint8), device="cuda")
        losses = []
        for _ in range(20):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        say(f"{name} train, 20 steps on one batch of {BATCH}: loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}")
        if not np.isfinite(losses).all() or losses[-1] >= losses[0]:
            raise AssertionError(f"{name}: loss {losses[0]} -> {losses[-1]} is not finite and falling")
    spc = 100
    step, state, batch, cfg, flops = setup_scanned_step("model01", spc=spc)
    rates = time_scanned_step(step, state, batch, spc, cfg.data.batch_size, n_iters=2,
                              n_repeats=4)
    say(f"model01 train f32 k={cfg.model.n_samples} B={cfg.data.batch_size}, {spc} steps per "
        f"call: {float(np.median(rates)):.1f} imgs/s (median of {len(rates)} blocks of 2 calls: "
        f"{', '.join(f'{r:.0f}' for r in rates)}); {flops / cfg.data.batch_size / 1e6:.2f} "
        f"MFLOP per image and step on {smi}")

    # model01's evaluation: a Bernoulli on dynamically binarised data, so one
    # fixed binarisation a batch, drawn from its generator before the noise
    cfg = experiment("model01")
    model = seeded_model(cfg.model)
    digits = np.random.default_rng(SEED).integers(0, 256, (BATCH,) + cfg.model.image_shape,
                                                  dtype=np.uint8)
    llh, per_image, _ = evaluate_llh(model, cfg, digits, n_samples=200, k_chunk=100,
                                     batch_size=BATCH, seed=SEED)
    gen = torch.Generator(device="cuda").manual_seed(_batch_seed(SEED, 0))
    binary = binarize(gen, torch.as_tensor(digits, device="cuda").float() / 255.0)
    off = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, dynamic_binarization=False))
    want = make_batch_evaluator(model, off, 200, 100)(binary, gen).cpu().numpy()
    say(f"model01 200-IS evaluation of {BATCH} images binarised once: llh {llh:.4f} nats; "
        f"equal per image to the evaluator fed the same draw's binary batch: "
        f"{bool(np.array_equal(per_image, want))}")
    if not np.isfinite(per_image).all() or not np.array_equal(per_image, want):
        raise AssertionError("model01 evaluation: not the evaluation of one binarised batch")


def probe_counts() -> dict:
    """Every kernel's launches since ``reset_probe_counts``."""
    return {**kernel_structure.launch_counts(), "sfu_probe": sfu_probe.launches,
            "channel_sum": io_probe.launches,
            **{f"channel_sum {layout} {path}": n
               for (layout, path), n in io_probe.launches_by_path.items()},
            **{f"channel_sum kernel {kernel}": n
               for kernel, n in io_probe.launches_by_kernel.items()}}


def reset_probe_counts() -> None:
    kernel_structure.reset_counts()
    sfu_probe.launches = io_probe.launches = 0
    io_probe.launches_by_path.clear()
    io_probe.launches_by_kernel.update(dict.fromkeys(io_probe.KERNELS, 0))


def _only(counts: dict, wanted, what: str) -> None:
    """Fail unless exactly the ``wanted`` kernels launched."""
    for kernel, n in counts.items():
        if kernel in wanted and n < 1:
            raise AssertionError(f"{what} never launched {kernel}")
        if kernel not in wanted and n:
            raise AssertionError(f"{what} launched {kernel} {n} times")


def _took(by_path: dict, path: str, what: str) -> None:
    """Fail unless every launch counted in ``by_path`` took ``path``."""
    others = {other: n for other, n in by_path.items() if other != path and n}
    if by_path[path] < 1 or others:
        raise AssertionError(f"{what} took {by_path}, not the {path} path alone")


def structure_path(smi: str):
    """This slice's main path, second part: the four-way step and the
    memory-path probes on model05, batch 128, k = 5, f32, each with every
    count set to 0 just before it and read just after. -> ({path: counts},
    the memory-path probes' times in ms by their labels)."""
    by_path = {}
    say(f"-- probes.kernel_structure on {smi}")
    reset_probe_counts()
    structure = kernel_structure.run(n_iters=3, n_repeats=4, say=say)
    wanted = {"full": ("mdl_log_prob", "mdl_log_prob_backward"),
              "dma": ("mdl_null_forward", "mdl_null_backward"),
              "staged": ("mdl_null_forward", "mdl_null_backward"),
              "dl_head": ("dl_log_prob", "dl_log_prob_backward")}
    for label, kernels in wanted.items():
        counts = {**structure["steps"][label]["launches"]}
        _only(counts, kernels, f"the {label} step")
        by_path[f"kernel_structure {label}"] = counts
    paths = {label: structure["steps"][label]["backward_paths"] for label in wanted}
    _took(structure["steps"]["full"]["forward_paths"]["mdl_log_prob"], "tiled",
          "the full step's MoDL forward")
    _took(paths["full"]["mdl_log_prob_backward"], "tiled", "the full step's MoDL backward")
    _took(paths["staged"]["mdl_null_backward"], "tiled", "the staged step's null backward")
    _took(paths["dma"]["mdl_null_backward"], "direct", "the dma step's null backward")
    _took(structure["steps"]["staged"]["forward_paths"]["mdl_null_forward"], "tiled",
          "the staged step's null forward")
    _took(structure["steps"]["dma"]["forward_paths"]["mdl_null_forward"], "direct",
          "the dma step's null forward")
    for label in ("dma", "staged"):  # the null pair's launches by memory path
        step = structure["steps"][label]
        for kernel, counts in (("mdl_null_forward", step["forward_paths"]["mdl_null_forward"]),
                               ("mdl_null_backward", paths[label]["mdl_null_backward"])):
            by_path[f"kernel_structure {label}"].update(
                {f"{kernel} {p}": n for p, n in counts.items()})
    dl_head = structure["steps"]["dl_head"]
    _took(dl_head["forward_paths"]["dl_log_prob"], "tiled", "the dl_head step's DL forward")
    _took(paths["dl_head"]["dl_log_prob_backward"], "tiled", "the dl_head step's DL backward")
    by_path["kernel_structure dl_head"].update(
        {f"dl_log_prob {p}": n for p, n in dl_head["forward_paths"]["dl_log_prob"].items()})
    by_path["kernel_structure dl_head"].update(
        {f"dl_log_prob_backward {p}": n
         for p, n in paths["dl_head"]["dl_log_prob_backward"].items()})
    say(f"kernel_structure launches by memory path: forward "
        f"{ {label: structure['steps'][label]['forward_paths'] for label in wanted} }, "
        f"backward {paths}")
    if mdl_kernel.mdl_log_prob.__module__ != mdl_kernel.__name__:
        raise AssertionError("the MoDL likelihood was not put back after the probe")

    say(f"-- probes.kernel_isolate, kernel_isolate2 on {smi}")
    reset_probe_counts()
    times = {**kernel_isolate.run(reps=5, say=say), **kernel_isolate2.run(reps=5, say=say)}
    by_path["kernel_isolate"] = counts = probe_counts()
    say(f"kernel_isolate main path: kernel launches {counts}")
    _only(counts, ("channel_sum", "channel_sum channel_minor direct",
                   "channel_sum channel_minor staged", "channel_sum channel_first direct",
                   "channel_sum kernel strided", "channel_sum kernel tiled",
                   "channel_sum kernel vec4"), "the memory-path probes")
    # every channel-first launch took the vec4 kernel, every channel-minor
    # direct one the strided kernel, every staged one the read walk
    if (counts["channel_sum kernel vec4"] != counts["channel_sum channel_first direct"]
            or counts["channel_sum kernel strided"] != counts["channel_sum channel_minor direct"]
            or counts["channel_sum kernel tiled"] != counts["channel_sum channel_minor staged"]):
        raise AssertionError(f"the channel sums took other kernels: {counts}")
    return by_path, times


def kernels_of(name: str):
    """The kernel module a model's likelihood launches."""
    return mdl_kernel if MODELS[name].likelihood == "mdl" else dl_kernel


def seeded_model(cfg):
    return build_model(cfg, torch.Generator().manual_seed(SEED)).eval()


def open_gates(model):
    """Every rezero gate of a ladder set to a seeded value in [0.5, 1.5]: at
    initialisation they are 0, which leaves every conv inside a residual
    branch without gradient. Other models have none."""
    gen = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".gate"):
                p.fill_(0.5 + float(torch.rand((), generator=gen)))
    return model


def images(n: int, shape=(32, 32, 3)) -> np.ndarray:
    return np.random.default_rng(SEED).integers(0, 256, (n,) + tuple(shape), dtype=np.uint8)


def seeded_noise(cfg):
    """One standard-normal tensor ``[k, B] + shape_i`` per stochastic layer
    (``[k, B, n_i]``; a ladder's ``[k, B, h_i, w_i, c_i]``), bottom up."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    return [torch.randn((cfg.n_samples, BATCH) + shape, generator=gen, device="cuda")
            for shape in latent_shapes(cfg)]


def phase_bound(name: str) -> None:
    cfg = MODELS[name]
    kernels = kernels_of(name)
    kernel_model = seeded_model(cfg)
    plain_model = seeded_model(dataclasses.replace(cfg, use_pallas=False))
    x = torch.as_tensor(images(BATCH), device="cuda").float() / 255.0
    eps = seeded_noise(cfg)
    results = {}
    for which, model in (("kernel", kernel_model), ("plain", plain_model)):
        before = kernels.launches
        with torch.inference_mode():
            Qs, Ps, pxz = model(x, cfg.n_samples, eps=eps)
            loss, metrics = compute_loss(prior_for(cfg, "cuda"), Qs, Ps, pxz, x)
        results[which] = (float(loss), metrics["lpxz"].double(), kernels.launches - before)
    (loss_k, lpxz_k, n_k), (loss_p, lpxz_p, n_p) = results["kernel"], results["plain"]
    lpxz_rel = float(((lpxz_k - lpxz_p).abs() / lpxz_p.abs()).max())
    say(f"{name} f32 bound k={cfg.n_samples} B={BATCH}: -iwae kernel {loss_k:.6f}, "
        f"plain {loss_p:.6f}, max rel lpxz diff {lpxz_rel:.3e}, kernel launches {n_k}/{n_p}")
    if not np.isfinite(loss_k) or abs(loss_k - loss_p) > SUM_RTOL * abs(loss_p) or lpxz_rel > SUM_RTOL:
        raise AssertionError(f"{name} bound: kernel and plain version disagree")
    if n_k < 1 or n_p != 0:
        raise AssertionError(f"{name} bound: kernel launched {n_k} times, plain path {n_p}")


def phase_train_step_check(name: str, compute_dtype: str = None, base=None) -> None:
    """One train step of the model in its config (float32; biladder_celeba
    bf16) or in ``compute_dtype``, through the kernels and through the plain
    version, from one state, batch and noise: the loss and each parameter's
    gradient, then the whole step. A ladder's rezero gates are opened first
    (``open_gates``), so that every leaf has a gradient to compare, and its
    train step does not flip the images (biladder_celeba's experiment
    would), so that the step sees the batch the loss saw. ``base`` stands
    in for the zoo's config (phase 20: model05 with ``head_pad``)."""
    base = MODELS[name] if base is None else base
    if compute_dtype is not None:
        base = dataclasses.replace(base, compute_dtype=compute_dtype)
    grad_rtol = GRAD_RTOL_BF16 if base.compute_dtype == "bfloat16" else GRAD_RTOL
    kernels = kernels_of(name)
    batch = torch.as_tensor(images(BATCH, base.image_shape), device="cuda")
    x = batch.float() / 255.0
    eps = seeded_noise(base)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the same conv algorithms in both runs
    results = {}
    for which, use in (("kernel", None), ("plain", False)):
        cfg = experiment(name, model=dataclasses.replace(base, use_pallas=use))
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, augment_flip=False))
        model = open_gates(seeded_model(cfg.model))
        state = create_train_state(model, cfg.train)
        before = kernels.launches, kernels.backward_launches
        loss_fn = training_loss_fn(model, cfg, prior_for(cfg.model, "cuda"), x,
                                   cfg.model.n_samples, eps=eps)
        loss, _ = loss_fn(state.params)
        grads = torch.autograd.grad(loss, list(state.params.values()))
        step = make_train_step(model, cfg, make_optimizer(cfg.train))
        state, metrics = step(state, batch, eps=eps)
        torch.cuda.synchronize()
        results[which] = (float(loss.detach()), dict(zip(state.params, grads)),
                          float(metrics["loss"]), kernels.launches - before[0],
                          kernels.backward_launches - before[1])
    torch.backends.cudnn.deterministic = deterministic
    loss_k, grads_k, step_k, fwd_k, bwd_k = results["kernel"]
    loss_p, grads_p, step_p, fwd_p, bwd_p = results["plain"]
    rel = {leaf: float((grads_k[leaf] - grads_p[leaf]).norm()
                       / grads_p[leaf].norm().clamp_min(1e-30)) for leaf in grads_p}
    leaf = max(rel, key=rel.get)
    say(f"{name} {base.compute_dtype} train step k={base.n_samples} B={BATCH}: loss kernel "
        f"{loss_k:.6f}, "
        f"plain {loss_p:.6f} (step {step_k:.6f} / {step_p:.6f}); max norm-relative gradient "
        f"diff {rel[leaf]:.3e} ({leaf}, of {len(rel)} leaves); kernel launches forward "
        f"{fwd_k}/{fwd_p}, backward {bwd_k}/{bwd_p}")
    for a, b in ((loss_k, loss_p), (step_k, step_p), (loss_k, step_k)):
        if not np.isfinite(a) or abs(a - b) > SUM_RTOL * abs(b):
            raise AssertionError(f"{name} train step: kernel and plain losses disagree")
    if not np.isfinite(rel[leaf]) or rel[leaf] > grad_rtol:
        raise AssertionError(f"{name} train step: {leaf} gradients differ beyond tolerance")
    if fwd_k < 1 or bwd_k < 1 or fwd_p != 0 or bwd_p != 0:
        raise AssertionError(f"{name} train step: kernels launched {fwd_k}+{bwd_k} times, "
                             f"plain path {fwd_p}+{bwd_p}")


def configs_of(name: str, plain: bool) -> dict:
    """The float32 parity config, the bfloat16 config (bf16 conv body; the
    MoDL's head -> likelihood boundary in bf16 too, the DL head stays
    float32) and, for training, float32 through the plain version; a ladder
    its own config alone, through the kernels."""
    base = MODELS[name]
    if name in LADDERS:
        return {"bf16" if base.compute_dtype == "bfloat16" else "f32": base}
    io_dtype = "bfloat16" if base.likelihood == "mdl" else None
    configs = {
        "f32": base,
        "bf16": dataclasses.replace(base, compute_dtype="bfloat16", likelihood_io_dtype=io_dtype),
    }
    if plain:
        configs["f32 plain"] = dataclasses.replace(base, use_pallas=False)
    return configs


def train_pool(shape=(32, 32, 3)) -> torch.Tensor:
    """One call's worth of seeded synthetic uint8 batches, on the card."""
    rng = np.random.default_rng(SEED)
    return torch.as_tensor(rng.integers(0, 256, (TRAIN_STEPS_PER_CALL, BATCH) + tuple(shape),
                                        dtype=np.uint8), device="cuda")


def phase_train(name: str, smi: str):
    """The main path of training. -> {config: imgs/s}."""
    pool = train_pool(MODELS[name].image_shape)
    rates = {}
    for which, mcfg in configs_of(name, plain=True).items():
        cfg = experiment(name, model=mcfg)
        model = seeded_model(mcfg)
        state = create_train_state(model, cfg.train)
        multi = make_multi_train_step(model, cfg, make_optimizer(cfg.train), TRAIN_STEPS_PER_CALL)
        state, metrics = multi(state, pool)  # warm-up
        first = float(metrics["loss"])
        torch.cuda.reset_peak_memory_stats()
        block_ms = []
        for _ in range(TRAIN_BLOCKS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            state, metrics = multi(state, pool)
            end.record()
            end.synchronize()
            block_ms.append(start.elapsed_time(end))
        last = float(metrics["loss"])
        peak = torch.cuda.max_memory_allocated() / 2**30
        rates[which] = TRAIN_STEPS_PER_CALL * BATCH / (float(np.median(block_ms)) / 1e3)
        say(f"{name} train {which} k={mcfg.n_samples} B={BATCH}: {rates[which]:.1f} imgs/s "
            f"(median of {TRAIN_BLOCKS} calls of {TRAIN_STEPS_PER_CALL} steps: "
            f"{', '.join(f'{ms:.2f}' for ms in block_ms)} ms; peak {peak:.2f} GiB); "
            f"loss {first:.4f} after {TRAIN_STEPS_PER_CALL} steps, {last:.4f} after "
            f"{(TRAIN_BLOCKS + 1) * TRAIN_STEPS_PER_CALL} on {smi}")
        if not (np.isfinite(first) and np.isfinite(last)) or last >= first:
            raise AssertionError(f"{name} train {which}: loss {first} -> {last} is not finite and falling")
        if state.step != (TRAIN_BLOCKS + 1) * TRAIN_STEPS_PER_CALL:
            raise AssertionError(f"{name} train {which}: state at step {state.step}")
    return rates


def traced(fn):
    """Run ``fn()`` under ``torch.profiler``. -> (host milliseconds of the
    traced run, device kernels launched, {kernel class: device ms},
    {likelihood kernel class: launches})."""
    wall_ms, kernels = device_times(fn)
    by_class: dict = {}
    launches: dict = {}
    n_kernels = 0
    for name, (count, ms) in kernels.items():
        cls = kernel_class(name)
        by_class[cls] = by_class.get(cls, 0.0) + ms
        n_kernels += count
        if cls.startswith(("MoDL", "DL")):
            launches[cls] = launches.get(cls, 0) + count
    return wall_ms, n_kernels, by_class, launches


def device_profile(fn, reps: int):
    """-> (device kernels per call of ``fn``, {kernel class: device ms per
    call}), over ``reps`` traced calls after a warm-up."""
    fn()
    _, n_kernels, by_class, _ = traced(lambda: [fn() for _ in range(reps)])
    return n_kernels / reps, {cls: ms / reps for cls, ms in by_class.items()}


def phase_profile(name: str) -> None:
    """Device time by kernel class over 5 train steps of each config, and the
    likelihood kernels' device time per launch."""
    pool = train_pool(MODELS[name].image_shape)
    for which, mcfg in configs_of(name, plain=False).items():
        cfg = experiment(name, model=mcfg)
        model = seeded_model(mcfg)
        state = create_train_state(model, cfg.train)
        step = make_train_step(model, cfg, make_optimizer(cfg.train))
        for batch in pool[:2]:
            state, _ = step(state, batch)

        def five_steps():
            nonlocal state
            for batch in pool[:5]:
                state, _ = step(state, batch)

        wall_ms, n_kernels, by_class, launches = traced(five_steps)
        busy = sum(by_class.values())
        shares = ", ".join(f"{cls} {ms:.3f} ms ({ms / busy:.1%})"
                           for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]))
        per_launch = ", ".join(f"{cls} {by_class[cls] / n:.4f} ms per launch ({n} launches)"
                               for cls, n in sorted(launches.items()))
        say(f"profile {name} train {which}, 5 steps: wall {wall_ms:.3f} ms (traced), "
            f"device busy {busy:.3f} ms, idle share {1 - busy / wall_ms:.3f}, "
            f"{n_kernels} device kernels; {shares}; {per_launch}")


def phase_eval(name: str, smi: str):
    """The main path of evaluation. -> {config: imgs/s}."""
    base = MODELS[name]
    n = EVAL_BATCH.get(name, BATCH)
    batch = images(n, base.image_shape)
    rates = {}
    for which, cfg in configs_of(name, plain=False).items():
        model = seeded_model(cfg)
        ecfg = experiment(name, model=cfg)
        llh, per_image, metrics = evaluate_llh(model, ecfg, batch, n_samples=5000,
                                               k_chunk=100, batch_size=n, seed=SEED)
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        llh2, _, metrics2 = evaluate_llh(model, ecfg, batch, n_samples=5000, k_chunk=100,
                                         batch_size=n, seed=SEED + 1)
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) / 1e3
        rates[which] = n / seconds
        peak = torch.cuda.max_memory_allocated() / 2**30
        say(f"{name} 5000-IS {which}: llh {llh:.4f} nats, bpd {metrics['bpd']:.6f} "
            f"(seed {SEED + 1}: llh {llh2:.4f}); {rates[which]:.2f} imgs/s "
            f"({seconds:.3f} s per batch of {n}, peak {peak:.1f} GiB) on {smi}")
        values = [llh, metrics["bpd"], llh2, metrics2["bpd"]]
        if not (np.isfinite(values).all() and np.isfinite(per_image).all()):
            raise AssertionError(f"{name} 5000-IS {which}: non-finite result")
        if per_image.shape != (n,):
            raise AssertionError(f"{name} 5000-IS {which}: per-image shape {per_image.shape}")

    # the same 200-sample evaluation through the kernel and the plain version
    plain_cfg = dataclasses.replace(base, use_pallas=False)
    got = evaluate_llh(seeded_model(base), experiment(name), batch, n_samples=200,
                       k_chunk=100, batch_size=n, seed=SEED)[1]
    want = evaluate_llh(seeded_model(plain_cfg), experiment(name, model=plain_cfg),
                        batch, n_samples=200, k_chunk=100, batch_size=n, seed=SEED)[1]
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    say(f"{name} 200-IS {base.compute_dtype} kernel vs plain: max rel per-image diff {rel:.3e}")
    if rel > SUM_RTOL:
        raise AssertionError(f"{name} evaluator: kernel and plain version disagree")
    return rates


def phase_layout() -> dict:
    """The memory layout in which each model's head hands its output to the
    likelihood kernel, read off the strides: the decoder's dense layer is
    reshaped to an NHWC grid and viewed as NCHW, which is channels-last
    memory, and cuDNN keeps a channels-last input's format through the
    stack. -> {"model05": "nhwc" | "nchw", "model03": the same}: the layout
    whose case goes into the kernels line."""
    layouts = {}
    for name in ("model05", "model03"):
        cfg = MODELS[name]
        model = seeded_model(cfg)
        x = torch.as_tensor(images(2), device="cuda").float() / 255.0
        with torch.inference_mode():
            dist = model(x, 1, generator=torch.Generator("cuda").manual_seed(SEED))[2].dist
        head = dist.parameters if cfg.likelihood == "mdl" else dist.loc
        channel, width = head.stride(-1), head.stride(-2)
        layouts[name] = "nhwc" if channel < width else "nchw"
        say(f"{name}: the head hands the likelihood {tuple(head.shape)} with strides "
            f"{head.stride()}: {layouts[name]}")
    return layouts


def main_path(name: str, path: str, smi: str) -> dict:
    """Drive one main path with every count set to 0 just before it and read
    just after. -> {kernel name: launches}; fails unless the path launched
    its own kernels (the forward; in training the backward too) and no
    other."""
    reset_probe_counts()
    if path == "eval":
        phase_eval(name, smi)
    else:
        TRAIN_RATES[name] = phase_train(name, smi)
    counts = probe_counts()
    say(f"{name} {path} main path: kernel launches {counts}")
    own = "mdl_log_prob" if MODELS[name].likelihood == "mdl" else "dl_log_prob"
    _only(counts, [own] + ([f"{own}_backward"] if path == "train" else []),
          f"the {name} {path} path")
    if own == "mdl_log_prob":
        say(f"{name} {path} main path: MoDL forward launches by memory path "
            f"{mdl_kernel.launches_by_path}")
        _took(mdl_kernel.launches_by_path, "tiled", f"the {name} {path} path's MoDL forward")
        counts["mdl_log_prob tiled"] = mdl_kernel.launches_by_path["tiled"]
    if own == "mdl_log_prob" and path == "train":
        by_memory_path = mdl_kernel.backward_launches_by_path
        say(f"{name} train main path: MoDL backward launches by memory path {by_memory_path}")
        _took(by_memory_path, "tiled", f"the {name} train path's MoDL backward")
    if own == "dl_log_prob":
        say(f"{name} {path} main path: DL forward launches by memory path "
            f"{dl_kernel.launches_by_path}, backward {dl_kernel.backward_launches_by_path}")
        _took(dl_kernel.launches_by_path, "tiled", f"the {name} {path} path's DL forward")
        counts.update({f"dl_log_prob {p}": n for p, n in dl_kernel.launches_by_path.items()})
        if path == "train":
            _took(dl_kernel.backward_launches_by_path, "tiled",
                  f"the {name} train path's DL backward")
            counts.update({f"dl_log_prob_backward {p}": n
                           for p, n in dl_kernel.backward_launches_by_path.items()})
    return counts


def phase_ladders(smi: str):
    """The ladder families, each at full width in its own config
    (biladder_celeba's body bf16), on seeded uint8 images of its shape: one
    train step through the kernels against the plain version (for
    biladder_celeba also with a float32 body, held to GRAD_RTOL); the main paths
    of evaluation (5000 samples, k-chunks of 100, on a batch of
    ``EVAL_BATCH``) and of training (batch 128, k = 5, 10 steps a call), each
    with every count set to 0 just before it and read just after, every DL
    launch on the tile path; the profile of 5 train steps; and the DL pair
    on each ladder's own head output at the train shape (forward and
    backward) and the eval chunk's (forward). -> ({path: counts}, {case:
    forward record}, {case: backward record})."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    by_path, fwd_cases, bwd_cases = {}, {}, {}
    for name in LADDERS:
        phase_train_step_check(name)
        if MODELS[name].compute_dtype != "float32":  # the same model, float32 body
            phase_train_step_check(name, "float32")
        for path in ("eval", "train"):
            by_path[f"{name} {path}"] = main_path(name, path, smi)
        phase_profile(name)
        for k, batch in ((5, BATCH), (100, EVAL_BATCH.get(name, BATCH))):
            x, head = model_head(name, k, batch)
            label = f"{name} head k={k} B={batch}"
            fwd_cases[label], bwd = head_cases(label, x, head, gen, backward=k == 5,
                                               reps=20 if k == 5 else 10)
            if bwd is not None:
                bwd_cases[label] = bwd
            del x, head
        torch.cuda.empty_cache()
    return by_path, fwd_cases, bwd_cases


class RecordingLogger(MetricLogger):
    """A ``MetricLogger`` that also keeps every image grid and every
    ``Perf`` record it is given."""

    def __init__(self, *args):
        super().__init__(*args)
        self.grids, self.perf = [], []

    def scalars(self, step, metrics, prefix="Evaluation"):
        super().scalars(step, metrics, prefix)
        if prefix == "Perf":
            self.perf.append((step, {name: float(v) for name, v in metrics.items()}))

    def image(self, step, name, img, prefix="Evaluation"):
        super().image(step, name, img, prefix)
        self.grids.append((step, name, img))


def trainer_config(root: str, n_updates: int = 40):
    """Phase 13's run: model05 at full width, f32, on synthetic SVHN-shaped
    data (no dataset is read; the name says synthetic, so nothing falls
    back)."""
    return dataclasses.replace(
        experiment("model05"),
        data=DataConfig(dataset="synthetic:svhn_cropped", batch_size=128, val_batch_size=500),
        train=TrainConfig(n_updates=n_updates, eval_interval=20, snapshot_interval=20,
                          max_snapshots=1, ema_decay=0.999, report_images=True,
                          checkpoint_dir=f"{root}/ckpt", log_dir=f"{root}/tb"))


def states_equal(a, b) -> bool:
    """Params, optimizer state and EMA bit for bit, and the step."""
    same = []
    for x, y in ((a.params, b.params), (a.opt_state, b.opt_state),
                 (a.ema_params, b.ema_params)):
        if x is None or y is None:  # no EMA copy
            same.append(x is y)
            continue
        tree_map(lambda u, v: same.append(torch.equal(u, v)), x, y)
    return a.step == b.step and all(same)


def first_difference(a, b) -> str:
    """The first leaf where two states differ, and by how much."""
    for tree_name, x, y in (("params", a.params, b.params), ("ema", a.ema_params, b.ema_params)):
        for name in x or ():
            if not torch.equal(x[name], y[name]):
                return (f"{tree_name} {name}: max |diff| "
                        f"{float((x[name] - y[name]).abs().max()):.3e}")
    return "the optimizer state"


def cuda_seconds(fn):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) / 1e3


def phase_trainer(smi: str) -> dict:
    """Phase 13, the training run as users start it; see the module
    docstring. -> the phase's kernel launches by name (its main path)."""
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with tempfile.TemporaryDirectory() as root:
            return _phase_trainer(root, smi)
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) = flags


def _phase_trainer(root: str, smi: str) -> dict:
    reset_probe_counts()
    # (a) the uninterrupted run
    cfg = trainer_config(f"{root}/a")
    logger = RecordingLogger(cfg.train.log_dir, "model05")
    trainer = Trainer(cfg, logger=logger)
    state = trainer.fit(progress=False)
    window2 = logger.perf[1][1]
    TRAIN_RATES["model05 trainer"] = window2["imgs_per_sec"]
    say(f"trainer (a): step {state.step}, best validation loss {state.best_val_loss:.4f}; "
        f"Perf by eval {logger.perf}; snapshots {trainer.ckpt.snapshots()} on {smi}")
    if state.step != 40 or not np.isfinite(state.best_val_loss):
        raise AssertionError(f"trainer (a): step {state.step}, best {state.best_val_loss}")
    if len(logger.grids) != 6:
        raise AssertionError(f"trainer (a): {len(logger.grids)} report grids, not 3 at each eval")

    # (b) preempted at 20, resumed by a new Trainer on the same directory
    Trainer(trainer_config(f"{root}/b", n_updates=20)).fit(progress=False)
    resumed = Trainer(trainer_config(f"{root}/b"))
    if resumed.state.step != 20:
        raise AssertionError(f"trainer (b): resumed at step {resumed.state.step}, not 20")
    resumed_state = resumed.fit(progress=False)
    resume_equal = states_equal(resumed_state, state)
    say(f"trainer (b): fit to 20, resumed by a new Trainer to 40: params, optimizer state and "
        f"EMA bit-equal to (a): {resume_equal}")
    if not resume_equal:
        raise AssertionError(f"trainer (b): the resumed run differs from (a) at "
                             f"{first_difference(resumed_state, state)}")

    # (c) the same 40 steps with synchronous copies of the pipeline's batches
    model = build_model(cfg.model, torch.Generator().manual_seed(cfg.train.seed))
    plain = create_train_state(model, cfg.train)
    step = make_train_step(model, cfg, make_optimizer(cfg.train))
    train_iter, _, _ = iterators_from_splits(make_splits(cfg.data.dataset), cfg.data.batch_size,
                                             cfg.data.val_batch_size, cfg.data.seed)
    for _ in range(40):
        plain, _ = step(plain, torch.as_tensor(next(train_iter)).to("cuda"))
    torch.cuda.synchronize()
    prefetch_equal = all(torch.equal(plain.params[n], state.params[n]) for n in state.params)
    say(f"trainer (c): 40 steps of make_train_step on synchronous copies: params bit-equal to "
        f"(a)'s through device_prefetch: {prefetch_equal}")
    if not prefetch_equal:
        raise AssertionError(f"trainer (c): the prefetched run differs at "
                             f"{first_difference(plain, state)}")
    # make_multi_train_step's rate on this model and these flags (phase 10's
    # loop: 10 steps a call, the median of 5 calls after a warm-up)
    multi = make_multi_train_step(model, cfg, make_optimizer(cfg.train), TRAIN_STEPS_PER_CALL)
    pool = train_pool()
    plain, _ = multi(plain, pool)
    calls = []
    for _ in range(TRAIN_BLOCKS):
        (plain, _), seconds = cuda_seconds(lambda: multi(plain, pool))
        calls.append(TRAIN_STEPS_PER_CALL * BATCH / seconds)
    multi_rate = float(np.median(calls))
    del model, plain, multi, pool

    # (d) restores of latest, best and the snapshot; a save's and a restore's ms
    ckpt = trainer.ckpt
    snapshots = ckpt.snapshots()
    if len(snapshots) != 1:
        raise AssertionError(f"trainer (d): {snapshots} on disk, max_snapshots is 1")
    scratch = create_train_state(build_model(cfg.model, torch.Generator().manual_seed(1)),
                                 cfg.train)
    restore_ms = []
    for tag in ("latest", "best", snapshots[0]):
        _, seconds = cuda_seconds(lambda: ckpt.restore(scratch, tag))
        restore_ms.append(1e3 * seconds)
        if tag == "latest" and not (states_equal(scratch, state)
                                    and scratch.best_val_loss == state.best_val_loss):
            raise AssertionError("trainer (d): 'latest' does not restore (a)'s final state")
        if tag == snapshots[0] and scratch.step != int(tag.split("_")[1]):
            raise AssertionError(f"trainer (d): {tag} restored at step {scratch.step}")
    save_ms = []
    for _ in range(3):
        _, seconds = cuda_seconds(lambda: ckpt.save(state, "latest"))
        save_ms.append(1e3 * seconds)
    state_mb = os.path.getsize(os.path.join(ckpt.base, "latest", "state.pt")) / 1e6
    say(f"trainer (d): restored latest (best validation loss {scratch.best_val_loss:.4f} in "
        f"it), best and {snapshots[0]}: ms {', '.join(f'{ms:.1f}' for ms in restore_ms)}; "
        f"save('latest') ms {', '.join(f'{ms:.1f}' for ms in save_ms)} ({state_mb:.1f} MB)")
    del scratch

    # (e) the report's three grids
    logger.grids.clear()
    trainer.report(40)
    names = [name for _, name, _ in logger.grids]
    for _, name, grid in logger.grids:
        if grid.shape != (256, 256, 3) or not np.isfinite(grid).all() or not (
                0.0 <= grid.min() and grid.max() <= 1.0):
            raise AssertionError(f"trainer (e): the {name} grid is {grid.shape}, "
                                 f"[{grid.min()}, {grid.max()}]")
    if names != ["inputs", "reconstructions", "samples"]:
        raise AssertionError(f"trainer (e): grids {names}")
    say(f"trainer (e): report grids {names}, each 256x256x3, finite, in [0, 1]")

    # (f) the test evaluation with its diagnostics; then fit goes on
    live = {n: p.detach().clone() for n, p in state.params.items()}
    torch.cuda.reset_peak_memory_stats()
    (llh, per_image, metrics), seconds = cuda_seconds(
        lambda: trainer.test(khat=True, k_curve=True))
    say(f"trainer (f): test() captured its batch beside the train step's graphs: peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated, "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved after it")
    n_test = len(per_image)
    points = [0, len(metrics["k_curve_ks"]) // 5, -1]
    say(f"trainer (f): test() 5000-IS on {n_test} images, the best checkpoint's EMA weights: "
        f"llh {llh:.4f} nats, bpd {metrics['bpd']:.6f}, k-hat mean {metrics['khat_mean']:.4f} "
        f"max {metrics['khat_max']:.4f}, frac > 0.7 {metrics['khat_frac_gt_07']:.4f}, "
        f"underflow {metrics['khat_n_underflow']}, ties {metrics['khat_n_ties']}; curve at k = "
        f"{metrics['k_curve_ks'][points].tolist()}: "
        f"{np.round(metrics['k_curve_llh'][points], 4).tolist()}; {n_test / seconds:.2f} "
        f"imgs/s with the extras")
    finite = [metrics[k] for k in ("khat_mean", "khat_max", "khat_frac_gt_07")]
    # the curve's last point is the mean of the same float32 values summed
    # in another order in float64
    curve_ok = abs(metrics["k_curve_llh"][-1] - llh) <= 1e-9 * abs(llh)
    if not (np.isfinite(per_image).all() and np.isfinite(finite).all() and curve_ok):
        raise AssertionError("trainer (f): test() gave non-finite values or a curve off its mean")
    best = ckpt.load("best", "cuda")["ema_params"]
    images = trainer.test_set[0][:BATCH]
    (with_extras, seconds_extras) = cuda_seconds(lambda: evaluate_llh(
        trainer.model, cfg, images, n_samples=5000, params=best, khat=True, k_curve=True))
    (without, seconds_plain) = cuda_seconds(lambda: evaluate_llh(
        trainer.model, cfg, images, n_samples=5000, params=best))
    same = bool(np.array_equal(with_extras[1], without[1]))
    curve_end = float(with_extras[2]["k_curve_llh"][-1])
    say(f"trainer (f): evaluate_llh 5000-IS on {BATCH} test images: {BATCH / seconds_plain:.2f} "
        f"imgs/s, {BATCH / seconds_extras:.2f} with k-hat and curve; per-image llh "
        f"bit-identical: {same}; curve end {curve_end:.6f} vs mean {without[0]:.6f}")
    if not same or abs(curve_end - without[0]) > 1e-9 * abs(without[0]):
        raise AssertionError("trainer (f): the extras changed the llh, or the curve misses it")
    untouched = all(torch.equal(live[n], p) for n, p in state.params.items())
    more = trainer.fit(n_updates=60, progress=False)
    other = resumed.fit(n_updates=60, progress=False)
    continued = untouched and more.step == 60 and states_equal(more, other)
    say(f"trainer (f): test() left the live weights as they were: {untouched}; fit to 60 "
        f"continues from step 40's live state, bit-equal to the resumed trainer's: {continued}")
    if not continued:
        raise AssertionError("trainer (f): fit after test() did not continue from the live state")

    counts = probe_counts()
    say(f"trainer main path: kernel launches {counts}; MoDL forward by memory path "
        f"{mdl_kernel.launches_by_path}, backward {mdl_kernel.backward_launches_by_path}")
    _only(counts, ("mdl_log_prob", "mdl_log_prob_backward"), "the training run")
    _took(mdl_kernel.launches_by_path, "tiled", "the training run's MoDL forward")
    _took(mdl_kernel.backward_launches_by_path, "tiled", "the training run's MoDL backward")
    counts["mdl_log_prob tiled"] = mdl_kernel.launches_by_path["tiled"]
    say("trainer: " + json.dumps({
        "card": smi,
        "trainer_imgs_per_sec_window2": window2["imgs_per_sec"],
        "trainer_step_ms_window2": window2["step_ms"],
        "multi_train_step_imgs_per_sec_same_flags": multi_rate,
        "multi_train_step_imgs_per_sec_phase10": TRAIN_RATES.get("model05", {}).get("f32"),
        "save_latest_ms": save_ms, "restore_ms": dict(zip(("latest", "best", snapshots[0]),
                                                          restore_ms)),
        "checkpoint_mb": state_mb,
        "test_imgs_per_sec_with_extras": n_test / seconds,
        "eval_imgs_per_sec": BATCH / seconds_plain,
        "eval_imgs_per_sec_with_extras": BATCH / seconds_extras,
        "modl_launches": {"forward": dict(mdl_kernel.launches_by_path),
                          "backward": dict(mdl_kernel.backward_launches_by_path)},
        "llh": llh, "khat_mean": metrics["khat_mean"], "khat_max": metrics["khat_max"],
        "khat_frac_gt_07": metrics["khat_frac_gt_07"],
        "khat_n_underflow": metrics["khat_n_underflow"], "khat_n_ties": metrics["khat_n_ties"],
    }))
    return counts


# -- phase 14: the CLI as users start it --------------------------------------------

# the keys of the JAX CLI's parity report (vae_mdl_tpu/cli/run.py cmd_parity)
PARITY_KEYS = {
    "model", "dataset", "synthetic_rehearsal", "step", "n_updates_protocol", "n_samples",
    "llh", "bpd", "khat_mean", "khat_max", "khat_frac_gt_07", "khat_n_underflow",
    "khat_n_ties", "k_curve_second_half_climb", "timestamp", "status", "target", "deviation"}
# the exported programs' float outputs against the live functions on the card
EXPORT_ATOL = 1e-6
# imgs/s of the live sampler and its exported program: CUDA events, median of
EXPORT_REPS = 5  # this many calls after a warm-up, at each n
EXPORT_SIZES = (64, 1024)


def cli(argv):
    """``cli.run.main(argv)``, its standard output echoed and returned with
    the seconds it took."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli_main(argv)
    seconds = time.perf_counter() - t0
    text = buf.getvalue()
    for line in text.splitlines():
        say(f"  | {line}")
    return text, seconds


def printed_llh(text: str) -> float:
    """The exact LLH a CLI eval line prints (``(llh <repr>)``)."""
    found = re.findall(r"\(llh (-?[0-9.e+-]+|nan|-?inf)\)", text)
    if len(found) != 1:
        raise AssertionError(f"expected one printed LLH, found {found}")
    return float(found[0])


def logged(log_dir: str, prefix: str, key: str) -> list:
    """``key`` of every ``prefix`` record a run's logger wrote under ``log_dir``."""
    files = glob.glob(os.path.join(log_dir, "*", "metrics.jsonl"))
    if len(files) != 1:
        raise AssertionError(f"{log_dir}: {len(files)} metrics files, not 1")
    with open(files[0]) as f:
        records = [json.loads(line) for line in f]
    return [r[key] for r in records if r["prefix"] == prefix]


def launches_now() -> dict:
    return {**kernel_structure.launch_counts(),
            **{f"mdl_log_prob {p}": n for p, n in mdl_kernel.launches_by_path.items()},
            **{f"mdl_log_prob_backward {p}": n
               for p, n in mdl_kernel.backward_launches_by_path.items()},
            **{f"dl_log_prob {p}": n for p, n in dl_kernel.launches_by_path.items()},
            **{f"dl_log_prob_backward {p}": n
               for p, n in dl_kernel.backward_launches_by_path.items()}}


def launched_since(before: dict) -> dict:
    return {k: n - before[k] for k, n in launches_now().items() if n != before[k]}


def rate(fn, n: int) -> float:
    """imgs/s of ``fn`` making ``n`` images: CUDA events, the median of
    ``EXPORT_REPS`` calls after a warm-up."""
    fn()
    return n / float(np.median([cuda_seconds(fn)[1] for _ in range(EXPORT_REPS)]))


def phase_cli(smi: str) -> dict:
    """Phase 14, the CLI as users start it; see the module docstring. It runs
    in a fresh temporary directory made the working directory, so that the
    CLI's ``./assets/`` lies there. -> the phase's kernel launches by name."""
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    cwd = os.getcwd()
    try:
        with tempfile.TemporaryDirectory() as root:
            os.chdir(root)
            try:
                return _phase_cli(root, smi)
            finally:
                os.chdir(cwd)
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) = flags


def _phase_cli(root: str, smi: str) -> dict:
    data = ["--dataset", "synthetic:svhn_cropped", "--batch-size", str(BATCH)]
    run = data + ["--checkpoint-dir", f"{root}/ckpt"]
    t_phase = time.perf_counter()
    reset_probe_counts()

    # (a) train model05 with EMA, checkpoints, assets and the final eval
    text, train_s = cli(["train", "model05", "--n-updates", "40", "--eval-interval", "20",
                         "--ema", "0.999", "--n-samples", "5000", "--khat", "--k-curve",
                         "--log-dir", f"{root}/tb_a"] + run)
    llh_a = printed_llh(text)
    assets = sorted(os.listdir(f"{root}/assets"))
    if assets != [f"model05_{t}.png" for t in ("inputs", "recon", "samples")]:
        raise AssertionError(f"cli (a): assets {assets}")
    window2 = logged(f"{root}/tb_a", "Perf", "imgs_per_sec")[1]
    cfg = load_config(f"{root}/ckpt/model05/config.json")
    ckpt = Checkpointer(f"{root}/ckpt", "model05")
    best = ckpt.load("best", "cuda")["ema_params"]
    test = make_splits(cfg.data.dataset).test[0]
    model = build_model(cfg.model, torch.Generator().manual_seed(SEED))
    (llh_lib, _, _), eval_s = cuda_seconds(lambda: evaluate_llh(model, cfg, test,
                                                                n_samples=5000, params=best))
    say(f"cli (a): train model05 (40 steps, EMA 0.999) {train_s:.1f} s; window 2 "
        f"{window2:.1f} imgs/s (phase 13's Trainer {TRAIN_RATES.get('model05 trainer')}); "
        f"printed llh {llh_a!r}; evaluate_llh on the best checkpoint's EMA weights "
        f"{llh_lib!r} ({len(test)} images, {len(test) / eval_s:.2f} imgs/s); assets {assets}")
    if llh_a != llh_lib:
        raise AssertionError(f"cli (a): printed llh {llh_a!r} != the library's {llh_lib!r}")
    lib_cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, checkpoint_dir=f"{root}/lib", log_dir=f"{root}/tb_lib"))
    lib = Trainer(lib_cfg).fit(progress=False).state_dict()
    saved = ckpt.load("latest", "cuda")
    same = [saved["step"] == lib["step"] == 40]
    for key in ("params", "opt_state", "ema_params"):
        tree_map(lambda u, v: same.append(torch.equal(u, v)), saved[key], lib[key])
    say(f"cli (a): the CLI's 'latest' equals Trainer(cfg).fit() bit for bit: {all(same)}")
    if not all(same):
        raise AssertionError("cli (a): the CLI's final state differs from the library Trainer's")

    # (b) eval of the best checkpoint's EMA weights; then the bf16 eval
    text, eval_cli_s = cli(["eval", "model05", "--ckpt", "best", "--ema", "0.999",
                            "--n-samples", "5000", "--log-dir", f"{root}/tb_b"] + run)
    llh_b = printed_llh(text)
    if llh_b != llh_a:
        raise AssertionError(f"cli (b): eval printed {llh_b!r}, train {llh_a!r}")
    before = launches_now()
    text, bf16_s = cli(["eval", "model05", "--ckpt", "best", "--ema", "0.999", "--bf16",
                        "--likelihood-io-dtype", "bfloat16", "--n-samples", "5000",
                        "--log-dir", f"{root}/tb_b16"] + run)
    bf16 = launched_since(before)
    if not bf16.get("mdl_log_prob tiled") or bf16.get("mdl_log_prob direct"):
        raise AssertionError(f"cli (b): the bf16 eval launched {bf16}")
    say(f"cli (b): eval printed {llh_b!r} ({eval_cli_s:.1f} s); bf16 eval llh "
        f"{printed_llh(text)!r} ({bf16_s:.1f} s), launches {bf16}")

    # (c) sample and export, no likelihood kernel
    before = launches_now()
    weights = ["--ckpt", "best", "--ema", "0.999", "--log-dir", f"{root}/tb_c"] + run
    cli(["sample", "model05", "--n", "64"] + weights)
    x = torch.as_tensor(test[:64], device="cuda").float() / 255.0
    gen = lambda: torch.Generator(device="cuda").manual_seed(SEED)  # noqa: E731
    live = {"sampler": lambda: make_sampler(model, cfg.model)(best, gen(), 64),
            "reconstructor": lambda: make_reconstructor(model, cfg.model)(best, gen(), x),
            "encoder": lambda: make_encoder_fn(model)(best, gen(), x)}
    exported = {}
    for what in ("sampler", "reconstructor", "encoder"):
        path = f"{root}/model05_{what}.pt2"
        _, export_s = cli(["export", "model05", "--what", what, "--n", "64", "--out", path]
                          + weights)
        t0 = time.perf_counter()
        serve = load_exported(path)
        load_s = time.perf_counter() - t0
        got = serve(gen()) if what == "sampler" else serve(gen(), x)
        want = live[what]()
        if what == "sampler":
            diff = int((got.int() - want.int()).abs().max())
            ok = got.dtype == torch.uint8 and diff == 0
        else:
            pairs = zip(got, want) if what == "encoder" else [(got, want)]
            diff = max(float((a - b).abs().max()) for a, b in pairs)
            ok = diff <= EXPORT_ATOL
        exported[what] = {"export_cli_s": export_s, "load_s": load_s,
                          "pt2_mb": os.path.getsize(path) / 1e6, "max_abs_diff": diff}
        if not ok:
            raise AssertionError(f"cli (c): the exported {what} differs from live by {diff}")
    rates = {}
    for n in EXPORT_SIZES:
        path = f"{root}/sampler_{n}.pt2"
        if n == 64:
            path = f"{root}/model05_sampler.pt2"
        else:
            _, seconds = cli(["export", "model05", "--what", "sampler", "--n", str(n),
                              "--out", path] + weights)
            exported[f"sampler n={n}"] = {"export_cli_s": seconds,
                                          "pt2_mb": os.path.getsize(path) / 1e6}
        serve = load_exported(path)
        sampler = make_sampler(model, cfg.model)
        rates[n] = {"live_imgs_per_sec": rate(lambda: sampler(best, gen(), n), n),
                    "exported_imgs_per_sec": rate(lambda: serve(gen()), n)}
    sampled = launched_since(before)
    say(f"cli (c): sample, export and the loaded programs on {smi}: {exported}; imgs/s "
        f"{rates}; likelihood launches {sampled}")
    if sampled:
        raise AssertionError(f"cli (c): sampling or export launched {sampled}")

    # (d) model03 in bf16 (the DL pair) and model01 (the bias init, Bernoulli)
    losses = {}
    for name, extra in (("model03", ["--bf16"] + data),
                        ("model01", ["--dataset", "synthetic:mnist"])):
        text, _ = cli(["train", name, "--n-updates", "20", "--eval-interval", "10",
                       "--skip-final-eval", "--checkpoint-dir", f"{root}/ckpt_d",
                       "--log-dir", f"{root}/tb_{name}"] + extra)
        losses[name] = logged(f"{root}/tb_{name}", "Train", "loss")
        if not (np.isfinite(losses[name]).all() and losses[name][-1] < losses[name][0]):
            raise AssertionError(f"cli (d): {name} losses {losses[name]}")
        if name == "model01" and "output bias initialised" not in text:
            raise AssertionError("cli (d): model01 trained without its bias init")
    say(f"cli (d): train losses at steps 1 and 11: {losses}")

    # (e) describe on the card: the live model's parameter count, the card's peak
    text, _ = cli(["describe", "model05", "--json"])
    card = json.loads(text)
    n_params = sum(p.numel() for p in model.parameters())
    peak = device_peaks()["float32"]
    if (card["n_params"], card["peak_part"], card["flops_peak"]) != (
            n_params, torch.cuda.get_device_name(0), peak):
        raise AssertionError(f"cli (e): describe gave {card}")

    # (f) the parity rehearsal
    report = f"{root}/parity.json"
    cli(["parity", "model05", "--allow-synthetic", "--n-updates", "20", "--report", report,
         "--checkpoint-dir", f"{root}/ckpt_f", "--log-dir", f"{root}/tb_f"] + data)
    with open(report) as f:
        parity = json.loads(f.read(), parse_constant=lambda token: (_ for _ in ()).throw(
            ValueError(f"non-RFC 8259 token {token}")))
    if set(parity) != PARITY_KEYS or parity["synthetic_rehearsal"] is not True:
        raise AssertionError(f"cli (f): report keys {sorted(parity)}")

    counts = probe_counts()
    counts.update({k: n for k, n in launches_now().items() if " " in k})
    say(f"cli main path: kernel launches {counts}")
    _only({k: n for k, n in counts.items() if " " not in k},
          ("mdl_log_prob", "mdl_log_prob_backward", "dl_log_prob", "dl_log_prob_backward"),
          "the CLI")
    for kernel in ("mdl_log_prob", "mdl_log_prob_backward", "dl_log_prob",
                   "dl_log_prob_backward"):
        if counts[f"{kernel} direct"]:
            raise AssertionError(f"the CLI launched {kernel} on the direct path")
    seconds = time.perf_counter() - t_phase
    say("cli: " + json.dumps({
        "card": smi, "seconds": seconds,
        "train_imgs_per_sec_window2": window2,
        "trainer_imgs_per_sec_window2_phase13": TRAIN_RATES.get("model05 trainer"),
        "train_cli_s": train_s, "llh": llh_a, "llh_library": llh_lib,
        "eval_imgs_per_sec": len(test) / eval_s, "eval_images": len(test),
        "eval_cli_s": eval_cli_s, "eval_bf16_cli_s": bf16_s, "export": exported,
        "sampler_rates": rates, "describe_ceiling_imgs_per_sec": card["ceiling_imgs_per_sec"],
        "parity_status": parity["status"], "losses": losses,
        "launches": {k: n for k, n in counts.items() if n and k.startswith(("mdl", "dl"))},
    }))
    return counts


# -- phase 15: the parallel paths -----------------------------------------------------

# One rank against one rank on the same rows and noise under cuDNN's
# deterministic flags runs the same operations: the one-rank data-parallel
# and ZeRO-1 steps add only an all-reduce (or a reduce-scatter and an
# all-gather) of one rank, and ZeRO-1's optimizer runs the same element-wise
# arithmetic on the flat vector. Held per element within PARALLEL_RTOL
# (measured bit-equal on the H100).
PARALLEL_RTOL = 1e-6
# Two ranks of 64 rows against one rank of 128 on the same noise: the mean of
# two per-rank float32 sums against one sum. The loss within SUM_RTOL; each
# first moment (0.1 g after one step) within GRAD_RTOL of the one-rank step's
# in norm, each second moment (1e-3 g^2) within 2 GRAD_RTOL; each parameter
# within 2 lr: a first Adam step moves an element by lr g / (|g| + eps),
# whose sign can differ where g is ~0; and TWO_RANK_PARAM_SHARE of all the
# elements within TWO_RANK_PARAM_CLOSE (measured at most 4.8e-6), so that a
# step that moved no parameter, by lr each, fails.
TWO_RANK_PARAM_ATOL = 2e-3
TWO_RANK_PARAM_CLOSE = 1e-5
TWO_RANK_PARAM_SHARE = 0.99
# The tensor-parallel step's moments within TP_GRAD_RTOL a leaf in norm (nu
# within twice it): at four ranks model05's decoder.conv_1, a transposed
# conv, runs on 16 of its 64 output channels, and cuDNN's input gradient for
# that shape sits 1.4e-4 from float64 against 2.4e-7 at 32 channels
# (probes/tp_precision.py on the H100); every leaf upstream of it carries
# that (2.2e-4 at four ranks, 1.2e-6 at two). A gather whose backward sums
# is off by the rank count, an input gradient not summed by far more.
TP_GRAD_RTOL = 1e-3
PARALLEL_EVAL_IMAGES = 256
PARALLEL_CHILD_TIMEOUT = 300


def _cpu_tree(tree):
    return tree_map(lambda t: t.detach().cpu().clone(), tree)


def _step_outcome(state, metrics, opt_state=None):
    """(loss, params, Adam mu and nu by parameter name) on the host."""
    from vae_mdl_tpu_torch.parallel.spmd import FLAT

    opt = state.opt_state if opt_state is None else opt_state
    mu, nu = opt["mu"], opt["nu"]
    if set(mu) == {FLAT}:  # ZeRO-1's whole flat moments, unflattened
        sizes = [p.numel() for p in state.params.values()]
        n = sum(sizes)

        def unflat(flat):
            return {name: part.view_as(p) for (name, p), part in
                    zip(state.params.items(), flat[FLAT][:n].split(sizes))}

        mu, nu = unflat(mu), unflat(nu)
    return (float(metrics["loss"]), _cpu_tree(dict(state.params)), _cpu_tree(mu),
            _cpu_tree(nu))


def _max_rel(a: dict, b: dict) -> float:
    return max(float(((a[n] - b[n]).abs() / b[n].abs().clamp(min=1e-30)).max()) for n in b)


def _leaf_norm_rel(a: dict, b: dict) -> float:
    return max(_leaf_norm_rels(a, b).values())


def _leaf_norm_rels(a: dict, b: dict) -> dict:
    return {n: float((a[n] - b[n]).norm() / b[n].norm().clamp(min=1e-30)) for n in b}


def _deterministic(fn, *args):
    """``fn(*args)`` under phase 13's cuDNN flags, put back after."""
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return fn(*args)
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) = flags


def _parallel_trainer(kind: str, mesh):
    """model05's seeded state and its step of ``kind`` ("plain", "dp" or
    "zero1"; ZeRO-1's state holds this rank's flat moments) -> (state,
    step, multi): ``step(state, batch, eps=None)`` is one step,
    ``multi(state, batches)`` one step a batch."""
    from vae_mdl_tpu_torch.parallel.spmd import (
        make_shard_map_train_step, make_zero1_train_step, zero1_opt_state)

    cfg = experiment("model05")
    model = seeded_model(cfg.model)
    tx = make_optimizer(cfg.train)
    state = create_train_state(model, cfg.train)
    if kind == "plain":
        return (state, make_train_step(model, cfg, tx),
                make_multi_train_step(model, cfg, tx, TRAIN_STEPS_PER_CALL))
    if kind == "dp":
        return (state, make_shard_map_train_step(model, cfg, tx, mesh),
                make_multi_train_step(model, cfg, tx, TRAIN_STEPS_PER_CALL, mesh=mesh))
    state.opt_state = zero1_opt_state(tx, state.params, mesh)
    step = make_zero1_train_step(model, cfg, tx, mesh)

    def multi(state, batches):
        for b in batches:
            state, metrics = step(state, b)
        return state, metrics

    return state, step, multi


def _parallel_steps(mesh, batch, eps, rows=None):
    """One step each of the plain step (on every row; where ``rows`` is
    given, skipped), the data-parallel step and ZeRO-1 (on ``rows``, the
    batch's by default) from model05's seeded state, with ``eps`` (the whole
    batch's noise) injected. -> {kind: _step_outcome}."""
    from vae_mdl_tpu_torch.parallel.spmd import gather_zero1_opt_state

    out = {}
    for kind in ("dp", "zero1") if rows is not None else ("plain", "dp", "zero1"):
        state, step, _ = _parallel_trainer(kind, mesh)
        state, metrics = step(state, batch if rows is None else rows, eps=eps)
        out[kind] = _step_outcome(state, metrics, gather_zero1_opt_state(state.opt_state)
                                  if kind == "zero1" else None)
    return out


def _tp_step(batch, eps):
    """One step of model05 in the tensor-parallel layout over every rank
    (``make_tp_mesh(1, world)``) on all of ``batch``, ``eps`` injected ->
    (_step_outcome of the whole state, the names of the sharded parameters)."""
    from vae_mdl_tpu_torch.parallel.distributed import process_count
    from vae_mdl_tpu_torch.parallel.tensor import make_tp_mesh, shard_state_tp
    from vae_mdl_tpu_torch.train.checkpoint import whole_state_dict

    cfg = experiment("model05")
    model = seeded_model(cfg.model)
    tx = make_optimizer(cfg.train)
    state = shard_state_tp(create_train_state(model, cfg.train),
                           make_tp_mesh(1, process_count()), model=model)
    state, metrics = make_train_step(model, cfg, tx)(state, batch, eps=eps)
    whole = whole_state_dict(state)
    opt = whole["opt_state"]
    return ((float(metrics["loss"]), _cpu_tree(whole["params"]), _cpu_tree(opt["mu"]),
             _cpu_tree(opt["nu"])), sorted(state.tp_layout.dims))


def parallel_child(rank: int, world: int, store: str, out_dir: str, backend: str) -> None:
    """One rank of phase 15 (b): the data-parallel and ZeRO-1 steps on this
    rank's rows, the tensor-parallel step on all of them, then
    ``evaluate_llh`` striped over the ranks; writes
    ``out_dir/rank<r>.pt``."""
    from vae_mdl_tpu_torch.config import MeshConfig
    from vae_mdl_tpu_torch.parallel.distributed import init_distributed
    from vae_mdl_tpu_torch.parallel.mesh import make_mesh, shard_batch

    init_distributed(f"file://{store}", world, rank, backend=backend, timeout=240)
    try:
        # phase_device's flags: the float32 config means float32 convolutions
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        mesh = make_mesh(MeshConfig())
        cfg = experiment("model05")
        batch = torch.as_tensor(images(BATCH), device="cuda")
        eps = seeded_noise(cfg.model)[0]
        reset_probe_counts()
        steps = _deterministic(_parallel_steps, mesh, batch, eps, shard_batch(mesh, batch))
        step_counts = {**probe_counts(), "tiled": dict(mdl_kernel.launches_by_path),
                       "backward tiled": dict(mdl_kernel.backward_launches_by_path)}
        reset_probe_counts()
        tp = _deterministic(_tp_step, batch, eps)
        tp_counts = {**probe_counts(), "tiled": dict(mdl_kernel.launches_by_path),
                     "backward tiled": dict(mdl_kernel.backward_launches_by_path)}
        model = seeded_model(cfg.model)
        _deterministic(_warm_eval, model, cfg)
        reset_probe_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, per_image, metrics = _deterministic(
            evaluate_llh, model, cfg, images(PARALLEL_EVAL_IMAGES), 5000, 100, BATCH, SEED)
        seconds = time.perf_counter() - t0
        eval_counts = {**probe_counts(), "tiled": dict(mdl_kernel.launches_by_path)}
        rates = _rank_rates(mesh) if "nccl" in backend else None
        torch.save({"steps": steps, "step_counts": step_counts, "tp": tp,
                    "tp_counts": tp_counts, "per_image": per_image,
                    "local_batches": metrics["local_batches"], "eval_seconds": seconds,
                    "eval_counts": eval_counts, "device": torch.cuda.current_device(),
                    "rates": rates},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


def _warm_eval(model, cfg) -> None:
    """Two k-chunks of the evaluator on one batch, outside any process
    group's striping: a fresh process's first launches at the eval's shapes
    (cuDNN's choices, the kernels' loading) stay out of the timed run."""
    make_batch_evaluator(model, cfg, 200, 100)(
        torch.as_tensor(images(BATCH), device="cuda"),
        torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()


def _rank_rates(mesh) -> dict:
    """Data-parallel and ZeRO-1 training of model05 with a batch of 128 on
    every rank (the global batch 128 x ranks), 10 steps a call: this rank's
    median ms of 5 calls after a warm-up, by CUDA events."""
    pool = train_pool()
    out = {}
    for kind in ("dp", "zero1"):
        state, _, multi = _parallel_trainer(kind, mesh)
        ms = []
        for call in range(TRAIN_BLOCKS + 1):
            (state, _), seconds = cuda_seconds(lambda: multi(state, pool))
            if call:
                ms.append(seconds * 1e3)
        out[kind] = float(np.median(ms))
    return out


def spawn_ranks(world: int, backend: str, work: str, task: str = "parallel",
                files: str = "") -> list:
    """``world`` processes of this script, each one rank of ``backend``'s
    group (gloo: all on card 0; with NCCL: one card each) running ``task``
    (phase 15's "parallel", phase 16's "export" or "serve" of the
    programs in ``files``, or phase 19's "mesh_capture"); every process is
    waited for or killed. -> their outputs in rank order."""
    os.makedirs(work, exist_ok=True)
    store = os.path.join(work, "store")
    procs = []
    try:
        for rank in range(world):
            env = {k: v for k, v in os.environ.items()
                   if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
            env["LOCAL_RANK"] = "0" if backend == "gloo" else str(rank)
            with open(os.path.join(work, f"rank{rank}.log"), "w") as log:
                procs.append(subprocess.Popen(
                    ["python3", os.path.abspath(__file__), "--rank", str(rank), "--world",
                     str(world), "--store", store, "--out", work, "--backend", backend,
                     "--task", task, "--files", files],
                    env=env, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + PARALLEL_CHILD_TIMEOUT
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = []
    for rank in range(len(procs)):
        with open(os.path.join(work, f"rank{rank}.log")) as log:
            logs.append(log.read())
    for rank, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"{task}: rank {rank} of {world} ({backend}) failed (exit "
                                 f"{p.returncode}; killed after {PARALLEL_CHILD_TIMEOUT} s if "
                                 f"negative):\n{log[-6000:]}")
    return [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _check_tiled(counts: dict, backward: bool, what: str) -> None:
    _took(counts["tiled"], "tiled", f"{what}'s MoDL forward")
    if backward:
        _took(counts["backward tiled"], "tiled", f"{what}'s MoDL backward")


def _two_rank_check(ranks: list, one: dict, what: str) -> dict:
    """Each rank's data-parallel, ZeRO-1 and tensor-parallel step against
    the one-rank data-parallel step on all rows; the ranks' parameters
    bit-equal."""
    report = {}
    for kind in ("dp", "zero1", "tp"):
        got = [out["tp"][0] if kind == "tp" else out["steps"][kind] for out in ranks]
        loss, params, mu, nu = got[0]
        want_loss, want_params, want_mu, want_nu = one["dp"]
        for other in got[1:]:
            if any(not torch.equal(other[1][n], params[n]) for n in params):
                raise AssertionError(f"{what} {kind}: the ranks' parameters differ")
        loss_rel = abs(loss - want_loss) / abs(want_loss)
        diff = torch.cat([(params[n] - want_params[n]).abs().flatten() for n in params])
        param_abs = float(diff.max())
        close = float((diff <= TWO_RANK_PARAM_CLOSE).float().mean())
        mu_rels = _leaf_norm_rels(mu, want_mu)
        mu_rel, nu_rel = max(mu_rels.values()), _leaf_norm_rel(nu, want_nu)
        report[kind] = {"loss_rel": loss_rel, "param_max_abs": param_abs,
                        "param_share_close": close,
                        "mu_leaf_norm_rel": mu_rel, "nu_leaf_norm_rel": nu_rel,
                        "mu_worst_leaf": max(mu_rels, key=mu_rels.get)}
        grad_rtol = TP_GRAD_RTOL if kind == "tp" else GRAD_RTOL
        if (loss_rel > SUM_RTOL or param_abs > TWO_RANK_PARAM_ATOL
                or close < TWO_RANK_PARAM_SHARE or mu_rel > grad_rtol
                or nu_rel > 2 * grad_rtol):
            raise AssertionError(f"{what} {kind} against the one-rank step: {report[kind]}")
    report["tp"]["sharded"] = ranks[0]["tp"][1]
    return report


def phase_parallel(smi: str):
    """Phase 15, the parallel paths; see the module docstring. -> {path: kernel
    launches}."""
    import torch.distributed as dist

    from vae_mdl_tpu_torch.parallel.distributed import init_distributed

    with tempfile.TemporaryDirectory() as root:
        init_distributed(f"file://{root}/store", world_size=1, rank=0)
        try:
            return _phase_parallel(root, smi)
        finally:
            dist.destroy_process_group()


def _phase_parallel(root: str, smi: str) -> dict:
    from vae_mdl_tpu_torch.config import MeshConfig
    from vae_mdl_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(MeshConfig())
    by_path, report = {}, {"card": smi, "backend_world_of_one": str(
        torch.distributed.get_backend())}
    cfg = experiment("model05")
    batch = torch.as_tensor(images(BATCH), device="cuda")
    eps = seeded_noise(cfg.model)[0]

    # (a) a world of one over NCCL: the three steps agree
    one = _deterministic(_parallel_steps, mesh, batch, eps)
    worst = {}
    for kind in ("dp", "zero1"):
        loss, params, mu, nu = one[kind]
        want = one["plain"]
        worst[kind] = {"loss_rel": abs(loss - want[0]) / abs(want[0]),
                       "params": _max_rel(params, want[1]), "mu": _max_rel(mu, want[2]),
                       "nu": _max_rel(nu, want[3])}
        if max(worst[kind].values()) > PARALLEL_RTOL:
            raise AssertionError(f"parallel (a): the one-rank {kind} step against the plain "
                                 f"step: {worst[kind]}")
    say(f"parallel (a): one rank over {report['backend_world_of_one']}: the data-parallel "
        f"and ZeRO-1 steps against make_train_step, largest relative differences {worst} "
        f"(tolerance {PARALLEL_RTOL})")
    report["world_of_one_max_rel"] = worst

    # (a) rates: 10 steps a call of each step, in turns, every count set to 0
    # just before each call and read just after
    pool = train_pool()
    steps, states, totals = {}, {}, {}
    for kind in ("plain", "dp", "zero1"):
        states[kind], _, steps[kind] = _parallel_trainer(kind, mesh)
    block_ms = {kind: [] for kind in steps}
    peak = {}
    first, last = {}, {}
    for block in range(TRAIN_BLOCKS + 1):
        order = list(steps) if block % 2 == 0 else list(reversed(steps))
        for kind in order:
            reset_probe_counts()
            torch.cuda.reset_peak_memory_stats()
            (states[kind], metrics), seconds = cuda_seconds(
                lambda kind=kind: steps[kind](states[kind], pool))
            counts = probe_counts()
            counts["tiled"] = dict(mdl_kernel.launches_by_path)
            counts["backward tiled"] = dict(mdl_kernel.backward_launches_by_path)
            _check_tiled(counts, True, f"parallel (a) {kind}")
            if kind != "plain":
                total = totals.setdefault(kind, {})
                for name, n in counts.items():
                    if isinstance(n, int):
                        total[name] = total.get(name, 0) + n
                total["mdl_log_prob tiled"] = total.get("mdl_log_prob tiled", 0) + \
                    counts["tiled"]["tiled"]
            if block == 0:
                first[kind] = float(metrics["loss"])
                continue
            block_ms[kind].append(seconds * 1e3)
            peak[kind] = max(peak.get(kind, 0.0), torch.cuda.max_memory_allocated() / 2**30)
            last[kind] = float(metrics["loss"])
    rates = {kind: TRAIN_STEPS_PER_CALL * BATCH / (float(np.median(ms)) / 1e3)
             for kind, ms in block_ms.items()}
    for kind in rates:
        if not (np.isfinite(first[kind]) and np.isfinite(last[kind])) or last[kind] >= first[kind]:
            raise AssertionError(f"parallel (a) {kind}: loss {first[kind]} -> {last[kind]}")
    for kind in ("dp", "zero1"):
        _only(totals[kind], ("mdl_log_prob", "mdl_log_prob_backward", "mdl_log_prob tiled"),
              f"the model05 {kind} path")
        by_path[f"model05 {kind}"] = totals[kind]
    report.update({
        "imgs_per_sec": rates, "peak_gib": peak,
        "gap_vs_plain": {k: 1.0 - rates[k] / rates["plain"] for k in ("dp", "zero1")},
        "block_ms": block_ms, "loss_first_last": {k: (first[k], last[k]) for k in rates}})
    say(f"parallel (a): imgs/s (median of {TRAIN_BLOCKS} calls of {TRAIN_STEPS_PER_CALL} steps, "
        f"in turns) {rates}; peak GiB {peak}; on {smi}")

    # the sharded 5000-IS evaluator at a world of one: the reference for (b)
    model = seeded_model(cfg.model)
    _deterministic(_warm_eval, model, cfg)
    reset_probe_counts()
    images_eval = images(PARALLEL_EVAL_IMAGES)
    (llh, per_image, _), seconds = _deterministic(cuda_seconds, lambda: evaluate_llh(
        model, cfg, images_eval, n_samples=5000, k_chunk=100, batch_size=BATCH, seed=SEED,
        mesh=mesh))
    counts = {**probe_counts(), "tiled": dict(mdl_kernel.launches_by_path)}
    _check_tiled(counts, False, "the sharded evaluator")
    counts["mdl_log_prob tiled"] = counts.pop("tiled")["tiled"]
    _only(counts, ("mdl_log_prob", "mdl_log_prob tiled"), "the sharded evaluator")
    by_path["model05 sharded eval"] = counts
    report["sharded_eval_one_rank"] = {"llh": llh, "imgs_per_sec": PARALLEL_EVAL_IMAGES / seconds}

    # (b) two processes on the one card over gloo on CUDA tensors; they share
    # it, so this process's graphs (the evaluation's holds a batch's peak) go
    # first
    clear_cache(model)
    del steps, states
    gc.collect()
    torch.cuda.empty_cache()
    report["two_process_backend"] = "gloo (NCCL takes one rank a card)"
    say("parallel (b): two ranks on card 0 over gloo, which takes CUDA tensors; NCCL refuses "
        "two ranks on one device")
    ranks = spawn_ranks(2, "gloo", os.path.join(root, "gloo2"))
    for r, out in enumerate(ranks):
        _check_tiled(out["step_counts"], True, f"parallel (b) rank {r}'s steps")
        _check_tiled(out["tp_counts"], True, f"parallel (b) rank {r}'s tensor-parallel step")
        _check_tiled(out["eval_counts"], False, f"parallel (b) rank {r}'s striped evaluation")
    report["two_process_vs_one_rank"] = _two_rank_check(ranks, one, "parallel (b)")
    tp_counts = {}
    for out in ranks:
        for name, n in out["tp_counts"].items():
            if isinstance(n, int):
                tp_counts[name] = tp_counts.get(name, 0) + n
        tp_counts["mdl_log_prob tiled"] = tp_counts.get("mdl_log_prob tiled", 0) + \
            out["tp_counts"]["tiled"]["tiled"]
    _only(tp_counts, ("mdl_log_prob", "mdl_log_prob_backward", "mdl_log_prob tiled"),
          "the tensor-parallel step")
    by_path["model05 tp"] = tp_counts
    for r, out in enumerate(ranks):
        if not np.array_equal(out["per_image"], per_image):
            diff = float(np.max(np.abs(out["per_image"] - per_image)))
            raise AssertionError(f"parallel (b): rank {r}'s striped per-image LLH differs from "
                                 f"one process's by up to {diff}")
    if sorted(out["local_batches"] for out in ranks) != [1, 1]:
        raise AssertionError("parallel (b): the striped evaluation did not split its batches")
    striped = {}
    for out in ranks:
        for name, n in out["eval_counts"].items():
            if isinstance(n, int):
                striped[name] = striped.get(name, 0) + n
        striped["mdl_log_prob tiled"] = striped.get("mdl_log_prob tiled", 0) + \
            out["eval_counts"]["tiled"]["tiled"]
    _only(striped, ("mdl_log_prob", "mdl_log_prob tiled"), "the striped evaluation")
    by_path["model05 striped eval"] = striped
    report["striped_eval"] = {"per_image_bit_equal": True,
                              "rank_seconds": [out["eval_seconds"] for out in ranks],
                              "one_rank_seconds": seconds}
    say(f"parallel (b): two gloo ranks against one rank: {report['two_process_vs_one_rank']}; "
        f"the striped 5000-IS per-image LLH of {PARALLEL_EVAL_IMAGES} images bit-equal to one "
        f"process's (llh {llh!r}); rank seconds {report['striped_eval']['rank_seconds']}, one "
        f"rank {seconds:.2f} s")
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        world = min(n_cards, 4)
        # the library's own backend: NCCL for the card's tensors, gloo for
        # the evaluation's host tensors
        nccl = spawn_ranks(world, "cpu:gloo,cuda:nccl", os.path.join(root, f"nccl{world}"))
        report[f"nccl_{world}_vs_one_rank"] = _two_rank_check(nccl, one,
                                                              f"parallel (b) nccl x{world}")
        for r, out in enumerate(nccl):
            _check_tiled(out["step_counts"], True, f"parallel (b) nccl rank {r}'s steps")
            _check_tiled(out["tp_counts"], True, f"parallel (b) nccl rank {r}'s TP step")
            if not np.array_equal(out["per_image"], per_image):
                raise AssertionError(f"parallel (b): nccl rank {r}'s striped per-image LLH "
                                     "differs from one process's")
        slowest = {kind: max(out["rates"][kind] for out in nccl) for kind in ("dp", "zero1")}
        report[f"nccl_{world}_imgs_per_sec"] = {
            kind: world * TRAIN_STEPS_PER_CALL * BATCH / (ms / 1e3)
            for kind, ms in slowest.items()}
        report[f"nccl_{world}_eval_seconds"] = [out["eval_seconds"] for out in nccl]
        say(f"parallel (b): {world} ranks over NCCL, one card each, batch {BATCH} a rank: "
            f"{report[f'nccl_{world}_imgs_per_sec']} imgs/s (the slowest rank's median); "
            f"one card's plain step {rates['plain']:.1f}; striped eval seconds a rank "
            f"{report[f'nccl_{world}_eval_seconds']}")
    else:
        say("parallel (b): one card, so (a)'s checks at a world of several over NCCL do not run")

    # (c) Trainer(cfg, mesh=...) at a world of one: 20 steps with EMA, checkpointed,
    # and a resume that restores the state exactly
    by_path["model05 mesh trainer"], report["trainer"] = _deterministic(
        _mesh_trainer, root, make_mesh(MeshConfig()))
    say("parallel: " + json.dumps(report))
    return by_path


def _mesh_trainer(root, mesh):
    base = trainer_config(f"{root}/trainer", n_updates=20)
    cfg = dataclasses.replace(base, train=dataclasses.replace(
        base.train, eval_interval=10, snapshot_interval=0, report_images=False))
    reset_probe_counts()
    trainer = Trainer(cfg, mesh=mesh)
    losses = []
    step = trainer.train_step

    def recording(state, batch):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        return state, metrics

    trainer.train_step = recording
    t0 = time.perf_counter()
    state = trainer.fit(progress=False)
    seconds = time.perf_counter() - t0
    counts = {**probe_counts(), "tiled": dict(mdl_kernel.launches_by_path),
              "backward tiled": dict(mdl_kernel.backward_launches_by_path)}
    _check_tiled(counts, True, "the mesh trainer")
    counts["mdl_log_prob tiled"] = counts.pop("tiled")["tiled"]
    counts.pop("backward tiled")
    _only(counts, ("mdl_log_prob", "mdl_log_prob_backward", "mdl_log_prob tiled"),
          "the mesh trainer")
    head, tail = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if len(losses) != 20 or not np.isfinite(losses).all() or tail >= head:
        raise AssertionError(f"parallel (c): losses {losses} are not finite and falling")
    resumed = Trainer(cfg, mesh=mesh)
    exact = states_equal(resumed.state, state)
    if not exact:
        raise AssertionError(f"parallel (c): the resume differs: "
                             f"{first_difference(resumed.state, state)}")
    report = {"steps": state.step, "seconds": seconds, "loss_first5_last5": (head, tail),
              "best_val_loss": state.best_val_loss, "resume_bit_equal": exact}
    say(f"parallel (c): Trainer(cfg, mesh=make_mesh(...)) model05 f32, 20 steps with EMA: "
        f"loss {head:.4f} (first 5) -> {tail:.4f} (last 5), best {state.best_val_loss:.4f}, "
        f"{seconds:.1f} s; the resumed Trainer's state equals it bit for bit")
    return counts, report


# phase 16, sharded serving: model05's sampler at SERVE_N images, its
# reconstructor and encoder at a batch of BATCH
SERVE_N = 1024
SERVE_WHATS = ("sampler", "reconstructor", "encoder")
# the sharded programs of several ranks against the single-device one on the
# same seed: a shard runs its convolutions at a smaller batch, where cuDNN may
# pick another algorithm and move a float32 value by a few ulps; floats within
# rtol = atol = SERVE_TOL (the JAX package's sharded export test), the
# sampler's uint8 images equal but for one level on at most SERVE_PIXEL_SHARE
# of the pixels
SERVE_TOL = 1e-5
SERVE_PIXEL_SHARE = 1e-3
SERVE_REPS = 5


def _export_programs(model, cfg, params, root: str, mesh) -> dict:
    """model05's three programs exported into ``root`` (sharded over
    ``mesh`` where given) -> {what: (path, export seconds)}."""
    from vae_mdl_tpu_torch.models.export import (
        export_encoder,
        export_reconstructor,
        export_sampler,
    )

    os.makedirs(root, exist_ok=True)
    out = {}
    for what in SERVE_WHATS:
        path = os.path.join(root, f"{what}.pt2")
        t0 = time.perf_counter()
        if what == "sampler":
            export_sampler(model, cfg, params, n=SERVE_N, path=path, mesh=mesh)
        else:
            fn = export_encoder if what == "encoder" else export_reconstructor
            fn(model, cfg, params, (BATCH,) + tuple(cfg.image_shape), path=path, mesh=mesh)
        out[what] = (path, time.perf_counter() - t0)
    return out


def _serve(serve, what: str):
    """One call of a loaded program on ``SEED`` (and the seeded images);
    the output on the host, a tuple for the encoder."""
    x = images(BATCH).astype(np.float32) / 255.0
    got = serve(SEED) if what == "sampler" else serve(SEED, x)
    got = tuple(got) if isinstance(got, (tuple, list)) else (got,)
    return tuple(t.cpu() for t in got)


def _serve_all(files: dict) -> tuple:
    """Each program of ``files`` loaded and run once under phase 13's cuDNN
    flags -> ({what: output}, {what: load seconds})."""
    outs, load_s = {}, {}
    for what, (path, _) in files.items():
        t0 = time.perf_counter()
        serve = load_exported(path)
        load_s[what] = time.perf_counter() - t0
        outs[what] = _deterministic(_serve, serve, what)
    return outs, load_s


def serving_child(task: str, rank: int, world: int, store: str, out_dir: str, backend: str,
                  files: str) -> None:
    """One rank of phase 16 (b): ``task`` "export" exports the three
    programs sharded over the ranks into ``files``; "serve" loads them in
    this fresh process and runs each. Writes ``out_dir/rank<r>.pt``."""
    from vae_mdl_tpu_torch.config import MeshConfig
    from vae_mdl_tpu_torch.parallel.distributed import init_distributed
    from vae_mdl_tpu_torch.parallel.mesh import make_mesh

    init_distributed(f"file://{store}", world, rank, backend=backend, timeout=240)
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        if task == "export":
            cfg = MODELS["model05"]
            model = seeded_model(cfg)
            params = {n: p.detach() for n, p in model.named_parameters()}
            out = _export_programs(model, cfg, params, files, make_mesh(MeshConfig()))
        else:
            outs, load_s = _serve_all({what: (os.path.join(files, f"{what}.pt2"), 0.0)
                                       for what in SERVE_WHATS})
            out = {"outputs": outs, "load_s": load_s, "device": torch.cuda.current_device()}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


def _serving_gap(got: tuple, want: tuple, what: str) -> dict:
    """How far a sharded program's output is from the single-device one's;
    raises past the limits."""
    if what == "sampler":
        diff = (got[0].int() - want[0].int()).abs()
        gap = {"max_levels": int(diff.max()), "pixel_share": float((diff > 0).float().mean())}
        if got[0].dtype != torch.uint8 or got[0].shape != want[0].shape or \
                gap["max_levels"] > 1 or gap["pixel_share"] > SERVE_PIXEL_SHARE:
            raise AssertionError(f"sharded serving: the sampler's images differ: {gap}")
        return gap
    if len(got) != len(want) or any(a.shape != b.shape for a, b in zip(got, want)):
        raise AssertionError(f"sharded serving: the {what}'s outputs have other shapes")
    excess = max(float(((a - b).abs() - SERVE_TOL - SERVE_TOL * b.abs()).max())
                 for a, b in zip(got, want))
    gap = {"max_abs": max(float((a - b).abs().max()) for a, b in zip(got, want)),
           "tolerance_excess": excess}
    if excess > 0:
        raise AssertionError(f"sharded serving: the {what} differs: {gap}")
    return gap


def _ranks_serving(world: int, backend: str, root: str, want: dict) -> dict:
    """Phase 16 (b): ``world`` ranks export the programs, ``world`` fresh
    ones serve them; each rank's outputs against ``want`` (the single-device
    program's), and the ranks' outputs bit-equal to each other."""
    files = os.path.join(root, "files")
    t0 = time.perf_counter()
    exported = spawn_ranks(world, backend, os.path.join(root, "export"), "export", files)
    export_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    served = spawn_ranks(world, backend, os.path.join(root, "serve"), "serve", files)
    serve_wall = time.perf_counter() - t0
    gaps = {}
    for what in SERVE_WHATS:
        outs = [rank["outputs"][what] for rank in served]
        for r, out in enumerate(outs[1:], 1):
            if not all(torch.equal(a, b) for a, b in zip(out, outs[0])):
                raise AssertionError(f"sharded serving: rank {r}'s {what} differs from rank 0's")
        gaps[what] = _serving_gap(outs[0], want[what], what)
    return {"gaps": gaps, "ranks_bit_equal": True,
            "devices": [rank["device"] for rank in served],
            "export_s": {w: [rank[w][1] for rank in exported] for w in SERVE_WHATS},
            "load_s": [rank["load_s"] for rank in served],
            "export_wall_s": export_wall, "serve_wall_s": serve_wall}


def phase_export_mesh(smi: str) -> dict:
    """Phase 16, sharded serving; see the module docstring."""
    import torch.distributed as dist

    from vae_mdl_tpu_torch.parallel.distributed import init_distributed

    with tempfile.TemporaryDirectory() as root:
        init_distributed(f"file://{root}/store", world_size=1, rank=0)
        try:
            return _phase_export_mesh(root, smi)
        finally:
            dist.destroy_process_group()


def _phase_export_mesh(root: str, smi: str) -> dict:
    from vae_mdl_tpu_torch.config import MeshConfig
    from vae_mdl_tpu_torch.parallel.mesh import make_mesh

    before = launches_now()
    cfg = MODELS["model05"]
    model = seeded_model(cfg)
    params = {n: p.detach() for n, p in model.named_parameters()}
    report = {"card": smi, "backend_world_of_one": str(torch.distributed.get_backend()),
              "sampler_n": SERVE_N, "batch": BATCH}

    # (a) a world of one over NCCL: the sharded programs against the
    # single-device ones, bit for bit, and the sampler's rate in turns
    files = {"single": _export_programs(model, cfg, params, f"{root}/single", None),
             "sharded": _export_programs(model, cfg, params, f"{root}/sharded",
                                         make_mesh(MeshConfig()))}
    outs, load_s = {}, {}
    for kind, progs in files.items():
        outs[kind], load_s[kind] = _serve_all(progs)
    for what in SERVE_WHATS:
        if not all(torch.equal(a, b) for a, b in zip(outs["sharded"][what],
                                                     outs["single"][what])):
            raise AssertionError(f"sharded serving (a): the world-of-one {what} is not "
                                 "bit-equal to the single-device program")
    serves = {kind: load_exported(files[kind]["sampler"][0]) for kind in files}
    ms = {kind: [] for kind in serves}
    for rep in range(SERVE_REPS + 1):
        for kind in (list(serves) if rep % 2 == 0 else list(reversed(serves))):
            _, seconds = cuda_seconds(lambda kind=kind: serves[kind](SEED))
            if rep:
                ms[kind].append(seconds * 1e3)
    report["world_of_one"] = {
        "bit_equal": True,
        "sampler_imgs_per_sec": {k: SERVE_N / (float(np.median(v)) / 1e3) for k, v in ms.items()},
        "sampler_ms": ms,
        "export_s": {k: {w: f[1] for w, f in progs.items()} for k, progs in files.items()},
        "load_s": load_s,
        "pt2_mb": {k: {w: os.path.getsize(f[0]) / 1e6 for w, f in progs.items()}
                   for k, progs in files.items()}}
    say(f"sharded serving (a): a world of one over {report['backend_world_of_one']}: the "
        f"sharded sampler (n = {SERVE_N}), reconstructor and encoder (batch {BATCH}) bit-equal "
        f"to the single-device programs; sampler imgs/s in turns "
        f"{report['world_of_one']['sampler_imgs_per_sec']}; on {smi}")

    # (b) two ranks on the one card over gloo: exported on both, served in
    # fresh processes, against (a)'s single-device outputs
    report["two_gloo_ranks"] = _ranks_serving(2, "gloo", f"{root}/gloo2", outs["single"])
    say(f"sharded serving (b): two gloo ranks on card 0, exported and served in fresh "
        f"processes, against the single-device programs: {report['two_gloo_ranks']['gaps']}")
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        world = min(n_cards, 4)
        report[f"nccl_{world}"] = _ranks_serving(world, "cpu:gloo,cuda:nccl",
                                                 f"{root}/nccl{world}", outs["single"])
        say(f"sharded serving (b): {world} ranks over NCCL, one card each: "
            f"{report[f'nccl_{world}']['gaps']}")
    launched = launched_since(before)
    if launched:
        raise AssertionError(f"sharded serving launched likelihood kernels: {launched}")
    say("export_mesh: " + json.dumps(report))
    return report


# -- phase 17: the measurement entry points ------------------------------------

# The MoDL forward's shapes that the bench and the probes launch and the
# earlier phases do not: (k, batch, boundary) on model05's own head output,
# bf16 body. bf16: the bench's eval and its k-chunk sweep; float32: the eval
# grid, the k-hat probe and kernel_bench, perf_probe.
MEASURE_SHAPES = ((200, 128, "bfloat16"), (50, 128, "bfloat16"), (250, 128, "bfloat16"),
                  (100, 100, "float32"), (250, 100, "float32"), (100, 250, "float32"),
                  (250, 250, "float32"), (100, 500, "float32"), (100, 25, "float32"))
# images the plain version takes at once (phase 4's eval case: 100 x 128)
PLAIN_IMAGES = 12800
# samples a smoke eval of the probes draws: a cut in depth (the k-chunks keep
# the probes' shapes); the bench runs at its own 5000
PROBE_SAMPLES = 1000
# the eval grid's points this phase runs (batch, k-chunk): those that fit
GRID_POINTS = ((100, 100), (100, 250), (250, 100), (250, 250), (500, 100))
BENCH_TIMEOUT = 600


def measure_shape(k: int, batch_size: int, boundary: str) -> dict:
    """The MoDL forward on model05's head output at (k, batch) against the
    plain version over slices of the samples, timed and bounded."""
    from vae_mdl_tpu_torch.bench import eval_config

    cfg = eval_config({"likelihood_io_dtype": "bfloat16"} if boundary == "bfloat16" else {})
    batch = torch.as_tensor(images(batch_size), device="cuda")
    x, p = roofline.head_parameters(cfg, batch, k)
    name = f"{dtype_name(p.dtype)} k={k} B={batch_size}"
    path = mdl_kernel.forward_path(p)
    if path != "tiled" or p.dtype != getattr(torch, boundary):
        raise AssertionError(f"model05 head {name}: {path} path, {p.dtype}")
    step = max(1, PLAIN_IMAGES // batch_size)

    def plain():
        return torch.cat([mixture_log_prob(x, p[i:i + step].float()) for i in range(0, k, step)])

    with torch.inference_mode():
        got = mdl_kernel.mdl_log_prob(x, p)
        want = plain()
        err = (got - want).abs()
        excess = float((err - (ATOL + RTOL * want.abs())).max())
        max_err = float(err.max())
        del err, want
        ms = cuda_ms(lambda: mdl_kernel.mdl_log_prob(x, p), 5)
        plain_ms = cuda_ms(plain, 1)
    counts = modl_branch_counts(x, p)
    calls = mdl_cuda_transcendentals(counts, got.numel(), N_MIX)
    bound_ms, bound_by, by = bound(distinct_bytes(x, p, got),
                                   modl_ops(counts, got.numel(), N_MIX, backward=False), calls)
    say(f"kernel model05 head {name}, {path} path: max|d|={max_err:.3e} (tolerance excess "
        f"{excess:.3e}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (slices of {step}), bound "
        f"{bound_ms:.4f} ms ({bound_by}; {bounds_text(by)}; {bound_ms / ms:.0%} reached)")
    if excess > 0 or not torch.isfinite(got).all():
        raise AssertionError(f"model05 head {name}: kernel and plain version differ")
    del x, p, got
    torch.cuda.empty_cache()
    return dict(shape=f"model05 head {name}", path=path, max_abs_err=max_err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, bounds=by)


def _launched(per_variant: dict) -> dict:
    """A probe's launches summed over its variants (each counted from 0)."""
    total: dict = {}
    for counts in per_variant.values():
        for kernel, n in counts.items():
            total[kernel] = total.get(kernel, 0) + n
    return total


def _finite(what: str, values) -> None:
    for key, v in values.items():
        if isinstance(v, bool) or isinstance(v, str):
            continue
        if v is None or not np.isfinite(v):
            raise AssertionError(f"{what}: {key} = {v}")


def run_bench() -> tuple:
    """(a): ``python -m vae_mdl_tpu_torch.bench`` in a fresh process -> (its
    last line, parsed, and its launches by path from its progress)."""
    from vae_mdl_tpu_torch.bench import KEYS

    proc = subprocess.run([sys.executable, "-m", "vae_mdl_tpu_torch.bench"],
                          capture_output=True, text=True, timeout=BENCH_TIMEOUT,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode:
        raise AssertionError(f"the bench exited {proc.returncode}: {proc.stderr[-3000:]}")
    last = proc.stdout.strip().splitlines()[-1]
    line = json.loads(last)
    say(last)
    if tuple(line) != KEYS:
        raise AssertionError(f"the bench's keys {list(line)} are not {list(KEYS)}")
    _finite("the bench's line", line)
    progress = [ln for ln in proc.stderr.splitlines() if ln.startswith("launches: ")]
    counts = json.loads(progress[-1][len("launches: "):])
    for kernel in ("mdl_log_prob tiled", "mdl_log_prob_backward tiled", "dl_log_prob tiled",
                   "dl_log_prob_backward tiled", "sfu_probe"):
        if counts.get(kernel, 0) < 1:
            raise AssertionError(f"the bench launched no {kernel}: {counts}")
    for kernel in ("mdl_log_prob direct", "mdl_log_prob_backward direct", "dl_log_prob direct",
                   "dl_log_prob_backward direct"):
        if counts.get(kernel, 0):
            raise AssertionError(f"the bench took a direct path: {counts}")
    return line, counts


def run_probes(root: str) -> dict:
    """(c) and (d): each probe once at full width, fewer repeats (and
    ``PROBE_SAMPLES`` where it evaluates) -> {probe: (its launches, its
    numbers)}."""
    from vae_mdl_tpu_torch.probes import (
        ablation_attribution,
        biladder_ablation,
        eval_attribution,
        eval_sweep,
        kernel_bench,
        khat_overhead,
        objective_cost,
        perf_probe,
        prod_attribution,
        scale_probe,
        stability_overhead,
        trace_profile,
    )
    from vae_mdl_tpu_torch.scripts import dump_assets

    quiet = lambda line: None  # noqa: E731  (each probe's summary is checked and printed here)
    short = dict(n_iters=1, n_repeats=2)
    out = {}

    def probe(label, fn, check, counted=False):
        """Run ``fn``; ``check`` reads (launches, numbers) off its result, or
        with ``counted`` (numbers) while the launches are counted here."""
        t0 = time.perf_counter()
        reset_probe_counts()
        result = fn()
        if counted:
            launches = kernel_structure.launched()
            numbers = check(result)
        else:
            launches, numbers = check(result)
        _finite(f"probe {label}", numbers)
        out[label] = (launches, numbers)
        say(f"probe {label} ({time.perf_counter() - t0:.1f} s): {json.dumps(numbers)}; "
            f"launches {launches}")

    def attribution(r):
        return _launched(r["launches"]), r["attribution"]

    probe("prod_attribution", lambda: prod_attribution.run(say=quiet, **short), attribution)
    probe("ablation_attribution", lambda: ablation_attribution.run(say=quiet, **short),
          attribution)

    def grid(r):
        failed = {point: v for point, v in r.items() if "failed" in v}
        if failed:
            raise AssertionError(f"eval grid points failed: {failed}")
        return (_launched({p: v["launches"] for p, v in r.items()}),
                {p: v["imgs_per_s"] for p, v in r.items()})

    for bs, kc in GRID_POINTS:
        probe(f"eval_sweep grid bs={bs} k_chunk={kc}",
              lambda: eval_sweep.grid(PROBE_SAMPLES, (bs,), (kc,), say=quiet), grid)
    probe("eval_sweep kchunk", lambda: eval_sweep.kchunk(PROBE_SAMPLES, n_timed=2, say=quiet),
          lambda r: (_launched({k: v["launches"] for k, v in r.items()}),
                     {k: v["median"] for k, v in r.items()}))
    probe("eval_attribution", lambda: eval_attribution.run(PROBE_SAMPLES, n_timed=1, say=quiet),
          attribution)
    probe("khat_overhead", lambda: khat_overhead.run(n_samples=PROBE_SAMPLES, say=quiet),
          lambda r: (_launched(r["launches"]), r["imgs_per_sec"]))
    probe("objective_cost", lambda: objective_cost.run(say=quiet, **short),
          lambda r: (r["launches"], {f"{m} {v}": t for m, by in r["imgs_per_sec"].items()
                                     for v, t in by.items()}))
    probe("stability_overhead", lambda: stability_overhead.run(say=quiet),
          lambda r: (r["launches"], r["imgs_per_sec"]))
    probe("scale_probe", lambda: scale_probe.run(say=quiet, n=1),
          lambda r: (r["launches"], {k: v["imgs_per_s"] for k, v in r["probes"].items()}))
    probe("perf_probe", lambda: perf_probe.run(say=quiet, steps=10,
                                               eval_over={"n_samples": PROBE_SAMPLES}),
          lambda r: (_launched(r["launches"]), r["imgs_per_sec"]))
    probe("biladder_ablation", lambda: biladder_ablation.run(say=quiet, **short),
          lambda r: (_launched(r["launches"]), r["ms"]))

    def trace(r):
        if r["clock"] != "device" or r["busy_ms"] <= 0:
            raise AssertionError(f"trace_profile read no device time: {r}")
        return {"busy_ms": r["busy_ms"], "span_ms": r["span_ms"]}

    probe("trace_profile", lambda: trace_profile.run(say=quiet, top=40), trace, counted=True)

    def bench_arms(r):
        if r["path"] != "tiled":
            raise AssertionError(f"kernel_bench took the {r['path']} path")
        if r["kernel"]["rel"] > SUM_RTOL:
            raise AssertionError(f"kernel_bench: the kernel and the plain arm disagree: {r}")
        return {"plain_ms": r["plain"]["ms"], "kernel_ms": r["kernel"]["ms"],
                "kernel_gb_per_s": r["kernel_gb_per_s"]}

    # the torch.compile arm (a comparison on no path; ~20 s of compile) is left
    # to the probe's own run
    probe("kernel_bench", lambda: kernel_bench.run(("plain", "kernel"), reps=5, say=quiet),
          bench_arms, counted=True)

    # (d) the three grids from a checkpoint of a few steps
    cfg = trainer_config(f"{root}/assets", n_updates=4)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, eval_interval=2,
                                                             snapshot_interval=0))
    with contextlib.redirect_stdout(io.StringIO()):
        Trainer(cfg).fit()
        dump_assets.run("model05", cfg.train.checkpoint_dir, "best", f"{root}/grids", cfg=cfg)
    written = sorted(os.listdir(f"{root}/grids"))
    want = [f"model05_{tag}.png" for tag in ("inputs", "recon", "samples")]
    if written != want:
        raise AssertionError(f"dump_assets wrote {written}, not {want}")
    say(f"dump_assets: {written}")
    return out


def phase_measurement(smi: str) -> dict:
    """Phase 17, the measurement entry points; see the module docstring.
    -> (the phase's launches by path: the bench's and each probe's; the
    MoDL forward's cases at ``MEASURE_SHAPES``)."""
    line, bench_counts = run_bench()
    shapes = [measure_shape(k, b, boundary) for k, b, boundary in MEASURE_SHAPES]
    with tempfile.TemporaryDirectory() as root:
        probes = run_probes(root)
    say("measurement: " + json.dumps({"bench": line, "shapes": shapes, "probes": {
        name: numbers for name, (_, numbers) in probes.items()}, "nvidia_smi": smi}))
    for name in ("trace_profile", "kernel_bench", "eval_sweep kchunk", "prod_attribution"):
        if probes[name][0].get("mdl_log_prob tiled", 0) < 1:
            raise AssertionError(f"probe {name} launched no MoDL forward on the tile path")
    for name, (counts, _) in probes.items():  # the model's heads are channels-last
        if any(n for kernel, n in counts.items() if kernel.endswith(" direct")):
            raise AssertionError(f"probe {name} took a direct path: {counts}")
    by_path = {"bench": bench_counts}
    by_path.update({f"probe {name}": counts for name, (counts, _) in probes.items()})
    return by_path, shapes


# -- phase 18: the compiled train step ------------------------------------------

CAPTURE_STEPS = 10
# (label, zoo name, configs_of key, train overrides, factory)
CAPTURE_CASES = (
    ("model05 f32", "model05", "f32", {}, "multi"),
    ("model05 bf16", "model05", "bf16", {}, "multi"),
    ("model03 f32", "model03", "f32", {}, "multi"),
    ("model01", "model01", "f32", {}, "multi"),
    ("model05 device data", "model05", "f32", {}, "device"),
    ("model05 warm-up, skip, clip, EMA, accumulation", "model05", "f32",
     dict(beta_warmup_steps=4, grad_skip_threshold=1e6, grad_clip_norm=1.0, ema_decay=0.999,
          grad_accum_steps=2), "multi"),
)
CAPTURE_DATA = 1024  # images of the device-data step's dataset
# A/B: (label, zoo name, configs_of key, steps a call)
CAPTURE_AB = (("model05 f32", "model05", "f32", 10), ("model05 bf16", "model05", "bf16", 10),
              ("model03 f32", "model03", "f32", 10), ("model03 bf16", "model03", "bf16", 10),
              ("model01", "model01", "f32", 100))
CAPTURE_AB_CALLS = 3  # timed calls a turn, after a warm-up call
# the host's calls that put work on the card
HOST_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch", "cuGraphLaunch",
                 "cudaMemcpyAsync", "cudaMemsetAsync", "cudaLaunchKernelExC", "cuLaunchKernelEx")


def capture_config(name: str, which: str, train_over: dict):
    cfg = experiment(name, model=configs_of(name, plain=False)[which])
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, batch_size=BATCH),
                               train=dataclasses.replace(cfg.train, **train_over))


def capture_pool(name: str, n: int) -> torch.Tensor:
    rng = np.random.default_rng(SEED)
    return torch.as_tensor(rng.integers(0, 256, (n, BATCH) + tuple(MODELS[name].image_shape),
                                        dtype=np.uint8), device="cuda")


def trace_launches(fn):
    """``fn()`` under ``torch.profiler``. -> (host ms, {kernel: (launches,
    device ms)}, calls the host made that put work on the card)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, host = {}, 0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            count, ms = kernels.get(evt.key, (0, 0.0))
            kernels[evt.key] = (count + evt.count, ms + evt.self_device_time_total / 1e3)
        elif evt.key in HOST_LAUNCHES:
            host += evt.count
    if sum(ms for _, ms in kernels.values()) <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return wall_ms, kernels, host


def _fresh(cfg, kind: str, n: int):
    """A model from the seed, its state and the step under test."""
    model = seeded_model(cfg.model)
    tx = make_optimizer(cfg.train)
    if kind == "device":
        step = make_device_data_train_step(model, cfg, tx, n_steps=n, n_data=CAPTURE_DATA)
    elif n == 1:
        step = make_train_step(model, cfg, tx)
    else:
        step = make_multi_train_step(model, cfg, tx, n)
    return model, create_train_state(model, cfg.train), step


def _state_gap(a, b) -> float:
    """The largest |difference| over params, optimizer state and EMA."""
    gaps = []
    for x, y in ((a.params, b.params), (a.opt_state, b.opt_state),
                 (a.ema_params, b.ema_params)):
        if x is not None and y is not None:
            tree_map(lambda u, v: gaps.append(
                float((u.detach().double() - v.detach().double()).abs().max())), x, y)
    return max(gaps + [0.0])


def _metrics_equal(a: dict, b: dict) -> bool:
    same = []
    tree_map(lambda u, v: same.append(torch.equal(u, v)), a, b)
    return a.keys() == b.keys() and all(same)


def _eager_window(cfg, kind: str, inputs):
    """CAPTURE_STEPS eager steps from the seed: single steps on ``inputs``
    (the batches), or the device-data window's eager body on the dataset.
    -> (state, metrics of the window)."""
    if kind == "device":
        _, state, step = _fresh(cfg, kind, CAPTURE_STEPS)
        return step.eager(state, inputs)
    _, state, step = _fresh(cfg, kind, 1)
    window = []
    for batch in inputs:
        state, metrics = step.eager(state, batch)
        window.append(metrics)
    return state, reduce_scan_metrics(window)


def capture_case(label, name, which, train_over, kind) -> dict:
    """A captured window of CAPTURE_STEPS steps against as many eager steps,
    from one seed: bit for bit where two eager runs are (else within what
    they differ by, stated)."""
    cfg = capture_config(name, which, train_over)
    inputs = (torch.as_tensor(images(CAPTURE_DATA, MODELS[name].image_shape), device="cuda")
              if kind == "device" else capture_pool(name, CAPTURE_STEPS))
    one, one_metrics = _eager_window(cfg, kind, inputs)
    two, two_metrics = _eager_window(cfg, kind, inputs)
    repeat = states_equal(one, two) and _metrics_equal(one_metrics, two_metrics)
    tolerance = 0.0 if repeat else _state_gap(one, two)
    _, state, step = _fresh(cfg, kind, CAPTURE_STEPS)
    state, metrics = step(state, inputs)
    torch.cuda.synchronize()
    equal = states_equal(state, one) and _metrics_equal(metrics, one_metrics)
    gap = _state_gap(state, one)
    say(f"capture {label}: a captured window of {CAPTURE_STEPS} steps ({kind}) against "
        f"{CAPTURE_STEPS} eager steps: params, optimizer state, EMA, step and metrics bit-equal "
        f"{equal} (largest gap {gap:.3e}); eager against eager bit-equal {repeat}"
        f"{'' if repeat else f', so the tolerance is their gap {tolerance:.3e}'}; "
        f"loss {float(one_metrics['loss']):.4f}; captures {step.cache_size()}")
    if step.cache_size() != 1 or state.step != CAPTURE_STEPS:
        raise AssertionError(f"capture {label}: {step.cache_size()} captures, step {state.step}")
    if (repeat and not equal) or gap > tolerance:
        raise AssertionError(f"capture {label}: the captured window differs from the eager "
                             f"steps by {gap:.3e} (eager against eager: {tolerance:.3e}) at "
                             f"{first_difference(state, one)}")
    return {"equal": equal, "eager_repeats": repeat, "gap": gap}


def _clone_state_dict(state) -> dict:
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
                    state.state_dict())


def capture_resume() -> None:
    """Exact resume from ``state_dict()`` in the middle of a captured run:
    10 steps in two captured windows of 5 against 5, a save, a load into a
    state of another model, and 5 more through the same step function and
    through a step function captured afresh."""
    cfg = capture_config("model05", "f32", {"ema_decay": 0.999})
    pool = capture_pool("model05", CAPTURE_STEPS)
    _, straight, step = _fresh(cfg, "multi", 5)
    for half in (pool[:5], pool[5:]):
        straight, _ = step(straight, half)
    _, first, step = _fresh(cfg, "multi", 5)
    first, _ = step(first, pool[:5])
    saved = _clone_state_dict(first)
    outcomes = {}
    for how in ("the same step", "a step captured afresh"):
        model = build_model(cfg.model, torch.Generator().manual_seed(SEED + 1))
        resumed = create_train_state(model, cfg.train)
        resumed.load_state_dict(saved)
        again = step if how == "the same step" else make_multi_train_step(
            model, cfg, make_optimizer(cfg.train), 5)
        resumed, _ = again(resumed, pool[5:])
        outcomes[how] = states_equal(resumed, straight)
    # the state the step function was captured with continues as it was
    first, _ = step(first, pool[5:])
    outcomes["the first state, continued"] = states_equal(first, straight)
    say(f"capture resume: 5 captured steps, state_dict(), a state of another model loaded, "
        f"5 more: bit-equal to 10 straight {outcomes}")
    if not all(outcomes.values()):
        raise AssertionError(f"capture resume: {outcomes}")


def capture_fresh_draws() -> None:
    """A replay draws for the state's step: from one state, the replay at
    step s and again at s equal, at s + 1 differ, each equal to the eager
    step at that step."""
    cfg = capture_config("model05", "f32", {})
    batch = capture_pool("model05", 1)[0]
    _, state, step = _fresh(cfg, "multi", 1)
    state, _ = step(state, batch)  # capture
    saved = _clone_state_dict(state)
    losses = {}
    for at in ("s", "s + 1", "s again"):
        state.load_state_dict(saved)
        state.step += at == "s + 1"
        eager = create_train_state(seeded_model(cfg.model), cfg.train)
        eager.load_state_dict(_clone_state_dict(state))
        eager, want = step.eager(eager, batch)
        state, got = step(state, batch)
        losses[at] = float(got["loss"])
        if not (states_equal(state, eager) and _metrics_equal(got, want)):
            raise AssertionError(f"capture draws: the replay at {at} differs from the eager step")
    say(f"capture draws: losses of replays from one state {losses}, each bit-equal to the "
        f"eager step there")
    if losses["s"] != losses["s again"] or losses["s"] == losses["s + 1"]:
        raise AssertionError(f"capture draws: {losses}")


def capture_trace(name: str, which: str) -> dict:
    """One replay of a captured window under the profiler: the likelihood
    kernels inside the graph on the tile path, launched by no host call of
    their own. -> the replay's numbers."""
    cfg = capture_config(name, which, {})
    pool = capture_pool(name, CAPTURE_STEPS)
    _, state, step = _fresh(cfg, "multi", CAPTURE_STEPS)
    state, _ = step(state, pool)  # capture
    before = launches_now()
    wall, kernels, host = trace_launches(lambda: step(state, pool))
    counted = launched_since(before)
    own = "mdl_log_prob" if MODELS[name].likelihood == "mdl" else "dl_log_prob"
    device = {}
    for kernel, (count, _) in kernels.items():
        for direction, fragment in (("forward", f"{own}_kernel"),
                                    ("backward", f"{own}_backward_kernel")):
            if fragment in kernel:
                path = "tiled" if "_tiled" in kernel else "direct"
                device[f"{direction} {path}"] = device.get(f"{direction} {path}", 0) + count
    busy = sum(ms for _, ms in kernels.values())
    out = {"device kernels": sum(c for c, _ in kernels.values()), "host launches": host,
           "likelihood kernels by path": device, "counted": counted,
           "wall ms": wall, "busy ms": busy}
    say(f"capture trace {name} {which}: one replay of {CAPTURE_STEPS} steps: {out}")
    want = {"forward tiled": CAPTURE_STEPS, "backward tiled": CAPTURE_STEPS}
    if device != want:
        raise AssertionError(f"capture trace {name} {which}: the graph ran {device}, not {want}")
    if host >= out["device kernels"] / CAPTURE_STEPS:
        raise AssertionError(f"capture trace {name} {which}: the host made {host} launch calls "
                             f"for {out['device kernels']} kernels: not one graph")
    if counted.get(f"{own} tiled") != CAPTURE_STEPS:
        raise AssertionError(f"capture trace {name} {which}: the counters took {counted}")
    return out


def capture_trainer(root: str, smi: str) -> dict:
    """``Trainer(cfg).fit()`` on model05 f32 with 1 and 10 steps a call:
    the guard prints no warning and each step holds one capture."""
    rates = {}
    for spc in (1, 10):
        cfg = trainer_config(f"{root}/spc{spc}")
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, steps_per_call=spc, n_updates=60, eval_interval=20,
            report_images=False))
        logger = RecordingLogger(cfg.train.log_dir, "model05")
        trainer = Trainer(cfg, logger=logger)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            trainer.fit(progress=False)
        sizes = (trainer.train_step.cache_size(), trainer.eval_step.cache_size())
        rates[spc] = [perf["imgs_per_sec"] for _, perf in logger.perf[1:]]
        say(f"capture trainer: steps_per_call {spc}: captures (train, eval) {sizes}, window "
            f"imgs/s {rates[spc]} on {smi}")
        if "WARNING" in out.getvalue() or sizes != (1, 1):
            raise AssertionError(f"capture trainer: steps_per_call {spc}: captures {sizes}; "
                                 f"{out.getvalue()}")
    return rates


def capture_ab(smi: str) -> dict:
    """The eager window and the captured one in turns (eager, captured,
    captured, eager), each from its own model of the seed: imgs/s of
    CAPTURE_AB_CALLS calls a turn (CUDA events), and one traced call of each
    for the device's busy time, its idle share and the host's launch calls,
    a step."""
    out = {}
    for label, name, which, n in CAPTURE_AB:
        cfg = capture_config(name, which, {})
        pool = capture_pool(name, n)
        runs = {}
        for kind in ("eager", "captured"):
            _, state, step = _fresh(cfg, "multi", n)
            call = step.eager if kind == "eager" else step
            state, _ = call(state, pool)
            runs[kind] = [call, state]
        rates = {"eager": [], "captured": []}
        for kind in ("eager", "captured", "captured", "eager"):
            call, state = runs[kind]
            for _ in range(CAPTURE_AB_CALLS):
                (state, _), seconds = cuda_seconds(lambda: call(state, pool))
                rates[kind].append(n * BATCH / seconds)
            runs[kind][1] = state
        row = {}
        for kind, (call, state) in runs.items():
            wall, kernels, host = trace_launches(lambda: call(state, pool))
            busy = sum(ms for _, ms in kernels.values())
            r = np.asarray(rates[kind])
            row[kind] = {"imgs_per_s": float(np.median(r)), "min": float(r.min()),
                         "sd": float(r.std(ddof=1)), "busy_ms_a_step": busy / n,
                         "idle_share": 1.0 - busy / wall, "host_launches_a_step": host / n,
                         "device_kernels_a_step": sum(c for c, _ in kernels.values()) / n}
        out[label] = row
        say(f"capture A/B {label}, {n} steps a call, batch {BATCH}, in turns: {row} on {smi}")
        del runs
        torch.cuda.empty_cache()
    return out


def phase_capture(smi: str) -> dict:
    """Phase 18, the compiled train step; see the module docstring. -> the
    kernel launches of its main path (the captured windows of model05 f32
    and model03 f32)."""
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        for case in CAPTURE_CASES:
            capture_case(*case)
            torch.cuda.empty_cache()
        capture_resume()
        capture_fresh_draws()
        reset_probe_counts()
        before = launches_now()
        traces = {f"{name} {which}": capture_trace(name, which)
                  for name, which in (("model05", "f32"), ("model05", "bf16"), ("model03", "f32"))}
        counts = launched_since(before)
        with tempfile.TemporaryDirectory() as root:
            trainer_rates = capture_trainer(root, smi)
        ab = capture_ab(smi)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    say("capture: " + json.dumps({"traces": traces, "trainer_imgs_per_s": trainer_rates,
                                  "ab": ab}))
    return counts



# -- phase 19: the mesh steps as one program -----------------------------------------

MESH_STEPS = 10
# (label, zoo name, configs_of key, kind): "window" make_multi_train_step(mesh=)
# of MESH_STEPS steps, "device" the device-data window under the mesh, "tp
# window" the window on a state in the tensor-parallel layout; "step"
# make_shard_map_train_step, "zero1" make_zero1_train_step and "tp" the
# data-parallel step on a state in the tensor-parallel layout, each called
# MESH_STEPS times; against as many eager steps of the one-step body
MESH_CASES = (
    ("model05 f32 window", "model05", "f32", "window"),
    ("model05 bf16 window", "model05", "bf16", "window"),
    ("model01 window", "model01", "f32", "window"),
    ("model05 f32 device data", "model05", "f32", "device"),
    ("model05 f32 step", "model05", "f32", "step"),
    ("model05 f32 zero1", "model05", "f32", "zero1"),
    ("model05 bf16 zero1", "model05", "bf16", "zero1"),
    ("model05 f32 tp", "model05", "f32", "tp"),
    ("model05 f32 tp window", "model05", "f32", "tp window"),
)
# A/B under the mesh: (label, configs_of key, kind), eager and captured in turns
MESH_AB = (("model05 f32 dp", "f32", "window"), ("model05 bf16 dp", "bf16", "window"),
           ("model05 f32 zero1", "f32", "zero1"))


def _tp_mesh():
    from vae_mdl_tpu_torch.parallel.distributed import process_count
    from vae_mdl_tpu_torch.parallel.tensor import make_tp_mesh

    world = process_count()
    return make_tp_mesh(world // 2, 2) if world % 2 == 0 else make_tp_mesh(world, 1)


def mesh_pool(name: str, n: int, mesh) -> torch.Tensor:
    """``n`` batches of BATCH rows, this rank's: seeded by its batch shard."""
    from vae_mdl_tpu_torch.parallel.mesh import batch_sharding

    rng = np.random.default_rng([SEED, batch_sharding(mesh)[0]])
    return torch.as_tensor(rng.integers(0, 256, (n, BATCH) + tuple(MODELS[name].image_shape),
                                        dtype=np.uint8), device="cuda")


def mesh_setup(name: str, which: str, kind: str, meshes: dict, over: dict = None,
               seed: int = SEED):
    """A model from ``seed`` and its state (ZeRO-1's flat moments, the
    tensor-parallel layout on ``meshes["tp"]``, else on ``meshes["dp"]``) ->
    (state, the step under test, the one-step factory whose eager body is
    the reference, the inputs)."""
    from vae_mdl_tpu_torch.parallel.mesh import batch_sharding
    from vae_mdl_tpu_torch.parallel.spmd import (make_shard_map_train_step,
                                                 make_zero1_train_step, zero1_opt_state)
    from vae_mdl_tpu_torch.parallel.tensor import shard_state_tp

    cfg = capture_config(name, which, over or {})
    mesh = meshes["tp" if kind.startswith("tp") else "dp"]
    count = batch_sharding(mesh)[1]
    if kind == "device":
        # the global batch: BATCH rows a batch shard
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data,
                                                                batch_size=BATCH * count))
    model = build_model(cfg.model, torch.Generator().manual_seed(seed)).eval()
    tx = make_optimizer(cfg.train)
    state = create_train_state(model, cfg.train)
    if kind == "zero1":
        state.opt_state = zero1_opt_state(tx, state.params, mesh)
        one = make_zero1_train_step(model, cfg, tx, mesh)
        return state, one, one, mesh_pool(name, MESH_STEPS, mesh)
    if kind.startswith("tp"):
        shard_state_tp(state, mesh, model=model)
    one = make_shard_map_train_step(model, cfg, tx, mesh)
    if kind in ("window", "tp window"):
        step = make_multi_train_step(model, cfg, tx, MESH_STEPS, mesh=mesh)
    elif kind == "device":
        step = make_device_data_train_step(model, cfg, tx, MESH_STEPS, CAPTURE_DATA, mesh=mesh)
        return state, step, one, torch.as_tensor(
            images(CAPTURE_DATA, MODELS[name].image_shape), device="cuda")
    else:
        step = one
    return state, step, one, mesh_pool(name, MESH_STEPS, mesh)


def mesh_run(step, state, inputs, kind: str, eager: bool):
    """The case's MESH_STEPS steps: the window in one call, else a call a
    batch; ``eager``: through the eager body. -> (state, metrics)."""
    call = step.eager if eager else step
    if kind in ("window", "device", "tp window"):
        return call(state, inputs)
    window = []
    for batch in inputs:
        state, metrics = call(state, batch)
        window.append(metrics)
    return state, reduce_scan_metrics(window)


def _digest(state) -> str:
    """A hash of the parameters (the whole ones of a tensor-parallel state: a
    collective), equal across ranks that hold equal parameters."""
    import hashlib

    from vae_mdl_tpu_torch.train.checkpoint import whole_state_dict

    params = whole_state_dict(state)["params"] if state.tp_layout is not None else state.params
    h = hashlib.sha256()
    for name in sorted(params):
        h.update(params[name].detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def mesh_case(label, name, which, kind, meshes) -> dict:
    """MESH_STEPS captured steps (one window, or a call each) against as many
    eager steps of the one-step body, each from the seed, twice: bit for bit
    where two eager runs are, else within their gap."""
    runs = []
    for _ in range(2):
        state, step, one, inputs = mesh_setup(name, which, kind, meshes)
        if kind == "device":  # the window's own eager body: its draws of rows
            runs.append(step.eager(state, inputs))
        else:
            runs.append(mesh_run(one, state, inputs, "step", eager=True))
    (one_state, one_metrics), (two_state, two_metrics) = runs
    repeat = states_equal(one_state, two_state) and _metrics_equal(one_metrics, two_metrics)
    tolerance = 0.0 if repeat else _state_gap(one_state, two_state)
    state, step, _, inputs = mesh_setup(name, which, kind, meshes)
    state, metrics = mesh_run(step, state, inputs, kind, eager=False)
    torch.cuda.synchronize()
    equal = states_equal(state, one_state) and _metrics_equal(metrics, one_metrics)
    gap = _state_gap(state, one_state)
    if step.cache_size() != 1 or state.step != MESH_STEPS:
        raise AssertionError(f"mesh capture {label}: {step.cache_size()} captures, step "
                             f"{state.step}")
    if (repeat and not equal) or gap > tolerance:
        raise AssertionError(f"mesh capture {label}: the captured steps differ from the eager "
                             f"ones by {gap:.3e} (eager against eager: {tolerance:.3e}) at "
                             f"{first_difference(state, one_state)}")
    return {"equal": equal, "eager_repeats": repeat, "gap": gap,
            "loss": float(metrics["loss"]), "digest": _digest(state)}


def mesh_resume(meshes) -> dict:
    """Exact resume of ZeRO-1 in the middle of a captured run: 5 steps,
    ``state_dict()`` with the flat moments gathered whole, re-sharded
    (``reshard_zero1_opt_state``) into a state of another model, 5 more
    through the same step function, against 10 straight."""
    from vae_mdl_tpu_torch.parallel.spmd import gather_zero1_opt_state, reshard_zero1_opt_state

    over = {"ema_decay": 0.999}
    pool = mesh_pool("model05", 10, meshes["dp"])
    straight, step, _, _ = mesh_setup("model05", "f32", "zero1", meshes, over)
    straight, _ = mesh_run(step, straight, pool, "zero1", eager=False)
    first, step, _, _ = mesh_setup("model05", "f32", "zero1", meshes, over)
    first, _ = mesh_run(step, first, pool[:5], "zero1", eager=False)
    saved = _clone_state_dict(first)
    saved["opt_state"] = gather_zero1_opt_state(first.opt_state)
    resumed = mesh_setup("model05", "f32", "zero1", meshes, over, seed=SEED + 1)[0]
    saved["opt_state"] = reshard_zero1_opt_state(saved["opt_state"], resumed.params,
                                                 meshes["dp"])
    resumed.load_state_dict(saved)
    resumed, _ = mesh_run(step, resumed, pool[5:], "zero1", eager=False)
    first, _ = mesh_run(step, first, pool[5:], "zero1", eager=False)
    out = {"resumed": states_equal(resumed, straight),
           "the first state, continued": states_equal(first, straight)}
    if not all(out.values()):
        raise AssertionError(f"mesh capture resume: {out}")
    return out


def mesh_trace(label, which, kind, meshes) -> dict:
    """One call of the captured and of the eager steps under the profiler:
    the MoDL pair inside the graph on the tile path, launched by no host call
    of its own, and NCCL's kernels inside it too. -> a step's numbers."""
    out = {}
    for how in ("captured", "eager"):
        state, step, _, inputs = mesh_setup("model05", which, kind, meshes)
        state, _ = mesh_run(step, state, inputs, kind, eager=how == "eager")  # capture
        before = launches_now()
        wall, kernels, host = trace_launches(
            lambda: mesh_run(step, state, inputs, kind, eager=how == "eager"))
        counted = launched_since(before)
        nccl = sum(c for k, (c, _) in kernels.items() if "nccl" in k.lower())
        busy = sum(ms for _, ms in kernels.values())
        out[how] = {"host_launches_a_step": host / MESH_STEPS,
                    "device_kernels_a_step": sum(c for c, _ in kernels.values()) / MESH_STEPS,
                    "nccl_kernels_a_step": nccl / MESH_STEPS, "busy_ms_a_step": busy / MESH_STEPS,
                    "idle_share": 1.0 - busy / wall, "counted": counted}
        if how == "captured":
            tiled = {k: c for k, (c, _) in kernels.items() if "mdl_log_prob" in k}
            want = {"mdl_log_prob tiled": MESH_STEPS, "mdl_log_prob_backward tiled": MESH_STEPS}
            if {k: counted.get(k) for k in want} != want or any(
                    "_tiled" not in k for k in tiled):
                raise AssertionError(f"mesh trace {label}: the counters took {counted}, the "
                                     f"graph ran {tiled}")
            if host >= out[how]["device_kernels_a_step"]:
                raise AssertionError(f"mesh trace {label}: {host} host launch calls for "
                                     f"{out[how]['device_kernels_a_step']} kernels a step")
        del state, step
    return out


def mesh_ab(meshes) -> dict:
    """Eager and captured in turns (eager, captured, captured, eager), each
    from its own model of the seed: this rank's imgs/s (BATCH rows a step)
    over CAPTURE_AB_CALLS calls of MESH_STEPS steps a turn, CUDA events."""
    out = {}
    for label, which, kind in MESH_AB:
        runs = {}
        for how in ("eager", "captured"):
            state, step, _, pool = mesh_setup("model05", which, kind, meshes)
            state, _ = mesh_run(step, state, pool, kind, eager=how == "eager")
            runs[how] = [step, state, pool]
        rates = {"eager": [], "captured": []}
        for how in ("eager", "captured", "captured", "eager"):
            step, state, pool = runs[how]
            for _ in range(CAPTURE_AB_CALLS):
                (state, _), seconds = cuda_seconds(
                    lambda: mesh_run(step, state, pool, kind, eager=how == "eager"))
                rates[how].append(MESH_STEPS * BATCH / seconds)
            runs[how][1] = state
        out[label] = {how: {"imgs_per_s": float(np.median(r)), "min": float(np.min(r)),
                            "sd": float(np.std(r, ddof=1))} for how, r in rates.items()}
        del runs
        torch.cuda.empty_cache()
    return out


def _mesh_capture_run(mesh) -> dict:
    """Phase 19's checks on this rank (every rank of the group runs them in
    step) on ``mesh`` and a tensor-parallel mesh of the same ranks -> their
    numbers and the main path's launches."""
    out = {"cases": {}}
    meshes = {"dp": mesh, "tp": _tp_mesh()}
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        for case in MESH_CASES:
            out["cases"][case[0]] = mesh_case(*case, meshes)
            torch.cuda.empty_cache()
        out["resume"] = mesh_resume(meshes)
        reset_probe_counts()
        before = launches_now()
        out["traces"] = {label: mesh_trace(label, which, kind, meshes) for label, which, kind in (
            ("model05 f32 dp", "f32", "window"), ("model05 bf16 dp", "bf16", "window"),
            ("model05 f32 zero1", "f32", "zero1"), ("model05 f32 tp", "f32", "tp window"))}
        out["launches"] = launched_since(before)
        out["ab"] = mesh_ab(meshes)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    return out


def mesh_capture_child(rank: int, world: int, store: str, out_dir: str, backend: str) -> None:
    """One rank of phase 19 (b); writes ``out_dir/rank<r>.pt``."""
    import torch.distributed as dist

    from vae_mdl_tpu_torch.config import MeshConfig
    from vae_mdl_tpu_torch.parallel.distributed import init_distributed
    from vae_mdl_tpu_torch.parallel.mesh import make_mesh

    init_distributed(f"file://{store}", world, rank, backend=backend, timeout=240)
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        out = _mesh_capture_run(make_mesh(MeshConfig()))
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _mesh_report(ranks: list, what: str) -> dict:
    """The ranks' cases bit-equal in parameters across ranks, and the
    slowest rank's rates."""
    for label in ranks[0]["cases"]:
        digests = {out["cases"][label]["digest"] for out in ranks}
        if len(digests) != 1:
            raise AssertionError(f"{what} {label}: the ranks' parameters differ")
    cases = {label: {k: v for k, v in case.items() if k != "digest"}
             for label, case in ranks[0]["cases"].items()}
    ab = {label: {how: {"imgs_per_s_a_rank_slowest": min(
        out["ab"][label][how]["imgs_per_s"] for out in ranks)} for how in ("eager", "captured")}
        for label in ranks[0]["ab"]}
    return {"cases": cases, "resume": ranks[0]["resume"], "traces": ranks[0]["traces"],
            "ab": ab, "ab_rank0": ranks[0]["ab"]}


def mesh_world_of_one(root: str, smi: str, report: dict) -> dict:
    """Phase 19 (a): the checks at a world of one over NCCL, in this
    process. -> the main path's launches."""
    import torch.distributed as dist

    from vae_mdl_tpu_torch.config import MeshConfig
    from vae_mdl_tpu_torch.parallel.distributed import init_distributed
    from vae_mdl_tpu_torch.parallel.mesh import make_mesh

    init_distributed(f"file://{root}/store", world_size=1, rank=0)
    try:
        report["backend"] = str(dist.get_backend())
        one = _mesh_capture_run(make_mesh(MeshConfig()))
    finally:
        dist.destroy_process_group()
    report["world_of_one"] = _mesh_report([one], "mesh capture (a)")
    say(f"mesh capture (a): a world of one over {report['backend']}: "
        f"{json.dumps(report['world_of_one'])} on {smi}")
    return dict(one["launches"])


def mesh_cards(root: str, smi: str, report: dict) -> dict:
    """Phase 19 (b): the same checks on min(cards, 4) ranks over NCCL, one
    card each, where there are two cards or more; then (c)
    ``graft_entry.dryrun_multichip`` over the cards. -> the ranks' main-path
    launches."""
    from vae_mdl_tpu_torch import graft_entry

    counts = {}
    n_cards = torch.cuda.device_count()
    world = min(n_cards, 4)
    if n_cards >= 2:
        ranks = spawn_ranks(world, "cpu:gloo,cuda:nccl", os.path.join(root, "mesh"),
                            task="mesh_capture")
        report[f"nccl_{world}"] = _mesh_report(ranks, f"mesh capture (b) x{world}")
        for out in ranks:
            for name, n in out["launches"].items():
                counts[name] = counts.get(name, 0) + n
        say(f"mesh capture (b): {world} ranks over NCCL, one card each: "
            f"{json.dumps(report[f'nccl_{world}'])} on {smi}")
    else:
        say("mesh capture (b): one card, so the checks at a world of several do not run")
    t0 = time.perf_counter()
    report["dryrun"] = graft_entry.dryrun_multichip(world)
    say(f"mesh capture (c): graft_entry.dryrun_multichip({world}) over NCCL in "
        f"{time.perf_counter() - t0:.1f} s")
    return counts


def phase_mesh_capture(smi: str) -> dict:
    """Phase 19, the mesh steps as one program; see the module docstring. ->
    the kernel launches of its main path (the traced mesh steps, every
    rank's)."""
    report = {"card": smi}
    with tempfile.TemporaryDirectory() as root:
        counts = mesh_world_of_one(root, smi, report)
        for name, n in mesh_cards(root, smi, report).items():
            counts[name] = counts.get(name, 0) + n
    say("mesh capture: " + json.dumps(report))
    return counts

# -- phase 20: the eval as one program -------------------------------------------------

# (label, zoo name, configs_of key, importance samples): each at full width on
# the bench's eval batch (EVAL_BATCH), k-chunks of 100
EVAL_CAPTURE_CASES = (
    ("model05 f32", "model05", "f32", 5000), ("model05 bf16", "model05", "bf16", 5000),
    # model03 in its bf16 config: 0.9 s a batch against the float32 one's 3.7
    ("model03 bf16", "model03", "bf16", 5000), ("model01", "model01", "f32", 5000),
    # the ladder's eager 5000-IS batch takes ~13 s (9.81 imgs/s): a tenth of
    # the samples keeps the phase inside the run's time limit
    ("ladder_svhn", "ladder_svhn", "f32", 500),
)
EVAL_K_CHUNK = 100
EVAL_AB = ("eager", "captured", "captured", "eager")
EVAL_PARAMS_SAMPLES = 200  # the EMA params= case: two chunks, as the card test's
HEAD_PAD = 64
# model05's decoder's three transposed convs: (in, out, input side)
POLY_SHAPES = ((128, 128, 4), (128, 64, 8), (64, 32, 16))
POLY_KS = (5, 100)
POLY_REPS = 3  # timed calls a turn, after a warm-up call


def _same(got, want) -> bool:
    got, want = (got if isinstance(got, tuple) else (got,)), (
        want if isinstance(want, tuple) else (want,))
    return len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))


def _stats(values) -> dict:
    r = np.asarray(values, dtype=np.float64)
    return {"median": float(np.median(r)), "min": float(r.min()),
            "sd": float(r.std(ddof=1)) if r.size > 1 else 0.0}


def eval_capture_case(label: str, name: str, which: str, n_samples: int, smi: str) -> dict:
    """One config's 5000-IS batch (``n_samples``) with the k-hat top set and
    the curve, eager and captured: bit-equal at two seeds (the capturing call
    and two replays) with the caller's generator left at one offset, peak
    memory of each, the capture's seconds, the rates in turns (EVAL_AB), one
    traced batch of each, and a second ``evaluate_llh`` that captures
    nothing."""
    from vae_mdl_tpu_torch.evaluation import harness

    cfg = experiment(name, model=configs_of(name, plain=False)[which])
    n = EVAL_BATCH.get(name, BATCH)
    host = images(n, cfg.model.image_shape)
    batch = torch.as_tensor(host, device="cuda")
    model = seeded_model(cfg.model)
    evaluator = make_batch_evaluator(model, cfg, n_samples, EVAL_K_CHUNK, with_khat=True,
                                     with_curve=True)

    def run(kind: str, seed: int):
        gen = torch.Generator("cuda").manual_seed(seed)
        call = evaluator.eager if kind == "eager" else evaluator
        out, seconds = cuda_seconds(lambda: call(batch, gen))
        return out, gen.get_offset(), seconds

    def check(seed, got, want):
        if not _same(got[0], want[0]) or got[1] != want[1]:
            raise AssertionError(f"eval capture {label}: seed {seed}: the captured batch "
                                 "differs from the eager loop (llh, top set, curve or the "
                                 "generator's offset)")

    # in turns (EVAL_AB: eager, captured, captured, eager), the first captured
    # turn a replay after the capturing call, each kind once at SEED + 1 and
    # once at SEED + 2
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    runs = {("eager", SEED + 1): run("eager", SEED + 1)}
    eager_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    eager_reserved = (torch.cuda.max_memory_reserved() - reserved) / 2**30
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = run("captured", SEED + 1)  # the warm-up, the capture and the first replay
    first_s = time.perf_counter() - t0
    capture_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    torch.cuda.empty_cache()
    held = (torch.cuda.memory_reserved() - reserved) / 2**30
    check(SEED + 1, first, runs["eager", SEED + 1])
    for kind, seed in zip(EVAL_AB[1:], (SEED + 1, SEED + 2, SEED + 2)):
        runs[kind, seed] = run(kind, seed)
    for seed in (SEED + 1, SEED + 2):
        check(seed, runs["captured", seed], runs["eager", seed])
    rates = {kind: [n / runs[kind, seed][2] for seed in (SEED + 1, SEED + 2)]
             for kind in ("eager", "captured")}
    want = runs["eager", SEED + 1]
    traces = {}
    for kind in ("eager", "captured"):
        gen = torch.Generator("cuda").manual_seed(SEED)
        call = evaluator.eager if kind == "eager" else evaluator
        wall, kernels, host_calls = trace_launches(lambda: call(batch, gen))
        busy = sum(ms for _, ms in kernels.values())
        traces[kind] = {"busy_ms": busy, "wall_ms": wall, "idle_share": 1.0 - busy / wall,
                        "host_launches": host_calls,
                        "device_kernels": sum(c for c, _ in kernels.values())}
    sizes = (evaluator.cache_size(), harness.cache_size(model))
    evaluate_llh(model, cfg, host, n_samples=n_samples, k_chunk=EVAL_K_CHUNK, batch_size=n,
                 seed=SEED, khat=True, k_curve=True)
    again = (evaluator.cache_size(), harness.cache_size(model))
    if sizes != (1, 1) or again != (1, 1):
        raise AssertionError(f"eval capture {label}: captures {sizes}, then {again} after a "
                             "second evaluate_llh")
    llh = want[0][0]
    if not (torch.isfinite(llh).all() and llh.shape == (n,)):
        raise AssertionError(f"eval capture {label}: llh {tuple(llh.shape)} not finite")
    row = {"n_samples": n_samples, "batch": n, "mean_llh": float(llh.mean()),
           "imgs_per_s": {kind: _stats(r) for kind, r in rates.items()},
           "traced": traces,
           "peak_gib": {"eager allocated": eager_peak, "eager reserved": eager_reserved,
                        "capturing call allocated": capture_peak,
                        "held by the graph (reserved)": held},
           # the first call less a replay: the warm-up (one chunk) and the capture
           "capture_s": first_s - float(np.median([n / r for r in rates["captured"]])),
           "captures": again}
    say(f"eval capture {label}, {n_samples} samples, batch {n}, k-chunks of {EVAL_K_CHUNK}: "
        f"captured bit-equal to eager at 2 seeds, generator offsets equal; {json.dumps(row)} "
        f"on {smi}")
    return row


def eval_capture_params() -> None:
    """The Trainer's case: the EMA copy through ``params=`` and the model's
    own parameters, each after a captured train step (which writes both in
    place) and after an eager one (which makes new optimizer and EMA
    tensors): each captured evaluation equal to the eager one."""
    cfg = experiment("model05")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, ema_decay=0.999))
    model = seeded_model(cfg.model)
    state = create_train_state(model, cfg.train)
    batch = torch.as_tensor(images(BATCH), device="cuda")
    evaluator = make_batch_evaluator(model, cfg, EVAL_PARAMS_SAMPLES, EVAL_K_CHUNK)
    step = make_train_step(model, cfg, make_optimizer(cfg.train))
    for kind in ("captured", "eager", "captured"):
        state, _ = (step if kind == "captured" else step.eager)(state, batch)
        for what, params in (("EMA", eval_params(cfg.train, state)), ("own", None)):
            want = evaluator.eager(batch, torch.Generator("cuda").manual_seed(SEED),
                                   params=params)
            got = evaluator(batch, torch.Generator("cuda").manual_seed(SEED), params=params)
            if not _same(got, want):
                raise AssertionError(f"eval capture params: the {what} weights after a "
                                     f"{kind} step differ captured and eager")
    say(f"eval capture params: model05 f32, {EVAL_PARAMS_SAMPLES} samples, batch {BATCH}: the "
        "EMA copy (params=) and the model's own weights after a captured, an eager and a "
        "captured train step, captured equal to eager bit for bit")


def eval_head_pad(smi: str) -> dict:
    """model05 with ``head_pad=64``: one train step kernel against plain
    (phase 10b's check) and a 200-IS eval, through the kernels against the
    plain version, with the MoDL launches by memory path."""
    base = MODELS["model05"]
    base = dataclasses.replace(base, decoder=dataclasses.replace(base.decoder, head_pad=HEAD_PAD))
    reset_probe_counts()
    phase_train_step_check("model05", base=base)
    step_paths = (dict(mdl_kernel.launches_by_path),
                  dict(mdl_kernel.backward_launches_by_path))
    batch = images(BATCH)
    reset_probe_counts()
    got = evaluate_llh(seeded_model(base), experiment("model05", model=base), batch,
                       n_samples=200, k_chunk=EVAL_K_CHUNK, batch_size=BATCH, seed=SEED)[1]
    eval_paths = dict(mdl_kernel.launches_by_path)
    plain = dataclasses.replace(base, use_pallas=False)
    want = evaluate_llh(seeded_model(plain), experiment("model05", model=plain), batch,
                        n_samples=200, k_chunk=EVAL_K_CHUNK, batch_size=BATCH, seed=SEED)[1]
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    out = {"train step forward": step_paths[0], "train step backward": step_paths[1],
           "200-IS eval forward": eval_paths, "eval max rel diff": rel}
    say(f"head_pad {HEAD_PAD}: model05's head emits {HEAD_PAD} channels, the likelihood reads "
        f"50: MoDL launches by memory path {json.dumps(out)} on {smi}")
    if rel > SUM_RTOL:
        raise AssertionError("head_pad: the 200-IS eval's kernel and plain version disagree")
    for what, paths in (("train forward", step_paths[0]), ("train backward", step_paths[1]),
                        ("eval forward", eval_paths)):
        if paths["direct"] < 1 or paths["tiled"]:
            raise AssertionError(f"head_pad: the {what} took {paths}, not the direct path")
    return out


def eval_polyphase(smi: str) -> dict:
    """The polyphase form against ``F.conv_transpose2d`` at model05's three
    decoder shapes, k = 5 and 100 at batch 128, f32 and bf16, on
    channels-last inputs as the decoder's: the largest difference, and the
    forward and forward+backward ms of both forms in turns."""
    import torch.nn.functional as F

    from vae_mdl_tpu_torch.nn.encoders import ConvLayer, ConvSpec, polyphase_conv_transpose

    out = {}
    gen = torch.Generator().manual_seed(SEED)
    for cin, cout, side in POLY_SHAPES:
        layer = ConvLayer(ConvSpec(cout, 4, 2, True, "none"), cin, gen).cuda()
        with torch.no_grad():
            layer.bias.normal_(generator=torch.Generator("cuda").manual_seed(SEED))
        for k in POLY_KS:
            rows = k * BATCH
            x = torch.randn((rows, side, side, cin), device="cuda").permute(0, 3, 1, 2)
            g = torch.randn((rows, 2 * side, 2 * side, cout), device="cuda").permute(0, 3, 1, 2)
            for dtype in (torch.float32, torch.bfloat16):
                xd, gd = x.to(dtype).requires_grad_(), g.to(dtype)
                forms = {
                    "conv_transpose2d": lambda: F.conv_transpose2d(
                        xd, layer.weight.to(dtype), layer.bias.to(dtype), stride=2, padding=1),
                    "polyphase": lambda: polyphase_conv_transpose(xd, layer.weight, layer.bias,
                                                                  dtype),
                }
                with torch.no_grad():
                    diff = float((forms["polyphase"]().float()
                                  - forms["conv_transpose2d"]().float()).abs().max())

                def backward(form):
                    return lambda: torch.autograd.grad(
                        form(), (xd, layer.weight, layer.bias), grad_outputs=gd)

                with torch.no_grad():
                    fwd = in_turns(forms, ("conv_transpose2d", "polyphase", "polyphase",
                                           "conv_transpose2d"), POLY_REPS)
                both = in_turns({name: backward(f) for name, f in forms.items()},
                                ("conv_transpose2d", "polyphase", "polyphase",
                                 "conv_transpose2d"), POLY_REPS)
                key = f"{cin}->{cout} {side}x{side} k={k} {dtype_name(dtype)}"
                out[key] = {"max_abs_diff": diff, "fwd_ms": fwd, "fwd_bwd_ms": both}
                scale = float(forms["conv_transpose2d"]().detach().float().abs().max())
                tol = 1e-5 * scale if dtype == torch.float32 else 2 ** -6 * scale
                if not diff <= tol:
                    raise AssertionError(f"polyphase {key}: max diff {diff} > {tol}")
            del x, g
    say(f"polyphase: against F.conv_transpose2d, in turns: {json.dumps(out)} on {smi}")
    return out


def phase_eval_capture(smi: str) -> dict:
    """Phase 20, the eval as one program; see the module docstring. -> the
    kernel launches of its main path (every config's captured and eager
    batches)."""
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        reset_probe_counts()
        before = launches_now()
        rows = {}
        for label, name, which, n_samples in EVAL_CAPTURE_CASES:
            rows[label] = eval_capture_case(label, name, which, n_samples, smi)
            torch.cuda.empty_cache()
        counts = launched_since(before)
        for kernel in ("mdl_log_prob", "dl_log_prob"):
            if not counts.get(kernel):
                raise AssertionError(f"eval capture: the main path launched no {kernel}")
        if counts.get("mdl_log_prob direct"):
            raise AssertionError(f"eval capture: MoDL forward launches off the tile path: "
                                 f"{counts}")
        eval_capture_params()
        head_pad = eval_head_pad(smi)
        polyphase = eval_polyphase(smi)
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) = flags
    say("eval capture: make_batch_evaluator(mesh=) over NCCL at sample = 2: not measured "
        f"(needs two cards; this machine has {torch.cuda.device_count()})"
        if torch.cuda.device_count() < 2 else
        "eval capture: make_batch_evaluator(mesh=) over NCCL at sample = 2: not run in this "
        "phase (the script drives one card)")
    say("eval capture: " + json.dumps({"configs": rows, "head_pad": head_pad,
                                       "polyphase": polyphase}))
    return counts


def timed(label: str, fn, *args):
    """``fn(*args)``, printing the seconds it took. The phase's models are
    collected after it, and with them their evaluation graphs' memory."""
    t0 = time.perf_counter()
    out = fn(*args)
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase {label}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> None:
    smi = timed("device", phase_device)
    timed("build", phase_build)
    layouts = timed("layout", phase_layout)
    k6_err = timed("probe kernel", phase_sfu_check)
    by_path = {"roofline": timed("roofline", roofline_path, smi)}
    k6_case = k6_record(k6_err)
    max_err, fwd_cases = timed("MoDL forward", phase_kernel_vs_plain)
    bwd_err, bwd_excess, bwd_cases = timed("MoDL backward", phase_backward)
    dl_err, dl_bwd_err, dl_cases, dl_bwd_cases = timed("DL kernels", phase_dl_kernels)
    io_cases = timed("memory-path probes", phase_io_probes)
    for name in ("model05", "model03"):
        timed(f"{name} bound", phase_bound, name)
    for name in ("model05", "model03", "model04", "model06"):
        timed(f"{name} train step", phase_train_step_check, name)
    timed("model01 and model02", phase_small_models, smi)

    for name in ("model05", "model03"):
        for path in ("eval", "train"):
            by_path[f"{name} {path}"] = timed(f"{name} {path}", main_path, name, path, smi)
    structure_counts, isolate_ms = timed("measurement path", structure_path, smi)
    by_path.update(structure_counts)
    for name in ("model05", "model03"):
        timed(f"{name} profile", phase_profile, name)
    ladder_counts, ladder_fwd, ladder_bwd = timed("ladders", phase_ladders, smi)
    by_path.update(ladder_counts)
    by_path["model05 trainer"] = timed("training run", phase_trainer, smi)
    by_path["model05 cli"] = timed("CLI", phase_cli, smi)
    by_path.update(timed("parallel", phase_parallel, smi))
    timed("sharded serving", phase_export_mesh, smi)
    measure_counts, measure_shapes = timed("measurement entry points", phase_measurement, smi)
    by_path.update(measure_counts)
    by_path["capture"] = timed("compiled train step", phase_capture, smi)
    by_path["mesh capture"] = timed("mesh steps as one program", phase_mesh_capture, smi)
    by_path["eval capture"] = timed("eval as one program", phase_eval_capture, smi)

    def record(kernel, source, replaces, max_abs_err, case, counter=None, paths=None, **more):
        """One entry of the kernels line; ``launches`` sums the main paths'
        counts of ``counter`` (default: the kernel's name) over ``paths``
        (default: all)."""
        launches = {path: counts[counter or kernel] for path, counts in by_path.items()
                    if counts.get(counter or kernel) and (paths is None or path in paths)}
        return {"name": kernel, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(launches.values()), "launches_by_path": launches,
                "max_abs_err": max_abs_err, "library_ms": None, **case, **more}

    modl, dl = layouts["model05"], f"{layouts['model03']} halves"
    # the DL kernels' launches on the main paths by memory path
    dl_paths = {direction: {path: sum(counts.get(f"{kernel} {path}", 0)
                                      for counts in by_path.values())
                            for path in dl_kernel.PATHS}
                for direction, kernel in (("forward", "dl_log_prob"),
                                          ("backward", "dl_log_prob_backward"))}

    def null_record(direction, variant):
        case = io_cases[f"P3 {direction} {variant} float32 k=5 B={BATCH} {modl}"]
        kernel = f"mdl_null_{direction}[{variant}]"
        more = {}
        if case.get("path") == "tiled":  # the direct variant on the same operands, in turns
            dma = io_cases[f"P3 {direction} dma float32 k=5 B={BATCH} {modl}"]
            more = dict(ms_direct=dma["ms"])
            if "device_ms" in dma:
                more.update(device_ms_direct=dma["device_ms"])
        counts = by_path[f"kernel_structure {variant}"]
        more.update(launches_by_memory_path={
            path: counts[f"mdl_null_{direction} {path}"] for path in mdl_null.PATHS})
        return record(kernel, IO_SOURCE, REPLACES_P3, case["max_abs_err"], case,
                      counter=f"mdl_null_{direction}", paths=(f"kernel_structure {variant}",),
                      **more)

    def sum_record(kernel, replaces, case, timed, library):
        """A channel sum's entry: checked in phase_io_probes, timed by the
        memory-path probes; its plain version is the library's ``sum``."""
        case = io_cases[case]
        counter = "channel_sum " + kernel[kernel.index("[") + 1:-1].replace(",", " ")
        return record(kernel, IO_SOURCE, replaces, case["max_abs_err"], case, counter=counter,
                      ms=isolate_ms[timed], plain_ms=isolate_ms[library],
                      library_ms=isolate_ms[library])

    kernels = [
        record("mdl_log_prob", MODL_SOURCE, REPLACES, max_err,
               fwd_cases[f"K3f/K1f eval float32 k=100 B={BATCH} {modl}"],
               model_head_device_ms=fwd_cases["model05 head f32 k=100"]["device_ms"],
               model_head_device_ms_direct=fwd_cases["model05 head f32 k=100"]["device_ms_direct"],
               measurement_shapes=measure_shapes),
        record("mdl_log_prob_backward", MODL_SOURCE, REPLACES_BACKWARD, bwd_err["float32"],
               bwd_cases[f"K1b/K3b float32 k=5 B={BATCH} {modl}"],
               max_abs_err_bf16=bwd_err["bfloat16"], tolerance_excess=bwd_excess),
        record("dl_log_prob", DL_SOURCE, REPLACES_DL, dl_err,
               dl_cases[f"K5 f32 k=100 B={BATCH} {dl}"],
               launches_by_memory_path=dl_paths["forward"],
               model_head_device_ms=dl_cases["model03 head k=100"]["device_ms"],
               model_head_device_ms_direct=dl_cases["model03 head k=100"]["device_ms_direct"],
               model_head_bound_ms=dl_cases["model03 head k=100"]["bound_ms"],
               ladder_heads=ladder_fwd),
        record("dl_log_prob_backward", DL_SOURCE, REPLACES_DL, dl_bwd_err,
               dl_bwd_cases[f"K5 f32 k=5 B={BATCH} {dl}"],
               replaces_note=REPLACES_DL_BACKWARD_NOTE,
               launches_by_memory_path=dl_paths["backward"],
               model_head_device_ms=dl_bwd_cases["model03 head k=5"]["device_ms"],
               model_head_device_ms_direct=dl_bwd_cases["model03 head k=5"]["device_ms_direct"],
               model_head_bound_ms=dl_bwd_cases["model03 head k=5"]["bound_ms"],
               ladder_heads=ladder_bwd),
        record("sfu_probe", SFU_SOURCE, REPLACES_K6, k6_case["max_abs_err"], k6_case),
        sum_record("channel_sum[channel_minor,direct]", REPLACES_P1, "P1 channel_minor direct",
                   "direct", "library sum(-1)"),
        sum_record("channel_sum[channel_minor,staged]", REPLACES_P1,
                   "P1 channel_minor staged", "staged", "library sum(-1)"),
        sum_record("channel_sum[channel_first,direct]", REPLACES_P2, "P2 channel_first direct",
                   "channel-first direct", "library sum(1)"),
        null_record("forward", "dma"), null_record("forward", "staged"),
        null_record("backward", "dma"), null_record("backward", "staged"),
    ]
    for entry in kernels:
        if entry["launches"] < 1:
            raise AssertionError(f"no main path launched {entry['name']}")
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    import sys

    if "--rank" in sys.argv:  # one rank of phase 15 (b), 16 (b) or 19 (b), by spawn_ranks
        args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
        if args["--task"] == "parallel":
            parallel_child(int(args["--rank"]), int(args["--world"]), args["--store"],
                           args["--out"], args["--backend"])
        elif args["--task"] == "mesh_capture":
            mesh_capture_child(int(args["--rank"]), int(args["--world"]), args["--store"],
                               args["--out"], args["--backend"])
        else:
            serving_child(args["--task"], int(args["--rank"]), int(args["--world"]),
                          args["--store"], args["--out"], args["--backend"], args["--files"])
    else:
        main()
