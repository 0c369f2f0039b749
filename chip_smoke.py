#!/usr/bin/env python3
"""Drive the PyTorch port (``bridgerl_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py             # from the repository root, on a machine with a card
    python3 chip_smoke.py --profile   # adds device-time breakdowns of retarget at b=4096
                                      # (live and through the artifact), in each dtype,
                                      # after every timed phase

Phases, each printed as one JSON line; any failed check raises and the
script exits non-zero. Each runs in float32 and then in bfloat16
(``compute_dtype="bfloat16"``: K1's bf16 entry points, float32 parameters):

1. ``device``: the card's name and power limit (``nvidia-smi``), and the time
   to build the CUDA kernels from ``bridgerl_tpu_torch/csrc/``.
2. ``kernel`` lines: each kernel against its plain PyTorch version on the
   card, at the shapes the serving and training paths give it, with its
   time (median of CUDA-event timings after warm-up: ``ms`` with the inputs
   warm in L2, ``ms_cold`` after writing a 128 MB buffer, outside the timed
   events, before every launch), the least time the card could take for the
   work these inputs need (``bound_ms``), the plain version's time and,
   where one PyTorch call computes the same function, its time as a
   yardstick the port never calls. K1 runs with ``window`` = S / packing,
   so its bound counts the diagonal window blocks only (bytes 4 * 4 *
   BH * S * Dh forward and 7 * 4 * BH * S * Dh backward; FLOPs
   4 * BH * S * W * Dh and 10 * BH * S * W * Dh); its yardsticks are
   ``scaled_dot_product_attention`` over the full rows with the float bias
   (``library_full_ms``) and over the (BH * S / W, W, Dh) windows with no
   mask (``library_window_ms``), forward, and backward through autograd;
   ``library_ms`` is the faster of the two. K1 runs with dropout 0 and
   0.1; with dropout its keep mask must equal the plain Philox mask bit for
   bit in both directions, and its kept share lie within 4 sigma of 0.9.
   K1 in bf16 must lie within one bf16 ulp of the plain version (both
   round the same float32 quantity); its bound counts 2 bytes an element
   and the FLOPs at the bf16 tensor cores' 989 TFLOP/s. Windows of 32 and
   more take K1's tensor-core path (``attention.k1_plan``); in float32 it
   does three tf32 products for each (3xTF32), so its bound counts 3x the
   FLOPs at the tf32 tensor cores' 495 TFLOP/s.
   K1 also runs at (1024, 64, 64) with window 64, the CLI's default
   transformer (the zoo path), at the latent path's (128, 80, 64)
   packed and (176, 10, 64) unpacked, and at (8192, 128, 64) with window 64
   and packing 2 (the studies' K4 teacher tokenizing 4096 windows; its
   backward at the teacher's training microbatch, (1024, 128, 64)). The
   backward also runs at S = W = 160, Dh 128 and at S = W = 200, Dh 64,
   which take its two-kernel tensor-core path (the row-buffered dq kernel
   and the keys kernel, entry points ``packed_attention_bwd[_bf16]_long``;
   windows up to 64, and up to 128 at Dh <= 64, take the window-resident
   kernel); every backward case is launched
   twice and its dq, dk and dv must repeat bit for bit. K2 runs
   at N = 4096 (serving), 512 (training), 6554 (validation) and 16384 (the
   K4 teacher's 4096 windows x 4 tokens) with K = 512, and at K = 1024 with
   N = 4096 and 16384 (the zoo's standard, ema and rvq at the CLI's batch),
   and past 512 columns (D 640 and 1024 at N 512 and 4096, and D 2048 at N
   4096, K 512, and a stacked two-seed step at (N 512, D 640): the
   tensor-core kernel of csrc/k2_wide.cuh, the ``vq_assign_wide`` row, its
   bound three tf32 products a product at 495 TFLOP/s; no profile):
   its counts and dw must equal ``assignment_stats`` on the CPU for its own
   indices bit for bit, a second call must repeat the first bit for bit,
   and in a child process one profile of all its shapes (``k2_device_ops``;
   a process's later profiler sessions lose records) must see no device
   operation but its two kernels and one record of each a call: a record
   of any other operation fails at once, and a profile whose records are
   all K2's but fewer (the profiler lost some) is reported with its listing
   by shape and taken once more in a fresh child, which must be whole;
   each K2 line carries the device time of each of its two
   kernels (the records inside its shape's range) and the time of one and
   of two empty kernels
   (``launch_floor_ms``), timed the same way. Seed groups (a stacked
   multi-seed step): K1 forward and backward, f32 and bf16, at (4096, 80,
   64) with 4 seed groups, dropout 0.1 and 0.0, and K2 over 4 groups at
   (N 2048, D 64, K 512), each bit for bit equal to the launches of one
   group each and held to its plain version as above.
3. The serving path: the flagship retargeting model (full width, weights
   from a fixed seed) served through the port's ``ServingApp``: ``retarget``
   at b = 1, 5, 64, 512, 4096, ``robot_recon`` and ``motion_codes`` at b = 64,
   one ``retarget`` over HTTP with the port's client, and a 3,000-frame
   overlap-add. Every answer is checked for shape, dtype and finiteness, for
   8 attention and 4 nearest-code launches per model call, and against the
   same weights run on the CPU through the plain versions. In bf16 the
   codes may leave float32's on at most twice the CPU bf16 share of rows,
   and one row; on the windows (the frames, for the overlap-add) whose
   codes the card, the CPU bf16 and the CPU float32 runs all share, the
   answer lies within 4 bf16 ulps of its scale of the CPU's bf16 answer
   and no farther from the CPU's float32 answer than twice the CPU's bf16
   answer is; a bf16 b = 1 request whose window flips code compares no
   values, so successive windows are tried until one keeps its codes, and
   the check fails after 16. Windows/s at b = 4096 and the b = 1 median
   latency in each dtype (``serve_summary``).
4. The training path: the flagship's teacher trains through the port's
   ``Trainer`` (batch 16384 in 32 microbatches of 512, dropout 0.1, seeded
   normal windows as the JAX package's bench makes them), then the student
   from the teacher's best checkpoint. Losses must be finite, the
   checkpoints and histories must carry the reference's names and keys, and
   every microbatch must launch exactly 8 K1 forwards, 8 K1 backwards and
   4 K2 (teacher) or 16, 4 and 8 (student); validation launches forwards
   only. Windows/s after a warm-up epoch.
5. ``train_agree``: one optimizer batch of 512 at dropout 0 from one seed,
   on the card and on the CPU: loss within 1e-4 relative, every parameter's
   gradient within 1e-3 in relative norm. ``train_agree_bf16``: the same
   batch in bf16 on the card and on the CPU, each held to the CPU float32
   step: the card's loss and every gradient no farther than twice the CPU
   bf16 step's (the loss may always be one bf16 rounding, 2**-8, off).
   ``train_agree_wide``: the transformer + ema at hidden_dim 640 (K2 at D
   640 in training), one f32 step under train_agree's rule. ``train_wide``:
   the flagship at hidden_dim 1024 (every K2 call of its residual VQ at D
   1024 on the tensor-core kernel), teacher training through the Trainer
   as ``train`` (batch 16384 in 32 microbatches of 512, dropout 0.1), f32
   and bf16, one warm-up and one timed epoch of 16,384 training windows;
   windows/s and launches (``vq_assign_wide`` above 0 in both dtypes), one
   f32 step under train_agree's rule and one bf16 step under
   train_agree_bf16's.
6. The model zoo: every arch x method at full width (the JAX package's
   defaults; window 64, the CLI's) served through ServingApp on 64 windows
   (``retarget``, ``robot_recon``, and ``motion_codes`` where the method
   has codes) and held to the CPU plain path under the float32 rule, then
   one teacher step at the CLI's batch of 256, whose loss must be finite
   and whose launches must be what the method implies (K2 once for
   standard and ema, n_layers for rvq, 4 for the hybrid, none for fsq, lfq
   and ae; K1 8 forward and 8 backward for the transformer); the three conv
   archs with the hybrid in bf16 under the bf16 rule; ``zoo_agree``: one
   step at batch 256, dropout 0, card against CPU, for resnet + standard,
   simple + lfq and resnet_no_down + rvq.
7. The port's CLI, each stage a child process on the card:
   ``cli.process_data --synthetic``, a teacher (resnet_no_down + hybrid,
   window 10) for 2 epochs and its student for 1; the checkpoints and
   histories must carry the reference's names, and the teacher's train
   loss must fall. ``serve_trained``: that teacher's checkpoint served on
   its own windows, in float32 (trained weights put windows on code
   boundaries) with values within 1e-3 of the CPU's on the windows whose
   codes the two share, and every token whose codes differ an RVQ near tie
   under K2's rule (FSQ flips within CODES_AGREE's share, and one), and in
   bf16 under the bf16 rules, with the share of windows whose codes flip in
   bf16.
8. The frozen serving artifact (``export/serialize.py``) of the flagship,
   in float32 and in bf16: exported with cuda and cpu programs (timed),
   loaded in a child process (which must import no ``models``, ``train``
   or ``config``) and here, and its four functions called at b = 1, 7, 64
   and 4096 with the launches of the unpacked path (the artifact exports
   its towers with packing 1, so K1 runs at S = 10): in float32 within
   1e-5 of the live serving module with codes equal, and
   ``decode_codes(motion_codes(x))`` within 1e-5 of ``retarget(x)``; in
   bf16 under the bf16 rules against the CPU runs up to b = 64, and at
   4096 within 4 bf16 ulps of the live module's answer on the card. Retarget's windows/s at
   b = 4096 and its b = 1 median latency through the artifact and through
   the live module. ``decode_http``: one decode_codes request to the
   artifact's HTTP host as an npz and as JSON, each equal to the
   in-process answer, and a 400 for a malformed body. ``stream``:
   ``StreamingRetargeter`` over the artifact's retarget for 240 frames at
   window 10 and step 5, equal to offline overlap-add within 1e-5, every
   frame out exactly W + 1 frames after it went in; the median time of a
   push that completes a window.
9. ``recipe``: the W64-transformer recipe through the CLI, each stage a
   child process (stages that need only the same earlier file run
   together; the children run in a thread beside phase 7's CLI children,
   and their checks here after both): ``process_data --synthetic --window 64``, an ``ae``
   teacher for 1 epoch, the hybrid at step 0 (``--epochs 0``: its towers
   must equal the ae checkpoint's and its first-stage codebook rows be the
   robot encoder's outputs on the first 256 training windows, plus the
   jitter) and then trained for 1 epoch with ``--init_from``,
   ``--codebook_data_init``, ``--cheap_dropout``, ``--reuse_dropout_mask``
   and ``--accum_chunks 4`` (finite losses; K1 forward and backward and K2
   launched); ``export_motion`` on its checkpoint (the reference's file
   names, equal to ``reconstruct_long_sequence`` over the same model),
   ``export_serving --platforms cuda --check`` and ``serve_http
   --max_requests 1`` (its answer held to the checkpoint's live module).
   The bf16 artifact exports cuda programs only.
11. ``multiseed``: the stacked teacher (``MultiSeedTrainer``) at
   bench.py:137-182's configuration (the flagship in bf16, seeds 0-3, batch
   2048, packing 8, dropout 0.1, 32,768 seeded windows), 2 warm-up and 2
   timed epochs, beside two of its seeds one after another through
   ``Trainer`` (a sequential run's aggregate rate does not depend on its
   seed count): aggregate windows/s of each; the stacked run must launch K1
   and K2 exactly as often as one seed's run, the sequential run twice.
   ``cli_multiseed`` (in the CLI phase's directory): ``train_ablation
   --multiseed --seed 1 2 --lambda_fk 1 --int8_ff`` for 2 epochs, then the student from a
   ``{seed}`` teacher pattern; each seed's files, other weights per seed.
12. ``int8``: the flagship with ``int8_ff`` in bf16, ``retarget`` at b =
   4096 and b = 1 held to the CPU's int8 model under the bf16 rules, its
   rate beside the plain bf16 model's, then one teacher epoch; the int8
   product at (M 37, K 100, N 196), K and N off multiples of 8, bit for bit
   the CPU's in both dtypes.
13. ``fk``: G1 link positions of 4,096 random windows on the card within
   1e-5 of ``fk_numpy``; the f32 teacher with ``lambda_fk`` 1 for one epoch
   at the train path's configuration; one step against the CPU under
   train_agree's rule; device ms and operations of a microbatch of 512
   with and without the FK term, and of FK alone.
14. ``multiseed_profile``: device ms, operations and idle share of one
   stacked optimizer step at S = 1 and S = 4 (torch.profiler);
   ``multiseed_agree``: two seeds stacked, one f32 step at batch 512 and
   dropout 0, each seed held to the card's sequential step under
   train_agree's rule.
15. ``k1_causal`` (with the kernel checks of phase 2): K1 forward and
   backward under the token prior's causal bias over whole rows, f32 and
   bf16, at (128, 128, 64) (training: the tensor-core path), (16384, 5, 64) (the
   slot-AR depth stack: the float32 window tiles, the bf16 multi-window
   kernels), dropout 0.1 and 0, (16, 32, 64)
   (sampling) and (128, 96, 64) (the studies' prior at max_len 96), dropout
   0.1 and 0, (32, 160, 64) (the backward's two-kernel path), (128, 256,
   64) (the prior at 256 positions: two kernels) at dropout 0.1 and 0, and
   (128, 128, 32) (a prior at d_model 128: the window-resident kernel at Dh
   32), each held to the plain version under the rules of phase 2, the
   backward's second launch bit for bit its first,
   with its bound for the lower triangle's work and SDPA ``is_causal=True``
   as the library yardstick; ``k1_causal_mask``: both kernels' keep bits at
   (128, 128, 128) equal to the plain Philox mask on and below the
   diagonal, in both dtypes. ``k1_head_dims``: K1 forward and backward, f32
   and bf16, dropout 0.1, at head dims off the instantiated widths (16, 32,
   64, 96, 128), each staged as it is at the next width (the kernels'
   ragged form: Dh 8 and 24 at W 10 (window tiles in float32, multi-window
   kernels in bf16), beside the native
   rows of their widths, 16 and 32, 48 on the
   window-resident kernel at W 64 and at the Dh-48 prior's backbone (128,
   96, 96) and depth stack (12288, 5, 5), causal; rows whose copies are
   narrower than 16 bytes: Dh 50 at W 10, 12 on the tensor-core
   forward and window-resident backward, 100 on the row-buffered backward, 1
   on the full grid's two-sweep backward), at 96 (W 10; the d384L6 prior's
   backbone (128, 96, 96) and depth stack (12288, 5, 96), causal; the full
   grid (128, 256, 96) causal, whose backward takes the two-sweep kernels)
   and past 128 on the wide kernels (256 at W 10 and W 5, 160 at W 64, the
   full grid (128, 256, 256) causal, 512 at (8, 64, 64), the Dh-256 prior's
   backbone (64, 96, 96) and depth stack (6144, 5, 5), causal; 130 and 300
   in narrower copies), under the rules of phase 2, two launches bit for
   bit, with the true Dh's bound and SDPA; ``k1_head_dim_masks``: both
   kernels' keep bits at Dh 24, 96, 160, 512, 256 (W 5: 12 windows a block)
   and staged in the ragged form at 21 (odd), 48, 100 and 130, equal to the
   plain Philox mask, in both dtypes.
16. ``prior``: 256 synthetic takes of 645 frames through the flagship (seed
   0) give (256, 128, 5) code grids on the card (K1, K2); on 32 takes the
   CPU's grids are equal but where K2's near-tie rule explains an RVQ flip
   (an FSQ flip counts against CODES_AGREE). The full-width prior
   (``scripts/train_prior.py``'s defaults) trains 3 timed epochs in f32 and
   in bf16 (windows/s, tokens/s, losses), a slot-AR prior (2 depth layers)
   one; one step at dropout 0 is held to the CPU under train_agree's and
   train_agree_bf16's rules.
    ``prior_long`` (after ``generator_artifact``): the same at 256 positions,
   the JAX TokenPrior's own max_len: 128 takes of 1,285 frames give (128,
   256, 5) grids on the card, 8 takes held to the CPU's; the full-width
   prior trains 2 timed epochs in f32 and bf16, every K1 backward on the
   two-kernel path; one step at dropout 0 against the CPU under the same
   two rules.
    ``prior_wide`` (after ``prior_long``): the prior-capacity arm d384L6 of
   ``scripts/exp_prior_scaling.py`` (d_model 384, 6 layers, 4 heads: Dh 96,
   ff_dim 768, slot-AR with 2 depth layers, dropout 0.1, max_len 96, batch
   32) at full width: 256 takes of 485 frames give (256, 96, 5) grids on
   the card, 8 takes held to the CPU's; 2 timed epochs in f32 and bf16,
   each launching K1's forward and backward; one step at dropout 0 under
   the same two rules; one greedy ``sample_grids`` call (4 samples, 8
   positions) on the f32 prior, every token the argmax of the CPU's
   teacher-forced logits but where its two best lie within 1e-4.
    ``prior_dh256`` (after ``prior_wide``): the capacity sweep's next arm,
   ``exp_prior_scaling.py --d_model 512 --n_heads 2`` with its defaults (4
   layers, ff_dim 1024, slot-AR with 2 depth layers, dropout 0.1, max_len
   96, batch 32): Dh 256, so every K1 launch of its training is the wide
   kernels' ((64, 96, 96) and (6144, 5, 5), causal); the same checks as
   ``prior_wide`` on other takes of the same shape.
    ``prior_dh48`` (after ``prior_dh256``): the capacity sweep's arm below
   the default width, ``exp_prior_scaling.py --d_model 192`` with its
   defaults (4 heads: Dh 48; 4 layers, ff_dim 384, slot-AR with 2 depth
   layers, dropout 0.1, max_len 96, batch 32): every K1 launch of its
   training in the kernels' ragged form, staged at 64 ((128, 96, 96) on the
   tensor-core forward and the window-resident backward, (12288, 5, 5) on
   the window tiles in float32 and the multi-window kernels in bf16,
   causal); the same checks as ``prior_wide`` on other
   takes of the same shape.
17. ``generate``: 4 motions of 32 positions from the f32 prior, unguided,
   guided (8 candidates, guide_dyn 0.2) and prompted (8 positions of a
   take): every token the CPU's draw from the card's prefix with the same
   Philox-Gumbel noise, but where the CPU's two best perturbed scores lie
   within 1e-4 (counted); each guided choice the CPU's argmin over its own
   candidates where no draw or score ties; decoded motion within 1e-3 of
   the CPU's decode of the same grid; frames/s of ``make_generation_fn``
   unguided and guided, as scripts/bench_generation.py counts them.
18. ``generator_artifact``: the f32 prior and the flagship frozen (8
   positions unrolled, cuda programs; export timed), loaded in a child
   process (no models, train or config imported) and here; ``generate``
   for a seed within 1e-5 of the live ``make_generation_fn`` in the child,
   here and over HTTP (``{"seed": N}``).
19. ``latent``: the flagship (seed 0, f32) saved as a ``.pth``, loaded on
   the card and on the CPU; synthetic raw takes of 3 actions through
   ``eval/latent.py``'s ``load_paired_data_by_action`` (300 windows an
   action) and both encoders through ``get_latent_vectors`` at batch 256
   (K1-fwd packed, the last 44 windows unpacked): card within 1e-3 of the
   CPU, K1-fwd 4 launches a batch; the encoders' windows/s.
20. ``csv``: ``cli.csv_to_npz`` on a seeded 300-frame LAFAN-style take at 30
   fps, a child on the card and one with ``--device cpu`` (together): every npz array
   within 1e-5 of max(1, its largest value); each run's seconds.
21. ``replay``: a seeded 400-frame take (drifting root, turning root
   quaternion) at 20 -> 50 fps through ``load_motion`` on the card and the
   CPU, every array within 1e-6; one pass of ``G1ReplayScene.step``
   (sampled frames within 1e-5 of ``fk_numpy``) and of ``get_next_state``
   (the wrap-around on the last frame only); ``rollout`` and
   ``rollout_full`` at 20,000 frames, 64 sampled frames within 1e-5 of
   ``fk_numpy`` and every frame within 1e-5 of the CPU's ``BatchedFK`` on
   the same motion; replay steps/s at 20,000 frames (median of 3 calls of
   ``benchmark_steps_per_sec``). ``replay_profile``, in a child process
   (a process's later profiler sessions lose records): device ms,
   operations and idle share of one rollout at 2,000 and at 20,000 frames.
22. ``torch_import`` (the main path of the reference-checkpoint import):
   the flagship (seed 0, FSQ unbounded, as the reference trains it) written
   as a reference wrapper (``module.`` keys, a plain config dict), a bare
   ``_final.pth`` and the learned tensors of ``cli.export_torch_ckpt``;
   each imported by ``cli.import_torch_ckpt --check`` in a child process on
   the card (the children started together; the bare file with ``--window
   10``, and without it a child that must fail), every tensor bit for bit
   the original's; the imported checkpoint served through ServingApp at
   b = 1, 64 and 4096 under the float32 rule against the same payload
   imported on the CPU, 8 K1-fwd and 4 K2 launches a call; its windows/s
   at b = 4096 and b = 1 p50. ``runners``: ``cli.run_batch`` (a teacher,
   its student, and a spec with JAX's ``prng`` that must fail: exit 1
   naming it alone) and ``cli.run_queue`` (``process_data --synthetic``,
   then ``import_torch_ckpt --check``), two children together; their seconds and
   each entry's. ``demo_stream`` (after ``stream``): the demo's 6D feed of
   240 frames streamed through the f32 artifact at step 5 (equal to offline
   overlap-add within 1e-5, latency W + 1), then the G1 replay on the card
   within 1e-5 of the CPU's; the median push.
23. ``data_parallel`` (``parallel/``): the flagship at full width (f32,
   dropout 0) trained through ``make_train_epoch``, the Trainer's step, on
   two ranks sharing the card over gloo and on one NCCL rank, both started
   with ``parallel.launch`` together while this process runs each case alone
   as the reference, on the same index matrices: the teacher 3 optimizer
   steps at batch 4096 in 8 microbatches (each rank takes 256 rows of each),
   the student 1 step, the teacher at dropout 0.1 1 step (gloo), and
   ``resnet_no_down`` + ``ema`` 2 steps (gloo; BatchNorm). The gloo ranks:
   every step's logs within 2e-4 relative of one process, the first step's
   gradients within 1e-5 * (1 + max|g|), EMA and BatchNorm state within
   2e-3 (tests/test_sharding.py's bands); the BatchNorm case's gradients
   and last state within those bands or 2x what the same batches with each
   microbatch's rows swapped by halves or reversed move one process's own
   run, whichever is larger (its tower's backward cancels, and Adam's
   first step takes the sign of a gradient whose true value is 0); every parameter and buffer bit-equal
   on both ranks; the NCCL rank bit-equal to this process; at dropout 0.1 the
   ranks' first K1 keep masks differ; each rank's K1 and K2 launches equal a
   microbatch's count times its microbatches. Windows/s a rank (two ranks
   share one card, and the three processes overlap: no claim).
24. ``native`` (after the kernel checks): the host's C++ runtime
   (``runtime/native.py``) built with g++ (its seconds), each function bit
   for bit equal to its numpy version on seeded inputs (statistics within
   1e-6). ``research``: the token-prior studies and the quantizer
   diagnostics of ``cli/`` as one ``run_queue`` child on the card, in a
   thread beside the CLI phases' children (its inputs written and the CPU's
   side of its checks taken there): the W64 K4 teacher (transformer +
   hybrid, 4 tokens a window, packing 2; seed 0, f32, and bf16 for sampling
   and prompting), seed-0 W64 fsq and lfq transformers and 40 synthetic
   takes, at the studies' widths with depth cut (``RESEARCH_REDUCED``):
   exp_prior_ar (fact, ar), exp_prior_sampling (T 1.0, top_k 0 and 1),
   exp_prior_prompted (P 0 and 8), exp_prior_scaling (one arm),
   exp_prior_conditioned (3 takes a class), exp_prior_dynamics (one seed,
   lam 0 and 0.75), diag_fsq_spread, diag_lfq. Exit 0 and each entry's OK
   line, the JAX scripts' JSON keys with every number finite, the
   diagnostics' reports; the card's tokenization of the takes against the
   CPU's on the same weights (f32 codes equal on 99.9% of the valid
   positions' slots and exp_prior_ar's ceiling within 1e-3 of the CPU's;
   bf16 under the bf16 code rule); each entry's seconds and launches.
25. The ``kernels`` line (every kernel, float32 and bf16 rows, K1's split
   into the float32 window tiles, under the entry point's name, the bf16
   multi-window kernels (W < 32, csrc/k1_multi.cuh) under ``<entry>_multi``,
   and the tensor-core
   path, under ``<entry>_mma``, the backward's two-kernel launches apart
   under ``<entry>_long``, head dims past 128 under ``<entry>_wide``, each
   with its own cases; with its
   launches on each path: serve, train, zoo and cli in each dtype that runs
   them, artifact in each dtype, decode_http, stream, recipe, multiseed,
   fk, int8, prior, prior_long, prior_wide, prior_dh256, prior_dh48, generate,
   generator_artifact,
   latent, torch_import,
   demo_stream, data_parallel (the ranks' launches; cli includes
   cli_multiseed) and research (the studies' child, summed over its
   entries); counts
   are set to 0 before a path, and a path that also runs the model only to
   check an answer sums the launches of its own calls; the float32
   tensor-core rows must show launches on the zoo, recipe, prior and
   research paths, the two-kernel rows on prior_long, K1's forward and
   backward of each dtype and K2 on prior_wide, vq_assign_wide on
   train_wide, the wide rows of each
   dtype and K2 on prior_dh256, the window-tile (float32), multi-window
   (bf16) and tensor-core rows of K1's forward and backward in each dtype
   and K2 on prior_dh48; the bf16 multi-window rows on train, serve and
   artifact in bf16, multiseed, int8, prior_wide and prior_dh48, and no bf16
   K1 launch left to a window-tile row; the fused layout's rows,
   ``<entry>_qkv`` (``check_k1_qkv``: K1 on the projection's (B, S, 3d)
   output at the training shape, the artifact's unpacked (S = W = 10) and
   the slot-AR depth stack's, against its plain version, bit for bit
   the 3-D launch on the folded copies, timed beside it, ``ms_3d``, with
   SDPA on the strided (B, H, S, Dh) views as the yardstick), whose
   launches must equal each path's entry-point launches: every model
   launch of K1 takes the fused layout), then,
   last,
   ``{"ok": true, "device": {...}}``.

Every K1 case of ``check_k1``, ``check_k1_bwd``, ``check_k1_mask`` and the
seed-group cases is also launched through the fused layout (q, k and v side
by side in one (B, S, 3 H Dh) buffer of 4 heads) and must equal its 3-D
launch bit for bit (``fused_equal``). After the timed phases, ``attention_ops``
(f32 and bf16) lists the device operations of one profiled ``SelfAttention``
forward and backward at (64, 80, 256) and fails on any copy of q, k, v, out
or their gradients or any ``cat``; ``profile`` lines then break down one
teacher optimizer step in each dtype (``train_breakdown``: device ms,
launches and idle share).

It exits non-zero and prints no result when CUDA is unavailable.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import hashlib
import json
import math
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

from bridgerl_tpu_torch import parallel
from bridgerl_tpu_torch.cli import demo_stream_retarget, export_torch_ckpt
from bridgerl_tpu_torch.config import (
    ARCHS,
    HISTORY_KEYS,
    METHODS,
    compute_dtype,
    make_experiment,
)
from bridgerl_tpu_torch.data.dataset import PairedDataset, train_val_split
from bridgerl_tpu_torch.data.synthetic import generate_synthetic_dataset, synth_pair
from bridgerl_tpu_torch.export.client import ServingClient
from bridgerl_tpu_torch.export.motion_export import load_model_from_checkpoint, robot_recon_fn
from bridgerl_tpu_torch.export.reconstruct import reconstruct_long_sequence
from bridgerl_tpu_torch.export.serialize import (
    build_generator_artifact,
    build_serving_artifact,
    load_serving_artifact,
)
from bridgerl_tpu_torch.export.server import ServingApp, make_server
from bridgerl_tpu_torch.export.serving import build_serving_module
from bridgerl_tpu_torch.export.streaming import StreamingRetargeter, window_starts
from bridgerl_tpu_torch.export.torch_import import import_torch_checkpoint, load_pth
from bridgerl_tpu_torch.models import init_model
from bridgerl_tpu_torch.models.layers import SelfAttention, attention_bias, causal_bias
from bridgerl_tpu_torch.models.stacked import stack_models
from bridgerl_tpu_torch.models.token_prior import (
    filter_logits,
    init_prior,
    position_noise,
    prior_loss,
    sample_grids,
    sample_grids_guided,
)
from bridgerl_tpu_torch.ops import attention, codebook, kernels, vq_kernel
from bridgerl_tpu_torch.eval.latent import get_latent_vectors, load_paired_data_by_action
from bridgerl_tpu_torch.eval.studies import RAW_MEAN, RAW_STD, decode_ceiling, load_takes
from bridgerl_tpu_torch.runtime import native
from bridgerl_tpu_torch.sim import (
    G1ReplayScene,
    fk_numpy,
    load_g1_chain,
    load_motion,
    make_batched_fk,
)
from bridgerl_tpu_torch.sim.kinematics import BatchedFK
from bridgerl_tpu_torch.train.checkpoint import (
    load_checkpoint,
    save_checkpoint,
    to_reference_state_dict,
)
from bridgerl_tpu_torch.tools.kernel_times import K2_WIDE
from bridgerl_tpu_torch.train.codebook_seed import JITTER
from bridgerl_tpu_torch.train.prior import (
    PriorTrainConfig,
    decode_grid,
    epoch_order,
    extract_code_grids,
    make_decode_window_fn,
    make_generation_fn,
    split_indices,
    train_prior,
)
from bridgerl_tpu_torch.train.multiseed import (
    MultiSeedTrainer,
    make_stacked_train_epoch,
    stacked_accumulate_grads,
)
from bridgerl_tpu_torch.train.trainer import (
    Trainer,
    accumulate_grads,
    epoch_generator,
    fork_for_rank,
    make_optimizer,
    make_train_epoch,
)

SEED = 0
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
L2_FLUSH_BYTES = 128 << 20     # written before each cold launch: over twice the 50 MB L2
HOST_LEAD_CYCLES = 10_000_000  # a ~5 ms spin queued before each timed call
FP32_FLOPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12      # H100 SXM bfloat16 on the tensor cores (dense)
TF32_FLOPS_PER_S = 495e12      # H100 SXM tf32 on the tensor cores (dense): K1's float32
                               # long windows, three tf32 products a product (3xTF32)
BF16 = torch.bfloat16
DTYPES = (torch.float32, BF16)
DTYPE_NAME = {torch.float32: "float32", BF16: "bfloat16"}
# (B*H, S, Dh, packing, dropout): serving at b=4096 and b=64 unpacked, the training
# microbatch of 512 windows packed 8 to a row, the zoo's transformer at the CLI's
# defaults (window 64, batch 256, no packing), the artifact at b=4096 (unpacked), and
# the recipe's hybrid stage (microbatches of 64 windows, validation of 49)
K1_SHAPES = ((2048, 80, 64, 8, 0.0), (256, 10, 64, 1, 0.0), (256, 80, 64, 8, 0.0),
             (256, 80, 64, 8, 0.1), (1024, 64, 64, 1, 0.0), (1024, 64, 64, 1, 0.1),
             (16384, 10, 64, 1, 0.0),   # the artifact's retarget at b = 4096: unpacked
             (256, 64, 64, 1, 0.1), (256, 64, 64, 1, 0.0), (196, 64, 64, 1, 0.0),
             # the latent encoders at batch 256: packed, then the last 44 windows unpacked
             (128, 80, 64, 8, 0.0), (176, 10, 64, 1, 0.0),
             # the studies' W64 teacher (packing 2, 4 tokens a window) tokenizing a chunk
             # of 4096 windows
             (8192, 128, 64, 2, 0.0))
K1_BWD_SHAPES = ((256, 80, 64, 8, 0.1), (256, 80, 64, 8, 0.0), (2048, 80, 64, 8, 0.0),
                 (2048, 80, 64, 8, 0.1), (1024, 64, 64, 1, 0.1), (1024, 64, 64, 1, 0.0),
                 (256, 64, 64, 1, 0.1), (256, 64, 64, 1, 0.0),
                 # the studies' W64 K4 teacher's training microbatch (packing 2)
                 (1024, 128, 64, 2, 0.1),
                 # windows past the window-resident backward (W > 128, or Dh != 64):
                 # its two-kernel path
                 (24, 160, 128, 1, 0.1), (48, 200, 64, 1, 0.1))
# (N, D, K): serving, training, validation; the zoo's standard, ema and rvq at K = 1024,
# simple / resnet (N = 256 windows x 16 tokens) and resnet_no_down (x 64 frames); the
# recipe's hybrid microbatch and validation batch
K2_SHAPES = ((4096, 64, 512), (512, 64, 512), (6554, 64, 512), (4096, 64, 1024),
             (16384, 64, 1024), (64, 64, 512), (49, 64, 512),
             (16384, 64, 512))   # the studies' teacher: 4096 windows x 4 tokens

K2_KERNELS = ("vq_assign_nearest", "vq_assign_stats")   # device names of K2's kernels
K2_DEVICE_OPS = len(K2_KERNELS)   # its outputs need no zero-fill
DROPOUT = 0.1
K1_ATOL = 1e-4
K1_BF16_ULPS, K1_BF16_ATOL = 1.0, 1e-6   # one bf16 ulp of the plain value, beyond the
                                         # float32 summation noise where a sum cancels
# seed groups: K1 at the stacked multi-seed step's shape (4 seeds x 1024 rows: batch 2048
# packed 8 to a row, 4 heads), K2 over 4 groups at its N
K1_GROUPED = ((4096, 80, 64, 8, 0.1), (4096, 80, 64, 8, 0.0))
K1_GROUPS = 4
K2_GROUPED = ((4, 2048, 64, 512),)
K2_TIE = 1e-5
SERVE_ATOL = 1e-3
CODES_AGREE = 0.999
RETARGET_BATCHES = (1, 5, 64, 512, 4096)
TRAIN_WINDOWS, TRAIN_BATCH, TRAIN_ACCUM = 65536, 16384, 32
TEACHER_EPOCHS, STUDENT_EPOCHS = 2, 2   # each rate from the epochs after the first
# launches per microbatch (train) and per validation batch: K1 fwd, K1 bwd, K2
PER_MICROBATCH = {"teacher": (8, 8, 4), "student": (16, 4, 8)}
PER_VAL_BATCH = {"teacher": (8, 0, 4), "student": (16, 0, 8)}
AGREE_BATCH, AGREE_LOSS_RTOL, AGREE_GRAD_RTOL = 512, 1e-4, 1e-3
# bf16 answers against the CPU's float32 ones: no farther than BF16_FACTOR times
# the CPU's own bf16 answer; a scalar loss may always be one bf16 rounding off
BF16_FACTOR, BF16_LOSS_FLOOR = 2.0, 2.0 ** -8
# a served bf16 answer against the CPU's bf16 one, on the windows whose codes
# agree: GEMMs rounded in another order, 1 ulp a block through 8 blocks' residual
# stream, in bf16 ulps of the answer's largest magnitude
BF16_SERVE_ULPS = 4.0
B1_TRIES = 16   # bf16 b = 1 windows tried until one keeps its codes
# the model zoo: every arch x method at full width (the JAX package's defaults) and
# the CLI's window; eval forwards of ZOO_FWD windows, teacher steps and the card-vs-
# CPU steps at the CLI's batch
ZOO_W, ZOO_FWD, ZOO_BATCH = 64, 64, 256
ZOO_BF16_ARCHS = ("simple", "resnet", "resnet_no_down")
ZOO_AGREE = (("resnet", "standard"), ("simple", "lfq"), ("resnet_no_down", "rvq"))
ZOO_ORDER_FACTOR = 2.0   # x the CPU's own row-order spread of a gradient (zoo_agree)
# the verify drive on the port's CLI, and the teacher checkpoint it serves
CLI_DATA = ("--synthetic", "--window", "10", "--step", "2", "--n_sequences", "8")
CLI_RUN = ("--arch", "resnet_no_down", "--method", "hybrid", "--window", "10",
           "--batch_size", "256", "--seed", "42")
CLI_EPOCHS = {"teacher": 2, "student": 1}
CLI_TEACHER = "checkpoints/Exp_resnet_no_down_W10_hybrid_teacher_seed_42_best.pth"
CLI_TIMEOUT_S = 300
# runs a CLI module's main (argv[1]) in a child process and prints its kernel
# launches last
CLI_WRAPPER = ("import importlib, json, sys\n"
               "from bridgerl_tpu_torch.ops import kernels\n"
               "rc = importlib.import_module(sys.argv[1]).main(sys.argv[2:])\n"
               "print('LAUNCHES ' + json.dumps({n: c.count for n, c in "
               "kernels.COUNTERS.items()}))\n"
               "sys.exit(rc)\n")
TRAIN_CLI = "bridgerl_tpu_torch.cli.train_ablation"
SERVE_TRAINED_WINDOWS = 512
# the frozen artifact of the flagship: request sizes, and the agreement with the live
# module in float32 (the artifact computes unpacked attention: summation order only)
ARTIFACT_BATCHES = (1, 7, 64, 4096)
ARTIFACT_ATOL = 1e-5
ARTIFACT_CPU_CHECKED = 64   # bf16: the CPU runs check the functions up to this b
# loads the artifact in a child process and prints which modules it imported
ARTIFACT_LOAD_PROBE = (
    "import json, sys\n"
    "import numpy as np\n"
    "from bridgerl_tpu_torch.export.serialize import load_serving_artifact\n"
    "mod = load_serving_artifact(sys.argv[1])\n"
    "out = mod.retarget(np.zeros((2, mod.window_size, 126), np.float32)).cpu().numpy()\n"
    "print(json.dumps({'finite': bool(np.isfinite(out).all()), 'shape': list(out.shape),\n"
    "                  'device': str(mod.device), 'modules': sorted(sys.modules)}))\n")
STREAM_FRAMES, STREAM_STEP = 240, 5
# multiseed: bench.py:137-182's configuration (the flagship in bf16, 4 seeds, batch 2048,
# packing 8, dropout 0.1, 32,768 seeded windows), 2 warm-up epochs, then timed ones;
# the stacked run beside two of its seeds one after another through Trainer
MS_SEEDS, MS_WINDOWS, MS_BATCH, MS_WARM, MS_TIMED = (0, 1, 2, 3), 32768, 2048, 2, 2
MS_SEQ_SEEDS = MS_SEEDS[:2]   # the sequential half: its aggregate rate does not
                              # depend on how many seeds run one after another
MS_AGREE_SEEDS = (0, 1)
FK_TOL = 1e-5          # FK positions on the card against fk_numpy (float64)
FK_FRAMES = 4096       # windows of random joint radians held to fk_numpy (16 frames each)
CLI_MS_RUN = ("--arch", "transformer", "--method", "hybrid", "--window", "10",
              "--batch_size", "256", "--multiseed", "--seed", "1", "2", "--int8_ff")
CLI_MS_EPOCHS = {"teacher": 2, "student": 1}
# the W64-transformer recipe on the CLI: pretrain ae, then the hybrid from it
RECIPE_WINDOW, RECIPE_EPOCHS, RECIPE_SEED, RECIPE_BATCH = 64, 1, 42, 256
RECIPE_FLAGS = ("--codebook_data_init", "--cheap_dropout", "--reuse_dropout_mask",
                "--accum_chunks", "4")
RECIPE_MOTIONS = 2
RECIPE_AE_CKPT = (f"checkpoints/Exp_transformer_W{RECIPE_WINDOW}_ae_teacher_seed_{RECIPE_SEED}"
                  "_best.pth")
RECIPE_HYBRID = f"Exp_transformer_W{RECIPE_WINDOW}_hybrid_teacher_seed_{RECIPE_SEED}"
# the paths whose K1 must show launches of the tensor-core kernels (W >= 32)
MMA_PATHS = ("zoo", "recipe", "prior", "research")
# the paths on which the bf16 multi-window kernels (K1 below W 32) must launch, by direction
MULTI_PATHS = {"fwd": ("train_bf16", "serve_bf16", "artifact_bf16", "multiseed", "int8",
                       "prior_wide", "prior_dh48"),
               "bwd": ("train_bf16", "multiseed", "int8", "prior_wide", "prior_dh48")}
# the token prior: K1 under the causal bias at the prior's shapes (B*H, S, Dh, dropout):
# training (batch 32 x 4 heads, 128 positions), the slot-AR depth stack (32 x 128 rows of
# 5 slots x 4 heads), sampling (4 samples x 4 heads, 32 positions) and the studies'
# prior (batch 32 x 4 heads, max_len 96)
K1_CAUSAL = ((128, 128, 64, 0.1), (128, 128, 64, 0.0), (16384, 5, 64, 0.1),
             (16384, 5, 64, 0.0), (16, 32, 64, 0.0), (128, 96, 64, 0.1), (128, 96, 64, 0.0),
             (32, 160, 64, 0.1),   # past the window-resident backward: its two kernels
             # the prior at 256 positions (the JAX TokenPrior's max_len; two kernels) and at
             # d_model 128 with 4 heads (Dh 32, 128 positions; window-resident)
             (128, 256, 64, 0.1), (128, 256, 64, 0.0), (128, 128, 32, 0.1))
# synthetic takes of 645 frames: 128 windows each at W 10 and stride 5, one grid a take
PRIOR_TAKES, PRIOR_FRAMES, PRIOR_POSITIONS, PRIOR_STRIDE = 256, 645, 128, 5
PRIOR_EPOCHS = 3
PRIOR_CPU_TAKES = 32          # the takes whose grids the CPU also extracts
# the prior at 256 positions, the JAX TokenPrior's own max_len (models/token_prior.py:64):
# takes of 1,285 frames, 256 windows each at W 10 and stride 5; its backward is K1 causal
# (128, 256, 64), the two-kernel path
PRIOR_LONG_TAKES, PRIOR_LONG_FRAMES, PRIOR_LONG_POSITIONS = 128, 1285, 256
PRIOR_LONG_EPOCHS, PRIOR_LONG_CPU_TAKES = 2, 8
# the prior-capacity arm takes640_d384L6 (docs/ROUND3.md:373-377; scripts/exp_prior_scaling.py
# --d_model 384 --n_layers 6 with its defaults: 4 heads, so Dh 96; ff_dim 2 d_model, slot-AR
# with 2 depth layers, dropout 0.1, max_len 96, batch 32) at full width on the flagship's
# codes of synthetic takes of 485 frames (96 windows each at W 10 and stride 5); its K1 runs
# at (128, 96, 96) causal (the backbone) and (12288, 5, 96) causal (the depth stack)
PRIOR_WIDE = dict(d_model=384, n_heads=4, n_layers=6, ff_dim=768, dropout=0.1, slot_ar=True,
                  depth_layers=2)
PRIOR_WIDE_TAKES, PRIOR_WIDE_FRAMES, PRIOR_WIDE_POSITIONS = 256, 485, 96
PRIOR_WIDE_EPOCHS, PRIOR_WIDE_CPU_TAKES = 2, 8
PRIOR_WIDE_SAMPLES, PRIOR_WIDE_SAMPLED = 4, 8   # greedy sample_grids: samples, positions
# the capacity sweep's next arm at 2 heads (scripts/exp_prior_scaling.py --d_model 512
# --n_heads 2 with its defaults: 4 layers, ff_dim 2 d_model, slot-AR with 2 depth layers,
# dropout 0.1, max_len 96, batch 32): Dh 256, on the wide kernels, its K1 at (64, 96, 96)
# causal (the backbone) and (6144, 5, 5) causal (the depth stack); the same takes' shape as
# prior_wide's, other takes
PRIOR_DH256 = dict(d_model=512, n_heads=2, n_layers=4, ff_dim=1024, dropout=0.1, slot_ar=True,
                   depth_layers=2)
# the capacity sweep's arm below the default width (scripts/exp_prior_scaling.py --d_model 192
# with its defaults: 4 heads, so Dh 48; 4 layers, ff_dim 2 d_model, slot-AR with 2 depth
# layers, dropout 0.1, max_len 96, batch 32): K1 staged at 64 in the kernels' ragged form, at
# (128, 96, 96) causal (the backbone: tensor cores, the window-resident backward) and
# (12288, 5, 5) causal (the depth stack: window tiles, multi-window kernels in bf16); the same
# takes' shape as prior_wide's
PRIOR_DH48 = dict(d_model=192, n_heads=4, n_layers=4, ff_dim=384, dropout=0.1, slot_ar=True,
                  depth_layers=2)
# K1 at the head dims the instantiated widths do not cover (B*H, S, W, Dh, causal, what),
# beside the native rows of their widths at W 10 (16, 32),
# staged at the next width in the kernels' ragged form (Dh 8, 24, 48; the Dh-48 prior's
# shapes; rows in copies narrower than 16 bytes: 50, 12, 100, 1), the d384L6 prior's 96
# natively, and past 128 on the wide kernels (160, 256, 512; Dh 256 at W 5 and 10 with 12 and
# 6 windows a block, and the Dh-256 prior's shapes; 130 and 300 in narrower copies). The
# copies' bytes (f32 · bf16) follow attention.copy_bytes
K1_HEAD_DIMS = ((256, 80, 10, 8, False, "tiles · multi, staged at 16"),
                (256, 80, 10, 16, False, "tiles · multi, native at Dh 8's width"),
                (256, 80, 10, 24, False, "tiles · multi, staged at 32"),
                (256, 80, 10, 32, False, "tiles · multi, native at Dh 24's width"),
                (256, 80, 10, 96, False, "tiles · multi"),
                (256, 80, 10, 256, False, "wide, 6 windows a block"),
                (128, 96, 96, 96, True, "d384L6 backbone: tensor cores; row-buffered backward"),
                (12288, 5, 5, 96, True, "d384L6 depth stack: tiles · multi"),
                (256, 64, 64, 48, False, "window-resident, staged at 64"),
                (256, 64, 64, 160, False, "wide, 160 columns staged as they are"),
                (128, 256, 256, 96, True, "full grid: two-sweep backward"),
                (128, 256, 256, 256, True, "full grid: wide two-sweep backward"),
                (8, 64, 64, 512, False, "wide, 8 column groups of 64, small grid"),
                (64, 96, 96, 256, True, "Dh-256 prior backbone: wide"),
                (6144, 5, 5, 256, True, "Dh-256 prior depth stack: wide, 12 windows a block"),
                (512, 40, 5, 256, False, "wide, W 5, 12 windows a block"),
                (128, 96, 96, 48, True, "Dh-48 prior backbone: tensor cores; window-resident "
                 "backward, staged at 64"),
                (12288, 5, 5, 48, True, "Dh-48 prior depth stack: tiles · multi, staged at 64"),
                (256, 80, 10, 50, False, "tiles · multi, staged at 64, copies of 8 · 4 bytes"),
                (256, 64, 64, 12, False, "tensor cores; window-resident backward, staged at 16, "
                 "copies of 16 · 8 bytes"),
                (24, 160, 160, 100, False, "row-buffered backward, staged at 128, copies of "
                 "16 · 8 bytes"),
                (128, 256, 256, 1, True, "full grid: two-sweep backward, staged at 16, copies "
                 "of 4 bytes · plain loads"),
                (64, 96, 96, 130, True, "wide, staged at 144, copies of 8 · 4 bytes"),
                (256, 64, 64, 300, False, "wide, staged at 304, copies of 16 · 8 bytes"))
# the keep masks at head dims off the instantiated ones (B*H, S, W, Dh, causal): v = I
# reads p_drop, so Dh >= S; ragged at 21 (odd: copies of 4 bytes · plain loads), 48, 100
# (row-buffered) and 130 (wide)
K1_HEAD_DIM_MASKS = ((64, 20, 10, 24, False), (128, 96, 96, 96, True),
                     (64, 64, 64, 160, False), (8, 64, 64, 512, False),
                     (64, 20, 5, 256, False), (64, 20, 10, 21, False),
                     (16, 40, 40, 48, False), (8, 100, 100, 100, False),
                     (8, 64, 64, 130, False))
# K2 past 512 columns (N, D, K), csrc/k2_wide.cuh: K2_WIDE (tools/kernel_times.py's) at
# hidden_dim 640 and 1024, training's and serving's N; also D 2048, and the grouped case
# (G, N, D, K) of a two-seed step
K2_WIDE_MORE = ((4096, 2048, 512),)
K2_WIDE_GROUPED = ((2, 512, 640, 512),)
K2_WIDE_MAIN = [512, 1024, 512]   # train_wide's residual VQ: the wide row's main case
INT8_ODD = (37, 100, 196)     # the int8 product at K and N off multiples of 8: M, K, N
AGREE_WIDE_HIDDEN = 640       # train_agree_wide: K2 at D 640 in training (transformer + ema)
# train_wide: the flagship at hidden_dim 1024; one warm-up and one timed epoch of TRAIN_BATCH
# training windows (the dataset holds the validation split besides)
TRAIN_WIDE_HIDDEN, TRAIN_WIDE_EPOCHS = 1024, 2
ZERO29, ONE29 = np.zeros(29, np.float32), np.ones(29, np.float32)   # raw in, raw out
# sampling: motions a call, positions, guided candidates and dynamics weight (the
# README's recommended policy), prompt positions, the seed
GEN_SAMPLES, GEN_POSITIONS, GEN_CANDIDATES, GEN_DYN, GEN_PROMPT, GEN_SEED = 4, 32, 8, 0.2, 8, 7
GENERATOR_POSITIONS = 8       # unrolled into the generator artifact (its export's time
                              # grows with them; generate's frames/s keep GEN_POSITIONS)
GEN_TIE = 1e-4                # the CPU's two best perturbed scores this close: not compared
GEN_ATOL = 1e-3               # decoded motion, card against the CPU, on the same grid
REPLAY_TAKE = 400              # frames of the seeded take at 20 fps -> 998 frames at 50 fps
REPLAY_FRAMES = 20000         # bench.py:185's replay frames (an 8,001-frame take at 20 -> 50 fps)
REPLAY_PROFILED = (2000, 20000)
REPLAY_SAMPLED = 64           # rollout frames held to fk_numpy (every frame: to the CPU's
                              # BatchedFK on the same motion, within FK_TOL)
MOTION_TOL = 1e-6             # load_motion, card against the CPU
CSV_FRAMES = 300              # a LAFAN-style take at 30 fps
CSV_TOL = 1e-5                # each npz array, card against CPU, of max(1, its largest |value|)
LATENT_ACTIONS = ("walk", "run", "jump")
LATENT_TAKES, LATENT_TAKE_FRAMES = 3, 600   # 357 windows an action at stride 5, capped at 300
LATENT_BATCH = 256
LATENT_ATOL = 1e-3            # the serving float32 rule
# profiles one rollout at each of REPLAY_PROFILED frames in a child process
REPLAY_PROFILE_PROBE = ("import json, torch\n"
                        "torch.backends.cuda.matmul.allow_tf32 = False\n"
                        "import chip_smoke\n"
                        "print(json.dumps(chip_smoke.replay_profile_rows()))\n")
# the slice's main path: the flagship as the reference trains it (FSQ unbounded) in the
# three file shapes a user brings, imported on the card and served at these batches
IMPORT_CLI = "bridgerl_tpu_torch.cli.import_torch_ckpt"
IMPORT_BATCHES = (1, 64, 4096)
REFERENCE_CONFIG = {"arch": "transformer", "method": "hybrid", "window": 10, "hidden_dim": 64,
                    "mode": "teacher"}
# the streaming demo: the synthetic 6D feed through the f32 artifact, then the G1 replay
DEMO_FRAMES, DEMO_STEP, DEMO_FPS = 240, 5, 25
# the run drivers: run_batch's specs at the CLI's batch, and a run_queue of two entries
RUNNER_EPOCHS = {"teacher": 2, "student": 1}
RUNNER_OK = re.compile(r"=== ((?:batch|queue)\[\d+\] \S+).* OK \(([\d.]+)s\) ===")
# the research phase: the token-prior studies of cli/ as one run_queue child on the card,
# on the W64 K4 teacher (transformer + hybrid, 4 tokens a window, packing 2; seed 0, f32
# and bf16), seed-0 fsq and lfq W64 checkpoints and RESEARCH_TAKES synthetic takes; depth
# is cut (RESEARCH_REDUCED), widths are the studies' own
RESEARCH_TEACHER = dict(window=64, tf_tokens=4, attn_packing=2)
RESEARCH_TAKES, RESEARCH_FRAMES = 40, (1100, 1300)   # 33-39 windows a take at stride 32
RESEARCH_EPOCHS, RESEARCH_POSITIONS = 2, 32
RESEARCH_CPU_TAKES = {"float32": 16, "bfloat16": 8}   # tokenized on the CPU as well
RESEARCH_CEILING_ATOL = 1e-3   # exp_prior_ar's ceiling against the CPU's
RESEARCH_TIMEOUT_S = 600
RESEARCH_NICE = 10   # the child's CPU priority below the CLI and recipe children
RESEARCH_REDUCED = [
    f"epochs {RESEARCH_EPOCHS} (the studies' defaults: 200-300)",
    f"positions {RESEARCH_POSITIONS} (default 64)",
    f"{RESEARCH_TAKES} synthetic takes of {RESEARCH_FRAMES[0]}-{RESEARCH_FRAMES[1]} frames "
    "(the studies: 64-1280 takes of 6,000-6,400)",
    "exp_prior_ar arms fact,ar (default fact,ar,ar_ph4)",
    "exp_prior_sampling T 1.0, top_k 0 and 1 over the ar prior",
    "exp_prior_prompted P 0 and 8 (default 0,4,8,16)",
    f"exp_prior_scaling one arm of {RESEARCH_TAKES + 4} takes (default 64,160,320)",
    "exp_prior_conditioned arms 3 at 700-800 frames, 2 samples a class (default 3,12,48 "
    "at 6,000-6,400, 6 a class)",
    f"exp_prior_dynamics {RESEARCH_TAKES} takes, seed 42, lam 0 and 0.75 (default 1280 "
    "takes, seeds 42,43)"]
# JSON keys the studies write (the JAX scripts'): the statistics of compare_to_data, code
# novelty and the nearest data window
GEN_KEYS = ("jerk_ratio", "jerk_rms_data", "jerk_rms_gen", "range_coverage_mean",
            "range_coverage_min", "static_frac_data", "static_frac_gen", "vel_ratio",
            "vel_rms_data", "vel_rms_gen")
NOVELTY_KEYS, NN_KEYS = ("bigram_novel_frac", "position_novel_frac"), (
    "nn_mse_max", "nn_mse_mean", "nn_mse_min")
CURVE_KEYS = ("nn_mse_by_offset", "offsets", "truth_mse_by_offset")
# runs run_queue's main (argv[1]) and prints each entry's kernel launches after it: the
# queue drops the port's modules between entries, and with them the counters
RESEARCH_WRAPPER = ("import json, sys\n"
                    "from bridgerl_tpu_torch.cli import run_queue\n"
                    "def launches(label):\n"
                    "    k = sys.modules.get('bridgerl_tpu_torch.ops.kernels')\n"
                    "    counts = {n: c.count for n, c in k.COUNTERS.items()} if k else {}\n"
                    "    print('LAUNCHES ' + json.dumps(counts), flush=True)\n"
                    "sys.exit(run_queue.main(sys.argv[1:], after_entry=launches))\n")
# data_parallel: the flagship (f32, dropout 0) on 2 ranks sharing the card over gloo and
# on 1 NCCL rank, each case against the one-process Trainer path (make_train_epoch) on
# the same index matrices: (arch, method, mode, optimizer steps, dropout, gradients kept)
DP_RANKS, DP_BATCH, DP_ACCUM, DP_STEPS = 2, 4096, 8, 3
DP_CASES = {"teacher": ("transformer", "hybrid", "teacher", DP_STEPS, 0.0, True),
            "student": ("transformer", "hybrid", "student", 1, 0.0, True),
            "dropout": ("transformer", "hybrid", "teacher", 1, DROPOUT, False),
            "batchnorm": ("resnet_no_down", "ema", "teacher", 2, 0.0, True)}
DP_NCCL_CASES = ("teacher", "student")
# tests/test_sharding.py's bands: loss rtol, gradient atol * (1 + max|g|), EMA / BatchNorm
DP_LOSS_RTOL, DP_GRAD_ATOL, DP_STATE_ATOL = 2e-4, 1e-5, 2e-3
DP_STATE = ("ema_w", "ema_cluster_size", "embedding.weight", "running_mean", "running_var")
# the BatchNorm case against one process's own row-order spread: the same batches with each
# microbatch's rows in these orders, in this process; held to DP_ORDER_FACTOR x the spread
DP_ORDERS, DP_ORDER_FACTOR = ("halves_swapped", "reversed"), 2.0
DP_TIMEOUT_S = 300
# profiles K2 at each of K2_SHAPES in a child process
K2_PROFILE_PROBE = ("import json, torch\n"
                    "import chip_smoke\n"
                    "print(json.dumps(chip_smoke.k2_device_ops_rows()))\n")
# loads the generator artifact in a child process, generates for a seed into a file
GENERATOR_LOAD_PROBE = (
    "import json, sys\n"
    "import numpy as np\n"
    "from bridgerl_tpu_torch.export.serialize import load_serving_artifact\n"
    "mod = load_serving_artifact(sys.argv[1])\n"
    "out = mod.generate(int(sys.argv[2])).cpu().numpy()\n"
    "np.save(sys.argv[3], out)\n"
    "print(json.dumps({'device': str(mod.device), 'modules': sorted(sys.modules)}))\n")


T_START = time.perf_counter()
# runs a phase's child process beside the phase's own checks
BACKGROUND = concurrent.futures.ThreadPoolExecutor(2)
EMIT_LOCK = threading.Lock()


def emit(obj) -> None:
    """Print ``obj`` as a line of JSON, whole (phases may run in threads); a
    phase's line also carries the script's seconds so far (``t_s``)."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T_START}
    with EMIT_LOCK:
        sys.stdout.write(json.dumps(obj) + "\n")
        sys.stdout.flush()


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def time_ms(fn, warmup: int = 5, iters: int = 30, cold: bool = False) -> float:
    """Median device time of one call, from CUDA events. A spin kernel
    queued before the start event keeps the card busy while the host
    enqueues the call, so the events bracket the call's device work and not
    the host's time to launch it. ``cold`` writes a buffer larger than L2
    before each call, outside the timed events."""
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda") if cold else None
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        if cold:
            flush.fill_(1.0)
        torch.cuda._sleep(HOST_LEAD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, flops: float, flops_per_s: float = FP32_FLOPS_PER_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def k2_bound(N: int, D: int, K: int, G: int = 1):
    """K2's bound: x and the codebook read once, idx, counts and dw written
    once; the products 2 N K D at the float32 cores' rate up to 512 columns,
    past it three tf32 products a product at the tensor cores' rate
    (csrc/k2_wide.cuh, as k1_bound counts K1's float32 tensor-core rows); the
    norms (2 K D) and dw's adds (N D) at the float32 cores' rate."""
    nbytes = 4 * G * (N * D + K * D + N + K + K * D)
    other = G * (2 * K * D + N * D)
    if D <= vq_kernel.MAX_NARROW:
        return bound(nbytes, G * 2 * N * K * D + other)
    seconds = G * 3 * 2 * N * K * D / TF32_FLOPS_PER_S + other / FP32_FLOPS_PER_S
    return bound(nbytes, seconds * FP32_FLOPS_PER_S)


def bf16_ulp(x) -> float:
    """The bfloat16 spacing at |x|: 2**-7 of the power of two at or below it."""
    return 2.0 ** (math.floor(math.log2(max(abs(float(x)), 2.0 ** -126))) - 7)


def bf16_ulps(got: torch.Tensor, want: torch.Tensor, atol: float = 0.0) -> float:
    """The largest ``|got - want| - atol`` in units of the bfloat16 spacing
    at each ``want``. Two bfloat16 results that round the same float32
    quantity, summed in another order, are at most 1 apart; ``atol`` allows
    for the float32 sums themselves, which differ by ~1e-7 of their terms
    and show where a sum cancels to near 0."""
    g, w = got.double(), want.double()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126))) - 7)
    return ((g - w).abs() - atol).clamp_min(0.0).div(ulp).max().item()


def k1_bound(dtype, elements: int, flops: int, window: int, mma=None):
    """K1's bound for its dtype: bytes at the element's size, FLOPs at the
    rate of the units the kernel uses: the bf16 tensor cores (bfloat16), the
    float32 cores (float32 window tiles) or, for float32 long windows (and
    ``mma``: the wide kernels of head dims past 128 at any W), the tf32
    tensor cores doing three products for each (3xTF32)."""
    if dtype == BF16:
        return bound(2 * elements, flops, BF16_FLOPS_PER_S)
    if (window >= attention.MIN_MMA_WINDOW) if mma is None else mma:
        return bound(4 * elements, 3 * flops, TF32_FLOPS_PER_S)
    return bound(4 * elements, flops)


def k1_want(want: dict, window: int) -> dict:
    """``want`` with each K1 entry point's tensor-core counter: the entry's
    launches where ``window`` takes that path (W >= MIN_MMA_WINDOW), else 0;
    and the bf16 multi-window counters (:func:`multi_want`)."""
    for name in attention.ENTRY.values():
        long = window >= attention.MIN_MMA_WINDOW
        want[name + "_mma"] = want.get(name, 0) if long else 0
    return multi_want(want)


def multi_want(want: dict) -> dict:
    """``want`` with each bf16 K1 entry point's multi-window counter: its
    launches below MIN_MMA_WINDOW at Dh <= 128, which are the ones on neither
    its tensor-core nor its wide counter; and the fused-layout counters
    (:func:`qkv_want`)."""
    for counter in attention.MULTI_COUNTER.values():
        entry = counter.name.removesuffix("_multi")
        want[counter.name] = (want.get(entry, 0) - want.get(entry + "_mma", 0)
                              - want.get(entry + "_wide", 0))
    return qkv_want(want)


def qkv_want(want: dict) -> dict:
    """``want`` with each K1 entry point's fused-layout counter: every launch
    of a model is one (SelfAttention hands K1 the projection's output)."""
    for key, counter in attention.QKV_COUNTER.items():
        want[counter.name] = want.get(attention.ENTRY[key], 0)
    return want


def launches() -> dict:
    return {name: c.count for name, c in kernels.COUNTERS.items()}


def _delta(before: dict) -> dict:
    """The launches since ``before``."""
    now = launches()
    return {k: now[k] - before[k] for k in now}


def add_launches(*deltas: dict) -> dict:
    """The sum of launch deltas: a path's count is the sum over its own
    calls, so that calls made only to check an answer (a bf16 answer's codes
    on the card model, the live module beside the artifact) are left out."""
    return {name: sum(d.get(name, 0) for d in deltas) for name in kernels.COUNTERS}


# device names of the port's kernels
PORT_KERNELS = ("k1_fwd_", "k1_bwd_", "vq_assign_nearest", "vq_assign_stats")


def _top(rows, n: int):
    """The n largest rows by device time, and every row of the port's own
    kernels below them."""
    return rows[:n] + [r for r in rows[n:] if any(k in r[0] for k in PORT_KERNELS)]


# ---------------------------------------------------------------- phase 2

def _k1_inputs(g, BH, S, Dh, P, dtype=torch.float32):
    q, k, v = (torch.randn(BH, S, Dh, device="cuda", generator=g).to(dtype)
               for _ in range(3))
    seed = attention.draw_seed(g, "cuda")
    return q, k, v, attention_bias(P, S // P, "cuda"), 1.0 / Dh ** 0.5, seed


def _sdpa_forms(q, k, v, bias, scale, rate, W):
    """The two single-call yardsticks: SDPA over the full rows with the
    float bias (in q's dtype, as SDPA takes it), and over the
    (BH * S / W, W, Dh) windows with no mask (the same function, since the
    bias is 0 inside the windows)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    Dh = q.shape[-1]
    qw, kw, vw = (t.view(-1, W, Dh) for t in (q, k, v))
    mask = bias.to(q.dtype)
    return (lambda: sdpa(q, k, v, attn_mask=mask, scale=scale, dropout_p=rate),
            lambda: sdpa(qw, kw, vw, scale=scale, dropout_p=rate))


K1_FUSED_HEADS = 4   # heads of the fused layout each K1 case is also launched in


def _fused_qkv(q, k, v, H: int = K1_FUSED_HEADS):
    """q, k and v side by side in one (B, S, 3 H Dh) buffer, row b * H + h head
    h of batch row b: the projection's output that SelfAttention hands K1."""
    return torch.cat([attention.unfold_heads(t, H) for t in (q, k, v)], dim=-1)


def fused_equal(name: str, q, k, v, bias, args: tuple, outs, do=None) -> bool:
    """The case launched through the fused layout (attention_qkv: q, k and v
    read in place, out written as (B, S, d); with ``do``, d(qkv) as one
    (B, S, 3d) tensor): bit for bit the 3-D launch's ``outs``."""
    H = K1_FUSED_HEADS
    qkv = _fused_qkv(q, k, v, H)
    if do is None:
        got = attention.attention_qkv(qkv, H, bias, *args)
        want = attention.unfold_heads(outs[0], H)
    else:
        got = attention.attention_qkv_bwd(qkv, H, bias, attention.unfold_heads(do, H), *args)
        want = torch.cat([attention.unfold_heads(t, H) for t in outs], dim=-1)
    torch.cuda.synchronize()
    require(torch.equal(got, want), f"{name}: the fused layout's launch differs from the "
            f"3-D launch in {int((got != want).sum())} elements")
    return True


def _agreement(name: str, got, want, dtype) -> dict:
    """The kernel's outputs against the plain version's: 1e-4 absolute in
    float32, one bf16 ulp of the plain value in bfloat16."""
    got, want = list(got), list(want)
    require(all(torch.isfinite(a).all().item() and a.dtype == dtype for a in got),
            f"{name}: non-finite values or not {dtype}")
    err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
    if dtype == BF16:
        ulps = max(bf16_ulps(a, b, K1_BF16_ATOL) for a, b in zip(got, want))
        require(ulps <= K1_BF16_ULPS, f"{name}: {ulps} bf16 ulps from the plain version")
        return {"max_abs_err": err, "max_ulp_err": ulps}
    require(err <= K1_ATOL, f"{name}: max abs error {err} > {K1_ATOL}")
    return {"max_abs_err": err}


def _kernel_row(name: str, source: str, replaces: str, cases: list) -> dict:
    main, rest = cases[0], cases[1:]
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            **main, "kernel_ms": main["ms"], "cases": rest}


ROW_KEYS = ("name", "route", "source", "replaces", "kernel_ms", "cases")
WIDE_SOURCE = "bridgerl_tpu_torch/csrc/k1_wide.cuh"   # K1 past Dh 128, both directions
MULTI_SOURCE = "bridgerl_tpu_torch/csrc/k1_multi.cuh"   # bf16 K1 below W 32, both directions


def k1_case_kernel(name: str, case: dict) -> str:
    """The row of the ``kernels`` line that a K1 case of entry point ``name``
    belongs to: the float32 window tiles (W < MIN_MMA_WINDOW) under the
    entry's name, the bf16 multi-window kernels there under
    ``<entry>_multi``; the tensor-core path under ``<entry>_mma`` and, for
    the backward's two-kernel launches (its plan has a dk / dv kernel),
    ``<entry>_long``. A head dim past 128 takes the wide kernels at every W:
    ``<entry>_wide``."""
    BH, S, Dh = case["shape"]
    direction = "bwd" if "bwd" in name else "fwd"
    plan = attention.k1_plan(BH, S, case["window"], Dh, BF16 if "bf16" in name else torch.float32,
                             direction, case.get("bias") == "causal")
    if plan.path == "tiles":
        return name
    if plan.path in ("wide", "multi"):
        return f"{name}_{plan.path}"
    return name + ("_long" if plan.blocks_kv else "_mma")


def split_k1_rows(table: list) -> list:
    """Each K1 entry point's row split by the kernels it launched
    (:func:`k1_case_kernel`), each with its own cases, the first its main
    one: a bf16 entry point has no window-tile row, its multi-window row in
    its place. K2's row is kept."""
    out = []
    for row in table:
        if row["name"] not in attention.ENTRY.values():
            out.append(row)
            continue
        main = {k: v for k, v in row.items() if k not in ROW_KEYS}
        cases = [main, *row["cases"]]
        bf16 = row["name"] + "_multi" in kernels.COUNTERS
        names = [row["name"] + ("_multi" if bf16 else ""), row["name"] + "_mma"]
        if "bwd" in row["name"]:
            names.append(row["name"] + "_long")
        names.append(row["name"] + "_wide")
        for name in names:
            part = [c for c in cases if k1_case_kernel(row["name"], c) == name]
            source = (WIDE_SOURCE if name.endswith("_wide") else
                      MULTI_SOURCE if name.endswith("_multi") else row["source"])
            out.append(_kernel_row(name, source, row["replaces"], part))
    return out


def row_launches(row: dict, launched: dict) -> int:
    """A kernel row's launches in one path's counts: an entry point's window
    tiles are its launches less its tensor-core, wide and multi-window ones
    (none for bf16, whose short windows are all multi-window launches), the
    backward's window-resident kernel its tensor-core launches less its
    two-kernel ones, and K2's row its launches less those past 512 columns."""
    name = row["name"]
    if name in attention.ENTRY.values():
        return (launched[name] - launched[name + "_mma"] - launched[name + "_wide"]
                - launched.get(name + "_multi", 0))
    if name == vq_kernel.launch_counter.name:   # K2's launches up to 512 columns
        return launched[name] - launched[vq_kernel.wide_counter.name]
    if name.endswith("_mma") and name[:-4] + "_long" in launched:
        return launched[name] - launched[name[:-4] + "_long"]
    return launched[name]


def _timings(kernel, plain, library_full, library_window) -> dict:
    full, window = time_ms(library_full), time_ms(library_window)
    return {"ms": time_ms(kernel), "ms_cold": time_ms(kernel, cold=True),
            "plain_ms": time_ms(plain), "library_ms": min(full, window),
            "library_full_ms": full, "library_window_ms": window}


def _k1_grouped_case(g, dtype, direction: str, BH, S, Dh, P, rate) -> dict:
    """K1 (``direction`` fwd or bwd) with K1_GROUPS seed groups in one
    launch: bit for bit the launches of one group each, and within today's
    tolerance of the plain version's grouped call; timed as the other cases."""
    W, G = S // P, K1_GROUPS
    q, k, v, bias, scale, _ = _k1_inputs(g, BH, S, Dh, P, dtype)
    do = torch.randn(BH, S, Dh, device="cuda", generator=g).to(dtype)
    seeds = torch.randint(0, attention.SEED_HIGH, (G,), device="cuda", generator=g,
                          dtype=torch.int32)
    if direction == "fwd":
        run = lambda q, k, v, do, sd: [attention.attention_fwd(q, k, v, bias, scale, sd, rate, W)]
        plain = lambda: [attention.packed_attention_reference(q, k, v, bias, scale, seeds, rate,
                                                              W)]
        b_ms, b_by = k1_bound(dtype, 4 * BH * S * Dh, 4 * BH * S * W * Dh, W)
    else:
        run = lambda q, k, v, do, sd: list(attention.attention_bwd(q, k, v, bias, do, scale, sd,
                                                                   rate, W))
        plain = lambda: list(attention.packed_attention_bwd_reference(q, k, v, bias, do, scale,
                                                                      seeds, rate, W))
        b_ms, b_by = k1_bound(dtype, 7 * BH * S * Dh, 10 * BH * S * W * Dh, W)
    got = run(q, k, v, do, seeds)
    fused = fused_equal(f"K1-{direction} {BH, S, Dh} {G} groups", q, k, v, bias,
                        (scale, seeds, rate, W), got, None if direction == "fwd" else do)
    n = BH // G
    for i in range(G):
        r = slice(i * n, (i + 1) * n)
        one = run(q[r], k[r], v[r], do[r], seeds[i:i + 1])
        require(all(torch.equal(a[r], b) for a, b in zip(got, one)),
                f"K1-{direction} {BH, S, Dh}: seed group {i} differs from its own launch")
    torch.cuda.synchronize()
    name = attention.ENTRY[direction, dtype]
    if direction == "fwd":
        library = _sdpa_forms(q, k, v, bias, scale, rate, W)
    else:
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        outs = [f() for f in _sdpa_forms(qg, kg, vg, bias, scale, rate, W)]
        library = [lambda o=o, d=d: torch.autograd.grad(o, (qg, kg, vg), d, retain_graph=True)
                   for o, d in zip(outs, (do, do.view(-1, W, Dh)))]
    case = {"shape": [BH, S, Dh], "dtype": DTYPE_NAME[dtype], "packing": P, "window": W,
            "dropout": rate, "seed_groups": G, "equal_to_single_group_launches": True,
            "fused_equal": fused,
            **_agreement(f"{name} {BH, S, Dh} {G} groups dropout {rate}", got, plain(), dtype),
            "bound_ms": b_ms, "bound_by": b_by,
            **_timings(lambda: run(q, k, v, do, seeds), plain, *library)}
    emit({"phase": "kernel", "name": name, **case})
    return case


def check_k1(g: torch.Generator, dtype=torch.float32) -> dict:
    """K1's forward for q, k, v of ``dtype`` against the plain version on the
    same inputs, at the serving and training shapes."""
    name = attention.ENTRY["fwd", dtype]
    cases = []
    for BH, S, Dh, P, rate in K1_SHAPES:
        W = S // P
        q, k, v, bias, scale, seed = _k1_inputs(g, BH, S, Dh, P, dtype)
        out = attention.attention_fwd(q, k, v, bias, scale, seed, rate, W)
        fused = fused_equal(f"{name} {BH, S, Dh} dropout {rate}", q, k, v, bias,
                            (scale, seed, rate, W), [out])
        ref = attention.packed_attention_reference(q, k, v, bias, scale, seed, rate, W)
        b_ms, b_by = k1_bound(dtype, 4 * BH * S * Dh, 4 * BH * S * W * Dh, W)
        case = {
            "shape": [BH, S, Dh], "dtype": DTYPE_NAME[dtype], "packing": P, "window": W,
            "dropout": rate, "fused_equal": fused,
            **_agreement(f"{name} {BH, S, Dh} dropout {rate}", [out], [ref], dtype),
            "bound_ms": b_ms, "bound_by": b_by,
            **_timings(lambda: attention.attention_fwd(q, k, v, bias, scale, seed, rate, W),
                       lambda: attention.packed_attention_reference(
                           q, k, v, bias, scale, seed, rate, W),
                       *_sdpa_forms(q, k, v, bias, scale, rate, W)),
        }
        emit({"phase": "kernel", "name": name, **case})
        cases.append(case)
    cases += [_k1_grouped_case(g, dtype, "fwd", *shape) for shape in K1_GROUPED]
    return _kernel_row(name, "bridgerl_tpu_torch/csrc/k1_fwd.cuh",
                       "bridgerl_tpu/ops/pallas/attention.py:143", cases)


def check_k1_mask(g: torch.Generator, dtype=torch.float32) -> dict:
    """With v = I (Dh >= S) the forward returns p_drop, and with dout = I the
    backward's dv is p_drop^T: both kernels' keep bits, read inside each
    window (where p > 0), must equal the plain Philox mask exactly."""
    BH, S, Dh, P = 256, 80, 128, 8
    q, k, _, bias, scale, seed = _k1_inputs(g, BH, S, Dh, P, dtype)
    eye = torch.eye(S, Dh, device="cuda", dtype=dtype).expand(BH, S, Dh).contiguous()
    args = (scale, seed, DROPOUT, S // P)
    out = attention.attention_fwd(q, k, eye, bias, *args)
    grads = attention.attention_bwd(q, k, eye, bias, eye, *args)
    fwd = out[:, :, :S] > 0
    bwd = grads[2][:, :S, :S].transpose(1, 2) > 0
    what = f"K1 {DTYPE_NAME[dtype]} mask case"
    fused_equal(what + " fwd", q, k, eye, bias, args, [out])
    fused_equal(what + " bwd", q, k, eye, bias, args, grads, eye)
    inside = attention_bias(P, S // P, "cuda") == 0
    want = attention.attention_dropout_mask(seed, BH, S, DROPOUT, "cuda") & inside
    require(torch.equal(fwd, want), f"K1 fwd keep mask differs in {int((fwd != want).sum())}")
    require(torch.equal(bwd, want), f"K1 bwd keep mask differs in {int((bwd != want).sum())}")
    n = int(inside.sum()) * BH
    share = fwd.sum().item() / n
    sigma = math.sqrt(DROPOUT * (1 - DROPOUT) / n)
    require(abs(share - (1 - DROPOUT)) <= 4 * sigma,
            f"K1 kept share {share} is not within 4 sigma ({sigma}) of {1 - DROPOUT}")
    out = {"phase": "kernel_mask", "dtype": DTYPE_NAME[dtype], "shape": [BH, S, Dh],
           "packing": P,
           "dropout": DROPOUT, "kept_share": share, "sigma": sigma, "elements": n,
           "mask_equal_fwd": True, "mask_equal_bwd": True, "fused_equal": True}
    emit(out)
    return out


def check_k1_bwd(g: torch.Generator, dtype=torch.float32) -> dict:
    """K1's backward for q, k, v, dout of ``dtype`` against the plain
    version on the same inputs."""
    name = attention.ENTRY["bwd", dtype]
    cases = []
    for BH, S, Dh, P, rate in K1_BWD_SHAPES:
        W = S // P
        q, k, v, bias, scale, seed = _k1_inputs(g, BH, S, Dh, P, dtype)
        do = torch.randn(BH, S, Dh, device="cuda", generator=g).to(dtype)
        got = attention.attention_bwd(q, k, v, bias, do, scale, seed, rate, W)
        again = attention.attention_bwd(q, k, v, bias, do, scale, seed, rate, W)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"{name} {BH, S, Dh} dropout {rate}: a second launch differs")
        fused = fused_equal(f"{name} {BH, S, Dh} dropout {rate}", q, k, v, bias,
                            (scale, seed, rate, W), got, do)
        want = attention.packed_attention_bwd_reference(q, k, v, bias, do, scale, seed, rate,
                                                        W)
        b_ms, b_by = k1_bound(dtype, 7 * BH * S * Dh, 10 * BH * S * W * Dh, W)
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        lib_outs = [f() for f in _sdpa_forms(qg, kg, vg, bias, scale, rate, W)]
        lib_do = (do, do.view(-1, W, Dh))
        case = {
            "shape": [BH, S, Dh], "dtype": DTYPE_NAME[dtype], "packing": P, "window": W,
            "dropout": rate, "repeat_equal": True, "fused_equal": fused,
            **_agreement(f"{name} {BH, S, Dh} dropout {rate}", got, want, dtype),
            "bound_ms": b_ms, "bound_by": b_by,
            **_timings(lambda: attention.attention_bwd(q, k, v, bias, do, scale, seed, rate,
                                                       W),
                       lambda: attention.packed_attention_bwd_reference(
                           q, k, v, bias, do, scale, seed, rate, W),
                       *(lambda o=o, d=d: torch.autograd.grad(o, (qg, kg, vg), d,
                                                              retain_graph=True)
                         for o, d in zip(lib_outs, lib_do))),
        }
        emit({"phase": "kernel", "name": name, **case})
        cases.append(case)
    cases += [_k1_grouped_case(g, dtype, "bwd", *shape) for shape in K1_GROUPED]
    return _kernel_row(name, "bridgerl_tpu_torch/csrc/k1_bwd.cuh",
                       "bridgerl_tpu/ops/pallas/attention.py:164", cases)


# (B, H, S, Dh, P, rate, causal) of the fused layout's rows: the training microbatch (the
# main case), the artifact's retarget at b = 4096 (unpacked, S = W = 10: the float32 tiles'
# blocks of two windows cross from one row to the next, the SPAN form) and the slot-AR
# depth stack (32 x 128 tokens, 5 slots, causal: blocks across rows in both dtypes)
K1_QKV_SHAPES = ((64, 4, 80, 64, 8, DROPOUT, False), (4096, 4, 10, 64, 1, 0.0, False),
                 (4096, 4, 5, 64, 1, DROPOUT, True))


def _qkv_case(g, dtype, direction: str, B, H, S, Dh, P, rate, causal) -> dict:
    """One fused-layout case (:func:`check_k1_qkv`): ``direction``'s launch on
    a (B, S, 3 H Dh) buffer against its plain fused version, bit for bit the
    3-D launch on the folded copies, timed beside it (``ms_3d``)."""
    W, BH, sdpa = S // P, B * H, torch.nn.functional.scaled_dot_product_attention
    qkv = torch.randn(B, S, 3 * H * Dh, device="cuda", generator=g).to(dtype)
    do = torch.randn(B, S, H * Dh, device="cuda", generator=g).to(dtype)
    bias = causal_bias(S, "cuda") if causal else attention_bias(P, W, "cuda")
    scale, seed = Dh ** -0.5, attention.draw_seed(g, "cuda")
    args = (scale, seed, rate, W, causal)
    q, k, v = attention.split_qkv(qkv, H)
    do3 = attention.fold_heads(do, H)
    plan = attention.k1_plan(BH, S, W, Dh, dtype, direction, causal)
    pairs = BH * (S * (S + 1) // 2 if causal else S * W)   # the (query, key) pairs computed
    mask = bias.to(dtype)
    win = lambda t: t.unflatten(2, (P, W))   # noqa: E731
    # SDPA on the strided (B, H, S, Dh) views: full rows with the bias, and the windows
    # without it (is_causal under causal)
    forms = lambda views: (   # noqa: E731
        lambda: sdpa(*views, attn_mask=mask, scale=scale, dropout_p=rate),
        (lambda: sdpa(*views, is_causal=True, scale=scale, dropout_p=rate)) if causal else
        (lambda: sdpa(*(win(t) for t in views), scale=scale, dropout_p=rate)))
    if direction == "fwd":
        run = lambda: attention.attention_qkv(qkv, H, bias, *args)   # noqa: E731
        run3 = lambda: attention.attention_fwd(q, k, v, bias, *args)   # noqa: E731
        plain = lambda: attention._qkv_fwd_cpu(qkv, H, bias, seed, scale, rate, W,  # noqa
                                               causal)
        library = forms(qkv.view(B, S, 3, H, Dh).permute(2, 0, 3, 1, 4))
        b_ms, b_by = k1_bound(dtype, 4 * BH * S * Dh, 4 * pairs * Dh, W, plan.path != "tiles")
        outs3 = [run3()]
    else:
        run = lambda: attention.attention_qkv_bwd(qkv, H, bias, do, *args)   # noqa: E731
        run3 = lambda: attention.attention_bwd(q, k, v, bias, do3, *args)   # noqa: E731
        plain = lambda: attention._qkv_bwd_cpu(qkv, H, bias, do, seed, scale, rate, W,  # noqa
                                               causal)
        leaf = qkv.clone().requires_grad_()
        dov = do.view(B, S, H, Dh).transpose(1, 2)
        outs = [f() for f in forms(leaf.view(B, S, 3, H, Dh).permute(2, 0, 3, 1, 4))]
        library = [lambda o=o: torch.autograd.grad(o, leaf, dov if o.dim() == 4 else win(dov),
                                                   retain_graph=True) for o in outs]
        b_ms, b_by = k1_bound(dtype, 7 * BH * S * Dh, 10 * pairs * Dh, W, plan.path != "tiles")
        outs3 = list(run3())
    name = attention.QKV_COUNTER[direction, dtype].name
    got = run()
    fused = fused_equal(f"{name} {B, H, S, Dh}", q, k, v, bias, args, outs3,
                        None if direction == "fwd" else do3)
    require(torch.equal(got, run()), f"{name} {B, H, S, Dh}: a second launch differs")
    case = {"shape": [B, S, 3 * H * Dh], "heads": H, "rows": [BH, S, Dh],
            "dtype": DTYPE_NAME[dtype], "packing": P, "window": W, "causal": causal,
            "dropout": rate, "path": plan.path, "fused_equal": fused, "repeat_equal": True,
            **_agreement(f"{name} {B, H, S, Dh}", [got], [plain()], dtype),
            "bound_ms": b_ms, "bound_by": b_by, **_timings(run, plain, *library),
            "ms_3d": time_ms(run3)}
    emit({"phase": "kernel", "name": name, **case})
    return case


def check_k1_qkv(g: torch.Generator, dtype=torch.float32) -> list:
    """K1 in the fused layout (attention_qkv), a row a direction
    (``<entry>_qkv``), at K1_QKV_SHAPES (the training shape its main case):
    against the plain fused version (fold, plain, unfold) on the same inputs,
    bit for bit the 3-D launch on the folded copies, timed beside it
    (``ms_3d``); the library yardstick is SDPA on the strided (B, H, S, Dh)
    views of the same buffer, full rows with the bias and (B, H, P, W, Dh)
    windows without it (``is_causal`` under causal)."""
    rows = []
    for direction in ("fwd", "bwd"):
        name = attention.QKV_COUNTER[direction, dtype].name
        cases = [_qkv_case(g, dtype, direction, *shape) for shape in K1_QKV_SHAPES]
        source = (MULTI_SOURCE if dtype == BF16 else
                  f"bridgerl_tpu_torch/csrc/k1_{direction}.cuh")
        rows.append(_kernel_row(name, source, "bridgerl_tpu/ops/pallas/attention.py:"
                                + ("143" if direction == "fwd" else "164"), cases))
    return rows


def k2_profile_status(names: list, calls: int) -> str:
    """A K2 profile's device records (their names) over ``calls`` calls:
    "whole", one record of each of K2's two kernels a call and nothing else;
    "short", every record one of K2's kernels but fewer than that (the
    profiler lost records, PERF.md §7). Raises on any other record, and on
    more than a record of each kernel a call."""
    foreign = sorted({n[:80] for n in names if not any(k in n for k in K2_KERNELS)})
    require(not foreign, f"K2: device records of other operations: {foreign}")
    per = {k: sum(1 for n in names if k in n) for k in K2_KERNELS}
    require(all(n <= calls for n in per.values()),
            f"K2: {per} device records in {calls} calls, more than one of each a call")
    return "whole" if all(n == calls for n in per.values()) else "short"


def k2_device_ops_rows(reps: int = 10) -> dict:
    """K2's device operations at each of K2_SHAPES from one torch.profiler
    session, ``reps`` calls a shape after a warm-up call, each shape's calls
    in a ``record_function`` range that ends in a synchronize, and the
    profile's :func:`k2_profile_status`. A shape's records are those inside
    its range (device timestamps on the host's clock); run in a child
    process (``K2_PROFILE_PROBE``), where the session is the process's
    first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    g = torch.Generator(device="cuda").manual_seed(SEED + 30)
    inputs = {f"k2 {N} {D} {K}": (torch.randn(N, D, device="cuda", generator=g),
                                  torch.randn(K, D, device="cuda", generator=g))
              for N, D, K in K2_SHAPES}
    for x, cb in inputs.values():
        vq_kernel.nearest_codes_cuda(x, cb)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for name, (x, cb) in inputs.items():
            with record_function(name):
                for _ in range(reps):
                    vq_kernel.nearest_codes_cuda(x, cb)
                torch.cuda.synchronize()
    events = prof.events()
    # a range may also appear on the device's timeline as an annotation
    device = [e for e in events if e.device_type == DeviceType.CUDA and e.name not in inputs]
    calls = reps * len(inputs)
    per_kernel = {k: sum(1 for e in device if k in e.name) for k in K2_KERNELS}
    shapes = {}
    for e in events:
        if e.device_type != DeviceType.CPU or e.name not in inputs:
            continue
        mine = [d for d in device if e.time_range.start <= d.time_range.start
                and d.time_range.end <= e.time_range.end]
        shapes[e.name] = {
            "device_ops_per_call": len(mine) / reps, "calls": reps,
            "device_records_by_kernel": {k: sum(1 for d in mine if k in d.name)
                                         for k in K2_KERNELS},
            "device_ms_by_kernel": {k: sum(d.time_range.elapsed_us() for d in mine
                                           if k in d.name) / 1e3 / reps for k in K2_KERNELS}}
    return {"status": k2_profile_status([e.name for e in device], calls), "calls": calls,
            "device_records": len(device), "records_by_kernel": per_kernel, "shapes": shapes}


def k2_device_ops(smi: str) -> dict:
    """``k2_device_ops_rows`` in a child process. A profile that lost some of
    K2's records ("short") is reported with its listing by shape and taken
    once more in a fresh child, which must be whole: one record of each of
    K2's two kernels a call."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    profile_child = lambda: json.loads(_run_cli(["-c", K2_PROFILE_PROBE], here, dict(
        os.environ, PYTHONPATH=here)).strip().splitlines()[-1])   # noqa: E731
    rows, retaken = profile_child(), False
    if rows["status"] == "short":
        emit({"phase": "k2_device_ops_short", "card": smi, "calls": rows["calls"],
              "device_records": rows["device_records"],
              "records_by_kernel": rows["records_by_kernel"],
              "by_shape": {n: r["device_records_by_kernel"] for n, r in rows["shapes"].items()}})
        rows, retaken = profile_child(), True
        require(rows["status"] == "whole",
                f"K2: the retaken profile lost records too: {rows['device_records']} records "
                f"{rows['records_by_kernel']} in {rows['calls']} calls")
    emit({"phase": "k2_device_ops", "card": smi, "calls": rows["calls"],
          "device_records": rows["device_records"], "records_by_kernel": rows["records_by_kernel"],
          "retaken": retaken, "k2_device_ops_s": time.perf_counter() - t0})
    return rows["shapes"]


def _k2_plain_mismatch(x, cb, idx) -> tuple:
    """Rows where K2's indices differ from the plain version's, all of them
    and those outside near ties (rows whose best two plain distances lie
    within K2_TIE may go either way)."""
    dist = torch.sum(cb * cb, dim=1)[None, :] - 2.0 * (x @ cb.t())
    two = torch.topk(dist, 2, dim=1, largest=False).values
    near_tie = (two[:, 1] - two[:, 0]) <= K2_TIE * (1.0 + two[:, 0].abs())
    idx0, _, _ = codebook.nearest_codes_plain(x, cb)
    return int((idx != idx0).sum()), int(((idx != idx0) & ~near_tie).sum())


def _k2_grouped_case(g, G, N, D, K) -> dict:
    """K2 over G groups in one launch: each group's indices against the
    plain version outside near ties, each group bit for bit its own call
    and the CPU's ``assignment_stats`` for its indices, a second call equal
    to the first."""
    x = torch.randn(G, N, D, device="cuda", generator=g)
    cb = torch.randn(G, K, D, device="cuda", generator=g)
    got = vq_kernel.nearest_codes_cuda(x, cb)
    torch.cuda.synchronize()
    near_ties, err = 0, 0.0
    for i in range(G):
        differ, mismatch = _k2_plain_mismatch(x[i], cb[i], got[0][i])
        require(mismatch == 0, f"K2 {G} groups: group {i}: {mismatch} rows disagree")
        near_ties += differ
        one = vq_kernel.nearest_codes_cuda(x[i].contiguous(), cb[i].contiguous())
        require(all(torch.equal(a[i], b) for a, b in zip(got, one)),
                f"K2 {G} groups: group {i} differs from its own call")
        c, d = codebook.assignment_stats(x[i].cpu(), got[0][i].cpu(), K)
        err = max(err, (got[2][i].cpu() - d).abs().max().item())
        require(torch.equal(got[1][i].cpu(), c) and torch.equal(got[2][i].cpu(), d),
                f"K2 {G} groups: group {i} counts or dw differ from the CPU's row-order "
                f"sums (dw by up to {err})")
    again = vq_kernel.nearest_codes_cuda(x, cb)
    require(all(torch.equal(a, b) for a, b in zip(got, again)),
            f"K2 {G} groups: a second call differs from the first")
    b_ms, b_by = k2_bound(N, D, K, G)
    return {"shape": [N, D, K], "groups": G, "dw_equal_cpu_row_order": True,
            "equal_to_single_group_calls": True, "repeat_equal": True,
            "max_abs_err": err, "idx_mismatch_near_ties": near_ties,
            "plan": vq_kernel.k2_plan(N, D, K)._asdict(),
            "ms": time_ms(lambda: vq_kernel.nearest_codes_cuda(x, cb)),
            "ms_cold": time_ms(lambda: vq_kernel.nearest_codes_cuda(x, cb), cold=True),
            "plain_ms": time_ms(lambda: codebook.nearest_codes_plain(x, cb)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def _k2_shape_case(g, N, D, K, extra: dict) -> dict:
    """K2 at one (N, D, K) under its rule (see check_k2), timed."""
    x = torch.randn(N, D, device="cuda", generator=g)
    cb = torch.randn(K, D, device="cuda", generator=g)
    idx, counts, dw = vq_kernel.nearest_codes_cuda(x, cb)
    torch.cuda.synchronize()
    near_ties, mismatch = _k2_plain_mismatch(x, cb, idx)
    require(mismatch == 0, f"K2 {N, D, K}: {mismatch} rows disagree")
    require(counts.sum().item() == N, f"K2: counts sum {counts.sum().item()} != {N}")
    own_counts, own_dw = codebook.assignment_stats(x.cpu(), idx.cpu(), K)
    require(torch.equal(counts.cpu(), own_counts), "K2: counts differ from its own indices")
    err = (dw.cpu() - own_dw).abs().max().item()
    require(torch.equal(dw.cpu(), own_dw),
            f"K2 {N, D, K}: dw differs from the CPU's row-order sums by up to {err}")
    again = vq_kernel.nearest_codes_cuda(x, cb)
    require(all(torch.equal(a, b) for a, b in zip((idx, counts, dw), again)),
            f"K2 {N, D, K}: a second call differs from the first")
    b_ms, b_by = k2_bound(N, D, K)
    return {
        "shape": [N, D, K], "max_abs_err": err, "dw_equal_cpu_row_order": True,
        "repeat_equal": True, "idx_mismatch_near_ties": near_ties,
        "plan": vq_kernel.k2_plan(N, D, K)._asdict(),
        "ms": time_ms(lambda: vq_kernel.nearest_codes_cuda(x, cb)),
        "ms_cold": time_ms(lambda: vq_kernel.nearest_codes_cuda(x, cb), cold=True),
        "plain_ms": time_ms(lambda: codebook.nearest_codes_plain(x, cb)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, **extra}


def check_k2(g: torch.Generator, smi: str) -> list:
    """K2 at the training, serving and validation shapes and past 512
    columns: indices against the plain version outside near ties; counts and
    dw bit for bit against ``assignment_stats`` on the CPU for the kernel's
    own indices (both add each code's rows in row order), and a second call
    bit for bit equal to the first; two device operations a call (the two
    kernels, no fills) up to 512 columns. Two rows: ``vq_assign`` (D up to
    512) and ``vq_assign_wide`` (csrc/k2_wide.cuh; its main case train_wide's
    (512, 1024, 512))."""
    device_ops = k2_device_ops(smi)
    floor = {"launch_floor_ms": time_ms(lambda: torch.cuda._sleep(0)),
             "launch_floor_two_ms": time_ms(lambda: (torch.cuda._sleep(0),
                                                     torch.cuda._sleep(0)))}
    narrow, wide = [], []
    for N, D, K in K2_SHAPES + K2_WIDE + K2_WIDE_MORE:
        case = _k2_shape_case(g, N, D, K, {**device_ops.get(f"k2 {N} {D} {K}", {}), **floor})
        emit({"phase": "kernel", "name": "vq_assign" if D <= vq_kernel.MAX_NARROW
              else "vq_assign_wide", **case})
        (narrow if D <= vq_kernel.MAX_NARROW else wide).append(case)
    for G, N, D, K in K2_GROUPED + K2_WIDE_GROUPED:
        case = _k2_grouped_case(g, G, N, D, K)
        emit({"phase": "kernel", "name": "vq_assign" if D <= vq_kernel.MAX_NARROW
              else "vq_assign_wide", **case})
        (narrow if D <= vq_kernel.MAX_NARROW else wide).append(case)
    wide.sort(key=lambda c: c["shape"] != K2_WIDE_MAIN or "groups" in c)   # the main case first
    replaces = "bridgerl_tpu/ops/pallas/vq_kernel.py:106"
    return [_kernel_row("vq_assign", "bridgerl_tpu_torch/csrc/vq_assign.cu", replaces, narrow),
            _kernel_row("vq_assign_wide", "bridgerl_tpu_torch/csrc/k2_wide.cuh", replaces, wide)]


# ---------------------------------------------------------------- phase 3

def _numpy(out):
    if isinstance(out, dict):
        return {k: v.cpu().numpy() for k, v in out.items()}
    return out.cpu().numpy()


def _check_answer(name: str, got, want) -> dict:
    """Shape, dtype, finiteness and agreement with the CPU run."""
    if isinstance(want, dict):
        require(sorted(got) == sorted(want), f"{name}: streams {sorted(got)}")
        for k in want:
            require(got[k].shape == want[k].shape and got[k].dtype == np.int32,
                    f"{name}/{k}: {got[k].shape} {got[k].dtype}")
        same = np.all([got[k] == want[k] for k in want], axis=0).reshape(-1)
        agree = float(same.mean())
        require(agree >= CODES_AGREE, f"{name}: codes agree on {agree} of rows")
        return {"codes_agree": agree}
    require(got.shape == want.shape and got.dtype == np.float32,
            f"{name}: {got.shape} {got.dtype}, want {want.shape}")
    require(bool(np.isfinite(got).all()), f"{name}: non-finite values")
    err = float(np.abs(got - want).max())
    require(err <= SERVE_ATOL, f"{name}: max abs error vs CPU {err} > {SERVE_ATOL}")
    return {"max_abs_err_vs_cpu": err}


def _rows_agree(a: dict, b: dict) -> np.ndarray:
    """(rows,) bool: every code stream equal."""
    return np.all([np.asarray(a[k]).reshape(len(a[k]), -1) == np.asarray(b[k]).reshape(
        len(b[k]), -1) for k in b], axis=(0, 2))


def _codes_rule(name: str, card: dict, cpu16: dict, cpu32: dict):
    """cuBLAS and the CPU round bf16 GEMMs differently, so a window near a
    code boundary may quantize to other codes on either side: the card's
    codes may disagree with float32's on at most BF16_FACTOR times the rows
    the CPU's bf16 codes do, and one row. Returns the shares and the rows
    on which all three runs' codes agree."""
    for k in cpu32:
        require(card[k].shape == cpu32[k].shape and card[k].dtype == np.int32,
                f"{name}/{k}: {card[k].shape} {card[k].dtype}")
    same16, same32 = _rows_agree(card, cpu16), _rows_agree(card, cpu32)
    card32, own32 = float(same32.mean()), float(_rows_agree(cpu16, cpu32).mean())
    require(1 - card32 <= BF16_FACTOR * (1 - own32) + 1 / len(same32),
            f"{name}: codes agree with float32 on {card32} of rows, the CPU's bf16 on {own32}")
    return {"codes_agree_f32": card32, "codes_agree_cpu_bf16": float(same16.mean()),
            "cpu_bf16_codes_agree_f32": own32}, same16 & same32


def _check_bf16_values(name: str, got, cpu16, cpu32, rows) -> dict:
    """A bf16 answer from the card against the CPU's bf16 and float32
    answers on the same weights, on ``rows``: those whose codes all three
    runs share, so that the distances measure bf16 rounding and not a code
    that flipped. The card lies within BF16_SERVE_ULPS bf16 ulps of the
    output's scale of the CPU's bf16 answer (the two differ only in how
    their GEMMs round), and no farther from the float32 answer than
    BF16_FACTOR times the CPU's bf16 answer is."""
    require(got.shape == cpu32.shape and got.dtype == np.float32,
            f"{name}: {got.shape} {got.dtype}, want {cpu32.shape}")
    require(bool(np.isfinite(got).all()), f"{name}: non-finite values")
    out = {"max_abs_err_vs_cpu_f32": float(np.abs(got - cpu32).max()),
           "cpu_bf16_max_abs_err_vs_cpu_f32": float(np.abs(cpu16 - cpu32).max()),
           "max_abs_err_vs_cpu_bf16": float(np.abs(got - cpu16).max()),
           "rows_compared": int(rows.sum()), "rows": len(rows)}
    if not rows.any():
        return out
    g, c16, c32 = got[rows], cpu16[rows], cpu32[rows]
    card, own, to16 = (float(np.abs(a - b).max()) for a, b in ((g, c32), (c16, c32), (g, c16)))
    scale = float(np.abs(c16).max())
    ulps = to16 / bf16_ulp(scale)
    require(ulps <= BF16_SERVE_ULPS, f"{name}: {to16} from the CPU's bf16 answer, "
            f"{ulps} bf16 ulps of its scale {scale}")
    require(card <= BF16_FACTOR * own, f"{name}: {card} from the CPU's float32 answer, "
            f"over {BF16_FACTOR} x the CPU bf16 answer's {own}")
    return {**out, "compared_max_abs_err_vs_cpu_f32": card,
            "compared_cpu_bf16_max_abs_err_vs_cpu_f32": own,
            "compared_max_abs_err_vs_cpu_bf16": to16, "compared_scale": scale,
            "compared_ulps_vs_cpu_bf16": ulps}


def _window_codes(model, branch: str, x: np.ndarray) -> dict:
    """The code streams of each window of x through ``model``'s branch."""
    dev = next(model.parameters()).device
    with torch.inference_mode():
        codes = model(**{f"x_{branch}": torch.as_tensor(x, device=dev)})[branch]["codes"]
    return _numpy(codes)


def per_call(cfg) -> tuple:
    """K1 forwards and K2 launches of one model call on one branch: a
    transformer's encoder and decoder blocks; one nearest-code search per VQ
    layer (standard and ema 1, rvq n_layers, the hybrid's residual VQ 4)."""
    k1 = 2 * cfg.n_tf_layers if cfg.arch == "transformer" else 0
    return k1, {"standard": 1, "ema": 1, "rvq": cfg.n_layers, "hybrid": 4}.get(cfg.method, 0)


def _expect_launches(name: str, before: dict, calls: int, dtype, cfg) -> dict:
    """The launches since ``before``: ``calls`` model calls of ``cfg``, one
    branch each, nothing else."""
    k1, k2 = per_call(cfg)
    now = launches()
    delta = {k: now[k] - before[k] for k in now}
    want = {k: 0 for k in now}
    want[attention.ENTRY["fwd", dtype]] = k1 * calls
    want["vq_assign"] = k2 * calls
    k1_want(want, cfg.window_size)
    require(delta == want, f"{name}: launches {delta}, want {want}")
    return delta


def seeded(cfg, device):
    """The model of ``cfg`` with weights from SEED on ``device``."""
    return init_model(cfg, SEED, device=device)


def serving_check(exp, build=seeded):
    """The model ``build`` gives for ``exp`` served on the card, and
    ``verify(name, fn, x, got)``, which holds a card answer to the same
    weights on the CPU: the f32 rule, or in bf16 the codes and values rules
    against the CPU's bf16 and float32 runs. Returns (model, module,
    verify, the CPU runs' (modules, models))."""
    cfg = exp.model
    dtype = compute_dtype(cfg)
    model = build(cfg, "cuda")
    module = build_serving_module(model, exp)
    cpu_model = build(cfg, "cpu")
    cpu = build_serving_module(cpu_model, exp)
    cpu32, cpu32_model = cpu, cpu_model
    if dtype == BF16:
        exp32 = dataclasses.replace(exp, model=dataclasses.replace(cfg, compute_dtype="float32"))
        cpu32_model = build(exp32.model, "cpu")
        cpu32 = build_serving_module(cpu32_model, exp32)

    def verify(name, fn, x, got):
        if dtype != BF16:
            return _check_answer(name, got, _numpy(cpu.fns[fn](x)))
        cpu16_out, cpu32_out = _numpy(cpu.fns[fn](x)), _numpy(cpu32.fns[fn](x))
        if fn == "motion_codes":
            require(sorted(got) == sorted(cpu32_out), f"{name}: streams {sorted(got)}")
            return _codes_rule(name, got, cpu16_out, cpu32_out)[0]
        branch = "robot" if fn == "robot_recon" else "human"
        if cfg.method == "ae":   # no codes to flip: every window is compared
            rows = np.ones(len(x), bool)
            return _check_bf16_values(name, got, cpu16_out, cpu32_out, rows)
        shares, rows = _codes_rule(name, *(_window_codes(m, branch, x)
                                           for m in (model, cpu_model, cpu32_model)))
        return {**shares, **_check_bf16_values(name, got, cpu16_out, cpu32_out, rows)}

    return model, module, verify, ((cpu, cpu_model), (cpu32, cpu32_model))


def serve_requests(exp, app, verify, requests, rng, x_for=None) -> list:
    """Each (fn, b) request through ``app``, its launches and its answer
    checked. A bf16 b = 1 request whose one window flips code compares no
    values, so successive windows are tried, up to B1_TRIES, until one keeps
    its codes. ``x_for(fn, b)`` gives the inputs (seeded normals when None)."""
    cfg = exp.model
    dtype = compute_dtype(cfg)
    dims = {"retarget": cfg.human_input_dim, "robot_recon": cfg.robot_input_dim,
            "motion_codes": cfg.human_input_dim}
    lines = []
    for fn, b in requests:
        tries = B1_TRIES if dtype == BF16 and b == 1 and fn != "motion_codes" else 1
        delta = add_launches()
        for tried in range(1, tries + 1):
            x = (x_for(fn, b) if x_for is not None
                 else rng.normal(size=(b, cfg.window_size, dims[fn])).astype(np.float32))
            before = launches()
            got = app.call(fn, x)
            delta = add_launches(delta, _expect_launches(f"{fn} b={b}", before, 1, dtype, cfg))
            checked = verify(f"{fn} b={b}", fn, x, got)
            if checked.get("rows_compared", 1) > 0:
                break
        require(tries == 1 or checked["rows_compared"] > 0,
                f"{fn} b={b}: no window of {tries} kept its codes in bf16")
        line = {"phase": "request", "dtype": cfg.compute_dtype, "fn": fn, "b": b,
                "launches": delta, **checked}
        if tries > 1:
            line["windows_tried"] = tried
        lines.append(line)
    return lines


def main_path(exp) -> tuple:
    """Serve the flagship at ``exp.model.compute_dtype`` through ServingApp
    and HTTP; every answer checked against the same weights on the CPU (in
    bf16, against the CPU's bf16 and float32 runs). Returns the line's
    fields, and the app with a b=4096 request for a later profile."""
    cfg = exp.model
    W = cfg.window_size
    dtype = compute_dtype(cfg)
    model, module, verify, ((cpu, cpu_model), (cpu32, cpu32_model)) = serving_check(exp)
    app = ServingApp(module)
    rng = np.random.default_rng(SEED)
    requests = [("retarget", b) for b in RETARGET_BATCHES]
    requests += [("robot_recon", 64), ("motion_codes", 64)]

    kernels.reset_counters()
    lines = serve_requests(exp, app, verify, requests, rng)
    for line in lines:
        emit(line)

    srv = make_server(module, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = srv.server_address
        client = ServingClient(f"http://{host}:{port}")
        health = client.health()
        require(health["ok"] and health["device"].startswith("cuda"), f"healthz {health}")
        x = rng.normal(size=(64, W, cfg.human_input_dim)).astype(np.float32)
        before = launches()
        got = client.retarget(x)
        http_delta = _expect_launches("HTTP retarget", before, 1, dtype, cfg)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join()
    emit({"phase": "request", "dtype": cfg.compute_dtype, "fn": "retarget", "b": 64,
          "via": "http", "healthz": health, "launches": http_delta,
          **verify("HTTP retarget", "retarget", x, got)})

    seq = rng.normal(size=(3000, cfg.robot_input_dim)).astype(np.float32)
    mean = np.zeros(cfg.robot_input_dim, np.float32)
    std = np.ones(cfg.robot_input_dim, np.float32)
    step = 5
    before = launches()
    got = reconstruct_long_sequence(module.fns["robot_recon"], seq, W, step, mean, std,
                                    device="cuda")
    delta = _expect_launches("overlap-add", before, 1, dtype, cfg)
    overlap = lambda fns: reconstruct_long_sequence(fns["robot_recon"], seq, W, step, mean,
                                                    std, device="cpu")
    if dtype == BF16:
        # a frame is compared when every window covering it has the same
        # codes in all three runs
        starts = window_starts(len(seq), W, step)
        windows = np.stack([seq[s:s + W] for s in starts])
        shares, agree = _codes_rule("overlap-add", *(_window_codes(m, "robot", windows)
                                                     for m in (model, cpu_model, cpu32_model)))
        frames = np.ones(len(seq), bool)
        for s in starts[~agree]:
            frames[s:s + W] = False
        checked = {**shares, **_check_bf16_values("overlap-add", got, overlap(cpu.fns),
                                                  overlap(cpu32.fns), frames)}
    else:
        checked = _check_answer("overlap-add", got, overlap(cpu.fns))
    emit({"phase": "request", "dtype": cfg.compute_dtype, "fn": "reconstruct_long_sequence",
          "frames": len(seq), "step": step, "launches": delta, **checked})
    counts = add_launches(*(l["launches"] for l in lines), http_delta, delta)
    require(counts[attention.ENTRY["fwd", dtype]] > 0 and counts["vq_assign"] > 0,
            f"a serving kernel never ran: {counts}")

    # serving speed, through the same ServingApp
    x4096 = rng.normal(size=(4096, W, cfg.human_input_dim)).astype(np.float32)
    x1 = x4096[:1].copy()
    for _ in range(3):
        app.call("retarget", x4096)
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        app.call("retarget", x4096)
    wps = reps * 4096 / (time.perf_counter() - t0)
    lat = []
    for _ in range(5):
        app.call("retarget", x1)
    for _ in range(50):
        t0 = time.perf_counter()
        app.call("retarget", x1)
        lat.append((time.perf_counter() - t0) * 1e3)
    out = {"dtype": cfg.compute_dtype, "launches": counts,
           "retarget_windows_per_s_b4096": wps, "retarget_p50_ms_b1": statistics.median(lat)}
    return out, (app, x4096)


def device_breakdown(app: ServingApp, x: np.ndarray, reps: int = 3) -> dict:
    """Device time by kernel over ``reps`` retarget requests, from
    torch.profiler, and the share of the requests' wall time the card idled."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    app.call("retarget", x)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            app.call("retarget", x)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(ev.key, ev.self_device_time_total / 1e3, ev.count)
            for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]
    busy_ms = sum(r[1] for r in rows)
    require(busy_ms > 0, "the profiler saw no device time")
    rows.sort(key=lambda r: -r[1])
    return {"b": x.shape[0], "requests": reps, "wall_ms_per_request": wall_ms / reps,
            "device_ms_per_request": busy_ms / reps, "idle_share": 1.0 - busy_ms / wall_ms,
            "device_launches_per_request": sum(r[2] for r in rows) / reps,
            "top": [{"kernel": name[:90], "ms_per_request": ms / reps,
                     "launches_per_request": n / reps, "share": ms / busy_ms}
                    for name, ms, n in _top(rows, 15)]}


# ---------------------------------------------------------------- phase 4

def _train_exp(workdir: str, **over):
    exp = make_experiment("transformer", "hybrid", window=10, attn_packing=8,
                          batch_size=TRAIN_BATCH, accum_chunks=TRAIN_ACCUM, seeds=(SEED,),
                          **over)
    return dataclasses.replace(exp, log_dir=os.path.join(workdir, "results"),
                               checkpoint_dir=os.path.join(workdir, "checkpoints"))


def _expected_train_launches(trainer: Trainer, n: int, epochs: int) -> dict:
    exp = trainer.exp
    mode = exp.train.mode
    n_train = int((1.0 - exp.train.val_fraction) * n)
    micro = (n_train // TRAIN_BATCH) * TRAIN_ACCUM
    val_batches = max((n - n_train) // min(TRAIN_BATCH, n - n_train), 1)
    dtype = compute_dtype(exp.model)
    names = (attention.ENTRY["fwd", dtype], attention.ENTRY["bwd", dtype], "vq_assign")
    want = {name: 0 for name in kernels.COUNTERS}
    want.update({name: epochs * (micro * m + val_batches * v)
                 for name, m, v in zip(names, PER_MICROBATCH[mode], PER_VAL_BATCH[mode])})
    if exp.model.hidden_dim > vq_kernel.MAX_NARROW:   # every K2 call past 512 columns
        want[vq_kernel.wide_counter.name] = want[vq_kernel.launch_counter.name]
    return multi_want(want)


def _run_stage(exp, ds: PairedDataset, epochs: int) -> dict:
    trainer = Trainer(exp, device="cuda", verbose=False)
    kernels.reset_counters()
    hist = trainer.run(ds)[SEED]
    counts = launches()
    mode = exp.train.mode
    want = _expected_train_launches(trainer, len(ds), epochs)
    require(counts == want, f"{mode}: launches {counts}, want {want}")
    require(sorted(hist) == sorted(HISTORY_KEYS), f"{mode}: history keys {sorted(hist)}")
    require(len(hist["train_loss"]) == epochs
            and all(math.isfinite(x) for k in ("train_loss", "val_loss") for x in hist[k]),
            f"{mode}: losses {hist['train_loss']} {hist['val_loss']}")
    for kind in ("best", "last", "final"):
        path = trainer.ckpt_path(SEED, kind)
        require(os.path.basename(path) == f"{exp.run_name(SEED)}_{kind}.pth"
                and os.path.exists(path), f"{mode}: no checkpoint {path}")
    for name in (exp.log_name(SEED), f"log_{exp.name}_{mode}_seed_{SEED}.json"):
        with open(os.path.join(exp.log_dir, name)) as f:
            require(sorted(json.load(f)) == sorted(HISTORY_KEYS), f"{mode}: {name}")
    timed = trainer.train_seconds[1:]          # the first epoch is the warm-up
    windows = sum(w for _, w, _ in timed)
    seconds = sum(t for _, _, t in timed)
    return {"mode": mode, "dtype": exp.model.compute_dtype, "epochs": epochs,
            "launches": counts,
            "microbatch": TRAIN_BATCH // TRAIN_ACCUM,
            "windows_per_s": windows / seconds, "timed_windows": windows,
            "timed_seconds": seconds, "epoch_seconds": [t for _, _, t in trainer.train_seconds],
            "train_loss": hist["train_loss"], "val_loss": hist["val_loss"],
            "ckpt_best": trainer.ckpt_path(SEED, "best")}


def train_path(smi: str, dtype=torch.float32) -> dict:
    """Teacher, then student from the teacher's best checkpoint, through
    the port's Trainer at full width in ``dtype``; files go to a temporary
    directory."""
    workdir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    over = {"compute_dtype": DTYPE_NAME[dtype]}
    try:
        g = torch.Generator(device="cuda").manual_seed(SEED + 1)
        W = 10
        ds = PairedDataset(torch.randn(TRAIN_WINDOWS, W, 29, device="cuda", generator=g),
                           torch.randn(TRAIN_WINDOWS, W, 126, device="cuda", generator=g))
        teacher = _run_stage(_train_exp(workdir, epochs=TEACHER_EPOCHS, **over), ds,
                             TEACHER_EPOCHS)
        emit({"phase": "train", "card": smi, **teacher})
        student = _run_stage(_train_exp(workdir, mode="student", epochs=STUDENT_EPOCHS,
                                        teacher_ckpt=teacher["ckpt_best"], **over),
                             ds, STUDENT_EPOCHS)
        emit({"phase": "train", "card": smi, **student})
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    total = {k: teacher["launches"][k] + student["launches"][k] for k in teacher["launches"]}
    ran = (attention.ENTRY["fwd", dtype], attention.ENTRY["bwd", dtype], "vq_assign")
    require(all(total[k] > 0 for k in ran), f"a kernel never ran in training: {total}")
    return {"dtype": DTYPE_NAME[dtype], "launches": total,
            "teacher_windows_per_s": teacher["windows_per_s"],
            "student_windows_per_s": student["windows_per_s"]}


def _step_grads(exp, dev: str, robot: torch.Tensor, human: torch.Tensor,
                rows=None) -> tuple:
    """The loss and every parameter's gradient of one optimizer batch (all
    of ``robot`` / ``human``, in the order ``rows`` gives, their own when
    None) from the seeded model of ``exp`` on ``dev``."""
    model = init_model(exp.model, SEED, device=dev)
    opt = make_optimizer(model, exp)
    opt.zero_grad(set_to_none=True)
    rows = torch.arange(len(robot)) if rows is None else rows
    logs = accumulate_grads(model, exp, robot.to(dev), human.to(dev), rows.to(dev), None)
    return (float(logs["train_loss"]),
            {n: p.grad.detach().cpu() for n, p in model.named_parameters()
             if p.grad is not None})


def _agree_exp(dtype, method: str = "hybrid", **over):
    return make_experiment("transformer", method, window=10, attn_packing=8, dropout=0.0,
                           batch_size=AGREE_BATCH, accum_chunks=1,
                           compute_dtype=DTYPE_NAME[dtype], **over)


def _agree_batch() -> tuple:
    rng = np.random.default_rng(SEED + 2)
    return tuple(torch.from_numpy(rng.normal(size=(AGREE_BATCH, 10, d)).astype(np.float32))
                 for d in (29, 126))


def _agree_step(dev: str, dtype, method: str = "hybrid", rows=None, **over) -> tuple:
    """The loss and every parameter's gradient of one optimizer batch of
    AGREE_BATCH at dropout 0 from one seed, on ``dev`` in ``dtype`` (only the
    windows ``rows`` of the batch, when given)."""
    robot, human = _agree_batch()
    return _step_grads(_agree_exp(dtype, method, **over), dev, robot, human, rows)


def _agree_codes(dev: str, dtype, **over) -> dict:
    """The code streams of each window of the agreement batch through the
    teacher's branch of the seeded model on ``dev`` in ``dtype``."""
    model = init_model(_agree_exp(dtype, **over).model, SEED, device=dev)
    return _window_codes(model, "robot", _agree_batch()[0].numpy())


def _agree_rule(what: str, got: tuple, want: tuple) -> dict:
    """train_agree's rule: (loss, gradients) ``got`` against ``want``, the
    loss within AGREE_LOSS_RTOL relative, every gradient within
    AGREE_GRAD_RTOL in relative norm."""
    (l_gpu, g_gpu), (l_cpu, g_cpu) = got, want
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    require(loss_rel <= AGREE_LOSS_RTOL, f"{what}: loss {l_gpu} vs {l_cpu}")
    require(sorted(g_gpu) == sorted(g_cpu) and g_cpu, f"{what}: gradient sets differ")
    worst, worst_name = 0.0, ""
    for name, gc in g_cpu.items():
        rel = ((g_gpu[name] - gc).norm() / gc.norm().clamp_min(1e-30)).item()
        if rel > worst:
            worst, worst_name = rel, name
    require(worst <= AGREE_GRAD_RTOL, f"{what}: {worst_name} gradient off by {worst}")
    return {"loss_got": l_gpu, "loss_want": l_cpu, "loss_rel_err": loss_rel,
            "params_compared": len(g_cpu), "worst_grad_rel_norm_err": worst,
            "worst_param": worst_name}


def train_agree() -> tuple:
    """One optimizer batch at dropout 0, from one seed, on the card and on
    the CPU (plain versions): the loss and every parameter's gradient.
    Returns the line and the CPU's step, which train_agree_bf16 reuses."""
    cpu32 = _agree_step("cpu", torch.float32)
    res = {"phase": "train_agree", "batch": AGREE_BATCH,
           **_agree_rule("train_agree", _agree_step("cuda", torch.float32), cpu32)}
    emit(res)
    return res, cpu32


def train_agree_bf16(cpu32: tuple) -> dict:
    """The same batch in bf16 on the card and on the CPU, held to the CPU's
    float32 step under _bf16_step_rule."""
    res = {"phase": "train_agree_bf16", "batch": AGREE_BATCH,
           **_bf16_step_rule("train_agree_bf16", cpu32, _agree_step("cuda", BF16),
                             _agree_step("cpu", BF16))}
    emit(res)
    return res


def train_agree_wide() -> dict:
    """train_agree's rule for the transformer + ema at hidden_dim
    AGREE_WIDE_HIDDEN in float32: K2 at D 640 (csrc/k2_wide.cuh) in
    training, card against the CPU."""
    over = dict(method="ema", hidden_dim=AGREE_WIDE_HIDDEN)
    before = launches()
    card = _agree_step("cuda", torch.float32, **over)
    k2 = _delta(before)[vq_kernel.wide_counter.name]
    require(k2 > 0, "train_agree_wide: K2 past 512 columns was not launched")
    res = {"phase": "train_agree_wide", "batch": AGREE_BATCH, "method": "ema",
           "hidden_dim": AGREE_WIDE_HIDDEN, "k2_wide_launches": k2,
           **_agree_rule("train_agree_wide", card, _agree_step("cpu", torch.float32, **over))}
    emit(res)
    return res


def train_wide(smi: str) -> dict:
    """The flagship at hidden_dim TRAIN_WIDE_HIDDEN, the teacher trained
    through the Trainer as train_path trains it (batch TRAIN_BATCH in
    TRAIN_ACCUM microbatches, dropout 0.1), in float32 and bf16: one warm-up
    epoch and one timed epoch of TRAIN_BATCH training windows; every K2 call
    of its residual VQ runs past 512 columns (vq_assign_wide). Then one
    float32 step at dropout 0 under train_agree's rule and one bf16 step
    under train_agree_bf16's, card against the CPU. The launches are the
    Trainer runs'."""
    workdir = tempfile.mkdtemp(prefix="chip_smoke_train_wide_")
    over = dict(hidden_dim=TRAIN_WIDE_HIDDEN)
    n = TRAIN_BATCH
    while int((1.0 - _train_exp(workdir).train.val_fraction) * n) < TRAIN_BATCH:
        n += 1
    rates, total = {}, {}
    try:
        g = torch.Generator(device="cuda").manual_seed(SEED + 41)
        ds = PairedDataset(torch.randn(n, 10, 29, device="cuda", generator=g),
                           torch.randn(n, 10, 126, device="cuda", generator=g))
        for dtype in DTYPES:
            exp = _train_exp(workdir, epochs=TRAIN_WIDE_EPOCHS, compute_dtype=DTYPE_NAME[dtype],
                             **over)
            res = _run_stage(exp, ds, TRAIN_WIDE_EPOCHS)
            wide = res["launches"][vq_kernel.wide_counter.name]
            require(wide > 0, f"train_wide {DTYPE_NAME[dtype]}: K2 past 512 columns never ran")
            emit({"phase": "train_wide", "card": smi, "hidden_dim": TRAIN_WIDE_HIDDEN,
                  "windows": n, **res})
            rates[DTYPE_NAME[dtype]] = res["windows_per_s"]
            total = add_launches(total, res["launches"])
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    train_wide_agree()
    return {"launches": total, "windows_per_s": rates}


def train_wide_agree() -> dict:
    """train_wide's steps against the CPU: one float32 step under
    train_agree's rule, and one bf16 step under train_agree_bf16's on the
    windows of the batch whose codes (FSQ and residual VQ) the card's bf16,
    the CPU's bf16 and the CPU's float32 forwards all share, as the bf16
    serving rule compares values (_codes_rule, _check_bf16_values): at a
    latent of 1024 a bf16 latent near an FSQ level's boundary rounds to
    another level on the card than on the CPU, and such a flip moves the FSQ
    projections' gradients by more than rounding does (PERF.md §6)."""
    over = dict(hidden_dim=TRAIN_WIDE_HIDDEN)
    cpu32 = _agree_step("cpu", torch.float32, **over)
    f32 = _agree_rule("train_wide", _agree_step("cuda", torch.float32, **over), cpu32)
    codes, rows = _codes_rule("train_wide_bf16", _agree_codes("cuda", BF16, **over),
                              _agree_codes("cpu", BF16, **over),
                              _agree_codes("cpu", torch.float32, **over))
    rows = torch.from_numpy(np.flatnonzero(rows))
    bf16 = _bf16_step_rule("train_wide_bf16", _agree_step("cpu", torch.float32, rows=rows, **over),
                           _agree_step("cuda", BF16, rows=rows, **over),
                           _agree_step("cpu", BF16, rows=rows, **over))
    res = {"phase": "train_wide_agree", "batch": AGREE_BATCH, "hidden_dim": TRAIN_WIDE_HIDDEN,
           **f32, "bf16": {**codes, "rows_compared": len(rows), **bf16}}
    emit(res)
    return res


def _bf16_step_rule(what: str, cpu32: tuple, card: tuple, cpu16: tuple) -> dict:
    """(loss, gradients) of a bf16 step on the card and on the CPU, each
    held to the CPU's float32 step: the card's loss and each gradient no
    farther from float32 (in relative norm) than BF16_FACTOR times the CPU's
    bf16 ones; the loss may always be one bf16 rounding of itself off."""
    (l32, g32), (l_gpu, g_gpu), (l_cpu, g_cpu) = cpu32, card, cpu16
    err, own = abs(l_gpu - l32), abs(l_cpu - l32)
    require(err <= max(BF16_FACTOR * own, BF16_LOSS_FLOOR * abs(l32)),
            f"{what}: loss {l_gpu}, CPU bf16 {l_cpu}, CPU float32 {l32}")
    require(sorted(g_gpu) == sorted(g_cpu) == sorted(g32) and g32,
            f"{what}: gradient sets differ")
    rel = lambda a, b: ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
    worst, worst_name, ratios = 0.0, "", []
    for name, gc in g32.items():
        r_card, r_own = rel(g_gpu[name], gc), rel(g_cpu[name], gc)
        require(r_card <= BF16_FACTOR * r_own,
                f"{what}: {name} gradient {r_card} from float32, the CPU bf16's {r_own}")
        ratios.append(r_card / max(r_own, 1e-30))
        if r_card > worst:
            worst, worst_name = r_card, name
    return {"loss_cuda_bf16": l_gpu, "loss_cpu_bf16": l_cpu, "loss_cpu_f32": l32,
            "loss_rel_err_vs_f32": err / abs(l32), "cpu_bf16_loss_rel_err_vs_f32": own / abs(l32),
            "params_compared": len(g32), "worst_grad_rel_norm_err_vs_f32": worst,
            "worst_param": worst_name,
            "cpu_bf16_grad_rel_norm_err_vs_f32_for_it": rel(g_cpu[worst_name], g32[worst_name]),
            "max_ratio_to_cpu_bf16": max(ratios),
            "median_ratio_to_cpu_bf16": statistics.median(ratios)}


def train_breakdown(dtype=torch.float32, reps: int = 1) -> dict:
    """Device time by kernel over one teacher optimizer step (32
    microbatches of 512) in ``dtype`` from torch.profiler, after one
    warm-up step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    exp = _train_exp(tempfile.gettempdir(), compute_dtype=DTYPE_NAME[dtype])
    model = init_model(exp.model, SEED, device="cuda")
    opt = make_optimizer(model, exp)
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    robot = torch.randn(TRAIN_BATCH, 10, 29, device="cuda", generator=g)
    human = torch.randn(TRAIN_BATCH, 10, 126, device="cuda", generator=g)
    idx = torch.arange(TRAIN_BATCH, device="cuda")[None]
    step = make_train_epoch(exp)
    step(model, opt, robot, human, idx, g)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            step(model, opt, robot, human, idx, g)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(ev.key, ev.self_device_time_total / 1e3, ev.count)
            for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]
    busy_ms = sum(r[1] for r in rows)
    require(busy_ms > 0, "the profiler saw no device time")
    rows.sort(key=lambda r: -r[1])
    return {"what": "teacher optimizer step", "dtype": DTYPE_NAME[dtype], "batch": TRAIN_BATCH,
            "microbatches": TRAIN_ACCUM, "steps": reps, "wall_ms_per_step": wall_ms / reps,
            "device_ms_per_step": busy_ms / reps, "idle_share": 1.0 - busy_ms / wall_ms,
            "device_launches_per_step": sum(r[2] for r in rows) / reps,
            "top": [{"kernel": name[:90], "ms_per_step": ms / reps,
                     "launches_per_step": n / reps, "share": ms / busy_ms}
                    for name, ms, n in _top(rows, 20)]}


ATTN_OPS_SHAPE = (64, 80, 256, 4)   # (B, S, d, heads): the flagship's training microbatch
# operations that copy their input into a new tensor on the card
COPY_OPS = ("aten::copy_", "aten::clone", "aten::contiguous", "aten::_to_copy", "aten::cat",
            "aten::stack", "aten::index_select", "aten::gather")


def attention_ops(dtype) -> dict:
    """The operations of one SelfAttention forward and backward at
    ATTN_OPS_SHAPE (packed windows of 10, dropout 0.1), from torch.profiler:
    the device launches by name, and every copying operation with its input
    sizes. None may copy q, k, v, out or their gradients (an input of B S d or
    B S 3d elements), and there is no cat at all; the bf16 weight casts (the
    (3d, d) and (d, d) weights and their biases, and their gradients back)
    stay: they are the trainer's host work, not the attention's layout."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    B, S, d, H = ATTN_OPS_SHAPE
    g = torch.Generator(device="cuda").manual_seed(SEED + 21)
    attn = SelfAttention(d, H, dtype).cuda()
    torch.nn.init.xavier_uniform_(attn.in_proj_weight)
    x = torch.randn(B, S, d, device="cuda", generator=g).to(dtype).requires_grad_()
    dy = torch.randn(B, S, d, device="cuda", generator=g).to(dtype)
    bias = attention_bias(8, 10, "cuda")

    def once():
        attn(x, bias, DROPOUT, g, window=10).backward(dy)

    once()
    torch.cuda.synchronize()
    kernels.reset_counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        once()
        torch.cuda.synchronize()
    counts = launches()
    activations = {B * S * d, B * S * 3 * d}
    copies, bad = [], []
    for ev in prof.events():
        if ev.device_type != DeviceType.CPU or ev.name not in COPY_OPS:
            continue
        sizes = [math.prod(shape) for shape in ev.input_shapes if shape]
        copies.append({"op": ev.name, "input_sizes": sizes})
        if ev.name in ("aten::cat", "aten::stack") or activations & set(sizes):
            bad.append(copies[-1])
    device = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            device[ev.key[:90]] = device.get(ev.key[:90], 0) + ev.count
    require(sum(device.values()) > 0, "attention_ops: the profiler saw no device operation")
    require(not bad, f"attention_ops {DTYPE_NAME[dtype]}: copies of activations {bad}")
    want = multi_want({**{k: 0 for k in kernels.COUNTERS}, attention.ENTRY["fwd", dtype]: 1,
                       attention.ENTRY["bwd", dtype]: 1})
    require(want == counts, f"attention_ops {DTYPE_NAME[dtype]}: launches {counts}, "
            f"want {want}")
    return {"dtype": DTYPE_NAME[dtype], "shape": [B, S, d], "heads": H,
            "device_launches": sum(device.values()), "device_ops": device,
            "copies": copies, "activation_copies": len(bad), "launches": counts}


# ---------------------------------------------------------------- phase 6

def zoo_exp(arch: str, method: str, **over):
    """An arch x method at full width (the JAX package's defaults: hidden 64,
    K 1024 (hybrid 512), 4 residual blocks, 256-wide transformer towers,
    FSQ (8, 5, 5, 5), 10 LFQ bits) at the CLI's window and batch."""
    return make_experiment(arch, method, window=ZOO_W, batch_size=ZOO_BATCH, **over)


def zoo_step(exp, g: torch.Generator) -> dict:
    """One teacher optimizer step on the card at the CLI's batch (dropout
    0.1 where the arch drops out): a finite loss, and the launches the
    model implies for one robot-branch microbatch, forward and backward."""
    cfg = exp.model
    model = init_model(cfg, SEED, device="cuda")
    opt = make_optimizer(model, exp)
    robot = torch.randn(ZOO_BATCH, ZOO_W, cfg.robot_input_dim, device="cuda", generator=g)
    human = torch.randn(ZOO_BATCH, ZOO_W, cfg.human_input_dim, device="cuda", generator=g)
    before = launches()
    logs = make_train_epoch(exp)(model, opt, robot, human,
                                 torch.arange(ZOO_BATCH, device="cuda")[None], g)
    now = launches()
    delta = {k: now[k] - before[k] for k in now}
    k1, k2 = per_call(cfg)
    want = {k: 0 for k in now}
    want.update({attention.ENTRY["fwd", torch.float32]: k1,
                 attention.ENTRY["bwd", torch.float32]: k1, "vq_assign": k2})
    k1_want(want, cfg.window_size)
    require(delta == want, f"{exp.id} step: launches {delta}, want {want}")
    require(all(math.isfinite(v) for v in logs.values()), f"{exp.id} step: logs {logs}")
    return {"train_loss": logs["train_loss"], "step_launches": delta}


def zoo_path() -> dict:
    """Every arch x method in float32: ``retarget``, ``robot_recon`` and
    (where the method has codes) ``motion_codes`` on ZOO_FWD windows through
    ServingApp, each against the CPU plain path under the f32 serving rule,
    then one teacher step on the card. Then the three conv archs with the
    hybrid in bf16, under the bf16 rule. Returns the path's launches."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    rng = np.random.default_rng(SEED + 4)
    kernels.reset_counters()
    counts = add_launches()
    t0 = time.perf_counter()
    runs = [(arch, method, torch.float32) for arch in ARCHS for method in METHODS]
    runs += [(arch, "hybrid", BF16) for arch in ZOO_BF16_ARCHS]
    for arch, method, dtype in runs:
        t1 = time.perf_counter()
        exp = zoo_exp(arch, method, compute_dtype=DTYPE_NAME[dtype])
        model, module, verify, _ = serving_check(exp)
        fns = [fn for fn in ("retarget", "robot_recon", "motion_codes") if fn in module.fns]
        lines = serve_requests(exp, ServingApp(module), verify, [(fn, ZOO_FWD) for fn in fns],
                               rng)
        line = {"phase": "zoo", "arch": arch, "method": method, "dtype": DTYPE_NAME[dtype],
                "requests": {l["fn"]: {k: v for k, v in l.items()
                                       if k not in ("phase", "fn", "dtype", "launches")}
                             for l in lines}}
        counts = add_launches(counts, *(l["launches"] for l in lines))
        if dtype == torch.float32:
            line.update(zoo_step(exp, g))
            counts = add_launches(counts, line["step_launches"])
        emit({**line, "seconds": time.perf_counter() - t1})
    for name in (attention.ENTRY["fwd", torch.float32], attention.ENTRY["bwd", torch.float32],
                 "vq_assign"):
        require(counts[name] > 0, f"zoo: {name} never ran: {counts}")
    return {"launches": counts, "models": len(runs), "zoo_path_s": time.perf_counter() - t0}


def zoo_agree() -> list:
    """One teacher step at ZOO_BATCH and dropout 0 on the card and on the
    CPU for three arch x method pairs: the loss within 1e-4 relative; each
    gradient within 1e-3 in relative norm of the CPU's, or, where float32
    itself holds less, no farther than ZOO_ORDER_FACTOR times what taking
    the same batch in another row order moves the CPU's own gradient. (The
    BatchNorm towers' backward cancels: reordering the rows moved resnet +
    standard's encoder gradients by 5.6e-3 on the CPU, and the card's were
    2.7e-3 from the CPU's.) A convolution bias that feeds a BatchNorm has a
    true gradient of exactly 0 (the batch mean cancels a shift), so both
    devices hold rounding residue there: held at 1e-4 of the largest
    gradient norm instead."""
    out = []
    for arch, method in ZOO_AGREE:
        exp = zoo_exp(arch, method, dropout=0.0)
        rng = np.random.default_rng(SEED + 5)
        robot, human = (torch.from_numpy(rng.normal(size=(ZOO_BATCH, ZOO_W, d)).astype(
            np.float32)) for d in (29, 126))
        order = torch.from_numpy(rng.permutation(ZOO_BATCH))
        (l_gpu, g_gpu), (l_cpu, g_cpu) = (_step_grads(exp, dev, robot, human)
                                          for dev in ("cuda", "cpu"))
        _, g_order = _step_grads(exp, "cpu", robot, human, order)
        loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
        require(sorted(g_gpu) == sorted(g_cpu) and g_cpu, f"zoo_agree {arch}: gradient sets")
        largest = max(gc.norm().item() for gc in g_cpu.values())
        rel = lambda a, b: ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
        over, residue = {}, {}
        for name, gc in g_cpu.items():
            if ".net.0.bias" in name or ".net.3.bias" in name:
                residue[name] = max(g_gpu[name].norm().item(), gc.norm().item()) / largest
                continue
            card, own = rel(g_gpu[name], gc), rel(g_order[name], gc)
            over[name] = (card / max(AGREE_GRAD_RTOL, ZOO_ORDER_FACTOR * own), card, own)
        worst = sorted(over.items(), key=lambda kv: -kv[1][0])[:3]
        res = {"phase": "zoo_agree", "arch": arch, "method": method, "batch": ZOO_BATCH,
               "window": ZOO_W, "loss_cuda": l_gpu, "loss_cpu": l_cpu, "loss_rel_err": loss_rel,
               "params_compared": len(g_cpu),
               "worst_grad_rel_norm_err": max(v[1] for v in over.values()),
               "worst_cpu_reorder_rel_norm_err": max(v[2] for v in over.values()),
               "worst_share_of_limit": [[n, *v] for n, v in worst],
               "bn_bias_residue_of_largest": max(residue.values(), default=0.0)}
        emit(res)
        require(loss_rel <= AGREE_LOSS_RTOL, f"zoo_agree {arch} {method}: loss {l_gpu} vs {l_cpu}")
        require(res["bn_bias_residue_of_largest"] <= AGREE_GRAD_RTOL * 0.1,
                f"zoo_agree {arch} {method}: BatchNorm-fed bias residue {residue}")
        require(worst[0][1][0] <= 1.0, f"zoo_agree {arch} {method}: {worst[0]}")
        out.append(res)
    return out


# ---------------------------------------------------------------- phase 7

def _run_rc(args, cwd: str, env: dict) -> tuple:
    """A child process that may fail: (rc, stdout, stderr, seconds)."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                       text=True, timeout=CLI_TIMEOUT_S)
    return r.returncode, r.stdout, r.stderr, time.perf_counter() - t0


def _run_cli(args, cwd: str, env: dict) -> str:
    rc, stdout, stderr, _ = _run_rc(args, cwd, env)
    require(rc == 0, f"{' '.join(args[:3])}: rc {rc}\n{stderr[-3000:]}")
    return stdout


def cli_path(smi: str) -> tuple:
    """The verify drive on the port's own CLI, each stage a child process on
    the card: ``cli.process_data --synthetic``, a teacher (``resnet_no_down``,
    ``hybrid``, window 10) for 2 epochs, then its student for 1. The
    checkpoints and histories must carry the reference's names and the
    teacher's train loss must fall. Returns the line (with the stages'
    launches, which the children print) and the work directory."""
    workdir = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    t0 = time.perf_counter()
    _run_cli(["-m", "bridgerl_tpu_torch.cli.process_data", *CLI_DATA], workdir, env)
    total = {name: 0 for name in kernels.COUNTERS}
    stages = {}
    for mode in ("teacher", "student"):
        args = ["-c", CLI_WRAPPER, TRAIN_CLI, *CLI_RUN, "--epochs", str(CLI_EPOCHS[mode]),
                "--mode", mode]
        if mode == "student":
            args += ["--teacher_ckpt", CLI_TEACHER]
        t1 = time.perf_counter()
        stdout = _run_cli(args, workdir, env)
        counts = json.loads(stdout.strip().splitlines()[-1].split("LAUNCHES ", 1)[1])
        require(f"Success: Exp_resnet_no_down_W10 | Mode: {mode} | Seed: 42" in stdout,
                f"cli {mode}: {stdout[-2000:]}")
        for kind in ("best", "last", "final"):
            path = os.path.join(workdir, "checkpoints",
                                f"Exp_resnet_no_down_W10_hybrid_{mode}_seed_42_{kind}.pth")
            require(os.path.exists(path), f"cli {mode}: no {path}")
        logs = ["log_resnet_no_down_hybrid_seed_42.json" if mode == "teacher"
                else "log_resnet_no_down_hybrid_student_seed_42.json",
                f"log_Exp_resnet_no_down_W10_{mode}_seed_42.json"]
        for name in logs:
            with open(os.path.join(workdir, "results", name)) as f:
                hist = json.load(f)
            require(sorted(hist) == sorted(HISTORY_KEYS)
                    and len(hist["train_loss"]) == CLI_EPOCHS[mode]
                    and all(math.isfinite(v) for v in hist["train_loss"]), f"cli {mode}: {name}")
        if mode == "teacher":
            require(hist["train_loss"][-1] < hist["train_loss"][0],
                    f"cli teacher: train loss {hist['train_loss']} does not fall")
        require(counts["vq_assign"] > 0, f"cli {mode}: K2 never ran: {counts}")
        stages[mode] = {"launches": counts, "train_loss": hist["train_loss"],
                        "val_loss": hist["val_loss"], "seconds": time.perf_counter() - t1}
        for k in total:
            total[k] += counts.get(k, 0)
    line = {"phase": "cli", "card": smi, **stages, "launches": total,
            "cli_path_s": time.perf_counter() - t0}
    emit(line)
    return line, workdir


def serve_trained(workdir: str, smi: str) -> dict:
    """The CLI-trained teacher served through ServingApp on the card, on
    SERVE_TRAINED_WINDOWS of its own training windows: in float32 under
    :func:`trained_f32_rule` (trained weights put windows on code
    boundaries: values on the windows whose codes the card and the CPU
    share, every other window a near tie); in bf16 (the same weights) under
    the bf16 rules, with the share of windows whose codes leave float32's
    on trained weights."""
    ck = load_checkpoint(os.path.join(workdir, CLI_TEACHER))
    weights = ck["model_state_dict"]

    def trained(cfg, device):
        model = init_model(cfg, SEED, device="cpu")
        model.load_state_dict(weights, strict=True)
        return model.to(device)

    data = os.path.join(workdir, "data", "processed")
    windows = {"retarget": np.load(os.path.join(data, "human_train.npy")),
               "robot_recon": np.load(os.path.join(data, "g1_train.npy"))}
    windows["motion_codes"] = windows["retarget"]
    pick = np.random.default_rng(SEED + 6).permutation(len(windows["retarget"]))
    out = {"phase": "serve_trained", "card": smi, "checkpoint": CLI_TEACHER}
    for dtype in DTYPES:
        exp = dataclasses.replace(ck["config"], model=dataclasses.replace(
            ck["config"].model, compute_dtype=DTYPE_NAME[dtype]))
        model, module, verify, ((cpu, cpu_model), _) = serving_check(exp, trained)
        if dtype == torch.float32:
            verify = _trained_verify(model, cpu, cpu_model)
        singles = iter(pick)   # b = 1 tries successive windows

        def x_for(fn, b, singles=singles):
            return windows[fn][pick[:b] if b > 1 else [next(singles)]].astype(np.float32)

        requests = [("retarget", SERVE_TRAINED_WINDOWS), ("robot_recon", SERVE_TRAINED_WINDOWS),
                    ("motion_codes", SERVE_TRAINED_WINDOWS), ("retarget", 1)]
        lines = serve_requests(exp, ServingApp(module), verify, requests, None, x_for)
        out[DTYPE_NAME[dtype]] = [{k: v for k, v in l.items() if k != "phase"} for l in lines]
    flips = [1.0 - l["codes_agree_f32"] for l in out["bfloat16"] if "codes_agree_f32" in l]
    out["bf16_code_flip_share"] = max(flips)
    emit(out)
    return out


def _trained_verify(model, cpu, cpu_model):
    """serve_trained's float32 check (:func:`trained_f32_rule`): the codes
    of each window on the card and on the CPU, the CPU's latents, and the
    answer's values against the CPU's on the windows whose codes agree."""
    def verify(name, fn, x, got):
        branch = "robot" if fn == "robot_recon" else "human"
        want = _numpy(cpu.fns[fn](x))
        with torch.no_grad():
            xt = torch.as_tensor(x)
            z = cpu_model.encode_robot(xt) if branch == "robot" else cpu_model.encode_human(xt)
        if fn == "motion_codes":
            require(sorted(got) == sorted(want), f"{name}: streams {sorted(got)}")
            return trained_f32_rule(name, cpu_model.quantizer, z, got, want)
        return trained_f32_rule(name, cpu_model.quantizer, z, _window_codes(model, branch, x),
                                _window_codes(cpu_model, branch, x), got, want)
    return verify


# ---------------------------------------------------------------- phase 8

def _calls(name: str, before: dict, dtype, k1: int, k2: int) -> dict:
    """The launches since ``before`` must be ``k1`` K1 forwards of ``dtype``
    and ``k2`` K2 launches, nothing else."""
    now = launches()
    delta = {k: now[k] - before[k] for k in now}
    want = {k: 0 for k in now}
    want[attention.ENTRY["fwd", dtype]] = k1
    want["vq_assign"] = k2
    multi_want(want)
    require(delta == want, f"{name}: launches {delta}, want {want}")
    return delta


def _fn_launches(cfg, fn: str) -> tuple:
    """K1 forwards and K2 launches of one call of serving function ``fn``:
    a whole model call, or for decode_codes the decoder alone."""
    k1, k2 = per_call(cfg)
    return (cfg.n_tf_layers, 0) if fn == "decode_codes" else (k1, k2)


def _bf16_vs_live(name: str, got, want) -> dict:
    """A bf16 answer of the artifact against the live module's on the card,
    which runs the same kernels on the same GEMM shapes (only K1's packing
    differs): codes equal on at least CODES_AGREE of the windows, values
    within BF16_SERVE_ULPS bf16 ulps of the answer's scale."""
    if isinstance(want, dict):
        agree = float(_rows_agree(got, want).mean())
        require(agree >= CODES_AGREE, f"{name}: codes agree with the live module on {agree}")
        return {"codes_agree_live": agree}
    scale = float(np.abs(want).max())
    ulps = float(np.abs(got - want).max()) / bf16_ulp(scale)
    require(ulps <= BF16_SERVE_ULPS, f"{name}: {ulps} bf16 ulps of {scale} from the live module")
    return {"ulps_vs_live": ulps, "scale": scale}


def _serving_rate(app: ServingApp, x: np.ndarray, reps: int = 20) -> tuple:
    """(windows/s of retarget at x's batch, median ms of a b = 1 request)
    through ``app``, after a warm-up."""
    for _ in range(3):
        app.call("retarget", x)
    t0 = time.perf_counter()
    for _ in range(reps):
        app.call("retarget", x)
    wps = reps * len(x) / (time.perf_counter() - t0)
    x1, lat = x[:1].copy(), []
    for _ in range(5):
        app.call("retarget", x1)
    for _ in range(50):
        t0 = time.perf_counter()
        app.call("retarget", x1)
        lat.append((time.perf_counter() - t0) * 1e3)
    return wps, statistics.median(lat)


def _load_in_child(path: str) -> dict:
    """Load the artifact in a child process: it must serve on the card and
    import nothing of the port's models, training or config."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", ARTIFACT_LOAD_PROBE, path], env=env,
                       capture_output=True, text=True, timeout=CLI_TIMEOUT_S)
    require(r.returncode == 0, f"artifact load in a child: rc {r.returncode}\n{r.stderr[-3000:]}")
    out = json.loads(r.stdout.strip().splitlines()[-1])
    model_code = [m for m in out["modules"] if m.split(".")[:2] in (
        ["bridgerl_tpu_torch", "models"], ["bridgerl_tpu_torch", "train"],
        ["bridgerl_tpu_torch", "config"])]
    require(not model_code, f"loading the artifact imported {model_code}")
    require(out["finite"] and out["shape"] == [2, 10, 29] and out["device"].startswith("cuda"),
            f"artifact in a child: {out}")
    return {"child_device": out["device"], "child_imported_model_code": model_code}


def artifact_path(smi: str, dtype) -> tuple:
    """The flagship frozen into a serving artifact (cuda and cpu programs,
    timed), loaded in a child process and here, its four functions called
    at each of ARTIFACT_BATCHES with their launches checked (the unpacked
    path launches what the live module does) and held to the live module
    on the card: in float32 within ARTIFACT_ATOL and codes equal; in bf16
    under the bf16 rules against the CPU runs up to ARTIFACT_CPU_CHECKED
    windows, and above that against the live module (_bf16_vs_live). The
    line's launches add up the artifact's own calls, not the live module's
    or the CPU checks'. Then retarget's rate at b = 4096 and b = 1 latency
    through the artifact and the live module.
    Returns the line, and (the loaded artifact, the live module, the work
    directory) for the phases that follow."""
    exp = make_experiment("transformer", "hybrid", window=10, attn_packing=8,
                          compute_dtype=DTYPE_NAME[dtype])
    cfg = exp.model
    t_phase = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_artifact_")
    path = os.path.join(workdir, "flagship.zip")
    model, live, verify, ((cpu16, _), (cpu32, _)) = serving_check(exp)
    t0 = time.perf_counter()
    # the cpu programs are exported in float32 only: the bf16 line checks the cuda ones
    platforms = ("cuda", "cpu") if dtype == torch.float32 else ("cuda",)
    meta = build_serving_artifact(model, exp, path, data_dir=None, platforms=platforms)
    export_s = time.perf_counter() - t0
    require(sorted(meta["functions"]) == ["decode_codes", "motion_codes", "retarget",
                                          "robot_recon"], f"artifact functions {meta}")
    loaded = BACKGROUND.submit(_load_in_child, path)   # a child: beside the checks here
    art = load_serving_artifact(path)
    own = []   # the launches of the artifact's own calls
    rng = np.random.default_rng(SEED + 7)
    for b in ARTIFACT_BATCHES:
        xh = rng.normal(size=(b, cfg.window_size, cfg.human_input_dim)).astype(np.float32)
        xr = rng.normal(size=(b, cfg.window_size, cfg.robot_input_dim)).astype(np.float32)
        line = {"b": b}
        got = {}
        for fn, x in (("retarget", xh), ("robot_recon", xr), ("motion_codes", xh)):
            before = launches()
            got[fn] = _numpy(art.fns[fn](x))
            own.append(_calls(f"artifact {fn} b={b}", before, dtype, *_fn_launches(cfg, fn)))
            want = _numpy(live.fns[fn](x))
            if fn == "motion_codes":
                agree = float(_rows_agree(got[fn], want).mean())
                line[f"{fn}_codes_agree_live"] = agree
                require(dtype == BF16 or agree == 1.0, f"artifact {fn} b={b}: codes {agree}")
            else:
                err = float(np.abs(got[fn] - want).max())
                line[f"{fn}_max_abs_err_vs_live"] = err
                require(dtype == BF16 or err <= ARTIFACT_ATOL,
                        f"artifact {fn} b={b}: {err} from the live module")
            if dtype == BF16 and b <= ARTIFACT_CPU_CHECKED:
                line[f"{fn}_vs_cpu"] = verify(f"artifact {fn} b={b}", fn, x, got[fn])
            elif dtype == BF16:
                line[f"{fn}_vs_live"] = _bf16_vs_live(f"artifact {fn} b={b}", got[fn], want)
        codes = got["motion_codes"]
        before = launches()
        decoded = _numpy(art.decode_codes(codes))
        own.append(_calls(f"artifact decode_codes b={b}", before, dtype,
                          *_fn_launches(cfg, "decode_codes")))
        live_decoded = _numpy(live.decode_codes(codes))
        line["decode_codes_max_abs_err_vs_live"] = float(np.abs(decoded - live_decoded).max())
        round_trip = float(np.abs(decoded - got["retarget"]).max())
        line["decode_of_codes_max_abs_err_vs_retarget"] = round_trip
        if dtype == BF16 and b <= ARTIFACT_CPU_CHECKED:   # codes are inputs: no flips
            line["decode_codes_vs_cpu"] = _check_bf16_values(
                f"artifact decode_codes b={b}", decoded, _numpy(cpu16.decode_codes(codes)),
                _numpy(cpu32.decode_codes(codes)), np.ones(b, bool))
        elif dtype == BF16:
            line["decode_codes_vs_live"] = _bf16_vs_live(f"artifact decode_codes b={b}",
                                                         decoded, live_decoded)
        else:
            require(line["decode_codes_max_abs_err_vs_live"] <= ARTIFACT_ATOL,
                    f"artifact decode_codes b={b}: {line['decode_codes_max_abs_err_vs_live']}")
            require(round_trip <= ARTIFACT_ATOL,
                    f"artifact decode_codes(motion_codes(x)) b={b}: {round_trip} from retarget")
        emit({"phase": "artifact_request", "dtype": DTYPE_NAME[dtype], **line})
    child = loaded.result()   # before the rates: no child beside them
    x4096 = rng.normal(size=(4096, cfg.window_size, cfg.human_input_dim)).astype(np.float32)
    art_wps, art_p50 = _serving_rate(ServingApp(art), x4096)
    live_wps, live_p50 = _serving_rate(ServingApp(live), x4096)
    out = {"phase": "artifact", "card": smi, "dtype": DTYPE_NAME[dtype],
           "export_s": export_s, "export_s_by_platform": meta["export_seconds"],
           "artifact_bytes": os.path.getsize(path), **child, "launches": add_launches(*own),
           "artifact_retarget_windows_per_s_b4096": art_wps,
           "live_retarget_windows_per_s_b4096": live_wps,
           "artifact_retarget_p50_ms_b1": art_p50, "live_retarget_p50_ms_b1": live_p50,
           "artifact_path_s": time.perf_counter() - t_phase}
    emit(out)
    return out, (art, live, workdir)


def _http_post(base: str, path: str, body: bytes, ctype: str) -> tuple:
    req = urllib.request.Request(base + path, data=body, headers={"Content-Type": ctype},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def decode_http(smi: str, art, dtype=torch.float32) -> dict:
    """One decode_codes request over HTTP from the artifact's server, as an
    npz and as JSON: each answer equal to the in-process call's, and one
    decoder's K1 launches each; a malformed body gets a 400."""
    cfg = make_experiment("transformer", "hybrid", window=10).model
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 8)
    x = rng.normal(size=(64, cfg.window_size, cfg.human_input_dim)).astype(np.float32)
    codes = _numpy(art.motion_codes(x))
    want = _numpy(art.decode_codes(codes))
    srv = make_server(art, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    kernels.reset_counters()
    try:
        host, port = srv.server_address
        base = f"http://{host}:{port}"
        before = launches()
        got_npz = ServingClient(base).decode_codes(codes)
        _calls("HTTP decode_codes npz", before, dtype, *_fn_launches(cfg, "decode_codes"))
        before = launches()
        status, body = _http_post(base, "/v1/decode_codes", json.dumps(
            {"codes": {k: v.tolist() for k, v in codes.items()}}).encode(), "application/json")
        _calls("HTTP decode_codes json", before, dtype, *_fn_launches(cfg, "decode_codes"))
        require(status == 200, f"HTTP decode_codes json: {status} {body[:300]}")
        got_json = np.asarray(json.loads(body)["windows"], np.float32)
        bad, _ = _http_post(base, "/v1/decode_codes", json.dumps(
            {"codes": {k: v[:, :0].tolist() for k, v in codes.items()}}).encode(),
            "application/json")
        require(bad == 400, f"HTTP decode_codes with empty streams: {bad}, want 400")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join()
    counts = launches()
    errs = {"npz": float(np.abs(got_npz - want).max()),
            "json": float(np.abs(got_json - want).max())}
    require(got_npz.shape == want.shape and max(errs.values()) <= 1e-6,
            f"HTTP decode_codes {errs}")
    out = {"phase": "decode_http", "card": smi, "dtype": DTYPE_NAME[dtype], "b": len(x),
           "max_abs_err_vs_in_process": errs, "malformed_status": bad, "launches": counts,
           "decode_http_s": time.perf_counter() - t0}
    emit(out)
    return out


def stream_path(smi: str, art, dtype=torch.float32) -> dict:
    """StreamingRetargeter over the artifact's retarget: STREAM_FRAMES
    frames at window 10 and step STREAM_STEP, one window a call. The output
    equals offline overlap-add over the same function within ARTIFACT_ATOL,
    each frame comes out exactly W + 1 frames after it went in, and each
    push that completes a window is timed."""
    cfg = make_experiment("transformer", "hybrid", window=10).model
    W = cfg.window_size
    t_phase = time.perf_counter()
    seq = np.random.default_rng(SEED + 9).normal(
        size=(STREAM_FRAMES, cfg.human_input_dim)).astype(np.float32)
    kernels.reset_counters()
    sr = StreamingRetargeter(art.retarget, window=W, step=STREAM_STEP,
                             in_dim=cfg.human_input_dim)
    out, late, window_ms = [], [], []
    for n, frame in enumerate(seq, start=1):
        t0 = time.perf_counter()
        frames = sr.push(frame)
        dt = (time.perf_counter() - t0) * 1e3
        if n >= W and (n - W) % STREAM_STEP == 0:
            window_ms.append(dt)
        first = sum(len(o) for o in out)
        late += [n - i for i in range(first, first + len(frames))]
        if len(frames):
            out.append(frames)
    out.append(sr.flush())
    got = np.concatenate([o for o in out if len(o)])
    windows = len(window_starts(STREAM_FRAMES, W, STREAM_STEP))
    k1, k2 = per_call(cfg)
    counts = launches()
    want_counts = {k: 0 for k in counts}
    want_counts.update({attention.ENTRY["fwd", dtype]: k1 * windows, "vq_assign": k2 * windows})
    multi_want(want_counts)
    require(counts == want_counts, f"stream: launches {counts}, want {want_counts}")
    require(set(late) == {W + 1}, f"stream: frames came out {sorted(set(late))} frames later")
    offline = reconstruct_long_sequence(art.fns["retarget"], seq, W, STREAM_STEP,
                                        np.zeros(1, np.float32), np.ones(1, np.float32),
                                        device="cuda")
    err = float(np.abs(got - offline).max())
    require(got.shape == offline.shape and err <= ARTIFACT_ATOL,
            f"stream: {got.shape} {err} from offline overlap-add")
    line = {"phase": "stream", "card": smi, "dtype": DTYPE_NAME[dtype], "frames": STREAM_FRAMES,
            "window": W, "step": STREAM_STEP, "windows": windows, "launches": counts,
            "latency_frames": W + 1, "max_abs_err_vs_offline": err,
            "window_push_p50_ms": statistics.median(window_ms),
            "window_push_max_ms": max(window_ms), "stream_s": time.perf_counter() - t_phase}
    emit(line)
    return line


# ---------------------------------------------------------------- phase 9

def _run_child(args, cwd: str, env: dict) -> tuple:
    """A CLI module through CLI_WRAPPER in a child: (stdout, its launches,
    seconds)."""
    t0 = time.perf_counter()
    stdout = _run_cli(["-c", CLI_WRAPPER, *args], cwd, env)
    counts = json.loads(stdout.strip().splitlines()[-1].split("LAUNCHES ", 1)[1])
    return stdout, counts, time.perf_counter() - t0


def _run_children(jobs: dict, cwd: str, env: dict) -> dict:
    """CLI modules through CLI_WRAPPER, each a child, all started together:
    name -> (stdout, its launches, seconds); any failure raises."""
    out = {}
    for name, (rc, stdout, stderr, sec) in _run_parallel(
            {n: ["-c", CLI_WRAPPER, *args] for n, args in jobs.items()}, cwd, env).items():
        require(rc == 0, f"{name}: rc {rc}\n{stderr[-3000:]}")
        counts = json.loads(stdout.strip().splitlines()[-1].split("LAUNCHES ", 1)[1])
        out[name] = (stdout, counts, sec)
    return out


def _history(workdir: str, name: str, epochs: int) -> dict:
    with open(os.path.join(workdir, "results", name)) as f:
        hist = json.load(f)
    require(sorted(hist) == sorted(HISTORY_KEYS) and len(hist["train_loss"]) == epochs
            and all(math.isfinite(v) for k in ("train_loss", "val_loss") for v in hist[k]),
            f"recipe: {name}: {hist}")
    return hist


def _check_step0(workdir: str, ae_ckpt: str, step0_ckpt: str, batch: int) -> dict:
    """The hybrid's weights at step 0: every tower entry equal to the ae
    checkpoint's, and the first-stage codebook rows the robot encoder's
    outputs on the first ``batch`` training windows plus the jitter."""
    ae, step0 = load_checkpoint(ae_ckpt), load_checkpoint(step0_ckpt)
    towers = [k for k in ae["model_state_dict"] if not k.startswith("quantizer.")]
    same = [k for k in towers if torch.equal(ae["model_state_dict"][k],
                                             step0["model_state_dict"][k])]
    require(towers and same == towers, f"recipe step 0: {len(same)} of {len(towers)} tower "
            "entries equal the ae checkpoint's")
    data = os.path.join(workdir, "data", "processed")
    ds = PairedDataset.from_numpy(np.load(os.path.join(data, "g1_train.npy")),
                                  np.load(os.path.join(data, "human_train.npy")), "cuda")
    train_ds, _ = train_val_split(ds, ae["config"].train.val_fraction, RECIPE_SEED)
    model = init_model(ae["config"].model, SEED, device="cpu")
    model.load_state_dict(ae["model_state_dict"])
    model = model.to("cuda")
    with torch.no_grad():
        z = model.encode_robot(train_ds.robot[:batch]).float()
    flat = z.reshape(-1, z.shape[-1]).cpu()
    sd = step0["model_state_dict"]
    emb = sd["quantizer.vq.layers.0.embedding.weight"]
    idx = (torch.arange(emb.shape[0]) * flat.shape[0]) // emb.shape[0]
    std = flat.std(dim=0, correction=0)
    off = (emb - flat[idx]).abs()
    scale = float(flat.abs().max())
    require(bool((off <= 6 * JITTER * std + 1e-5 * scale).all()),
            f"recipe step 0: codebook rows {float((off / std).max())} std from encoder rows")
    require(torch.equal(sd["quantizer.vq.layers.0.ema_w"], emb)
            and bool((sd["quantizer.vq.layers.0.ema_cluster_size"] == 1).all()),
            "recipe step 0: EMA state not warm-started from the seeded rows")
    return {"tower_entries_equal_ae": len(same), "codebook_rows": emb.shape[0],
            "encoder_rows": flat.shape[0], "max_row_offset_in_std": float((off / std).max())}


def recipe_children(workdir: str) -> dict:
    """The W64-transformer recipe's children, in ``workdir``, each stage a
    child on the card: process_data --synthetic, an ae teacher, the hybrid
    at step 0 (epochs 0) and, beside it, trained with --init_from,
    --codebook_data_init, --cheap_dropout, --reuse_dropout_mask and
    --accum_chunks 4; then export_motion on its checkpoint beside
    export_serving --check, and serve_http --max_requests 1 with one
    retarget request. Children and files only, no kernel launch in this
    process: it runs in a thread beside other phases, and recipe_path
    checks what it leaves. Returns each stage's stdout, launches and
    seconds, and the request with its answer."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    t0 = time.perf_counter()
    W = RECIPE_WINDOW
    seconds, total = {}, {name: 0 for name in kernels.COUNTERS}
    t1 = time.perf_counter()
    _run_cli(["-m", "bridgerl_tpu_torch.cli.process_data", "--synthetic", "--window",
              str(W)], workdir, env)
    seconds["process_data"] = time.perf_counter() - t1
    common = ["--arch", "transformer", "--window", str(W), "--seed", str(RECIPE_SEED),
              "--batch_size", str(RECIPE_BATCH)]
    stages = {
        "ae": common + ["--method", "ae", "--epochs", str(RECIPE_EPOCHS)],
        "hybrid_step0": common + ["--method", "hybrid", "--init_from", RECIPE_AE_CKPT,
                                  *RECIPE_FLAGS, "--epochs", "0",
                                  "--checkpoint_dir", "step0", "--log_dir", "step0"],
        "hybrid": common + ["--method", "hybrid", "--init_from", RECIPE_AE_CKPT, *RECIPE_FLAGS,
                            "--epochs", str(RECIPE_EPOCHS)]}
    launched, stdouts = {}, {}
    # the two hybrid stages need only the ae checkpoint: they run together
    for group in (("ae",), ("hybrid_step0", "hybrid")):
        done = _run_children({stage: [TRAIN_CLI, *stages[stage]] for stage in group},
                             workdir, env)
        for stage, (stdouts[stage], counts, seconds[stage]) in done.items():
            require(f"Success: Exp_transformer_W{W} | Mode: teacher" in stdouts[stage],
                    f"recipe {stage}: {stdouts[stage][-2000:]}")
            launched[stage] = counts
            for k in total:
                total[k] += counts.get(k, 0)
    best = os.path.join(workdir, "checkpoints", f"{RECIPE_HYBRID}_best.pth")
    art = os.path.join(workdir, "serving", "hybrid.zip")
    done = _run_children({   # both read the checkpoint only: they run together
        "export_motion": ["bridgerl_tpu_torch.cli.export_motion", "--ckpt", best,
                          "--num_samples", str(RECIPE_MOTIONS)],
        "export_serving": ["bridgerl_tpu_torch.cli.export_serving", "--ckpt", best,
                           "--out", art, "--check", "--platforms", "cuda"]},
        workdir, env)          # the artifact phase exports and checks both platforms
    for stage, (stdouts[stage], counts, seconds[stage]) in done.items():
        for k in total:
            total[k] += counts.get(k, 0)
    stdout = stdouts["export_serving"]
    require("check ok: retarget (2, 64, 126) -> (2, 64, 29) on cuda" in stdout,
            f"export_serving --check: {stdout[-2000:]}")
    seconds["serve_http"], request = _serve_one(art, workdir, env)
    return {"seconds": seconds, "launched": launched, "launches": total, "stdouts": stdouts,
            "request": request, "children_s": time.perf_counter() - t0}


def recipe_path(smi: str, workdir: str, children) -> dict:
    """The W64-transformer recipe through the CLI: recipe_children's result
    (``children``, a future), then its checks here. Finite losses; K1
    forward and backward and K2 launched in the trained hybrid; the hybrid
    at step 0 holds the ae's towers and the first-stage codebook encoder
    rows; export_motion's files carry the reference's names and equal
    reconstruct_long_sequence over the same model; serve_http's answer is
    the checkpoint's live module's."""
    W = RECIPE_WINDOW
    try:
        run = children.result()
        t0 = time.perf_counter()
        stdout = run["stdouts"]["hybrid"]
        require("[InitFrom]" in stdout and "[Seed] codebook data init" in stdout,
                f"recipe hybrid: no init or seeding line: {stdout[-2000:]}")
        hist = {m: _history(workdir, make_experiment("transformer", m, window=W).log_name(
            RECIPE_SEED), RECIPE_EPOCHS) for m in ("ae", "hybrid")}
        step0 = _check_step0(workdir, os.path.join(workdir, RECIPE_AE_CKPT),
                             os.path.join(workdir, "step0", f"{RECIPE_HYBRID}_final.pth"),
                             RECIPE_BATCH)
        h = run["launched"]["hybrid"]
        require(all(h[attention.ENTRY[d, torch.float32]] > 0 for d in ("fwd", "bwd"))
                and h["vq_assign"] > 0, f"recipe hybrid: a kernel never ran: {h}")
        best = os.path.join(workdir, "checkpoints", f"{RECIPE_HYBRID}_best.pth")
        motions = _check_motions(workdir, best)
        served = _check_served(best, *run["request"])
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    line = {"phase": "recipe", "card": smi, "window": W, "epochs": RECIPE_EPOCHS,
            "stage_seconds": run["seconds"], "launches_by_stage": run["launched"],
            "launches": run["launches"],
            "train_loss": {k: v["train_loss"] for k, v in hist.items()},
            "val_loss": {k: v["val_loss"] for k, v in hist.items()},
            "step0": step0, "motions": motions, "served": served,
            "recipe_children_s": run["children_s"],
            "recipe_path_s": run["children_s"] + time.perf_counter() - t0}
    emit(line)
    return line


def _check_motions(workdir: str, ckpt: str) -> dict:
    """export_motion's files: the reference's names, each reconstruction
    equal to reconstruct_long_sequence over the same model within
    ARTIFACT_ATOL."""
    model, exp = load_model_from_checkpoint(ckpt)
    W = exp.model.window_size
    raw = np.load(os.path.join(workdir, "data", "processed", "g1_train_full_raw.npy"),
                  allow_pickle=True)
    errs = []
    for i in range(RECIPE_MOTIONS):
        gt = np.load(os.path.join(workdir, "motions", f"idx{i}_gt.npy"))
        got = np.load(os.path.join(workdir, "motions",
                                   f"recon_transformer_FullSeq_W{W}_idx{i}.npy"))
        want = reconstruct_long_sequence(robot_recon_fn(model), np.asarray(raw[i], np.float32),
                                         W, W // 2, np.zeros(1, np.float32),
                                         np.ones(1, np.float32), device="cuda")
        require(np.array_equal(gt, np.asarray(raw[i], np.float32)) and got.shape == want.shape,
                f"export_motion idx{i}: {gt.shape} {got.shape}")
        errs.append(float(np.abs(got - want).max()))
    require(max(errs) <= ARTIFACT_ATOL, f"export_motion: {errs} from reconstruct_long_sequence")
    return {"files": 2 * RECIPE_MOTIONS, "max_abs_err_vs_reconstruct": max(errs)}


def _serve_one(artifact: str, workdir: str, env: dict) -> tuple:
    """serve_http --max_requests 1 as a child: one retarget request answered
    and the child exits 0. Returns the seconds and (request, answer)."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    child = subprocess.Popen([sys.executable, "-m", "bridgerl_tpu_torch.cli.serve_http",
                              "--artifact", artifact, "--port", str(port), "--max_requests",
                              "1"], cwd=workdir, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
    try:
        x = np.random.default_rng(SEED + 10).normal(size=(3, RECIPE_WINDOW, 126)).astype(
            np.float32)
        client = ServingClient(f"http://127.0.0.1:{port}")
        deadline = time.perf_counter() + CLI_TIMEOUT_S
        while True:
            try:
                got = client.retarget(x)
                break
            except (ConnectionError, urllib.error.URLError):
                require(child.poll() is None and time.perf_counter() < deadline,
                        f"serve_http did not come up: {child.poll()}")
                time.sleep(0.2)
        _, err = child.communicate(timeout=CLI_TIMEOUT_S)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    require(child.returncode == 0, f"serve_http: rc {child.returncode}\n{err[-2000:]}")
    return time.perf_counter() - t0, (x, got)


def _check_served(ckpt: str, x: np.ndarray, got: np.ndarray) -> dict:
    """serve_http's answer within ARTIFACT_ATOL of the checkpoint's live
    module in this process (the artifact's unpacked towers sum in another
    order)."""
    model, exp = load_model_from_checkpoint(ckpt)
    want = _numpy(build_serving_module(model, exp).retarget(x))
    diff = float(np.abs(got - want).max())
    require(got.shape == (3, RECIPE_WINDOW, 29) and diff <= ARTIFACT_ATOL,
            f"serve_http answer {diff}")
    return {"b": 3, "max_abs_err_vs_live": diff}


# ---------------------------------------------------------------- phases 11-14

def _profile_step(fn, what: str) -> dict:
    """Device ms, device operations and the idle share of one call of
    ``fn`` from torch.profiler, after one warm-up call (as --profile counts
    a teacher step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(ev.key, ev.self_device_time_total / 1e3, ev.count)
            for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]
    busy_ms = sum(r[1] for r in rows)
    require(busy_ms > 0, f"{what}: the profiler saw no device time")
    rows.sort(key=lambda r: -r[1])
    return {"what": what, "wall_ms": wall_ms, "device_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms, "device_ops": sum(r[2] for r in rows),
            "top": [{"kernel": name[:90], "ms": ms, "launches": n}
                    for name, ms, n in _top(rows, 8)]}


def _ms_exp(workdir: str, seeds, **over):
    exp = make_experiment("transformer", "hybrid", window=10, attn_packing=8,
                          batch_size=MS_BATCH, compute_dtype="bfloat16", dropout=DROPOUT,
                          seeds=tuple(seeds), epochs=MS_WARM + MS_TIMED, **over)
    return dataclasses.replace(exp, log_dir=os.path.join(workdir, "results"),
                               checkpoint_dir=os.path.join(workdir, "checkpoints"))


def _timed_rate(train_seconds, warm: int) -> tuple:
    """(windows/s, windows, seconds) over the epochs from ``warm`` on."""
    timed = [(w, t) for e, w, t in train_seconds if e >= warm]
    windows, seconds = sum(w for w, _ in timed), sum(t for _, t in timed)
    return windows / seconds, windows, seconds


def multiseed_path(smi: str) -> dict:
    """The stacked teacher at bench.py's multiseed configuration through
    MultiSeedTrainer, then two of its seeds one after another through
    Trainer in the same call: aggregate windows/s over the timed epochs; the
    stacked run must launch K1 and K2 exactly as often as one seed's run
    (once a microbatch for all seeds) and the sequential run twice as
    often, every loss finite, each seed's files written."""
    workdir = tempfile.mkdtemp(prefix="chip_smoke_multiseed_")
    S = len(MS_SEEDS)
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    ds = PairedDataset(torch.randn(MS_WINDOWS, 10, 29, device="cuda", generator=g),
                       torch.randn(MS_WINDOWS, 10, 126, device="cuda", generator=g))
    t0 = time.perf_counter()
    try:
        kernels.reset_counters()
        stacked = MultiSeedTrainer(_ms_exp(os.path.join(workdir, "stacked"), MS_SEEDS),
                                   device="cuda", verbose=False)
        hist = stacked.run(ds)
        counts = launches()
        stacked_s = time.perf_counter() - t0
        kernels.reset_counters()
        seq = Trainer(_ms_exp(os.path.join(workdir, "sequential"), MS_SEQ_SEEDS),
                      device="cuda", verbose=False)
        seq_hist = seq.run(ds)
        seq_counts = launches()
        for s in MS_SEEDS:
            for kind in ("best", "last", "final"):
                require(os.path.exists(stacked.ckpt_path(s, kind)),
                        f"multiseed: no {kind} checkpoint of seed {s}")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    epochs = MS_WARM + MS_TIMED
    n_train = int(0.9 * MS_WINDOWS)
    micro = n_train // MS_BATCH                       # accum 1: a microbatch a step
    val = max((MS_WINDOWS - n_train) // min(MS_BATCH, MS_WINDOWS - n_train), 1)
    names = (attention.ENTRY["fwd", BF16], attention.ENTRY["bwd", BF16], "vq_assign")
    one_seed = {name: 0 for name in kernels.COUNTERS}
    one_seed.update({name: epochs * (micro * m + val * v)
                     for name, m, v in zip(names, PER_MICROBATCH["teacher"],
                                           PER_VAL_BATCH["teacher"])})
    multi_want(one_seed)
    require(counts == one_seed, f"multiseed: launches {counts}, one seed's run {one_seed}")
    n_seq = len(MS_SEQ_SEEDS)
    require({k: v * n_seq for k, v in counts.items()} == seq_counts,
            f"multiseed: sequential launches {seq_counts}, {n_seq} x the stacked {counts}")
    for s in MS_SEEDS:
        require(len(hist[s]["train_loss"]) == epochs
                and all(math.isfinite(x) for k in ("train_loss", "val_loss")
                        for x in hist[s][k]), f"multiseed seed {s}: {hist[s]}")
    rate, windows, seconds = _timed_rate(stacked.train_seconds, MS_WARM)
    seq_rate, seq_windows, seq_seconds = _timed_rate(seq.train_seconds, MS_WARM)
    gap = max(abs(a - b) / abs(b) for s in MS_SEQ_SEEDS
              for a, b in zip(hist[s]["train_loss"], seq_hist[s]["train_loss"]))
    line = {"phase": "multiseed", "card": smi, "dtype": "bfloat16", "seeds": S,
            "sequential_seeds": n_seq,
            "batch": MS_BATCH, "windows": MS_WINDOWS, "timed_epochs": MS_TIMED,
            "launches": counts, "sequential_launches": seq_counts,
            "stacked_windows_per_s": rate, "stacked_timed_windows": windows,
            "stacked_timed_seconds": seconds, "sequential_windows_per_s": seq_rate,
            "sequential_timed_windows": seq_windows, "sequential_timed_seconds": seq_seconds,
            "stacked_over_sequential": rate / seq_rate,
            "bf16_train_loss_max_rel_gap_stacked_vs_sequential": gap,
            "train_loss": {s: hist[s]["train_loss"] for s in MS_SEEDS},
            "stacked_run_s": stacked_s, "multiseed_path_s": time.perf_counter() - t0}
    emit(line)
    return line


def multiseed_breakdown(smi: str) -> dict:
    """Device ms, device operations and idle share of one stacked optimizer
    step (batch MS_BATCH a seed, bf16, dropout 0.1) at S = 1 and S = 4,
    from torch.profiler."""
    out = {}
    for S in (1, len(MS_SEEDS)):
        seeds = MS_SEEDS[:S]
        exp = _ms_exp(tempfile.gettempdir(), seeds)
        model = stack_models([init_model(exp.model, s, device="cuda") for s in seeds])
        opt = make_optimizer(model, exp)
        g = torch.Generator(device="cuda").manual_seed(SEED + 12)
        robot = torch.randn(S * MS_BATCH, 10, 29, device="cuda", generator=g)
        human = torch.randn(S * MS_BATCH, 10, 126, device="cuda", generator=g)
        idx = torch.arange(S * MS_BATCH, device="cuda").reshape(S, 1, MS_BATCH)
        gens = [torch.Generator(device="cuda").manual_seed(100 + s) for s in seeds]
        step = make_stacked_train_epoch(exp)
        out[f"S{S}"] = _profile_step(lambda: step(model, opt, robot, human, idx, gens),
                                     f"stacked optimizer step, {S} seed(s)")
        del model, opt
    line = {"phase": "multiseed_profile", "card": smi, "dtype": "bfloat16",
            "batch_per_seed": MS_BATCH, **out,
            "device_ms_ratio_S4_over_S1": out["S4"]["device_ms"] / out["S1"]["device_ms"],
            "device_ops_ratio_S4_over_S1": out["S4"]["device_ops"] / out["S1"]["device_ops"]}
    emit(line)
    return line


def multiseed_agree() -> dict:
    """Two seeds stacked, one float32 optimizer batch of AGREE_BATCH each at
    dropout 0 on the card, each seed held to the card's sequential step for
    that seed under train_agree's rule."""
    exp = make_experiment("transformer", "hybrid", window=10, attn_packing=8, dropout=0.0,
                          batch_size=AGREE_BATCH, accum_chunks=1, seeds=MS_AGREE_SEEDS)
    S = len(MS_AGREE_SEEDS)
    rng = np.random.default_rng(SEED + 13)
    robot, human = (torch.from_numpy(rng.normal(size=(S * AGREE_BATCH, 10, d)).astype(
        np.float32)).cuda() for d in (29, 126))
    idx = torch.arange(S * AGREE_BATCH, device="cuda").reshape(S, AGREE_BATCH)
    model = stack_models([init_model(exp.model, s, device="cuda") for s in MS_AGREE_SEEDS])
    make_optimizer(model, exp).zero_grad(set_to_none=True)
    logs = stacked_accumulate_grads(model, exp, robot, human, idx, None)
    seeds = {}
    for i, s in enumerate(MS_AGREE_SEEDS):
        one = init_model(exp.model, s, device="cuda")
        make_optimizer(one, exp).zero_grad(set_to_none=True)
        want = accumulate_grads(one, exp, robot, human, idx[i], None)
        got = (float(logs["train_loss"][i]),
               {n: p.grad[i].detach().cpu() for n, p in model.named_parameters()
                if p.grad is not None})
        seeds[s] = _agree_rule(f"multiseed_agree seed {s}", got,
                               (float(want["train_loss"]),
                                {n: p.grad.detach().cpu() for n, p in one.named_parameters()
                                 if p.grad is not None}))
    line = {"phase": "multiseed_agree", "batch": AGREE_BATCH, "seeds": seeds}
    emit(line)
    return line


def fk_path(smi: str) -> dict:
    """The FK loss on the card: positions of FK_FRAMES random windows
    against fk_numpy; the flagship float32 teacher with lambda_fk 1.0 at the
    train path's configuration for one epoch (finite losses, the teacher's
    launches); one step against the CPU under train_agree's rule; device ms
    and operations of one microbatch of 512 with and without the FK term."""
    t0 = time.perf_counter()
    chain = load_g1_chain()
    g = torch.Generator(device="cuda").manual_seed(SEED + 14)
    q = torch.rand(FK_FRAMES, 10, 29, device="cuda", generator=g) * 3.0 - 1.5
    pos = make_batched_fk(chain)(q).cpu().numpy()
    qn = q.cpu().numpy().astype(np.float64)
    err = max(float(np.abs(pos[i, t] - fk_numpy(chain, qn[i, t])[0]).max())
              for i in range(0, FK_FRAMES, FK_FRAMES // 16) for t in (0, 9))
    require(err <= FK_TOL, f"fk: positions {err} from fk_numpy")

    workdir = tempfile.mkdtemp(prefix="chip_smoke_fk_")
    try:
        ds = PairedDataset(torch.randn(TRAIN_WINDOWS, 10, 29, device="cuda", generator=g) * 0.5,
                           torch.randn(TRAIN_WINDOWS, 10, 126, device="cuda", generator=g))
        trainer = Trainer(_train_exp(workdir, lambda_fk=1.0, epochs=1), device="cuda",
                          verbose=False)
        kernels.reset_counters()
        hist = trainer.run(ds)[SEED]
        counts = launches()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    want = _expected_train_launches(trainer, TRAIN_WINDOWS, 1)
    require(counts == want, f"fk: launches {counts}, want {want}")
    require(all(math.isfinite(x) for k in ("train_loss", "val_loss") for x in hist[k]),
            f"fk: losses {hist}")
    agree = _agree_rule("fk_agree", _agree_step("cuda", torch.float32, lambda_fk=1.0),
                        _agree_step("cpu", torch.float32, lambda_fk=1.0))

    micro = TRAIN_BATCH // TRAIN_ACCUM
    robot = torch.randn(micro, 10, 29, device="cuda", generator=g) * 0.5
    human = torch.randn(micro, 10, 126, device="cuda", generator=g)
    idx = torch.arange(micro, device="cuda")
    per_mb = {}
    for lam in (0.0, 1.0):
        exp = make_experiment("transformer", "hybrid", window=10, attn_packing=8,
                              batch_size=micro, lambda_fk=lam)
        model = init_model(exp.model, SEED, device="cuda")
        make_optimizer(model, exp)
        mb_g = torch.Generator(device="cuda").manual_seed(SEED + 15)
        per_mb[f"lambda_fk_{lam:g}"] = _profile_step(
            lambda: accumulate_grads(model, exp, robot, human, idx, mb_g),
            f"teacher microbatch of {micro}, lambda_fk {lam:g}")
    fk_only = _profile_step(lambda: make_batched_fk(chain)(robot.requires_grad_()).sum()
                            .backward(), f"FK forward and backward on {micro} windows")
    line = {"phase": "fk", "card": smi, "dtype": "float32", "positions_max_abs_err": err,
            "frames_checked": 32, "launches": counts, "train_loss": hist["train_loss"],
            "val_loss": hist["val_loss"], "windows_per_s": _timed_rate(
                trainer.train_seconds, 0)[0], "agree": agree, "microbatch": per_mb,
            "fk_alone": fk_only,
            "fk_device_ms_per_microbatch": (per_mb["lambda_fk_1"]["device_ms"]
                                            - per_mb["lambda_fk_0"]["device_ms"]),
            "fk_device_ops_per_microbatch": (per_mb["lambda_fk_1"]["device_ops"]
                                             - per_mb["lambda_fk_0"]["device_ops"]),
            "fk_path_s": time.perf_counter() - t0}
    emit(line)
    return line


def int8_path(smi: str) -> dict:
    """The flagship with int8_ff in bf16: retarget at b = 4096 and b = 1
    (padded rows in the int8 product) through ServingApp, held to the CPU's
    int8 model under the bf16 serving rules; its rate beside the same
    model without int8_ff in the same call; then one teacher epoch at the
    train path's configuration."""
    t0 = time.perf_counter()
    exp = make_experiment("transformer", "hybrid", window=10, attn_packing=8,
                          compute_dtype="bfloat16", int8_ff=True)
    W = exp.model.window_size
    _, module, verify, _ = serving_check(exp)
    app = ServingApp(module)
    rng = np.random.default_rng(SEED + 16)
    lines = serve_requests(exp, app, verify, [("retarget", 4096), ("retarget", 1)], rng)
    for line in lines:
        emit({**line, "int8_ff": True})
    plain_exp = dataclasses.replace(exp, model=dataclasses.replace(exp.model, int8_ff=False))
    plain_app = ServingApp(build_serving_module(seeded(plain_exp.model, "cuda"), plain_exp))
    x4096 = rng.normal(size=(4096, W, exp.model.human_input_dim)).astype(np.float32)
    before = launches()
    int8_wps, int8_p50 = _serving_rate(app, x4096)
    rate_delta = add_launches({k: v - before[k] for k, v in launches().items()})
    plain_wps, plain_p50 = _serving_rate(plain_app, x4096)
    # the int8 product at K and N off multiples of 8 (zero-padded for torch._int_mm),
    # bit for bit the CPU's exact product, in both dtypes
    from bridgerl_tpu_torch.ops import int8 as int8_ops
    M, K, N = INT8_ODD
    x = torch.randn(M, K, device="cuda", generator=torch.Generator(device="cuda").manual_seed(3))
    w = torch.randn(N, K, device="cuda", generator=torch.Generator(device="cuda").manual_seed(4))
    odd = {"shape": [M, K, N]}
    for dtype in DTYPES:
        got = int8_ops.int8_matmul(x.to(dtype), (0.1 * w).to(dtype))
        want = int8_ops.int8_matmul(x.to(dtype).cpu(), (0.1 * w).to(dtype).cpu())
        require(got.shape == (M, N) and torch.equal(got.cpu(), want),
                f"int8 {DTYPE_NAME[dtype]} at {INT8_ODD}: differs from the CPU's product")
        odd[f"{DTYPE_NAME[dtype]}_equal_cpu"] = True

    workdir = tempfile.mkdtemp(prefix="chip_smoke_int8_")
    try:
        g = torch.Generator(device="cuda").manual_seed(SEED + 17)
        ds = PairedDataset(torch.randn(TRAIN_WINDOWS, 10, 29, device="cuda", generator=g),
                           torch.randn(TRAIN_WINDOWS, 10, 126, device="cuda", generator=g))
        trainer = Trainer(_train_exp(workdir, int8_ff=True, compute_dtype="bfloat16",
                                     epochs=1), device="cuda", verbose=False)
        before = launches()
        hist = trainer.run(ds)[SEED]
        train_delta = {k: v - before[k] for k, v in launches().items()}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    want = _expected_train_launches(trainer, TRAIN_WINDOWS, 1)
    require(train_delta == want, f"int8: training launches {train_delta}, want {want}")
    require(all(math.isfinite(x) for k in ("train_loss", "val_loss") for x in hist[k]),
            f"int8: losses {hist}")
    line = {"phase": "int8", "card": smi, "dtype": "bfloat16",
            "launches": add_launches(*(l["launches"] for l in lines), rate_delta, train_delta),
            "int8_retarget_windows_per_s_b4096": int8_wps,
            "plain_retarget_windows_per_s_b4096": plain_wps,
            "int8_retarget_p50_ms_b1": int8_p50, "plain_retarget_p50_ms_b1": plain_p50,
            "odd_widths": odd,
            "teacher_windows_per_s": _timed_rate(trainer.train_seconds, 0)[0],
            "train_loss": hist["train_loss"], "val_loss": hist["val_loss"],
            "int8_path_s": time.perf_counter() - t0}
    emit(line)
    return line


def cli_multiseed(workdir: str, smi: str) -> dict:
    """In the CLI phase's work directory (its synthetic data at window 10):
    train_ablation --multiseed --seed 1 2 --lambda_fk 1 --int8_ff for
    CLI_MS_EPOCHS["teacher"] epochs, then the student from a {seed} teacher
    pattern, each a child on the card: each seed's checkpoints and logs,
    and the two seeds' final weights differ."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    teacher = "checkpoints/Exp_transformer_W10_hybrid_teacher_seed_{seed}_best.pth"
    total = {name: 0 for name in kernels.COUNTERS}
    stages = {}
    for mode in ("teacher", "student"):
        args = [TRAIN_CLI, *CLI_MS_RUN, "--epochs", str(CLI_MS_EPOCHS[mode]), "--mode", mode]
        args += ["--lambda_fk", "1"] if mode == "teacher" else ["--teacher_ckpt", teacher]
        stdout, counts, seconds = _run_child(args, workdir, env)
        require("Multi-seed: Exp_transformer_W10 x 2 seeds" in stdout,
                f"cli multiseed {mode}: {stdout[-2000:]}")
        finals = []
        for s in (1, 2):
            require(f"Success: Exp_transformer_W10 | Mode: {mode} | Seed: {s}" in stdout,
                    f"cli multiseed {mode}: {stdout[-2000:]}")
            name = f"Exp_transformer_W10_hybrid_{mode}_seed_{s}"
            for kind in ("best", "last", "final"):
                require(os.path.exists(os.path.join(workdir, "checkpoints",
                                                    f"{name}_{kind}.pth")),
                        f"cli multiseed {mode}: no {name}_{kind}.pth")
            with open(os.path.join(workdir, "results",
                                   f"log_Exp_transformer_W10_{mode}_seed_{s}.json")) as f:
                hist = json.load(f)
            require(sorted(hist) == sorted(HISTORY_KEYS)
                    and len(hist["train_loss"]) == CLI_MS_EPOCHS[mode]
                    and all(math.isfinite(v) for v in hist["train_loss"]),
                    f"cli multiseed {mode} seed {s}: {hist}")
            finals.append(load_checkpoint(os.path.join(workdir, "checkpoints",
                                                       f"{name}_final.pth"))["model_state_dict"])
        key = "human_encoder.input_proj.weight"
        require(not torch.equal(finals[0][key], finals[1][key]),
                f"cli multiseed {mode}: the seeds' final weights are equal")
        require(counts["vq_assign"] > 0 and counts[attention.ENTRY["fwd", torch.float32]] > 0,
                f"cli multiseed {mode}: a kernel never ran: {counts}")
        stages[mode] = {"launches": counts, "seconds": seconds}
        for k in total:
            total[k] += counts.get(k, 0)
    line = {"phase": "cli_multiseed", "card": smi, "args": list(CLI_MS_RUN), **stages,
            "launches": total}
    emit(line)
    return line


# ---------------------------------------------------------------- phases 16-19: the token prior

def _causal_case(g, dtype, direction: str, BH, S, Dh, rate) -> dict:
    """K1 (``direction`` fwd or bwd) under the prior's causal bias over whole
    rows (window = S, causal=True as the prior's stacks call it) against the
    plain version, with its bound for the lower triangle's work, and the
    plain version's and SDPA's ``is_causal=True`` times beside the
    kernel's."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v = (torch.randn(BH, S, Dh, device="cuda", generator=g).to(dtype) for _ in range(3))
    do = torch.randn(BH, S, Dh, device="cuda", generator=g).to(dtype)
    bias, scale, seed = causal_bias(S, "cuda"), Dh ** -0.5, attention.draw_seed(g, "cuda")
    pairs = S * (S + 1) // 2        # the (query, key) pairs the causal bias leaves
    if direction == "fwd":
        run = lambda: [attention.attention_fwd(q, k, v, bias, scale, seed, rate, causal=True)]
        plain = lambda: [attention.packed_attention_reference(q, k, v, bias, scale, seed, rate,
                                                              causal=True)]
        library = lambda: sdpa(q, k, v, is_causal=True, scale=scale, dropout_p=rate)
        b_ms, b_by = k1_bound(dtype, 4 * BH * S * Dh, 4 * BH * pairs * Dh, S)
    else:
        run = lambda: list(attention.attention_bwd(q, k, v, bias, do, scale, seed, rate,
                                                   causal=True))
        plain = lambda: list(attention.packed_attention_bwd_reference(q, k, v, bias, do, scale,
                                                                      seed, rate, causal=True))
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        o = sdpa(qg, kg, vg, is_causal=True, scale=scale, dropout_p=rate)
        library = lambda: torch.autograd.grad(o, (qg, kg, vg), do, retain_graph=True)
        b_ms, b_by = k1_bound(dtype, 7 * BH * S * Dh, 10 * BH * pairs * Dh, S)
    name = attention.ENTRY[direction, dtype]
    got, again = run(), run()
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(got, again)),
            f"{name} causal {BH, S, Dh} dropout {rate}: a second launch differs")
    case = {"shape": [BH, S, Dh], "dtype": DTYPE_NAME[dtype], "bias": "causal", "window": S,
            "dropout": rate, **_agreement(f"{name} causal {BH, S, Dh} dropout {rate}", got,
                                          plain(), dtype),
            "bound_ms": b_ms, "bound_by": b_by, "ms": time_ms(run),
            "ms_cold": time_ms(run, cold=True), "plain_ms": time_ms(plain, iters=10),
            "library_ms": time_ms(library), "library": "sdpa is_causal=True"}
    emit({"phase": "k1_causal", "name": name, **case})
    return case


def check_k1_causal(g: torch.Generator, table: list) -> dict:
    """K1 forward and backward under the causal bias at the prior's shapes
    (K1_CAUSAL), f32 and bf16, each case appended to its kernel's row of
    ``table``; then the keep mask of both kernels, both dtypes, at S = 128
    (the tensor-core path, causal=True): bit for bit the plain Philox mask
    on and below the diagonal, nothing kept above it."""
    rows = {r["name"]: r for r in table}
    for dtype in DTYPES:
        for direction in ("fwd", "bwd"):
            row = rows[attention.ENTRY[direction, dtype]]
            row["cases"] += [_causal_case(g, dtype, direction, *shape) for shape in K1_CAUSAL]
    BH, S, Dh = 128, 128, 128
    lower = torch.ones(S, S, device="cuda").tril().bool()
    out = {"phase": "k1_causal_mask", "shape": [BH, S, Dh], "dropout": DROPOUT}
    for dtype in DTYPES:
        q, k = (torch.randn(BH, S, Dh, device="cuda", generator=g).to(dtype) for _ in range(2))
        eye = torch.eye(S, Dh, device="cuda", dtype=dtype).expand(BH, S, Dh).contiguous()
        bias, seed = causal_bias(S, "cuda"), attention.draw_seed(g, "cuda")
        fwd = attention.attention_fwd(q, k, eye, bias, Dh ** -0.5, seed, DROPOUT,
                                      causal=True)[:, :, :S] > 0
        dv = attention.attention_bwd(q, k, eye, bias, eye, Dh ** -0.5, seed, DROPOUT,
                                     causal=True)[2]
        bwd = dv[:, :S, :S].transpose(1, 2) > 0
        want = attention.attention_dropout_mask(seed, BH, S, DROPOUT, "cuda") & lower
        for what, got in (("fwd", fwd), ("bwd", bwd)):
            require(torch.equal(got, want), f"K1 {what} {DTYPE_NAME[dtype]} causal keep mask "
                    f"differs in {int((got != want).sum())}")
        out[f"{DTYPE_NAME[dtype]}_kept_share"] = fwd.sum().item() / (int(lower.sum()) * BH)
    out["mask_equal"] = True
    emit(out)
    return out


def _head_dim_bias(S: int, W: int, causal: bool) -> torch.Tensor:
    return causal_bias(S, "cuda") if causal else attention_bias(S // W, W, "cuda")


def _head_dim_case(g, dtype, direction: str, BH, S, W, Dh, causal, what: str) -> dict:
    """K1 (``direction`` fwd or bwd) at a head dim off the instantiated
    widths (the kernels' ragged form), at 96, or past 128 (wide), dropout
    0.1, against the plain
    version at the true Dh under the rules of phase 2, two launches bit for
    bit; its bound counts the true Dh's work (windows, or the lower
    triangle), at the units of the path it takes; SDPA the library form."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v, do = (torch.randn(BH, S, Dh, device="cuda", generator=g).to(dtype)
                   for _ in range(4))
    bias, scale = _head_dim_bias(S, W, causal), Dh ** -0.5
    seed, rate = attention.draw_seed(g, "cuda"), DROPOUT
    plan = attention.k1_plan(BH, S, W, Dh, dtype, direction, causal)
    pairs = BH * (S * (S + 1) // 2 if causal else S * W)   # the (query, key) pairs computed
    lib = ((lambda q, k, v: [lambda: sdpa(q, k, v, is_causal=True, scale=scale,
                                          dropout_p=rate)]) if causal
           else (lambda q, k, v: list(_sdpa_forms(q, k, v, bias, scale, rate, W))))
    if direction == "fwd":
        run = lambda: [attention.attention_fwd(q, k, v, bias, scale, seed, rate, W, causal)]
        plain = lambda: [attention.packed_attention_reference(q, k, v, bias, scale, seed, rate,
                                                              W, causal)]
        library = lib(q, k, v)
        b_ms, b_by = k1_bound(dtype, 4 * BH * S * Dh, 4 * pairs * Dh, W, plan.path != "tiles")
    else:
        run = lambda: list(attention.attention_bwd(q, k, v, bias, do, scale, seed, rate, W,
                                                   causal))
        plain = lambda: list(attention.packed_attention_bwd_reference(q, k, v, bias, do, scale,
                                                                      seed, rate, W, causal))
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        outs = [f() for f in lib(qg, kg, vg)]
        library = [lambda o=o: torch.autograd.grad(o, (qg, kg, vg), do.view(o.shape),
                                                   retain_graph=True) for o in outs]
        b_ms, b_by = k1_bound(dtype, 7 * BH * S * Dh, 10 * pairs * Dh, W, plan.path != "tiles")
    name = attention.ENTRY[direction, dtype]
    got, again = run(), run()
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(got, again)),
            f"{name} Dh {Dh} {BH, S, W}: a second launch differs")
    lib_ms = [time_ms(f) for f in library]
    case = {"shape": [BH, S, Dh], "dtype": DTYPE_NAME[dtype], "window": W,
            "bias": "causal" if causal else "window", "dropout": rate, "what": what,
            "head_width": plan.width, "copy_bytes": plan.copy_bytes, "ragged": plan.ragged,
            "groups": plan.groups,
            "windows_per_block": plan.windows_per_block,
            "kernel_path": k1_case_kernel(name, {"shape": [BH, S, Dh], "window": W,
                                                 "bias": "causal" if causal else "window"}),
            "repeat_equal": True,
            **_agreement(f"{name} Dh {Dh} {BH, S, W}", got, plain(), dtype),
            "bound_ms": b_ms, "bound_by": b_by, "ms": time_ms(run),
            "ms_cold": time_ms(run, cold=True), "plain_ms": time_ms(plain, iters=10),
            "library_ms": min(lib_ms), "library": "sdpa is_causal=True" if causal
            else "sdpa full rows / windows", "library_forms_ms": lib_ms}
    emit({"phase": "k1_head_dims", "name": name, **case})
    return case


def check_k1_head_dims(g: torch.Generator, table: list) -> dict:
    """K1 forward and backward at K1_HEAD_DIMS, f32 and bf16, each case
    appended to its kernel's row of ``table``; then both kernels' keep bits
    at K1_HEAD_DIM_MASKS, both dtypes, equal to the plain Philox mask inside
    the windows (on and below the diagonal), nothing kept elsewhere."""
    rows = {r["name"]: r for r in table}
    for dtype in DTYPES:
        for direction in ("fwd", "bwd"):
            row = rows[attention.ENTRY[direction, dtype]]
            row["cases"] += [_head_dim_case(g, dtype, direction, *shape)
                             for shape in K1_HEAD_DIMS]
    out = {"phase": "k1_head_dim_masks", "dropout": DROPOUT, "shapes": K1_HEAD_DIM_MASKS}
    for BH, S, W, Dh, causal in K1_HEAD_DIM_MASKS:
        bias = _head_dim_bias(S, W, causal)
        allowed = (torch.ones(S, S, device="cuda").tril().bool() if causal else bias == 0)
        for dtype in DTYPES:
            q, k = (torch.randn(BH, S, Dh, device="cuda", generator=g).to(dtype)
                    for _ in range(2))
            eye = torch.eye(S, Dh, device="cuda", dtype=dtype).expand(BH, S, Dh).contiguous()
            seed = attention.draw_seed(g, "cuda")
            fwd = attention.attention_fwd(q, k, eye, bias, Dh ** -0.5, seed, DROPOUT, W,
                                          causal)[:, :, :S] > 0
            dv = attention.attention_bwd(q, k, eye, bias, eye, Dh ** -0.5, seed, DROPOUT, W,
                                         causal)[2]
            bwd = dv[:, :S, :S].transpose(1, 2) > 0
            want = attention.attention_dropout_mask(seed, BH, S, DROPOUT, "cuda") & allowed
            for what, got in (("fwd", fwd), ("bwd", bwd)):
                require(torch.equal(got, want), f"K1 {what} {DTYPE_NAME[dtype]} Dh {Dh} keep "
                        f"mask differs in {int((got != want).sum())}")
    out["mask_equal"] = True
    emit(out)
    return out


def _prior_takes(n: int = PRIOR_TAKES, frames: int = PRIOR_FRAMES, seed: int = SEED + 11) -> list:
    """n synthetic robot takes of ``frames`` frames (data/synthetic.py): PRIOR_TAKES
    of PRIOR_FRAMES, so PRIOR_POSITIONS windows each at W 10, stride 5."""
    rng = np.random.default_rng(seed)
    return [synth_pair(rng, frames)[0] for _ in range(n)]


def rvq_flip_counts(q, z: torch.Tensor, got: np.ndarray, want: np.ndarray) -> dict:
    """Tokens whose hybrid codes differ between ``got`` (the card's) and
    ``want`` (the CPU's), rows of (FSQ code, each RVQ stage's code), with
    ``z`` (N, D) their CPU latents before quantization: an FSQ flip (a
    rounding boundary, not K2), or at the first RVQ stage where they differ
    a near tie under K2's rule (the two codes' plain distances to the CPU's
    residual within K2_TIE * (1 + |d|)) or not."""
    out = {"fsq_flips": 0, "rvq_near_ties": 0, "rvq_not_ties": 0}
    if not len(got):
        return out
    with torch.no_grad():
        _, z_fsq, _, _ = q.fsq(z)
        residual = (z - z_fsq).float()
    open_rows = got[:, 0] == want[:, 0]
    out["fsq_flips"] = int((~open_rows).sum())
    for i, layer in enumerate(q.vq.layers):
        cb = layer.embedding.weight.float()
        d = (residual ** 2).sum(-1, keepdim=True) - 2 * residual @ cb.T + (cb ** 2).sum(-1)
        gi, wi = torch.from_numpy(got[:, 1 + i]).long(), torch.from_numpy(want[:, 1 + i]).long()
        flip = open_rows & (got[:, 1 + i] != want[:, 1 + i])
        dg, dw = d.gather(1, gi[:, None])[:, 0], d.gather(1, wi[:, None])[:, 0]
        tie = ((dg - dw).abs() <= K2_TIE * (1 + dw.abs())).numpy()
        out["rvq_near_ties"] += int((flip & tie).sum())
        out["rvq_not_ties"] += int((flip & ~tie).sum())
        open_rows = open_rows & ~flip
        residual = residual - cb[wi]
    return out


def require_near_ties(name: str, flips: dict, tokens: int) -> None:
    """Every RVQ flip a near tie; FSQ flips no more than CODES_AGREE leaves,
    and one."""
    require(flips["rvq_not_ties"] == 0, f"{name}: RVQ codes differ outside near ties {flips}")
    require(flips["fsq_flips"] <= (1 - CODES_AGREE) * tokens + 1,
            f"{name}: FSQ codes differ on too many tokens {flips}")


def _code_flips(model, exp, takes: list, got: np.ndarray, want: np.ndarray,
                mask: np.ndarray) -> dict:
    """Positions whose codes differ between ``got`` (the card's grids) and
    ``want`` (the CPU's) over ``takes``, each held to :func:`rvq_flip_counts`'s
    rule by :func:`require_near_ties`."""
    differ = (got != want).any(-1) & (mask > 0)
    rows = np.argwhere(differ)
    out = {"positions": int(mask.sum()), "positions_differ": len(rows)}
    x = np.stack([takes[i][t * PRIOR_STRIDE:t * PRIOR_STRIDE + exp.model.window_size]
                  for i, t in rows]) if len(rows) else None
    with torch.no_grad():
        z = model.encode_robot(torch.from_numpy(x))[:, 0] if len(rows) else None
    out.update(rvq_flip_counts(model.quantizer, z, got[tuple(rows.T)], want[tuple(rows.T)]))
    require_near_ties("prior grids", out, out["positions"])
    return out


def trained_f32_rule(name: str, q, z: torch.Tensor, got: dict, want: dict,
                     got_values=None, want_values=None) -> dict:
    """The float32 serving rule on weights trained on the card, whose
    windows may sit on a code boundary: ``got`` and ``want`` are the card's
    and the CPU's hybrid code streams of each window ({stream: (B, T)}),
    ``z`` (B, T, D) the CPU's latents. Each token whose codes differ must be
    an RVQ near tie or one of the few FSQ flips :func:`require_near_ties`
    allows; the values (B, ...) are held within SERVE_ATOL of the CPU's on
    the windows whose codes the two share."""
    streams = ["fsq"] + [f"rvq/vq_{i}" for i in range(len(q.vq.layers))]

    def stream(codes, name):   # a model's streams carry its quantizer's path
        key = [k for k in codes if k == name or k.endswith("/" + name)]
        require(len(key) == 1, f"{name}: no one code stream {name} in {sorted(codes)}")
        return np.asarray(codes[key[0]]).reshape(len(codes[key[0]]), -1)

    g, w = (np.stack([stream(c, k) for k in streams], -1) for c in (got, want))
    require(g.shape == w.shape and g.dtype == w.dtype == np.int32,
            f"{name}: codes {g.shape} {g.dtype}, want {w.shape} {w.dtype}")
    differ = (g != w).any(-1)   # (B, T)
    flips = {"tokens": int(differ.size), "tokens_differ": int(differ.sum()),
             **rvq_flip_counts(q, z[torch.from_numpy(differ)], g[differ], w[differ])}
    require_near_ties(name, flips, flips["tokens"])
    out = {"codes_agree": 1.0 - flips["tokens_differ"] / flips["tokens"], "code_flips": flips}
    if got_values is None:
        return out
    require(got_values.shape == want_values.shape and got_values.dtype == np.float32,
            f"{name}: {got_values.shape} {got_values.dtype}, want {want_values.shape}")
    require(bool(np.isfinite(got_values).all()), f"{name}: non-finite values")
    rows = ~differ.any(1)
    err = float(np.abs(got_values[rows] - want_values[rows]).max()) if rows.any() else 0.0
    require(err <= SERVE_ATOL, f"{name}: max abs error vs CPU {err} > {SERVE_ATOL} on the "
            f"{int(rows.sum())} windows whose codes agree")
    return {**out, "max_abs_err_vs_cpu": err, "rows_compared": int(rows.sum()),
            "rows": len(rows), "max_abs_err_all_rows": float(np.abs(got_values - want_values).max())}


def _prior_config(pcfg, **over):
    """scripts/train_prior.py's full width over the extracted code space."""
    return dataclasses.replace(pcfg, d_model=256, n_heads=4, n_layers=4, ff_dim=512,
                               dropout=0.1, **over)


def _prior_tcfg(epochs: int, dtype) -> PriorTrainConfig:
    return PriorTrainConfig(epochs=epochs, batch_size=32, lr=3e-4, weight_decay=0.01,
                            patience=-1, seed=SEED, compute_dtype=DTYPE_NAME[dtype])


def _prior_train(grids, mask, seq_ids, pcfg, dtype, epochs: int) -> tuple:
    """train_prior on the card after a one-epoch warm-up call: (the prior,
    history, seconds of the timed call, train positions an epoch)."""
    tcfg = _prior_tcfg(epochs, dtype)
    train_prior(grids, mask, pcfg, _prior_tcfg(1, dtype), verbose=False, seq_ids=seq_ids)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prior, hist = train_prior(grids, mask, pcfg, tcfg, verbose=False, seq_ids=seq_ids)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    train_idx, _ = split_indices(len(grids), tcfg, seq_ids)
    order = epoch_order(train_idx, tcfg, 0)
    return prior, hist, seconds, float(mask[order.reshape(-1)].sum())


def _prior_step(pcfg, dtype, dev: str, g: np.ndarray, m: np.ndarray) -> tuple:
    """(loss, gradients) of one prior step at dropout 0 from seed 0's weights."""
    prior = init_prior(dataclasses.replace(pcfg, dropout=0.0), SEED, DTYPE_NAME[dtype],
                       device=dev)
    gt, mt = torch.from_numpy(g).long().to(dev), torch.from_numpy(m).to(dev)
    loss = prior_loss(prior(gt, train=True), gt, mt)
    loss.backward()
    return float(loss.detach()), {n: p.grad.detach().cpu() for n, p in prior.named_parameters()
                         if p.grad is not None}


def prior_path(smi: str) -> tuple:
    """The token prior on the flagship's codes: PRIOR_TAKES synthetic takes
    through the flagship (seed 0) give code grids on the card, held to the
    CPU's on PRIOR_CPU_TAKES takes (_code_flips); the full-width prior
    trains in f32 and bf16 for PRIOR_EPOCHS timed epochs (windows/s and
    tokens/s, per-epoch losses), a slot-AR prior (2 depth layers) for one;
    one step at dropout 0 on the card against the CPU under train_agree's
    float32 rule and train_agree_bf16's bf16 rule. Returns the line and
    (the f32 prior, the flagship, its experiment, grids, mask) for the
    generation phases."""
    t_phase = time.perf_counter()
    exp = make_experiment("transformer", "hybrid", window=10, attn_packing=8)
    takes = _prior_takes()
    vq = init_model(exp.model, SEED)
    own = []
    before = launches()
    t0 = time.perf_counter()
    grids, mask, pcfg, seq_ids = extract_code_grids(vq, exp, takes, ZERO29, ONE29, PRIOR_STRIDE,
                                                    max_len=PRIOR_POSITIONS)
    extract_s = time.perf_counter() - t0
    own.append(_delta(before))
    require(grids.shape == (PRIOR_TAKES, PRIOR_POSITIONS, 5) and mask.all(),
            f"prior grids {grids.shape}, {mask.sum()} positions")
    n = PRIOR_CPU_TAKES
    cpu_vq = init_model(exp.model, SEED, device="cpu")
    cpu = extract_code_grids(cpu_vq, exp, takes[:n], ZERO29, ONE29, PRIOR_STRIDE,
                             max_len=PRIOR_POSITIONS)
    flips = _code_flips(cpu_vq, exp, takes[:n], grids[:n], cpu[0], cpu[1])
    line = {"phase": "prior", "card": smi, "takes": PRIOR_TAKES, "grids": list(grids.shape),
            "extract_windows": int(mask.sum()), "extract_s": extract_s,
            "extract_windows_per_s": float(mask.sum()) / extract_s,
            "cpu_checked_takes": n, "codes_vs_cpu": flips}
    prior32 = None
    for dtype in DTYPES:
        full = _prior_config(pcfg)
        before = launches()
        prior, hist, seconds, positions = _prior_train(grids, mask, seq_ids, full, dtype,
                                                       PRIOR_EPOCHS)
        own.append(_delta(before))
        require(all(np.isfinite(hist["train_loss"] + hist["val_loss"])),
                f"prior {DTYPE_NAME[dtype]} losses {hist}")
        rate = PRIOR_EPOCHS * positions / seconds
        line[DTYPE_NAME[dtype]] = {
            "epochs": PRIOR_EPOCHS, "train_s": seconds, "windows_per_s": rate,
            "tokens_per_s": rate * len(pcfg.vocab_sizes), "history": hist}
        if dtype == torch.float32:
            prior32 = prior
    before = launches()
    _, hist, seconds, positions = _prior_train(
        grids, mask, seq_ids, _prior_config(pcfg, slot_ar=True, depth_layers=2),
        torch.float32, 1)
    own.append(_delta(before))
    require(all(np.isfinite(hist["train_loss"])), f"slot-AR prior losses {hist}")
    line["slot_ar"] = {"epochs": 1, "depth_layers": 2, "train_s": seconds,
                       "windows_per_s": positions / seconds, "history": hist}
    g, m = grids[:32], mask[:32]
    full = _prior_config(pcfg)
    cpu32 = _prior_step(full, torch.float32, "cpu", g, m)
    line["step_agree"] = _agree_rule("prior step_agree",
                                     _prior_step(full, torch.float32, "cuda", g, m), cpu32)
    line["step_agree_bf16"] = _bf16_step_rule(
        "prior step_agree_bf16", cpu32, _prior_step(full, BF16, "cuda", g, m),
        _prior_step(full, BF16, "cpu", g, m))
    line["launches"] = add_launches(*own)
    line["prior_path_s"] = time.perf_counter() - t_phase
    emit(line)
    return line, (prior32, vq, exp, grids, mask)


def prior_long_path(smi: str, vq, exp) -> dict:
    """The prior at PRIOR_LONG_POSITIONS positions on the flagship's codes
    (``vq``, seed 0): PRIOR_LONG_TAKES synthetic takes give (128, 256, 5)
    grids on the card (K1, K2), held to the CPU's on PRIOR_LONG_CPU_TAKES
    takes under the prior phase's rule; the full-width prior trains
    PRIOR_LONG_EPOCHS timed epochs in f32 and bf16 (windows/s, tokens/s),
    its backward on K1's two-kernel path; one step at dropout 0 is held to
    the CPU under the prior phase's ``step_agree`` and ``step_agree_bf16``
    rules. The launches of its own calls, K1's by kernel."""
    t_phase = time.perf_counter()
    takes = _prior_takes(PRIOR_LONG_TAKES, PRIOR_LONG_FRAMES, SEED + 12)
    own = []
    before = launches()
    t0 = time.perf_counter()
    grids, mask, pcfg, seq_ids = extract_code_grids(vq, exp, takes, ZERO29, ONE29, PRIOR_STRIDE,
                                                    max_len=PRIOR_LONG_POSITIONS)
    extract_s = time.perf_counter() - t0
    own.append(_delta(before))
    require(grids.shape == (PRIOR_LONG_TAKES, PRIOR_LONG_POSITIONS, 5) and mask.all(),
            f"prior_long grids {grids.shape}, {mask.sum()} positions")
    n = PRIOR_LONG_CPU_TAKES
    cpu_vq = init_model(exp.model, SEED, device="cpu")
    cpu = extract_code_grids(cpu_vq, exp, takes[:n], ZERO29, ONE29, PRIOR_STRIDE,
                             max_len=PRIOR_LONG_POSITIONS)
    line = {"phase": "prior_long", "card": smi, "takes": PRIOR_LONG_TAKES,
            "grids": list(grids.shape), "extract_windows": int(mask.sum()),
            "extract_s": extract_s, "extract_windows_per_s": float(mask.sum()) / extract_s,
            "cpu_checked_takes": n,
            "codes_vs_cpu": _code_flips(cpu_vq, exp, takes[:n], grids[:n], cpu[0], cpu[1])}
    full = _prior_config(pcfg)
    require(full.max_len == PRIOR_LONG_POSITIONS, f"prior_long max_len {full.max_len}")
    for dtype in DTYPES:
        before = launches()
        _, hist, seconds, positions = _prior_train(grids, mask, seq_ids, full, dtype,
                                                   PRIOR_LONG_EPOCHS)
        delta = _delta(before)
        own.append(delta)
        require(all(np.isfinite(hist["train_loss"] + hist["val_loss"])),
                f"prior_long {DTYPE_NAME[dtype]} losses {hist}")
        long = attention.LONG_COUNTER["bwd", dtype]
        require(delta[long.name] > 0 and delta[long.name] == delta[attention.ENTRY["bwd", dtype]],
                f"prior_long {DTYPE_NAME[dtype]}: every K1 backward must take the two-kernel "
                f"path: {delta}")
        rate = PRIOR_LONG_EPOCHS * positions / seconds
        line[DTYPE_NAME[dtype]] = {
            "epochs": PRIOR_LONG_EPOCHS, "train_s": seconds, "windows_per_s": rate,
            "tokens_per_s": rate * len(pcfg.vocab_sizes), "history": hist}
    g, m = grids[:32], mask[:32]
    cpu32 = _prior_step(full, torch.float32, "cpu", g, m)
    line["step_agree"] = _agree_rule("prior_long step_agree",
                                     _prior_step(full, torch.float32, "cuda", g, m), cpu32)
    line["step_agree_bf16"] = _bf16_step_rule(
        "prior_long step_agree_bf16", cpu32, _prior_step(full, BF16, "cuda", g, m),
        _prior_step(full, BF16, "cpu", g, m))
    line["launches"] = add_launches(*own)
    line["prior_long_path_s"] = time.perf_counter() - t_phase
    emit(line)
    return line


def _greedy_rule(cpu_prior, grid: torch.Tensor) -> dict:
    """Greedy tokens (``grid`` (B, N, S), the card's ``sample_grids`` at
    top_k 1) against the CPU: each the argmax of the CPU's teacher-forced
    logits on the card's prefix, but where the CPU's two best logits lie
    within GEN_TIE."""
    with torch.no_grad():
        logits = cpu_prior(grid.long())
    ties = mismatches = 0
    for s_, lg in enumerate(logits):
        top2 = lg.topk(2, dim=-1).values
        tie = (top2[..., 0] - top2[..., 1]) <= GEN_TIE
        ties += int(tie.sum())
        mismatches += int(((lg.argmax(-1) != grid[..., s_].long()) & ~tie).sum())
    require(mismatches == 0, f"greedy sampling: {mismatches} tokens differ from the CPU's")
    return {"tokens": grid.numel(), "near_ties": ties, "mismatches": 0}


def prior_wide_path(smi: str, vq, exp) -> dict:
    """The prior-capacity arm d384L6 (PRIOR_WIDE: 4 heads of Dh 96, K1 at
    that head dim natively) on the flagship's codes (``vq``, seed 0): as
    :func:`_prior_arm`, each epoch launching both K1 entry points of its
    dtype."""
    return _prior_arm(smi, vq, exp, "prior_wide", PRIOR_WIDE, SEED + 13, head_dim=96)


def prior_dh256_path(smi: str, vq, exp) -> dict:
    """The capacity sweep's d512 2-head arm (PRIOR_DH256: Dh 256) on the
    flagship's codes: as :func:`_prior_arm`, every K1 launch of its training
    on the wide kernels, forward and backward, in both dtypes."""
    return _prior_arm(smi, vq, exp, "prior_dh256", PRIOR_DH256, SEED + 14, head_dim=256)


def prior_dh48_path(smi: str, vq, exp) -> dict:
    """The capacity sweep's d192 arm (PRIOR_DH48: 4 heads of Dh 48) on the
    flagship's codes: as :func:`_prior_arm`, every K1 launch of its training
    staged at 64 in the kernels' ragged form (window tiles in float32,
    multi-window kernels in bf16, and tensor cores), forward and backward,
    in both dtypes."""
    return _prior_arm(smi, vq, exp, "prior_dh48", PRIOR_DH48, SEED + 15, head_dim=48)


def _prior_arm(smi: str, vq, exp, phase: str, config: dict, take_seed: int,
               head_dim: int) -> dict:
    """A prior-capacity arm (``config`` over the extracted code space) on
    the flagship's codes (``vq``, seed 0): PRIOR_WIDE_TAKES synthetic takes
    of PRIOR_WIDE_FRAMES frames (seeded ``take_seed``) give (256, 96, 5)
    grids on the card (K1, K2), held to the CPU's on PRIOR_WIDE_CPU_TAKES
    takes under the prior phase's rule; the prior trains PRIOR_WIDE_EPOCHS
    timed epochs in f32 and bf16 (windows/s, tokens/s), each launching K1's
    forward and backward at the arm's ``head_dim`` (past 128 every launch the
    wide kernels');
    one step at dropout 0 is held to the CPU under ``step_agree`` and
    ``step_agree_bf16``; one greedy ``sample_grids`` call on the f32 prior
    (PRIOR_WIDE_SAMPLES x PRIOR_WIDE_SAMPLED positions) under
    :func:`_greedy_rule`. The launches of its own calls."""
    t_phase = time.perf_counter()
    takes = _prior_takes(PRIOR_WIDE_TAKES, PRIOR_WIDE_FRAMES, take_seed)
    own = []
    before = launches()
    t0 = time.perf_counter()
    grids, mask, pcfg, seq_ids = extract_code_grids(vq, exp, takes, ZERO29, ONE29, PRIOR_STRIDE,
                                                    max_len=PRIOR_WIDE_POSITIONS)
    extract_s = time.perf_counter() - t0
    own.append(_delta(before))
    require(grids.shape == (PRIOR_WIDE_TAKES, PRIOR_WIDE_POSITIONS, 5) and mask.all(),
            f"{phase} grids {grids.shape}, {mask.sum()} positions")
    n = PRIOR_WIDE_CPU_TAKES
    cpu_vq = init_model(exp.model, SEED, device="cpu")
    cpu = extract_code_grids(cpu_vq, exp, takes[:n], ZERO29, ONE29, PRIOR_STRIDE,
                             max_len=PRIOR_WIDE_POSITIONS)
    full = dataclasses.replace(pcfg, **config)
    wide = head_dim > attention.SUPPORTED_HEAD_DIMS[-1]
    require(full.d_model // full.n_heads == head_dim and full.max_len == PRIOR_WIDE_POSITIONS,
            f"{phase} config {full}")
    line = {"phase": phase, "card": smi, "config": config, "head_dim": head_dim,
            "takes": PRIOR_WIDE_TAKES, "grids": list(grids.shape),
            "extract_windows": int(mask.sum()), "extract_s": extract_s,
            "extract_windows_per_s": float(mask.sum()) / extract_s, "cpu_checked_takes": n,
            "codes_vs_cpu": _code_flips(cpu_vq, exp, takes[:n], grids[:n], cpu[0], cpu[1])}
    prior32 = None
    for dtype in DTYPES:
        before = launches()
        prior, hist, seconds, positions = _prior_train(grids, mask, seq_ids, full, dtype,
                                                       PRIOR_WIDE_EPOCHS)
        delta = _delta(before)
        own.append(delta)
        require(all(np.isfinite(hist["train_loss"] + hist["val_loss"])),
                f"{phase} {DTYPE_NAME[dtype]} losses {hist}")
        for d in ("fwd", "bwd"):
            name = attention.ENTRY[d, dtype]
            wide_name = attention.WIDE_ENTRY[d, dtype]
            require(delta[name] > 0 and (not wide or delta[wide_name] == delta[name]),
                    f"{phase} {DTYPE_NAME[dtype]}: K1 {d} must launch"
                    f"{', every launch on the wide kernels' if wide else ''}: {delta}")
        rate = PRIOR_WIDE_EPOCHS * positions / seconds
        line[DTYPE_NAME[dtype]] = {
            "epochs": PRIOR_WIDE_EPOCHS, "train_s": seconds, "windows_per_s": rate,
            "tokens_per_s": rate * len(pcfg.vocab_sizes), "history": hist}
        if dtype == torch.float32:
            prior32 = prior
    g, m = grids[:32], mask[:32]
    cpu32 = _prior_step(full, torch.float32, "cpu", g, m)
    line["step_agree"] = _agree_rule(f"{phase} step_agree",
                                     _prior_step(full, torch.float32, "cuda", g, m), cpu32)
    line["step_agree_bf16"] = _bf16_step_rule(
        f"{phase} step_agree_bf16", cpu32, _prior_step(full, BF16, "cuda", g, m),
        _prior_step(full, BF16, "cpu", g, m))
    before = launches()
    with torch.inference_mode():
        sampled = sample_grids(prior32.eval(), GEN_SEED, PRIOR_WIDE_SAMPLES, PRIOR_WIDE_SAMPLED,
                               top_k=1)
    torch.cuda.synchronize()
    own.append(_delta(before))
    line["greedy"] = {"samples": PRIOR_WIDE_SAMPLES, "positions": PRIOR_WIDE_SAMPLED,
                      **_greedy_rule(copy.deepcopy(prior32).cpu(), sampled.cpu())}
    line["launches"] = add_launches(*own)
    require(line["launches"][vq_kernel.launch_counter.name] > 0,
            f"{phase}: K2 was not launched: {line['launches']}")
    line[f"{phase}_path_s"] = time.perf_counter() - t_phase
    emit(line)
    return line


def _replay_draws(cpu_prior, grid: torch.Tensor, seed: int, rows: int, pick, t0: int,
                  **kw) -> dict:
    """The CPU's draws from the card's prefix: teacher-forced logits on the
    card's ``grid`` (B, N, S), filtered, plus the same Philox-Gumbel noise
    (rows of ``rows`` a position; ``pick`` (B, N) the row each sample's kept
    token came from) -> argmax. Every token from position ``t0`` on must be
    the card's unless the CPU's two best perturbed scores lie within GEN_TIE."""
    B, N, S = grid.shape
    noise = position_noise(cpu_prior, torch.tensor(seed), N, rows)       # (N, S, rows, V)
    with torch.no_grad():
        logits = cpu_prior(grid.long())
    ties = mismatches = 0
    for s, lg in enumerate(logits):
        nz = noise[torch.arange(N)[None, :], s, pick][..., :lg.shape[-1]]  # (B, N, V)
        scores = filter_logits(lg, **kw) + nz
        top2 = scores.topk(2, dim=-1).values
        tie = (top2[..., 0] - top2[..., 1]) <= GEN_TIE
        bad = (scores.argmax(-1) != grid[..., s].long()) & ~tie
        ties += int(tie[:, t0:].sum())
        mismatches += int(bad[:, t0:].sum())
    require(mismatches == 0, f"generate: {mismatches} tokens differ from the CPU's draw")
    return {"tokens": B * (N - t0) * S, "near_ties": ties, "mismatches": 0}


def _gen_rate(fn, frames: int) -> float:
    """frames/s of ``fn`` (one call makes GEN_SAMPLES motions of ``frames``),
    as scripts/bench_generation.py counts it: median of 3 calls after one."""
    times = []
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            fn(100 + i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return GEN_SAMPLES * frames / statistics.median(times[1:])


def generate_path(smi: str, prior, vq, exp, grids) -> dict:
    """GEN_SAMPLES motions of GEN_POSITIONS positions from the f32 prior on
    the card, unguided, guided (GEN_CANDIDATES candidates, guide_dyn
    GEN_DYN) and prompted (the first take's first GEN_PROMPT positions):
    every token the CPU's draw from the card's prefix (_replay_draws); the
    guided choices the CPU's argmin of the overlap score over its own
    candidates, where no candidate's draw and no score is a near tie; the
    decoded motions within GEN_ATOL of the CPU's decode of the card's grids.
    frames/s of make_generation_fn, unguided and guided."""
    t_phase = time.perf_counter()
    pcfg = prior.cfg
    cpu_prior, cpu_vq = copy.deepcopy(prior).cpu(), init_model(exp.model, SEED, device="cpu")
    B, N, C = GEN_SAMPLES, GEN_POSITIONS, GEN_CANDIDATES
    frames = pcfg.stride * (N - 1) + pcfg.window
    line = {"phase": "generate", "card": smi, "samples": B, "positions": N,
            "frames_per_motion": frames}
    own = []
    decode = make_decode_window_fn(vq, exp, pcfg, ZERO29, ONE29)
    cpu_decode = make_decode_window_fn(cpu_vq, exp, pcfg, ZERO29, ONE29)
    prompt = grids[0, :GEN_PROMPT]
    runs = {"unguided": {}, "prompted": {"prompt": prompt},
            "guided": {"guide": True}}
    for name, kw in runs.items():
        seed = GEN_SEED
        before = launches()
        with torch.inference_mode():
            if kw.get("guide"):
                grid, choices = sample_grids_guided(prior, seed, B, N, decode, candidates=C,
                                                    dyn_weight=GEN_DYN, return_choices=True)
            else:
                grid = sample_grids(prior, seed, B, N, prompt=kw.get("prompt"))
            wins = decode_grid(vq, exp, pcfg, grid, *_stats29(vq))
        torch.cuda.synchronize()
        own.append(_delta(before))
        grid = grid.cpu()
        t0 = GEN_PROMPT if name == "prompted" else 0
        res = {}
        if kw.get("guide"):
            pick = torch.arange(B)[:, None] * C + choices.cpu()
            res["draws"] = _replay_draws(cpu_prior, grid, seed, B * C, pick, t0)
            res["choices"] = _replay_choices(cpu_prior, cpu_decode, grid, choices.cpu(), seed)
        else:
            pick = torch.arange(B)[:, None].expand(B, N)
            res["draws"] = _replay_draws(cpu_prior, grid, seed, B, pick, t0)
        if name == "prompted":
            require(torch.equal(grid[:, :GEN_PROMPT].long(),
                                torch.from_numpy(prompt).long().expand(B, -1, -1)),
                    "generate: the prompt was not kept")
        with torch.no_grad():
            want = decode_grid(cpu_vq, exp, pcfg, grid, *_stats29(cpu_vq))
        err = float((wins.cpu() - want).abs().max())
        require(bool(torch.isfinite(wins).all()) and err <= GEN_ATOL,
                f"generate {name}: decoded windows {err} from the CPU's")
        res["decode_max_abs_err_vs_cpu"] = err
        line[name] = res
    for name, guide in (("unguided", 0), ("guided", C)):
        fn = make_generation_fn(vq, exp, prior, ZERO29, ONE29, n_positions=N, n_samples=B,
                                guide_candidates=guide, guide_dyn=GEN_DYN if guide else 0.0)
        before = launches()
        line[name]["frames_per_s"] = _gen_rate(fn, frames)
        own.append(_delta(before))
    line["launches"] = add_launches(*own)
    line["generate_path_s"] = time.perf_counter() - t_phase
    emit(line)
    return line


def _stats29(model) -> tuple:
    """Identity stats (raw motion) on ``model``'s device."""
    dev = next(model.parameters()).device
    return torch.zeros(29, device=dev), torch.ones(29, device=dev)


def _replay_choices(cpu_prior, cpu_decode, grid: torch.Tensor, choices: torch.Tensor,
                    seed: int) -> dict:
    """The guided choices against the CPU's: from the card's prefix, the CPU
    draws every candidate (the same noise rows), decodes them and takes the
    argmin of the overlap score against the decode of the card's previous
    position. A position whose CPU candidate draws hold a near tie, or whose
    two best scores lie within GEN_TIE relative, is not compared."""
    B, N, S = grid.shape
    C, pcfg = GEN_CANDIDATES, cpu_prior.cfg
    ov, stride = pcfg.window - pcfg.stride, pcfg.stride
    noise = position_noise(cpu_prior, torch.tensor(seed), N, B * C)
    compared = skipped = 0
    with torch.no_grad():
        ctx = cpu_prior(grid.long(), mode="context")
        heads = cpu_prior(mode="position_logits", ctx=ctx.reshape(B * N, -1))
        prev = cpu_decode(grid[:, 0].long())
        for t in range(1, N):
            tie = torch.zeros(B, dtype=torch.bool)
            cand = torch.zeros(B * C, S, dtype=torch.int64)
            for s, lg in enumerate(heads):
                lg = lg.reshape(B, N, -1)[:, t].repeat_interleave(C, dim=0)
                scores = lg + noise[t, s][:, :lg.shape[-1]]
                top2 = scores.topk(2, dim=-1).values
                tie |= ((top2[:, 0] - top2[:, 1]) <= GEN_TIE).reshape(B, C).any(1)
                cand[:, s] = scores.argmax(-1)
            wins = cpu_decode(cand).reshape(B, C, pcfg.window, -1)
            score = ((wins[:, :, :ov] - prev[:, None, stride:]) ** 2).mean(dim=(2, 3))
            score = score - GEN_DYN * wins.diff(dim=2).abs().mean(dim=(2, 3))
            best2 = score.topk(2, dim=1, largest=False).values
            tie |= (best2[:, 1] - best2[:, 0]) <= GEN_TIE * best2[:, 0].abs().clamp_min(1e-30)
            ok = tie | (score.argmin(1) == choices[:, t])
            require(bool(ok.all()), f"generate guided: position {t} choices "
                    f"{choices[:, t].tolist()} vs the CPU's {score.argmin(1).tolist()}")
            compared += int((~tie).sum())
            skipped += int(tie.sum())
            prev = cpu_decode(grid[:, t].long())
    return {"compared": compared, "near_ties": skipped}


def generator_artifact_path(smi: str, prior, vq, exp) -> dict:
    """The f32 prior and the flagship frozen into a generator artifact
    (unguided, GEN_SAMPLES x GENERATOR_POSITIONS, cuda programs; export timed),
    loaded in a child process (which must import no models, train or
    config) and here; ``generate`` for a seed within 1e-5 of the live
    make_generation_fn, in the child, here and over HTTP (``{"seed": N}``)."""
    t_phase = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_generator_")
    try:
        path = os.path.join(workdir, "generator.zip")
        t0 = time.perf_counter()
        meta = build_generator_artifact(vq, exp, prior, path,
                                        n_positions=GENERATOR_POSITIONS,
                                        n_samples=GEN_SAMPLES, platforms=("cuda",))
        export_s = time.perf_counter() - t0
        child_out = os.path.join(workdir, "child.npy")
        env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        loaded = BACKGROUND.submit(   # a child: beside the checks here
            subprocess.run, [sys.executable, "-c", GENERATOR_LOAD_PROBE, path, str(GEN_SEED),
                             child_out], env=env, capture_output=True, text=True,
            timeout=CLI_TIMEOUT_S)
        live_fn = make_generation_fn(vq, exp, prior, ZERO29, ONE29,
                                     n_positions=GENERATOR_POSITIONS, n_samples=GEN_SAMPLES)
        with torch.inference_mode():
            live = live_fn(GEN_SEED).cpu().numpy()
        t0 = time.perf_counter()
        art = load_serving_artifact(path)
        load_s = time.perf_counter() - t0
        before = launches()
        got = art.generate(GEN_SEED).cpu().numpy()
        own = _delta(before)
        errs = {"here": float(np.abs(got - live).max())}
        r = loaded.result()
        require(r.returncode == 0, f"generator load in a child: rc {r.returncode}\n"
                f"{r.stderr[-3000:]}")
        child = json.loads(r.stdout.strip().splitlines()[-1])
        model_code = [m for m in child["modules"] if m.split(".")[:2] in (
            ["bridgerl_tpu_torch", "models"], ["bridgerl_tpu_torch", "train"],
            ["bridgerl_tpu_torch", "config"])]
        require(not model_code and child["device"].startswith("cuda"),
                f"generator in a child: {child['device']}, imported {model_code}")
        errs["child"] = float(np.abs(np.load(child_out) - live).max())
        srv = make_server(art, port=0)
        th = threading.Thread(target=srv.handle_request, daemon=True)
        th.start()
        host, port = srv.server_address
        status, body = _http_post(f"http://{host}:{port}", "/v1/generate",
                                  json.dumps({"seed": GEN_SEED}).encode(), "application/json")
        th.join(60)
        srv.server_close()
        require(status == 200, f"generator over HTTP: {status} {body[:300]}")
        errs["http"] = float(np.abs(np.asarray(json.loads(body)["windows"], np.float32)
                                    - live).max())
        shape = [GEN_SAMPLES, PRIOR_STRIDE * (GENERATOR_POSITIONS - 1) + 10, 29]
        require(list(got.shape) == shape and np.isfinite(got).all(), f"generator {got.shape}")
        require(max(errs.values()) <= ARTIFACT_ATOL, f"generator vs live: {errs}")
        line = {"phase": "generator_artifact", "card": smi, "positions": GENERATOR_POSITIONS,
                "samples": GEN_SAMPLES, "export_s": export_s,
                "export_s_by_platform": meta["export_seconds"], "load_s": load_s,
                "artifact_bytes": os.path.getsize(path), "max_abs_err_vs_live": errs,
                "child_device": child["device"], "launches": own,
                "generator_artifact_path_s": time.perf_counter() - t_phase}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    emit(line)
    return line


# ---------------------------------------------------------------- phases 19-21: replay, csv, latent

def _replay_take(frames: int, seed: int) -> tuple:
    """A seeded (frames, 29) take with a drifting root and a root quaternion
    (wxyz) turning twice about a tilted axis."""
    g = np.random.default_rng(seed)
    dof = g.uniform(-0.5, 0.5, (frames, 29)).astype(np.float32)
    pos = (np.cumsum(g.normal(scale=0.01, size=(frames, 3)), axis=0)
           + [0.0, 0.0, 0.74]).astype(np.float32)
    half = np.linspace(0.0, 2.0 * np.pi, frames)[:, None]
    axis = np.array([0.2, 0.1, 1.0]) / np.linalg.norm([0.2, 0.1, 1.0])
    rot = np.concatenate([np.cos(half), np.sin(half) * axis], axis=1).astype(np.float32)
    return dof, pos, rot


def _fk_err(chain, pos, rot, q, base_pos=None) -> float:
    """The largest distance of positions and rotations from fk_numpy's."""
    want = fk_numpy(chain, q.astype(np.float64), base_pos)
    return max(float(np.abs(pos - want[0]).max()), float(np.abs(rot - want[1]).max()))


def _replay_motions() -> dict:
    """frames -> a Motion of that many frames on the card (seeded takes of
    2 * frames / 5 + 1 frames at 20 -> 50 fps)."""
    motions = {}
    for frames in REPLAY_PROFILED:
        take = _replay_take(frames // 5 * 2 + 1, SEED + 21)[0]
        motions[frames] = load_motion(take, 20, 50, device="cuda")
        require(motions[frames].num_frames == frames, f"replay: {frames} frames")
    return motions


def replay_profile_rows() -> dict:
    """Device ms, device operations and the idle share of one rollout at each
    of REPLAY_PROFILED frames (torch.profiler, after one warm-up rollout)."""
    scene = G1ReplayScene(device="cuda")
    return {f"frames_{n}": _profile_step(lambda m=m: scene.rollout(m), f"rollout of {n} frames")
            for n, m in _replay_motions().items()}


def replay_path(smi: str) -> tuple:
    """The G1 replay scene on the card: a seeded 400-frame take at 20 -> 50
    fps through load_motion on the card and the CPU (every array within
    MOTION_TOL); one pass of ``step`` (sampled frames within FK_TOL of
    fk_numpy at the motion's root) and of ``get_next_state`` (the wrap-around
    on the last frame only); rollout and rollout_full at 20,000 frames (64
    sampled frames, positions and rotations, within FK_TOL of fk_numpy at the
    default root, and every frame within FK_TOL of the CPU's BatchedFK on
    the same motion); steps/s of ``benchmark_steps_per_sec(20000)``, the median
    of 3 calls (each after its 2 warm-up rollouts)."""
    t0 = time.perf_counter()
    dof, pos, rot = _replay_take(REPLAY_TAKE, SEED + 20)
    card = load_motion(dof, 20, 50, base_pos=pos, base_rot=rot, device="cuda")
    cpu = load_motion(dof, 20, 50, base_pos=pos, base_rot=rot, device="cpu")
    motion_err = {name: float((getattr(card, name).cpu() - getattr(cpu, name)).abs().max())
                  for name in ("dof_pos", "dof_vel", "base_pos", "base_rot", "base_lin_vel",
                               "base_ang_vel")}
    require(card.num_frames == cpu.num_frames == 998 and max(motion_err.values()) <= MOTION_TOL,
            f"replay: load_motion card vs CPU {motion_err}")

    scene = G1ReplayScene(device="cuda")
    chain = scene.chain
    scene.motion, scene.current_idx = card, 0
    q, base = cpu.dof_pos.numpy(), cpu.base_pos.numpy()
    n, step_err = card.num_frames, 0.0
    t1 = time.perf_counter()
    for i in range(n):
        p, r = scene.step()
        if i % (n // 16) == 0 or i == n - 1:
            step_err = max(step_err, _fk_err(chain, p.cpu().numpy(), r.cpu().numpy(), q[i],
                                             base[i].astype(np.float64)))
    torch.cuda.synchronize()
    steps_s = time.perf_counter() - t1
    require(scene.current_idx == 0 and step_err <= FK_TOL,
            f"replay: step pass ended at {scene.current_idx}, {step_err} from fk_numpy")
    flags = [scene.get_next_state()[1] for _ in range(n)]
    require(flags[-1] and not any(flags[:-1]), "replay: wrap-around not on the last frame")

    big = _replay_motions()[REPLAY_FRAMES]
    traj = scene.rollout(big).cpu().numpy()
    full_pos, full_rot = (a.cpu().numpy() for a in scene.rollout_full(big))
    qb = big.dof_pos.cpu().numpy()
    sampled = np.linspace(0, REPLAY_FRAMES - 1, REPLAY_SAMPLED).astype(int)
    rollout_err = max(_fk_err(chain, full_pos[t], full_rot[t], qb[t]) for t in sampled)
    rollout_err = max(rollout_err, float(np.abs(traj - full_pos).max()))
    require(rollout_err <= FK_TOL, f"replay: rollout {rollout_err} from fk_numpy")
    # every frame against the CPU's BatchedFK on the same motion
    cpu_pos, cpu_rot = (a.numpy() for a in BatchedFK(chain)(big.dof_pos.cpu()))
    frame_err = np.maximum(np.abs(full_pos - cpu_pos).max(axis=(1, 2)),
                           np.abs(full_rot - cpu_rot).max(axis=(1, 2, 3)))
    worst = int(frame_err.argmax())
    require(frame_err[worst] <= FK_TOL,
            f"replay: rollout frame {worst} is {frame_err[worst]} from the CPU's BatchedFK")

    rates = sorted(scene.benchmark_steps_per_sec(REPLAY_FRAMES) for _ in range(3))
    line = {"phase": "replay", "card": smi, "dtype": "float32",
            "motion_max_abs_err": motion_err, "step_frames": n,
            "step_max_abs_err": step_err, "steps_per_s_step_api": n / steps_s,
            "rollout_frames": REPLAY_FRAMES, "rollout_frames_checked": REPLAY_SAMPLED,
            "rollout_max_abs_err": rollout_err, "rollout_frames_vs_cpu": len(frame_err),
            "rollout_max_abs_err_vs_cpu": float(frame_err[worst]),
            "rollout_worst_frame_vs_cpu": worst, "replay_steps_per_s": rates[1],
            "replay_steps_per_s_all": rates, "replay_path_s": time.perf_counter() - t0}
    emit(line)
    return line


def replay_profile(smi: str) -> dict:
    """``replay_profile_rows`` in a child process: its profiler session is
    the child's first (a process's later sessions lose records: this
    script's own profiled phases come before it), and no later phase of
    this script runs after it in the same process."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    stdout = _run_cli(["-c", REPLAY_PROFILE_PROBE], os.path.dirname(os.path.abspath(__file__)),
                      env)
    line = {"phase": "replay_profile", "card": smi,
            **json.loads(stdout.strip().splitlines()[-1])}
    emit(line)
    return line


def _lafan_csv(path: str, frames: int, seed: int) -> None:
    """A LAFAN-style take: root position, root quaternion xyzw, 29 dof a row."""
    dof, pos, rot = _replay_take(frames, seed)
    xyzw = np.concatenate([rot[:, 1:], rot[:, :1]], axis=1)
    np.savetxt(path, np.concatenate([pos, xyzw, dof], axis=1), delimiter=",")


def csv_path(smi: str) -> dict:
    """``cli.csv_to_npz`` on a seeded 300-frame, 30 fps take, a child process
    on the card and one with ``--device cpu``: every array of the two npz
    files within CSV_TOL of max(1, its largest |value|) (the velocities
    divide float32 differences by dt), the link quaternions up to sign; each
    run's seconds. The root turns through half turns, where the quaternion
    of a matrix is read off its largest component."""
    workdir = tempfile.mkdtemp(prefix="chip_smoke_csv_")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    try:
        src = os.path.join(workdir, "take.csv")
        _lafan_csv(src, CSV_FRAMES, SEED + 22)
        out = {dev: os.path.join(workdir, f"{dev}.npz") for dev in ("cuda", "cpu")}
        seconds = {}
        for dev, (rc, _, stderr, seconds[dev]) in _run_parallel({   # together
                dev: ["-m", "bridgerl_tpu_torch.cli.csv_to_npz", "--input_file", src,
                      "--input_fps", "30", "--output_fps", "50", "--output_file", out[dev],
                      "--device", dev] for dev in out}, workdir, env).items():
            require(rc == 0, f"csv_to_npz --device {dev}: rc {rc}\n{stderr[-3000:]}")
        card, cpu = np.load(out["cuda"]), np.load(out["cpu"])
        err = {k: float(np.abs(card[k] - cpu[k]).max()) for k in cpu.files}
        # q and -q are one rotation: where w is near 0 the sign is noise
        err["body_quat_w"] = float(np.minimum(
            np.abs(card["body_quat_w"] - cpu["body_quat_w"]).max(-1),
            np.abs(card["body_quat_w"] + cpu["body_quat_w"]).max(-1)).max())
        scale = {k: max(1.0, float(np.abs(cpu[k]).max())) for k in cpu.files}
        require(sorted(card.files) == sorted(cpu.files)
                and all(err[k] <= CSV_TOL * scale[k] for k in err),
                f"csv: card vs CPU {err} (scales {scale})")
        frames = int(card["joint_pos"].shape[0])
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    line = {"phase": "csv", "card": smi, "frames_in": CSV_FRAMES, "frames_out": frames,
            "max_abs_err": err, "csv_to_npz_s_cuda": seconds["cuda"],
            "csv_to_npz_s_cpu": seconds["cpu"]}
    emit(line)
    return line


def _raw_takes(raw_dir: str) -> None:
    g = np.random.default_rng(SEED + 23)
    for action in LATENT_ACTIONS:
        for i in range(LATENT_TAKES):
            robot, human_aa = synth_pair(g, LATENT_TAKE_FRAMES)
            np.savez(os.path.join(raw_dir, f"{action}_take_{i}.npz"), joint_pos=robot,
                     smplx_pose_body=human_aa.reshape(LATENT_TAKE_FRAMES, -1, 3))


def latent_path(smi: str) -> dict:
    """``eval/latent.py`` on the card: the flagship (seed 0's weights, f32)
    saved as a ``.pth`` and loaded on the card and the CPU; synthetic raw
    takes of 3 actions through ``load_paired_data_by_action``; both encoders
    through ``get_latent_vectors`` (batch 256: K1-fwd packed 8 at (128, 80,
    64), then the last 44 windows unpacked), card within LATENT_ATOL of the
    CPU; K1-fwd launched 4 times a batch; windows/s of the encoders, the
    median of 3 passes after the counted one."""
    exp = make_experiment("transformer", "hybrid", window=10, attn_packing=8)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_latent_")
    try:
        ckpt = os.path.join(workdir, "flagship_best.pth")
        save_checkpoint(ckpt, epoch=0, model=init_model(exp.model, SEED, device="cpu"),
                        config=exp)
        _raw_takes(workdir)
        card_model, _ = load_model_from_checkpoint(ckpt, device="cuda")
        cpu_model, _ = load_model_from_checkpoint(ckpt, device="cpu")
        stats = {"mean": 0.0, "std": 1.0, "human_mean": 0.0, "human_std": 1.0}
        by_action = load_paired_data_by_action(workdir, exp.model.window_size, stats)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    require(list(by_action) == list(LATENT_ACTIONS)
            and all(len(r) == 300 for r, _ in by_action.values()), "latent: takes by action")

    def encode(model):
        return {(a, side): get_latent_vectors(model, x, side, LATENT_BATCH)
                for a, (r, h) in by_action.items() for side, x in (("robot", r), ("human", h))}

    kernels.reset_counters()
    card = encode(card_model)
    counts = launches()
    cpu = encode(cpu_model)
    err = max(float(np.abs(card[k] - cpu[k]).max()) for k in card)
    require(all(card[k].shape == (300, exp.model.hidden_dim) for k in card)
            and err <= LATENT_ATOL, f"latent: card vs CPU {err}")
    batches = sum(math.ceil(len(x) / LATENT_BATCH) for x in
                  (x for r, h in by_action.values() for x in (r, h)))
    want = qkv_want({**{k: 0 for k in kernels.COUNTERS},
                     "packed_attention_fwd": batches * exp.model.n_tf_layers})
    require(counts == want, f"latent: launches {counts}, want {want}")
    windows = sum(len(r) + len(h) for r, h in by_action.values())
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        encode(card_model)
        times.append(time.perf_counter() - t0)
    line = {"phase": "latent", "card": smi, "dtype": "float32", "windows": windows,
            "max_abs_err": err, "launches": counts,
            "windows_per_s": windows / statistics.median(times), "seconds": times}
    emit(line)
    return line


# ---------------------------------------------------------------- phase 22: import, runners, demo

def _run_parallel(jobs: dict, cwd: str, env: dict) -> dict:
    """Each job's args in a child process, all started together: name ->
    (rc, stdout, stderr, seconds). Every child is ended before this returns."""
    procs = {}
    try:
        for name, args in jobs.items():
            procs[name] = (time.perf_counter(), subprocess.Popen(
                [sys.executable, *args], cwd=cwd, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        out = {}
        for name, (t0, p) in procs.items():
            stdout, stderr = p.communicate(timeout=CLI_TIMEOUT_S)
            out[name] = (p.returncode, stdout, stderr, time.perf_counter() - t0)
        return out
    finally:
        for _, p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


def _reference_files(workdir: str) -> tuple:
    """The flagship at SEED, FSQ unbounded, written as a user of the
    reference brings it: a wrapper (DataParallel's ``module.`` keys, the
    plain config dict, no ``config_json``), a bare ``_final.pth``, and the
    learned tensors only, through ``cli.export_torch_ckpt``. Returns (the
    model on the CPU, name -> path)."""
    exp = make_experiment("transformer", "hybrid", window=10, attn_packing=8, fsq_bounded=False)
    model = init_model(exp.model, SEED, device="cpu")
    sd = to_reference_state_dict(model.state_dict())
    files = {name: os.path.join(workdir, f"{name}.pth")
             for name in ("reference_best", "reference_final", "exported")}
    torch.save({"epoch": 3, "model_state_dict": {f"module.{k}": v for k, v in sd.items()},
                "optimizer_state_dict": {}, "best_loss": 0.5, "config": REFERENCE_CONFIG},
               files["reference_best"])
    torch.save(sd, files["reference_final"])
    port = os.path.join(workdir, "port_best.pth")
    save_checkpoint(port, epoch=3, model=model, best_loss=0.5, config=exp)
    with contextlib.redirect_stdout(sys.stderr):
        rc = export_torch_ckpt.main(["--ckpt", port, "--out", files["exported"]])
    require(rc == 0, f"export_torch_ckpt: rc {rc}")
    return model, files


def torch_import_path(smi: str) -> tuple:
    """The slice's main path. The flagship's weights in the three file
    shapes of ``_reference_files``, each imported by ``cli.import_torch_ckpt
    --check`` in a child process on the card (the four children started
    together); the bare file with ``--window 10``, and without it a child
    that must fail naming the window. Every imported tensor equal bit for
    bit to the original (so export_torch_ckpt -> import_torch_ckpt gives
    back every tensor), the reference semantics (FSQ unbounded) in the
    config. The imported checkpoint served through ServingApp at
    IMPORT_BATCHES (retarget) and 64 (motion_codes), held to the same
    payload imported on the CPU under the float32 rule, 8 K1-fwd and 4 K2
    launches a call; retarget's windows/s at b = 4096 and b = 1 p50.
    Returns the line and the work directory (its files feed ``runners``)."""
    t_phase = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_import_")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    model, files = _reference_files(workdir)
    out = {name: os.path.join(workdir, f"imported_{name}.pth") for name in files}
    jobs = {name: ["-c", CLI_WRAPPER, IMPORT_CLI, "--pth", path, "--out", out[name], "--check"]
            + (["--window", "10"] if name == "reference_final" else [])
            for name, path in files.items()}
    jobs["reference_final_no_window"] = ["-c", CLI_WRAPPER, IMPORT_CLI, "--pth",
                                         files["reference_final"], "--out",
                                         os.path.join(workdir, "refused.pth")]
    children = _run_parallel(jobs, workdir, env)
    refused_rc, _, stderr, _ = children.pop("reference_final_no_window")
    require(refused_rc != 0 and "window" in stderr
            and not os.path.exists(os.path.join(workdir, "refused.pth")),
            f"import of a bare file without --window: rc {refused_rc}\n{stderr[-2000:]}")
    want_sd = model.state_dict()
    child_lines, child_launches = {}, []
    for name, (rc, stdout, stderr, seconds) in children.items():
        require(rc == 0, f"import_torch_ckpt {name}: rc {rc}\n{stderr[-3000:]}")
        require("check ok: recon (2, 10, 29), retargeted (2, 10, 29) on cuda" in stdout,
                f"import_torch_ckpt {name}: {stdout[-2000:]}")
        counts = json.loads(stdout.strip().splitlines()[-1].split("LAUNCHES ", 1)[1])
        want = qkv_want({**{k: 0 for k in kernels.COUNTERS}, "packed_attention_fwd": 16,
                         "vq_assign": 8})
        require(counts == want, f"import_torch_ckpt {name} --check: launches {counts}, "
                f"want {want} (both branches)")
        ck = load_checkpoint(out[name])
        cfg = ck["config"].model
        require((cfg.arch, cfg.method, cfg.window_size, cfg.fsq_bounded, cfg.lfq_norm)
                == ("transformer", "hybrid", 10, False, False), f"import {name}: {cfg}")
        got_sd = ck["model_state_dict"]
        require(sorted(got_sd) == sorted(want_sd) and all(
            torch.equal(got_sd[k], want_sd[k]) for k in want_sd),
            f"import {name}: tensors differ from the original's")
        child_lines[name] = {"seconds": seconds, "launches": counts, "epoch": ck["epoch"]}
        child_launches.append(counts)

    imported = out["reference_best"]
    exp = load_checkpoint(imported)["config"]

    def build(cfg, device):
        if device == "cuda":
            return load_model_from_checkpoint(imported, device="cuda")[0]
        return import_torch_checkpoint(load_pth(files["reference_best"]), device="cpu")[1]

    _, module, verify, _ = serving_check(exp, build)
    app = ServingApp(module)
    rng = np.random.default_rng(SEED + 23)
    requests = [("retarget", b) for b in IMPORT_BATCHES] + [("motion_codes", 64)]
    kernels.reset_counters()
    lines = serve_requests(exp, app, verify, requests, rng)
    for line in lines:
        emit({**line, "path": "torch_import"})
    x4096 = rng.normal(size=(4096, 10, exp.model.human_input_dim)).astype(np.float32)
    wps, p50 = _serving_rate(app, x4096)
    line = {"phase": "torch_import", "card": smi, "dtype": "float32",
            "imports": child_lines, "tensors_checked": len(want_sd),
            "bare_without_window_rc": refused_rc, "attn_packing": exp.model.attn_packing,
            "launches": add_launches(*child_launches, *(l["launches"] for l in lines)),
            "served_launches": add_launches(*(l["launches"] for l in lines)),
            "retarget_windows_per_s_b4096": wps, "retarget_p50_ms_b1": p50,
            "torch_import_path_s": time.perf_counter() - t_phase}
    emit(line)
    return line, workdir


def demo_stream_path(smi: str, art) -> dict:
    """``cli.demo_stream_retarget``'s device half on the f32 flagship
    artifact: ``stream_feed`` of DEMO_FRAMES synthetic human frames (the
    demo's 6D feed) at step DEMO_STEP, equal to offline overlap-add within
    ARTIFACT_ATOL, each frame released W + 1 frames after it went in,
    8 K1-fwd and 4 K2 launches a window; then ``drive_g1`` on the card, its
    trajectory within FK_TOL of the CPU replay of the same frames. The
    median push and the median push that completes a window."""
    t_phase = time.perf_counter()
    cfg = make_experiment("transformer", "hybrid", window=10).model
    W = art.window_size
    feed = demo_stream_retarget.human_feed(None, DEMO_FRAMES)
    kernels.reset_counters()
    robot, push_ms, released = demo_stream_retarget.stream_feed(art, feed, DEMO_STEP)
    counts = launches()
    windows = len(window_starts(DEMO_FRAMES, W, DEMO_STEP))
    k1, k2 = per_call(cfg)
    want = qkv_want({**{k: 0 for k in counts}, "packed_attention_fwd": k1 * windows,
                     "vq_assign": k2 * windows})
    require(counts == want, f"demo_stream: launches {counts}, want {want}")
    require(np.cumsum(released).tolist() == [max(n - W, 0) for n in range(1, DEMO_FRAMES + 1)],
            "demo_stream: frames not released W + 1 frames after they went in")
    offline = reconstruct_long_sequence(art.fns["retarget"], feed, W, DEMO_STEP,
                                        np.zeros(1, np.float32), np.ones(1, np.float32),
                                        device="cuda")
    err = float(np.abs(robot - offline).max())
    require(robot.shape == offline.shape == (DEMO_FRAMES, 29) and err <= ARTIFACT_ATOL,
            f"demo_stream: {robot.shape} {err} from offline overlap-add")
    t0 = time.perf_counter()
    traj = demo_stream_retarget.drive_g1(robot, DEMO_FPS, "cuda")
    torch.cuda.synchronize()
    drive_s = time.perf_counter() - t0
    cpu_traj = demo_stream_retarget.drive_g1(robot, DEMO_FPS, "cpu")
    traj_err = float((traj.cpu() - cpu_traj).abs().max())
    require(traj.device.type == "cuda" and traj.shape == cpu_traj.shape
            and traj_err <= FK_TOL, f"demo_stream: G1 trajectory {traj_err} from the CPU's")
    window_ms = [ms for n, ms in enumerate(push_ms, start=1)
                 if n >= W and (n - W) % DEMO_STEP == 0]
    line = {"phase": "demo_stream", "card": smi, "dtype": "float32", "frames": DEMO_FRAMES,
            "window": W, "step": DEMO_STEP, "windows": windows, "launches": counts,
            "latency_frames": W + 1, "max_abs_err_vs_offline": err,
            "trajectory_frames": int(traj.shape[0]), "trajectory_max_abs_err_vs_cpu": traj_err,
            "push_p50_ms": statistics.median(push_ms),
            "window_push_p50_ms": statistics.median(window_ms), "drive_g1_s": drive_s,
            "demo_stream_s": time.perf_counter() - t_phase}
    emit(line)
    return line


def _entry_seconds(stdout: str) -> dict:
    return {m.group(1): float(m.group(2)) for m in RUNNER_OK.finditer(stdout)}


def runners_path(smi: str, reference_pth: str) -> dict:
    """The run drivers, each a child process on the card. ``cli.run_batch``
    over three specs at the CLI's batch: a resnet_no_down + hybrid W10
    teacher (2 epochs), its student from the teacher's best checkpoint (1),
    and a spec with JAX's ``prng``, which must fail: the batch exits 1
    naming only that spec, the good runs write the reference's file names
    with finite losses. Then ``cli.run_queue`` over ``process_data
    --synthetic`` and ``import_torch_ckpt --check`` on the reference
    wrapper file: exit 0, each entry's OK line. The two children run
    together. Each child's seconds and the seconds of each entry inside it."""
    t_phase = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_runners_")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    try:
        data = os.path.join(workdir, "data")
        generate_synthetic_dataset(data, n_sequences=8, window=10, step=2, seed=0)   # CLI_DATA
        ckpts, results = os.path.join(workdir, "checkpoints"), os.path.join(workdir, "results")
        base = {"arch": "resnet_no_down", "method": "hybrid", "data_dir": data, "window": 10,
                "batch_size": 256, "seeds": [42], "save_every": 1, "log_dir": results,
                "checkpoint_dir": ckpts}
        teacher = os.path.join(ckpts, "Exp_resnet_no_down_W10_hybrid_teacher_seed_42_best.pth")
        specs = [{**base, "label": "teacher", "epochs": RUNNER_EPOCHS["teacher"]},
                 {**base, "label": "student", "mode": "student", "teacher_ckpt": teacher,
                  "epochs": RUNNER_EPOCHS["student"]},
                 {**base, "label": "jax_prng", "prng": "rbg", "epochs": 1}]
        spec_path = os.path.join(workdir, "specs.json")
        with open(spec_path, "w") as f:
            json.dump(specs, f)
        queue = [["bridgerl_tpu_torch.cli.process_data", *CLI_DATA, "--output_dir",
                  os.path.join(workdir, "queue_data")],
                 [IMPORT_CLI, "--pth", reference_pth, "--out",
                  os.path.join(workdir, "imported.pth"), "--check"]]
        queue_path = os.path.join(workdir, "queue.json")
        with open(queue_path, "w") as f:
            json.dump(queue, f)
        done = _run_parallel({   # they share no file: together
            "batch": ["-m", "bridgerl_tpu_torch.cli.run_batch", spec_path],
            "queue": ["-m", "bridgerl_tpu_torch.cli.run_queue", queue_path]}, workdir, env)
        rc, stdout, stderr, batch_s = done["batch"]
        require(rc == 1 and stdout.strip().splitlines()[-1] == "BATCH DONE failures=['jax_prng']"
                and "prng='rbg'" in stdout, f"run_batch: rc {rc}\n{stdout[-2000:]}\n"
                f"{stderr[-2000:]}")
        losses = {}
        for mode in ("teacher", "student"):
            for kind in ("best", "last", "final"):
                path = os.path.join(ckpts, f"Exp_resnet_no_down_W10_hybrid_{mode}_seed_42_"
                                           f"{kind}.pth")
                require(os.path.exists(path), f"run_batch {mode}: no {path}")
            log = ("log_resnet_no_down_hybrid_seed_42.json" if mode == "teacher"
                   else "log_resnet_no_down_hybrid_student_seed_42.json")
            with open(os.path.join(results, log)) as f:
                hist = json.load(f)
            require(len(hist["train_loss"]) == RUNNER_EPOCHS[mode]
                    and all(math.isfinite(v) for v in hist["train_loss"] + hist["val_loss"]),
                    f"run_batch {mode}: {hist['train_loss']}")
            losses[mode] = hist["train_loss"]
        batch_entries = _entry_seconds(stdout)
        require(sorted(batch_entries) == ["batch[0] teacher", "batch[1] student"],
                f"run_batch entries {batch_entries}")

        rc, stdout, stderr, queue_s = done["queue"]
        queue_entries = _entry_seconds(stdout)
        require(rc == 0 and "[QUEUE] all entries OK" in stdout and len(queue_entries) == 2
                and "check ok: recon (2, 10, 29)" in stdout
                and os.path.exists(os.path.join(workdir, "queue_data", "g1_train.npy")),
                f"run_queue: rc {rc}\n{stdout[-2000:]}\n{stderr[-2000:]}")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    line = {"phase": "runners", "card": smi, "run_batch_s": batch_s,
            "run_batch_entries_s": batch_entries, "run_batch_train_loss": losses,
            "run_queue_s": queue_s, "run_queue_entries_s": queue_entries,
            "runners_s": time.perf_counter() - t_phase}
    emit(line)
    return line


# ---------------------------------------------------------------- research, native

def _research_exp(dtype: str):
    """The studies' teacher: the W64 K4 quality configuration at the default widths."""
    return make_experiment("transformer", "hybrid", **RESEARCH_TEACHER, compute_dtype=dtype)


def research_files(workdir: str) -> dict:
    """The studies' inputs, written on the host: the K4 teacher at SEED in
    float32 and bfloat16 (the same weights), W64 fsq and lfq transformers at
    SEED, and RESEARCH_TAKES synthetic takes at W 64 (``data/``)."""
    files = {"data": os.path.join(workdir, "data"), "out": os.path.join(workdir, "out")}
    weights = init_model(_research_exp("float32").model, SEED, device="cpu").state_dict()
    for dtype in ("float32", "bfloat16"):
        files[dtype] = os.path.join(workdir, f"teacher_{dtype}.pth")
        save_checkpoint(files[dtype], epoch=0, model=weights, config=_research_exp(dtype))
    for method in ("fsq", "lfq"):
        exp = make_experiment("transformer", method, window=64)
        files[method] = os.path.join(workdir, f"{method}.pth")
        save_checkpoint(files[method], epoch=0, model=init_model(exp.model, SEED, device="cpu"),
                        config=exp)
    generate_synthetic_dataset(files["data"], n_sequences=RESEARCH_TAKES,
                               min_len=RESEARCH_FRAMES[0], max_len=RESEARCH_FRAMES[1],
                               window=64, step=32, seed=SEED)
    return files


def research_queue(files: dict) -> list:
    """The run_queue entries: each study at its own widths and cut depth
    (RESEARCH_REDUCED), then the two diagnostics."""
    cli, out, data = "bridgerl_tpu_torch.cli.", files["out"], files["data"]
    depth = ["--epochs", str(RESEARCH_EPOCHS), "--positions", str(RESEARCH_POSITIONS)]
    prior = os.path.join(out, "ar", "prior_ar.ckpt")
    frames = ["--min_len", str(RESEARCH_FRAMES[0]), "--max_len_frames", str(RESEARCH_FRAMES[1])]
    return [
        [cli + "exp_prior_ar", "--ckpt", files["float32"], "--data_dir", data, "--arms",
         "fact,ar", *depth, "--out_dir", os.path.join(out, "ar")],
        [cli + "exp_prior_sampling", "--ckpt", files["bfloat16"], "--priors", prior,
         "--data_dir", data, "--temperatures", "1.0", "--top_ks", "0,1", *depth[2:],
         "--out", os.path.join(out, "sampling.json")],
        [cli + "exp_prior_prompted", "--ckpt", files["bfloat16"], "--priors", prior,
         "--data_dir", data, "--prompt_positions", "0,8", *depth[2:],
         "--out", os.path.join(out, "prompted.json")],
        [cli + "exp_prior_scaling", "--ckpt", files["float32"], "--data_dir", data, "--arms",
         str(RESEARCH_TAKES + 4), *frames, *depth, "--out_dir", os.path.join(out, "scale")],
        [cli + "exp_prior_conditioned", "--ckpt", files["float32"], "--arms", "3",
         "--min_len", "700", "--max_len_frames", "800", "--gen_per_class", "2", *depth,
         "--out_dir", os.path.join(out, "cond")],
        [cli + "exp_prior_dynamics", "--ckpt", files["float32"], "--data_dir", data, "--takes",
         str(RESEARCH_TAKES), "--seeds", "42", "--lams", "0.0,0.75", *depth,
         "--out_dir", os.path.join(out, "dyn")],
        [cli + "diag_fsq_spread", "--ckpt", files["fsq"], "--data_dir", data],
        [cli + "diag_lfq", "--ckpt", files["lfq"], "--data_dir", data],
    ]


def _research_tokens(files: dict, dtype: str, device: str, takes: list) -> tuple:
    """(model, experiment, grids, mask, prior config) of ``takes`` through the
    K4 teacher in ``dtype`` on ``device``, at the studies' stride 32 and
    max_len 96 (one grid a take)."""
    model, exp = load_model_from_checkpoint(files[dtype], device=device)
    grids, mask, pcfg, _ = extract_code_grids(model, exp, takes, RAW_MEAN, RAW_STD, 32,
                                              max_len=96)
    return model, exp, grids, mask, pcfg


def research_background(workdir: str) -> dict:
    """Beside the CLI phases, in a thread: writes the studies' inputs, starts
    the run_queue child (RESEARCH_WRAPPER) on the card and, while it runs,
    takes the CPU's side of the tokenization check: the takes' grids in
    float32 and bfloat16 and exp_prior_ar's ceiling in float32. Nothing here
    runs on the card (the launch counters belong to the main thread's
    phases). Returns the inputs, the child's (rc, stdout, stderr, seconds)
    and the CPU's results. The child is ended before this returns."""
    files = research_files(workdir)
    queue_path = os.path.join(workdir, "queue.json")
    with open(queue_path, "w") as f:
        json.dump(research_queue(files), f)
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    t0 = time.perf_counter()
    # at a lower CPU priority than the timed children beside it
    proc = subprocess.Popen(["nice", "-n", str(RESEARCH_NICE), sys.executable, "-c",
                             RESEARCH_WRAPPER, queue_path], cwd=workdir, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        t_cpu = time.perf_counter()
        takes = load_takes(files["data"])
        cpu = {dtype: _research_tokens(files, dtype, "cpu", takes[:n])[2:4]
               for dtype, n in RESEARCH_CPU_TAKES.items()}
        model, exp, grids, mask, pcfg = _research_tokens(files, "float32", "cpu", takes[:8])
        cpu["ceiling"] = decode_ceiling(model, exp, grids, mask, pcfg, takes, 32)
        cpu["seconds"] = time.perf_counter() - t_cpu
        stdout, stderr = proc.communicate(timeout=RESEARCH_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return {"files": files, "child": (proc.returncode, stdout, stderr,
                                      time.perf_counter() - t0), "cpu": cpu}


def _entries(stdout: str) -> dict:
    """The queue's entries in order: label -> {"seconds", "launches", "stdout"}
    (the lines an entry printed, and the launches printed after its OK)."""
    entries, label, lines = {}, None, []
    for line in stdout.splitlines():
        ok = RUNNER_OK.match(line)
        if line.startswith("=== queue[") and line.endswith(" start ==="):
            label, lines = None, []
        elif ok:
            label = ok.group(1)
            entries[label] = {"seconds": float(ok.group(2)), "stdout": lines}
            lines = []
        elif line.startswith("LAUNCHES ") and label:
            entries[label]["launches"] = json.loads(line.split(" ", 1)[1])
        else:
            lines.append(line)
    return entries


def _walk_numbers(obj, where: str) -> int:
    """The count of numbers in a JSON value; raises at a non-finite one."""
    if isinstance(obj, dict):
        return sum(_walk_numbers(v, f"{where}/{k}") for k, v in obj.items())
    if isinstance(obj, list):
        return sum(_walk_numbers(v, f"{where}[{i}]") for i, v in enumerate(obj))
    if isinstance(obj, (int, float)) and not isinstance(obj, bool):
        require(math.isfinite(obj), f"research: {where} is {obj}")
        return 1
    return 0


def _require_keys(what: str, row: dict, *groups) -> None:
    want = sorted(k for g in groups for k in g)
    require(sorted(row) == want, f"research: {what} keys {sorted(row)}, want {want}")


def _research_outputs(out: str) -> dict:
    """Each study's JSON against the JAX scripts' keys, every number finite;
    returns the numbers checked by file."""
    def read(*parts):
        with open(os.path.join(out, *parts)) as f:
            return json.load(f)

    sample_row = GEN_KEYS + NOVELTY_KEYS + NN_KEYS + ("overlap_disagreement",)
    files = {"ar/summary.json": read("ar", "summary.json"),
             "sampling.json": read("sampling.json"), "prompted.json": read("prompted.json"),
             "scale/scaling.json": read("scale", "scaling.json"),
             "cond/conditioned.json": read("cond", "conditioned.json"),
             "dyn/dynamics.json": read("dyn", "dynamics.json")}
    ar = files["ar/summary.json"]
    require(sorted(ar) == ["arms", "ceiling"] and sorted(ar["arms"]) == ["ar", "fact"],
            f"research: summary.json {sorted(ar)}")
    _require_keys("ceiling", ar["ceiling"], GEN_KEYS, NN_KEYS, ("overlap_disagreement",))
    for arm, row in ar["arms"].items():
        _require_keys(f"arm {arm}", row, sample_row,
                      ("best_val_ce", "best_train_ce", "epochs_run", "train_s"))
    require(sorted(files["sampling.json"]) == ["prior_ar|T1.0|k0", "prior_ar|T1.0|k1"],
            f"research: sampling rows {sorted(files['sampling.json'])}")
    for key, row in files["sampling.json"].items():
        _require_keys(key, row, sample_row, ("sample_s",))
    require(sorted(files["prompted.json"]) == ["prior_ar|P0", "prior_ar|P8"],
            f"research: prompted rows {sorted(files['prompted.json'])}")
    for key, row in files["prompted.json"].items():
        _require_keys(key, row, GEN_KEYS, NOVELTY_KEYS, NN_KEYS, CURVE_KEYS, (
            "overlap_disagreement_seam", "overlap_disagreement_cont", "sample_s"))
    prompted = GEN_KEYS + NOVELTY_KEYS + CURVE_KEYS
    (arm, row), = files["scale/scaling.json"].items()
    require(arm == f"takes{RESEARCH_TAKES + 4}", f"research: scaling arm {arm}")
    _require_keys(arm, row, ("arm_s", "best_train_ce", "epochs_run", "free_run", "n_grids",
                             "n_positions", "n_val_takes", "prompted_val_P8", "recon_floor",
                             "val_ce_best", "val_ce_best_epoch", "val_ce_epoch0",
                             "val_ce_final", "val_nn_floor"))
    _require_keys(f"{arm} free_run", row["free_run"], sample_row)
    _require_keys(f"{arm} prompted", row["prompted_val_P8"], prompted)
    (arm, row), = files["cond/conditioned.json"].items()
    require(arm == "perclass3", f"research: conditioned arm {arm}")
    _require_keys(arm, row, ("arm_s", "classifier_accuracy_train", "classifier_accuracy_val",
                             "classifier_confusion", "cond_val_ce_best", "cond_val_ce_epoch0",
                             "conditioning_gain_nats", "histogram_match", "n_grids",
                             "n_takes", "uncond_val_ce_best", "uncond_val_ce_epoch0",
                             "vel_ratio_by_class"))
    _require_keys(f"{arm} histogram_match", row["histogram_match"],
                  ("accuracy", "margins", "n_classes", "predicted"))
    rows = files["dyn/dynamics.json"]
    require(sorted(rows) == ["lam0.75_seed42", "lam0_seed42"],
            f"research: dynamics {sorted(rows)}")
    for arm, row in rows.items():
        _require_keys(arm, row, ("arm_s", "best_train_ce", "epochs_run", "free_guided",
                                 "free_unguided", "lam", "n_grids", "prompted_val_P8", "seed",
                                 "val_ce_best", "val_ce_best_epoch", "val_ce_epoch0"))
        for key in ("free_guided", "free_unguided"):
            _require_keys(f"{arm} {key}", row[key], sample_row, ("frames", "sample_s"))
        _require_keys(f"{arm} prompted", row["prompted_val_P8"], prompted)
    return {name: _walk_numbers(obj, name) for name, obj in files.items()}


def _codes_equal(name: str, card: tuple, cpu: tuple) -> float:
    """The share of valid positions' codes equal between two (grids, mask)."""
    (g, m), (w, wm) = card, cpu
    require(g.shape == w.shape and np.array_equal(m, wm), f"{name}: grids {g.shape} {w.shape}")
    return float((g == w)[m > 0].mean())


def research_path(smi: str, run) -> dict:
    """The studies on the card, from ``research_background``'s child: exit 0
    and every entry's OK line; each study's JSON with the JAX scripts' keys
    and finite numbers; the diagnostics' reports; K1 (f32 and bf16 teacher,
    the prior's causal training) and K2 launched. The card's tokenization of
    the takes against the CPU's on the same weights: float32 codes equal on
    CODES_AGREE of the valid positions' slots, and exp_prior_ar's ceiling (the
    child's, on the card) within RESEARCH_CEILING_ATOL of the CPU's; bfloat16
    under the bf16 code rule (``_codes_rule``). Each entry's seconds and
    launches, the child's seconds and the cuts."""
    t0 = time.perf_counter()
    result = run.result()
    files, cpu = result["files"], result["cpu"]
    rc, stdout, stderr, child_s = result["child"]
    require(rc == 0 and "[QUEUE] all entries OK" in stdout,
            f"research: rc {rc}\n{stdout[-3000:]}\n{stderr[-3000:]}")
    entries = _entries(stdout)
    require(len(entries) == len(research_queue(files))
            and all("launches" in e for e in entries.values()),
            f"research: entries {list(entries)}")
    numbers = _research_outputs(files["out"])
    fsq, lfq = (entries[f"queue[{i}] bridgerl_tpu_torch.cli.diag_{m}"]["stdout"]
                for i, m in ((6, "fsq_spread"), (7, "lfq")))
    fsq_json = json.loads(fsq[-1])
    require(sorted(fsq_json) == ["nominal", "ratio", "uniq", "z_e_std", "zp_std"]
            and fsq_json["nominal"] == 1000 and len(fsq_json["zp_std"]) == 4,
            f"research: diag_fsq_spread {fsq[-3:]}")
    require(any(line.startswith("live bits:") for line in lfq)
            and lfq[-1].startswith("z_e variance expressible"), f"research: diag_lfq {lfq[-3:]}")

    takes = load_takes(files["data"])
    tokens = {}
    n32 = RESEARCH_CPU_TAKES["float32"]
    card32 = _research_tokens(files, "float32", "cuda", takes[:n32])[2:4]
    tokens["float32"] = {"takes": n32, "positions": int(card32[1].sum()),
                         "codes_agree": _codes_equal("research f32 tokens", card32,
                                                     cpu["float32"])}
    require(tokens["float32"]["codes_agree"] >= CODES_AGREE,
            f"research: f32 codes agree on {tokens['float32']['codes_agree']}")
    n16 = RESEARCH_CPU_TAKES["bfloat16"]
    card16 = _research_tokens(files, "bfloat16", "cuda", takes[:n16])[2:4]
    valid = cpu["bfloat16"][1] > 0
    rows = lambda grids: {"grid": np.ascontiguousarray(grids[:n16][valid])}   # noqa: E731
    shares, _ = _codes_rule("research bf16 tokens", rows(card16[0]), rows(cpu["bfloat16"][0]),
                            rows(cpu["float32"][0]))
    tokens["bfloat16"] = {"takes": n16, "positions": int(valid.sum()), **shares}
    with open(os.path.join(files["out"], "ar", "summary.json")) as f:
        ceiling = json.load(f)["ceiling"]
    ceiling_err = max(abs(ceiling[k] - v) for k, v in cpu["ceiling"].items())
    require(ceiling_err <= RESEARCH_CEILING_ATOL,
            f"research: exp_prior_ar's ceiling {ceiling_err} from the CPU's")

    total = add_launches(*(e["launches"] for e in entries.values()))
    for name in (attention.ENTRY["fwd", torch.float32], attention.ENTRY["bwd", torch.float32],
                 attention.ENTRY["fwd", BF16], "vq_assign"):
        require(total[name] > 0, f"research: {name} never launched: {total}")
    line = {"phase": "research", "card": smi,
            "entries": {label: {"seconds": e["seconds"], "launches": e["launches"]}
                        for label, e in entries.items()},
            "child_s": child_s, "cpu_tokenize_s": cpu["seconds"],
            "json_numbers_checked": numbers, "tokenize": tokens,
            "ceiling_max_abs_err_vs_cpu": ceiling_err, "reduced": RESEARCH_REDUCED,
            "launches": total, "research_path_s": time.perf_counter() - t0}
    emit(line)
    return line


def native_path(smi: str) -> dict:
    """The host's native runtime (``runtime/native.py`` over
    ``csrc/motiondata.cpp``): the g++ build's seconds (built anew), then each
    function on seeded inputs of the studies' size, bit for bit equal to its
    numpy version (``mean_std`` within 1e-6): npy v1 and v2 loads of a
    6,400-frame take, its W64 windows at stride 32, their statistics, a
    permutation of 65,536 and the windows normalised."""
    t0 = time.perf_counter()
    native.ensure_built(rebuild=True)
    build_s = time.perf_counter() - t0
    take = np.random.default_rng(SEED + 31).normal(size=(6400, 29)).astype(np.float32)
    equal = {}
    with tempfile.TemporaryDirectory() as d:
        for version in ((1, 0), (2, 0)):
            path = os.path.join(d, f"take_v{version[0]}.npy")
            with open(path, "wb") as f:
                np.lib.format.write_array(f, take, version=version)
            equal[f"load_npy_f32_v{version[0]}"] = np.array_equal(
                native.load_npy_f32(path), native.load_npy_f32_numpy(path))
    wins = native.slice_windows(take, 64, 32)
    equal["slice_windows"] = np.array_equal(wins, native.slice_windows_numpy(take, 64, 32))
    mean, std = native.mean_std(wins)
    stats_err = max(float(np.abs(a - b).max())
                    for a, b in zip((mean, std), native.mean_std_numpy(wins)))
    equal["shuffle_indices"] = np.array_equal(native.shuffle_indices(65536, 42),
                                              native.shuffle_indices_numpy(65536, 42))
    equal["normalize_inplace"] = np.array_equal(native.normalize_inplace(wins.copy(), mean, std),
                                                native.normalize_inplace_numpy(wins, mean, std))
    require(all(equal.values()) and stats_err <= 1e-6,
            f"native: {equal}, mean_std {stats_err} from numpy")
    line = {"phase": "native", "card": smi, "build_s": build_s, "bit_equal": equal,
            "mean_std_max_abs_err": stats_err, "windows": list(wins.shape),
            "native_s": time.perf_counter() - t0}
    emit(line)
    return line


# ---------------------------------------------------------------- data_parallel

def dp_exp(case: str):
    arch, method, mode, _, dropout, _ = DP_CASES[case]
    packing = {"attn_packing": 8} if arch == "transformer" else {}
    return make_experiment(arch, method, window=10, mode=mode, dropout=dropout,
                           batch_size=DP_BATCH, accum_chunks=DP_ACCUM, **packing)


def dp_data(device) -> tuple:
    """Seeded normal windows and the (DP_STEPS, DP_BATCH) index matrix."""
    rng = np.random.default_rng(SEED + 3)
    n = DP_BATCH * DP_STEPS
    robot, human = (torch.from_numpy(rng.normal(size=(n, 10, d)).astype(np.float32)).to(device)
                    for d in (29, 126))
    return robot, human, torch.from_numpy(rng.permutation(n).reshape(DP_STEPS, DP_BATCH)).to(
        device)


def state_digest(model) -> str:
    """sha256 of every parameter's and buffer's bytes: equal digests, equal bits."""
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _reorder(idx: torch.Tensor, order: str) -> torch.Tensor:
    """The (steps, batch) index matrix with each microbatch's rows in
    ``order`` (DP_ORDERS, or "given"): the same batches, summed in another
    order."""
    if order == "given":
        return idx
    mb = idx.reshape(idx.shape[0], DP_ACCUM, -1)
    half = mb.shape[-1] // 2
    mb = (torch.cat([mb[..., half:], mb[..., :half]], -1) if order == "halves_swapped"
          else mb.flip(-1))
    return mb.reshape(idx.shape)


def dp_steps(case: str, device, order: str = "given") -> dict:
    """One case of the data_parallel phase through make_train_epoch, one
    call an optimizer step, on a rank (with its share of each microbatch)
    or in this process (each microbatch's rows in ``order``): the logs of
    each step, the gradients the first leaves (where kept), the EMA and
    BatchNorm state, a digest of every parameter and buffer, the K1 seeds
    drawn, the launches and seconds."""
    _, _, mode, steps, _, keep_grads = DP_CASES[case]
    exp = dp_exp(case)
    model = init_model(exp.model, SEED, device=device)
    parallel.broadcast_module(model)
    opt = make_optimizer(model, exp)
    train_epoch = make_train_epoch(exp)
    robot, human, idx = dp_data(device)
    idx = _reorder(idx, order)
    gen = fork_for_rank(epoch_generator(SEED, 0, device), SEED, 0)
    draw, seeds = attention.draw_seed, []

    def recording_draw(generator, dev):
        out = draw(generator, dev)
        seeds.append(out)
        return out

    logs, grads, step_s = [], None, []
    attention.draw_seed = recording_draw
    kernels.reset_counters()
    try:
        for step in range(steps):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            logs.append(train_epoch(model, opt, robot, human, idx[step:step + 1], gen))
            torch.cuda.synchronize(device)
            step_s.append(time.perf_counter() - t0)
            if step == 0:
                first = _dp_state(model)
                if keep_grads:
                    grads = {n: p.grad.detach().cpu().numpy()
                             for n, p in model.named_parameters()
                             if p.grad is not None and p.requires_grad}
    finally:
        attention.draw_seed = draw
    counts = launches()
    return {"logs": logs, "grads": grads, "launches": counts, "step_seconds": step_s,
            "windows_per_step": DP_BATCH // parallel.world_size(),
            "state_first": first, "state": _dp_state(model),
            "digest": state_digest(model), "k1_seeds": [int(s[0]) for s in seeds]}


def _dp_state(model) -> dict:
    """The EMA codebook and BatchNorm state, as numpy."""
    return {k: v.detach().cpu().clone().numpy() for k, v in model.state_dict().items()
            if k.endswith(DP_STATE)}


def dp_rank(cases) -> list:
    """A rank of the data_parallel phase (parallel.launch's target)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.build_all()
    return [dp_steps(case, parallel.active().device) for case in cases]


def _dp_expected(case: str) -> dict:
    """K1-fwd, K1-bwd and K2 launches of a case's run on one rank: every
    microbatch share runs the whole model (train_path's counts)."""
    arch, method, mode, steps, _, _ = DP_CASES[case]
    per = PER_MICROBATCH[mode] if arch == "transformer" else (0, 0, 1)   # one EMA VQ
    names = (attention.ENTRY["fwd", torch.float32], attention.ENTRY["bwd", torch.float32],
             "vq_assign")
    want = {name: 0 for name in kernels.COUNTERS}
    want.update({name: steps * DP_ACCUM * m for name, m in zip(names, per)})
    return qkv_want(want)


def _feeds_batchnorm(name: str) -> bool:
    """A residual block's convolution bias, which a BatchNorm follows."""
    return ".net.0.bias" in name or ".net.3.bias" in name


def _dp_gaps(got: dict, want: dict) -> dict:
    """``got``'s distance from ``want``: the largest relative difference of
    the logs; each gradient of the first step, max|dg| / (1 + max|g|); each
    EMA / BatchNorm state key, its largest |d| after the first step and
    after the last."""
    require(sorted(got["grads"]) == sorted(want["grads"]), "gradient sets differ")
    return {"loss": max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-12)
                        for g, w in zip(got["logs"], want["logs"]) for k in w),
            "grads": {k: float(np.abs(got["grads"][k] - w).max()) / (1.0 + float(np.abs(w).max()))
                      for k, w in want["grads"].items()},
            "first": {k: float(np.abs(got["state_first"][k] - w).max())
                      for k, w in want["state_first"].items()},
            "last": {k: float(np.abs(got["state"][k] - w).max())
                     for k, w in want["state"].items()}}


def _dp_spread(runs: list, want: dict) -> dict:
    """Key by key, the largest _dp_gaps of ``runs`` (one process, its rows
    in DP_ORDERS) from ``want`` (the given order)."""
    gaps = [_dp_gaps(run, want) for run in runs]
    return {part: {k: max(g[part][k] for g in gaps) for k in gaps[0][part]}
            for part in ("grads", "first", "last")}


def _worst(over: dict) -> tuple:
    return max((v, k) for k, v in over.items())


def _dp_rule(what: str, got: dict, want: dict, spread: dict = None) -> dict:
    """Case (b)'s rule: each step's logs within DP_LOSS_RTOL relative, the
    first step's gradients within DP_GRAD_ATOL * (1 + max|g|), the EMA and
    BatchNorm state within DP_STATE_ATOL after the first step (both runs
    started from the same bits) and after the last.

    With ``spread`` (the BatchNorm case: _dp_spread, what taking the same
    batches in other row orders moves one process's own run) the gradients
    and the state after the last step may also lie up to DP_ORDER_FACTOR
    times the largest such move away. The BatchNorm tower's backward cancels (a
    convolution bias that feeds a BatchNorm has a true gradient of exactly
    0; zoo_agree reads the same of the row order on the CPU), so rounding
    decides the sign of such a gradient. Adam's first step moves every
    parameter by lr times that sign: the runs leave step 1 up to 2 lr
    apart there, and after it a row near a code tie moves ema_w by
    (1 - decay) |x|. One process in another row order meets the same."""
    gaps = _dp_gaps(got, want)
    require(gaps["loss"] <= DP_LOSS_RTOL, f"{what}: logs off by {gaps['loss']} relative: "
            f"{got['logs']} vs {want['logs']}")
    first, first_key = _worst(gaps["first"])
    require(first <= DP_STATE_ATOL, f"{what}: {first_key} off by {first} after step 1")
    out = {"loss_rel_err": gaps["loss"], "state_err_step1": first}
    for part, band in (("grads", DP_GRAD_ATOL), ("last", DP_STATE_ATOL)):
        err, key = _worst(gaps[part])
        limit = max(band, DP_ORDER_FACTOR * _worst(spread[part])[0]) if spread else band
        require(err <= limit, f"{what}: {key} off by {err} (limit {limit}"
                f"{', from the row-order spread' if limit > band else ''}) "
                f"{'in the first step' if part == 'grads' else 'after the last step'}")
        name = "grad" if part == "grads" else "state_last"
        out[f"{name}_err"], out[f"{name}_worst"], out[f"{name}_limit"] = err, key, limit
        if spread:
            out[f"{name}_order_spread"] = _worst(spread[part])
    rel, rel_key = max((float(np.linalg.norm(got["grads"][k] - w))
                        / max(float(np.linalg.norm(w)), 1e-30), k)
                       for k, w in want["grads"].items() if not _feeds_batchnorm(k))
    out["grad_rel_norm_err"], out["grad_rel_norm_worst"] = rel, rel_key
    return out


def _dp_equal(what: str, got: dict, want: dict) -> None:
    """Bit-equal runs: logs, gradients, every parameter and buffer."""
    require(got["logs"] == want["logs"], f"{what}: logs {got['logs']} vs {want['logs']}")
    if want["grads"] is not None:
        require(all(np.array_equal(got["grads"][k], w) for k, w in want["grads"].items()),
                f"{what}: gradients differ")
    require(got["digest"] == want["digest"], f"{what}: parameters or buffers differ")


def _dp_rate(run: dict) -> float:
    """Windows a second of one process or rank, over the steps after the first."""
    timed = run["step_seconds"][1:]
    return run["windows_per_step"] * len(timed) / sum(timed)


def data_parallel_path(smi: str) -> dict:
    """Data-parallel training (``parallel/``) at the flagship's full width:
    DP_CASES on DP_RANKS ranks sharing the card over gloo and DP_NCCL_CASES
    on one NCCL rank, started together and run while this process runs
    every case alone (the reference): the gloo ranks under case (b)'s rule
    and bit-equal to each other, the NCCL rank bit-equal to this process;
    at dropout 0.1 the ranks' K1 keep masks differ; every rank launches K1
    and K2 in each microbatch share."""
    import chip_smoke as this   # the ranks import the script's functions by name

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        gloo = pool.submit(parallel.launch, this.dp_rank, DP_RANKS, "gloo",
                           args=(list(DP_CASES),), device="cuda", timeout=DP_TIMEOUT_S)
        nccl = pool.submit(parallel.launch, this.dp_rank, 1, "nccl",
                           args=(list(DP_NCCL_CASES),), timeout=DP_TIMEOUT_S)
        one = {case: dp_steps(case, torch.device("cuda")) for case in DP_CASES}
        spread = _dp_spread([dp_steps("batchnorm", torch.device("cuda"), order)
                             for order in DP_ORDERS], one["batchnorm"])
        ranks = [dict(zip(DP_CASES, r)) for r in gloo.result()]
        world1 = dict(zip(DP_NCCL_CASES, nccl.result()[0]))
    emit({"phase": "data_parallel_gaps", "card": smi,
          "batchnorm_order_spread": {part: _worst(v) for part, v in spread.items()},
          "gloo": {case: [{part: _worst(v) if isinstance(v, dict) else v
                           for part, v in _dp_gaps(rank[case], one[case]).items()}
                          for rank in ranks] for case in DP_CASES if case != "dropout"}})
    checks, total = {}, {name: 0 for name in kernels.COUNTERS}
    for case in DP_CASES:
        want = _dp_expected(case)
        runs = [rank[case] for rank in ranks]
        for r, run in enumerate(runs):
            require(run["launches"] == want, f"gloo rank {r} {case}: launches "
                    f"{run['launches']}, want {want}")
            require(all(math.isfinite(v) for l in run["logs"] for v in l.values()),
                    f"gloo rank {r} {case}: losses {run['logs']}")
            total = add_launches(total, run["launches"])
        require(all(run["digest"] == runs[0]["digest"] for run in runs),
                f"{case}: the ranks' parameters or buffers differ")
        if case != "dropout":
            checks[case] = [_dp_rule(f"gloo rank {r} {case}", run, one[case],
                                     spread if case == "batchnorm" else None)
                            for r, run in enumerate(runs)]
    for case, run in world1.items():
        require(run["launches"] == _dp_expected(case), f"nccl {case}: {run['launches']}")
        _dp_equal(f"nccl world 1 {case}", run, one[case])
        total = add_launches(total, run["launches"])
    # the first K1 call of each rank at dropout 0.1: another seed, another keep mask
    cfg = dp_exp("dropout").model
    BH = DP_BATCH // DP_ACCUM // DP_RANKS // cfg.attn_packing * cfg.n_heads
    masks = [attention.attention_dropout_mask(run["dropout"]["k1_seeds"][0], BH,
                                              cfg.window_size * cfg.attn_packing, DROPOUT,
                                              "cuda") for run in ranks]
    require(not torch.equal(*masks), "the ranks drew the same K1 keep mask")
    line = {"phase": "data_parallel", "card": smi, "ranks": DP_RANKS, "batch": DP_BATCH,
            "accum_chunks": DP_ACCUM, "rows_per_rank_microbatch": DP_BATCH // DP_ACCUM // DP_RANKS,
            "checks": checks, "nccl_world1_bit_equal": list(world1),
            "dropout_k1_seeds": [run["dropout"]["k1_seeds"][:2] for run in ranks],
            "dropout_mask_differs": int((masks[0] != masks[1]).sum()),
            "launches_by_rank": {f"gloo{r}": {case: {k: v for k, v in run[case]["launches"].items()
                                                     if v} for case in DP_CASES}
                                 for r, run in enumerate(ranks)},
            "teacher_windows_per_s_per_rank": [_dp_rate(run["teacher"]) for run in ranks],
            "teacher_windows_per_s_one_process": _dp_rate(one["teacher"]),
            "teacher_windows_per_s_nccl_world1": _dp_rate(world1["teacher"]),
            "launches": total, "data_parallel_path_s": time.perf_counter() - t0}
    emit(line)
    return line


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    kernels.build_all()
    build_s = time.perf_counter() - t0
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kernel_build_s": build_s})
    print(smi, flush=True)

    g = torch.Generator(device="cuda").manual_seed(SEED)
    table = [check_k1(g), check_k1_bwd(g), *check_k2(g, smi), check_k1(g, BF16),
             check_k1_bwd(g, BF16), *check_k1_qkv(g), *check_k1_qkv(g, BF16)]
    for dtype in DTYPES:
        check_k1_mask(g, dtype)
    check_k1_causal(g, table)
    check_k1_head_dims(g, table)
    table = split_k1_rows(table)
    native_path(smi)

    serve, requests = {}, {}
    for dtype in DTYPES:
        exp = make_experiment("transformer", "hybrid", window=10, attn_packing=8,
                              compute_dtype=DTYPE_NAME[dtype])
        t0 = time.perf_counter()
        serve[dtype], requests[dtype] = main_path(exp)
        emit({"phase": "serve", "card": smi, **serve[dtype],
              "main_path_s": time.perf_counter() - t0})
    emit({"phase": "serve_summary", "card": smi, **{
        f"{DTYPE_NAME[dt]}_{k}": serve[dt][k] for dt in DTYPES
        for k in ("retarget_windows_per_s_b4096", "retarget_p50_ms_b1")}})

    train = {}
    for dtype in DTYPES:
        t0 = time.perf_counter()
        train[dtype] = train_path(smi, dtype)
        emit({"phase": "train_summary", "card": smi, **train[dtype],
              "train_path_s": time.perf_counter() - t0})
    _, cpu32 = train_agree()
    train_agree_bf16(cpu32)
    train_agree_wide()
    t0 = time.perf_counter()
    wide = train_wide(smi)
    emit({"phase": "train_wide_summary", "card": smi, **wide,
          "train_wide_s": time.perf_counter() - t0})

    zoo = zoo_path()
    emit({"phase": "zoo_summary", "card": smi, **zoo})
    zoo_agree()
    # the recipe's children and the studies' queue child run in threads beside the CLI
    # phases, which are children too
    recipe_dir = tempfile.mkdtemp(prefix="chip_smoke_recipe_")
    research_dir = tempfile.mkdtemp(prefix="chip_smoke_research_")
    try:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            recipe_run = pool.submit(recipe_children, recipe_dir)
            research_run = pool.submit(research_background, research_dir)
            cli, workdir = cli_path(smi)
            try:
                serve_trained(workdir, smi)
                cli_ms = cli_multiseed(workdir, smi)
            finally:
                shutil.rmtree(workdir, ignore_errors=True)
            recipe = recipe_path(smi, recipe_dir, recipe_run)
            research = research_path(smi, research_run)
    finally:
        shutil.rmtree(research_dir, ignore_errors=True)
    cli["launches"] = add_launches(cli["launches"], cli_ms["launches"])

    artifact, served = {}, {}
    try:
        for dtype in DTYPES:
            artifact[dtype], served[dtype] = artifact_path(smi, dtype)
        http = decode_http(smi, served[torch.float32][0])
        stream = stream_path(smi, served[torch.float32][0])
        demo = demo_stream_path(smi, served[torch.float32][0])
    finally:
        for _, _, artifact_dir in served.values():
            shutil.rmtree(artifact_dir, ignore_errors=True)
    multiseed = multiseed_path(smi)
    int8 = int8_path(smi)
    prior, (prior32, vq, vq_exp, grids, _) = prior_path(smi)
    generate = generate_path(smi, prior32, vq, vq_exp, grids)
    generator = generator_artifact_path(smi, prior32, vq, vq_exp)
    prior_long = prior_long_path(smi, vq, vq_exp)
    prior_wide = prior_wide_path(smi, vq, vq_exp)
    prior_dh256 = prior_dh256_path(smi, vq, vq_exp)
    prior_dh48 = prior_dh48_path(smi, vq, vq_exp)
    del prior32, vq
    latent = latent_path(smi)
    imported, import_dir = torch_import_path(smi)
    try:
        runners_path(smi, os.path.join(import_dir, "reference_best.pth"))
    finally:
        shutil.rmtree(import_dir, ignore_errors=True)
    csv_path(smi)
    replay_path(smi)
    dp = data_parallel_path(smi)
    replay_profile(smi)
    # the phases with profiler sessions come last, so that no timed phase
    # runs after them (PERF.md §6: bf16 serving timed after one read slower)
    fk = fk_path(smi)
    multiseed_breakdown(smi)
    multiseed_agree()
    for dtype in DTYPES:
        emit({"phase": "attention_ops", "card": smi, **attention_ops(dtype)})
    for dtype in DTYPES:
        emit({"phase": "profile", "card": smi, **train_breakdown(dtype)})
    if "--profile" in argv:
        for dtype in DTYPES:
            emit({"phase": "profile", "card": smi, "dtype": DTYPE_NAME[dtype],
                  **device_breakdown(*requests[dtype])})
            emit({"phase": "profile", "card": smi, "dtype": DTYPE_NAME[dtype],
                  "via": "artifact", **device_breakdown(ServingApp(served[dtype][0]),
                                                        requests[dtype][1])})

    paths = {"serve": serve[torch.float32], "serve_bf16": serve[BF16],
             "train": train[torch.float32], "train_bf16": train[BF16], "train_wide": wide,
             "zoo": zoo, "cli": cli,
             "artifact": artifact[torch.float32], "artifact_bf16": artifact[BF16],
             "decode_http": http, "stream": stream, "recipe": recipe, "multiseed": multiseed,
             "fk": fk, "int8": int8, "prior": prior, "prior_long": prior_long,
             "prior_wide": prior_wide, "prior_dh256": prior_dh256, "prior_dh48": prior_dh48,
             "generate": generate,
             "generator_artifact": generator, "latent": latent, "torch_import": imported,
             "demo_stream": demo, "data_parallel": dp, "research": research}
    for row in table:
        by_path = {p: row_launches(row, r["launches"]) for p, r in paths.items()}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
        require(row["launches"] > 0, f"{row['name']} was never launched on the main paths")
    # every K1 launch of a model takes the fused layout: on each path each fused counter
    # equals its entry point's, and paths that run a transformer have fused launches
    for p, r in paths.items():
        for key, counter in attention.QKV_COUNTER.items():
            require(r["launches"][counter.name] == r["launches"][attention.ENTRY[key]],
                    f"{p}: {counter.name} {r['launches'][counter.name]}, "
                    f"{attention.ENTRY[key]} {r['launches'][attention.ENTRY[key]]}")
    fused_paths = [p for p, r in paths.items()
                   if any(r["launches"][c.name] for c in attention.QKV_COUNTER.values())]
    require(len(fused_paths) == sum(any(r["launches"][n] for n in attention.ENTRY.values())
                                    for r in paths.values()),
            f"fused launches on {fused_paths} only")
    for direction in ("fwd", "bwd"):
        name = attention.ENTRY[direction, torch.float32] + "_mma"
        by_path = next(r["launches_by_path"] for r in table if r["name"] == name)
        require(all(by_path[p] > 0 for p in MMA_PATHS),
                f"{name}: no launch on one of {MMA_PATHS}: {by_path}")
    for dtype in DTYPES:
        name = attention.LONG_COUNTER["bwd", dtype].name
        by_path = next(r["launches_by_path"] for r in table if r["name"] == name)
        require(by_path["prior_long"] > 0, f"{name}: no launch on prior_long: {by_path}")
    # prior_wide (Dh 96) and prior_dh256 (Dh 256): K1's forward and backward of each dtype,
    # on prior_dh256 the wide kernels', and K2
    for name in [*attention.ENTRY.values(), "vq_assign"]:
        for path in ("prior_wide", "prior_dh256"):
            rows = ((name + "_wide",) if path == "prior_dh256" and name != "vq_assign"
                    else (name, name + "_multi", name + "_mma", name + "_long", name + "_wide"))
            launched = sum(r["launches_by_path"][path] for r in table if r["name"] in rows)
            require(launched > 0, f"{name}: no launch on {path} ({rows})")
    wide_row = next(r for r in table if r["name"] == vq_kernel.wide_counter.name)
    require(wide_row["launches_by_path"]["train_wide"] > 0,
            f"vq_assign_wide: no launch on train_wide: {wide_row['launches_by_path']}")
    # prior_dh48 (Dh 48, the ragged form): K1's window tiles in float32 and multi-window
    # kernels in bf16 (the depth stack) and tensor cores (the backbone: the forward, the
    # window-resident backward) in each dtype, and K2
    short = lambda n: n + ("_multi" if n + "_multi" in kernels.COUNTERS else "")  # noqa: E731
    for name in [*(part for n in attention.ENTRY.values() for part in (short(n), n + "_mma")),
                 "vq_assign"]:
        by_path = next(r["launches_by_path"] for r in table if r["name"] == name)
        require(by_path["prior_dh48"] > 0, f"{name}: no launch on prior_dh48: {by_path}")
    # the bf16 multi-window kernels on every path that runs bf16 K1 below W 32, and no bf16
    # launch left to a window-tile row (bf16 has none)
    for (direction, dtype), counter in attention.MULTI_COUNTER.items():
        by_path = next(r["launches_by_path"] for r in table if r["name"] == counter.name)
        require(all(by_path[p] > 0 for p in MULTI_PATHS[direction]),
                f"{counter.name}: no launch on one of {MULTI_PATHS[direction]}: {by_path}")
        entry = {"name": attention.ENTRY[direction, dtype]}
        tiles = {p: row_launches(entry, r["launches"]) for p, r in paths.items()}
        require(not any(tiles.values()), f"{entry['name']}: window-tile launches {tiles}")
    emit({"phase": "total", "card": smi, "chip_smoke_s": time.perf_counter() - t_start})
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
