#!/usr/bin/env python3
"""Drive the PyTorch port (``cnn_autoencoder_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, in order; any failure exits non-zero:

1. Device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; build the CUDA kernels from ``cnn_autoencoder_tpu_torch/csrc``
   (ptxas registers, spills and shared memory logged for every
   instantiation), and check in the built library's SASS that K1 and K2
   (each on float32 and on bf16 rows), K3 and K4 multiply on the tensor
   cores (HMMA);
   meanwhile build K1's, K2's, K3's, K4's and the rANS kernels' probes
   (``csrc/probes``): K1 (and K2 on float32 rows) with one TF32 pass, the
   control that must fail K1's accuracy check; K2 on float32 rows storing
   r from the registers; K1, K2, K3 and K4 without their device-memory
   traffic, to time what the SM spends; K2 and K3 with cycle counts by part
   of a tile; K4 with one pass for its float32 conv and with every mma
   operand in registers; K5 and K6's state pass with clock64 marks around
   their serial loops.
2. Serving kernels: each kernel's wrapper on card tensors at the shapes the
   serving path gives it (16 tiles of 512^2 through the flagship), held
   against its plain PyTorch version on the same inputs, then timed with
   CUDA events beside the plain version and its bound; K1 also at ragged
   rows, every shared-memory layout of its C range and a misaligned row
   pointer, its one-pass control, and its probes' times; K1 on bf16 rows
   at the bf16 round trip's three calls (one bf16 ulp), ragged rows, both
   its layouts and a misaligned row pointer, timed beside cuBLAS's bf16
   product of its shape; K4 in both
   variants and both types at ragged Cin and Cout and at Cout 129 to
   1024 (in bf16 the default route's mode 3: its y held value by value to
   one bf16 ulp of each rounded term it sums, r and out to one ulp of the
   plain GDN of the kernel's y, ``rounded_check``), its probes' times, its
   bf16 serving variant (``conv_gdn_fwd_bf16``) at the round trip's
   shape, and timed at (8, 128, 128, 192) -> 192; K6
   (state pass, compaction) and K5 bit-identical to their plain versions
   at S = 1024, 100, 2048, 3000 and 65535, a peaked table, a 60x60
   plane and 192 channels of 255 values (a table past the state pass's
   shared memory),
   with one state pass compacted at two capacities and whole and cut
   queues, timed at each of these but the peaked table and the plane, and
   their serial chain from the probe.
3. Serving end to end: the flagship checkpoint through ``CAETurboCore``
   (the ``cae_tpu`` codec's batched core), ``encode_tiles`` then
   ``decode_tiles`` on 16 synthetic 512^2 tiles, with launch counts reset
   just before and read just after (K1 3, K4 1, one state pass, one
   compaction per capacity tried, K5 1); then the same tiles through the
   plain versions on the card; then one tile through the ``cae_tpu``
   codec object; then the same tiles through a core of 2048 streams; then
   the device time by operation and the host<->device copies of one more
   round trip (torch.profiler).  Then the decoder's transposed
   convolutions, float32 and bf16, timed three ways (the port's, cuDNN's
   default and cuDNN's deterministic algorithms, the last two timings
   only); then the same round trip in bf16 (a core built with
   ``compute_dtype=torch.bfloat16``), its launches counted on their own
   (K1 on bf16 rows 3, K4 1, K6 and K5 as in float32), symbols lossless,
   the plain versions on the card at bf16 held as in float32, PSNR within
   0.05 dB of the float32 round trip's; three decodes of the same frames
   bit-equal in each precision, with cuDNN's deterministic switch off;
   and the device time by operation of one bf16 round trip.
4. Training kernels: K2, K3 and K4's training variant against their plain
   versions at the training path's shapes (batch 16 of 256^2 through the
   flagship: 262144 and 65536 rows of K2 and K3), float32 and bf16,
   forward and inverse GDN, K2 and K3 also at C = 3, 48, 128, 130, 256 and
   512 with ragged and misaligned rows (K3's dbeta, the float32 dnorm's
   column sums from its partial sums, to 1e-4 of the column sums of
   |dnorm|), K2 at norms below 2^-100; then
   timed by CUDA events (K2's device time beside it), K2 and K3 each beside
   its probes and beside cuBLAS's bf16 product of the same shape (a
   yardstick only).  K2 on float32 rows (``gdn_train_fwd_f32``, the bf16
   mode's GDN after a batch norm; K1's kernel with r) is held to y within
   K1's limit, y equal to K1's and r within one bf16 ulp at the path's
   shapes, the ragged cases and K1's wider layouts (C = 136, 1000, 1552,
   1553), its plan at C = 128 logged and required resident with r tiles,
   its one-pass control required to fail; then timed at (16 x 128^2, 128)
   and (16 x 64^2, 128) beside K1 on the same rows and the build that
   stores r from the registers.
5. Training end to end: the flagship's RateMSE train step (lambda 0.01,
   encoder, decoder and fact_ent trainable, Adam at lr 1e-4; the
   configuration of ``scripts/bench_train.py``), from the flagship
   checkpoint, on a batch of 16 synthetic 256^2 patches, 3 float32 steps
   and 3 bf16 steps with launch counts reset just before and read just
   after each run; every trainable parameter's step-1 gradient finite and
   non-zero; the same steps with the same noise through the plain versions
   on the card, losses held to the kernels' run; then the step time, an
   eval step and the device time by operation of one more step.
6. Host coder and every CAE codec: (a) build the host rANS library
   (``coding/csrc/rans.cpp``, ``g++``) and hold it byte for byte to the
   plain Python coder on one 64^2 crop's symbols, with and without
   escapes; (b) the 16 flagship 512^2 tiles through ``CAECodecCore`` (the
   ``cae`` codec's core): symbols equal to ``CAETurboCore``'s, lossless
   host coding, reconstructions bit-equal to the turbo decode, encode and
   decode MP/s with the host coder's ms and bytes a tile, in float32 and
   again in bf16 (symbols equal to the bf16 turbo core's, two decodes
   bit-equal, reconstructions bit-equal to its turbo decode); (c) the
   fallbacks to host frames: one symbol out of its table, a flagship copy
   with a scaled encoder, six overflowing capacities at S = 16; (d) one
   decode batch of v4, host and v3 frames and a 500 x 300 tile; (e)
   ``cae_bn`` on one tile's float latent.  Launch counts are reset after
   (b)'s warm-up and read just after its timed round trips, and logged on
   their own: the ``cae`` path launches K1 and K4 and no rANS kernel.
   Nothing sets cuDNN's deterministic switch outside phase 3's timings.
7. The slide: a 4096^2 synthetic slide (``synth_histology``, the port's
   copy of ``bench.py:127``) written as a port zarr store (YXC, 512^2
   chunks, raw), in float32 and again in bf16: (a) ``cae_tpu`` through
   ``compress_pixels_to_cae_turbo`` and ``decompress_cae_turbo_array`` (4
   batches of 16 tiles on the pipeline's worker threads), every chunk equal
   to ``CAETurboCore.encode_tiles`` of the same batches called serially on
   one thread and the image bit-equal to ``decode_tiles`` of those frames,
   then ``roundtrip_cae_turbo`` to the same bytes and image; (b) ``cae``
   through ``compress_pixels_to_cae`` and ``decompress_cae_array`` with the
   same checks against ``CAECodecCore``, then again with the halo
   ``offset = 2**level``; (c) ``cae_bn`` on a 1024^2 crop with a latent
   halo of 2; (d) the compress and decompress CLIs as subprocesses
   (``-cod CAETPU`` and ``-cod CAE``, zarr in and out; the four
   compresses at once, then the four decompresses), their stores
   byte-equal to (a)'s and (b)'s and their images to the pipeline's
   decodes.  Launch counts are reset before each timed compress +
   decompress pass and read after it, logged on their own line and held
   to 4 batches' worth (K1 12, K4 4; ``cae_tpu`` also K6 4 state passes and
   4 compactions plus one per capacity retry, K5 4); they do not enter the
   ``kernels`` line.  Encode and decode MP/s, PSNR, bpp, the round trip's
   MP/s and ``GLOBAL_TIMER.report()`` are printed beside the card's name
   and power limit.  (e) The whole-image fused paths
   (``compress_image_fused`` / ``decompress_image_fused``, chunks of 16
   tiles): every chunk byte-equal to (b)'s store at offset 0, the decode
   bit-equal to its decode, launches exactly 4 chunks' worth (K1 12, K4
   4); encode and decode MP/s beside the pipeline's timed again in the same
   call, and the device busy share of each fused pass (torch.profiler); in
   float32 one fused compress under ``utils/profiling.py:trace``, whose
   file must name K4's and K1's kernels.
8. The training CLI (``cli/train_cae.py``) on the card at the flagship's
   width and depth: 2 synthetic 2048^2 train slides and a 1024^2 val slide
   (``synth_histology``, seeds 11 to 13) as raw zarr stores; (a) ``main``
   in-process with ``-ds Zarr -chk benchmarks/bench_flagship.msgpack -bs 16
   -vbs 16 -ps 256 -s 6 -cs 3 -cr RateMSE``, in float32 and in bf16, launch
   counts reset just before and read just after: exactly K1 and K4
   ``want_y`` a float32 step, K2, K3 and K4 ``want_y`` a bf16 step, K1 (on
   bf16 rows in bf16) and K4 a validation batch, over 7 steps and 3
   validations; (b) the same run through the plain versions on the card,
   per-step losses within 1e-5 relative (float32) and 2e-2 (bf16); (d)
   ``last_`` and ``best_`` written, ``last_`` serving a 512^2 tile through
   ``CAECodecCore``; (e) a resume from the float32 ``last_`` under
   ``--resume-optimizers``: every slot's count, mu and nu equal to the
   saved ones bit for bit, then 3 more steps with their launches; (f)
   ``python -m cnn_autoencoder_tpu_torch.cli.train_cae`` as a subprocess;
   (g) ms per step and images/s beside phase 5's bare step, the loader's
   host time a batch and the peak memory.
9. Energy compaction, multiscale training, the reference ``.pth`` import
   and coarser reconstructions, at the flagship's width: (a) the flagship
   written as a reference-layout ``.pth`` (this script's inverse of the
   importer's GDN unit layout), loaded by ``autoencoder_from_state_dict``:
   weights equal to the msgpack model's, phase 3's 16 tiles through
   ``CAETurboCore`` with frames byte-equal and decodes bit-equal to the
   msgpack model's (launches counted), and ``cli.compress -chk <.pth>`` on
   the 4096^2 slide (in-process) writing the msgpack model's chunks; (b)
   ``cli/train_cae.py -cr MultiscaleRateMSSSIM -dl 0.01 0.01 0.01`` from
   the flagship with color layers fit by least squares to its decoder's
   features of the val slide on phase 8's slides, batch 16
   x 256^2, float32 and bf16: MS-SSIM windows 11 / 9 / 7 and paddings 0 /
   8 / 24, launches exactly the steps' and validations' worth, losses
   against the plain versions' run (1e-5 / 2e-2), every color layer's
   step-1 gradient finite and non-zero; (c) ``-cr RateMSEPA`` and
   ``RateMSEPB`` with ``-ss 3`` and energy limits that keep every batch
   iterating, float32 and bf16: 3 sub-steps a batch as in the plain
   versions' run, launches exactly the sub-steps' worth (PB's one-hot
   decode adds 2 K1 a sub-step in float32, 2 K2 and 2 K3 in bf16, and 2 K1
   a validation batch), losses as in (b); (d) a 'cae_bn' store of the
   slide from (b)'s float32 ``last_`` decoded by ``cli.decompress -rl 2``
   and ``-rl 1`` (2048^2 and 1024^2), twice in-process with K1's launches
   counted and bit-equal.  The
   ms per sub-step and peak memory of (b) and (c) are printed beside
   phase 8's RateMSE step.
10. The remaining architecture options at the flagship's widths (128 /
   48, 3 levels, GDN): R (residual units, ``-res``) and B (batch norm and
   dropout 0.1, ``-bn -do 0.1``), each from the flagship's trained layers
   (R's residual branches from seed 0 at a hundredth of their scale, B's
   batch norms set to the identity on the flagship's features of the val
   slide); (a) the train CLI on phase 8's slides, batch 16 x 256^2, 3
   steps and 1 validation, float32 and bf16: launches exact (R: 8 GDN
   kernels a step and a validation batch; B: 4, and its bf16 step runs K2
   on float32 rows, its bf16 validation K1 on float32 rows), losses against the plain versions' run (1e-5 / 2e-2, floored
   elements left out), every step-1 gradient finite and non-zero (batch
   norms' scale and bias included), B's running statistics moved by step 1
   and equal to the plain run's, the same dropout masks in both runs; (b)
   each float32 ``last_`` (loaded in train mode) through ``CAETurboCore``
   on phase 3's 16 tiles in float32 and bf16: launches exact, symbols
   lossless, two decodes bit-equal, the plain versions within phase 3's
   tolerances; (c) R's bare step with and without remat, float32 and
   bf16, cuDNN deterministic for the comparison: loss within 1e-6, every
   parameter within 1e-5, the recompute's launches, peak memory of both;
   (d) a grouped GDN model (3 / 3 / 3, seed 0) through the 'cae' core's
   device encode and decode, K1 at C = 3 on 16 x 256^2 rows, against the
   plain versions.  The ms per step and peak memory of (a) are printed
   beside phase 8's RateMSE step.
11. Evaluation and the compressed-domain heads on the frozen flagship:
   (a) the RD harness (``cli/test_cae.py:test_cae``) over phase 7's 4096^2
   slide, patch 512, float32 and bf16: the stats file's keys exactly the
   JAX harness's, launches exactly 4 batches' worth (K1 12, K4 4), bpp
   within 0.1 %, PSNR within 0.01 dB, SSIM, MS-SSIM and delta-E within
   1e-4 of the same run through the plain versions, its seconds, the round
   trip's MP/s and each metric's seconds; (b) a ViT-B/16 head (768, 12
   heads, MLP 3072, cut 6, 10 classes) trained through the train CLI
   (``-cr RateMSECE -cmt ViT -ccp 6 -trm class_model``) on a synthetic
   10-class set in the CIFAR-10 pickle layout, batch 64 of 32^2, 3 steps
   and 1 validation per mode: launches exact (the codec's serving kernels,
   K1 3 and K4 1 a step and a validation batch), losses against the plain
   versions' run (1e-5 / 2e-2), every step-1 head gradient finite and
   non-zero (the attention's key biases, whose exact gradient is 0,
   finite), the encoder bit-equal after training; then
   ``cli/test_cae_classifier.py`` on its checkpoint: the prediction tree's
   groups, classes equal to the plain run's where the scores are not
   tied, the metrics equal to its within what the tied images can move;
   (c) a JNet segmenter (the CLI's 128 / 48 / 1) trained with BCE on
   phase 8's slides with a label group, batch 16 x 256^2, checked as (b),
   then the harness with ``-ccm`` on the val slide at the threshold that
   marks the labels' share of pixels positive, twice and through the
   plain versions: ROC arrays, ``auc``, the object-level metrics with
   true positives, both runs bit-equal, scores, classes and metrics
   against the plain run's; (d) ViT-B/16
   cut 6, ResNet-152 cut 3, InceptionV3 with its cut from the patch size
   and JNet on the flagship's latent of 16 x 256^2, float32 and bf16: ms,
   device busy share and peak memory.
12. The pixel transport (``coding/pixel_rans.py``, ``coding/pixel_pack.py``,
   ``coding/link_probe.py``) at full width on phase 7's 4096^2 slide
   (``synth_histology``, seed 0): (a) K6 (state pass, compaction) and K5 at
   the transport's geometry, (16, 768, 1024) with one channel of 256
   values, on the zigzag residuals of the slide's first batch under the
   table the coded upload calibrates from it: bit-identical to the plain
   versions as in phase 2, the transport's words equal to the host C++
   coder's, decoded back to the tiles by K5 and by the host, timed beside
   the plain versions and the byte bound; (b) ``cae`` and ``cae_tpu`` in
   float32 and ``cae_tpu`` in bf16 through the pipeline, untransported,
   with ``CAE_TPU_CODED_UPLOAD=1``, and with ``CAE_TPU_PACKED_FETCH=1``
   under ``CAE_TPU_FETCH_CODEC=rans`` (a fresh transport, then the
   persisted one) and ``pack``: chunks equal to the untransported store's,
   pixels equal to the raw fetch's, launches exact, no overflow; MP/s,
   link bytes each way, bits a value, the host coder's stage seconds; then
   the link probe's rates and what ``auto`` chooses.  The transport's K5
   and K6 launches enter the ``kernels`` line.
13. The data mesh on the one card (two shards or two ranks on it; several
   cards cannot be checked on a machine with one): (a) phase 3's 16 tiles
   and a ragged 13 through ``CAETurboCore`` and ``CAECodecCore`` over
   ``create_mesh(data=2, devices=["cuda:0", "cuda:0"])``, float32 and
   bf16: frames byte-equal to the one-device cores', decodes bit-equal,
   symbols lossless, launches exact per shard (K4 2, K1 6, K6's state
   pass 2, K5 2 a round trip); the rANS fetch's ``(2, head_words)`` head
   decoded to the raw fetch's pixels; the plain versions on a two-shard
   CPU mesh within phase 3's tolerances; MP/s and busy share beside the
   one-device cores'; ``serving_mesh()`` None; (b) the train CLI's
   ``main`` over ``devices=["cuda:0", "cuda:0"]`` (two spawned ranks over
   gloo) against one process, flagship float32 and bf16 and B bf16, 3
   steps and a validation: losses, every rank's launches, step-1
   gradients, B's running statistics, only rank 0 writing; ms a step and
   the gradient all-reduce's ms; (c) NCCL at world size 1 in a subprocess
   started from ``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES=1`` /
   ``PROCESS_ID=0``: one all-reduce and one CLI step.
14. The offline tools (``cnn_autoencoder_tpu_torch/tools``,
   ``utils/manifold.py``), which import no JAX: (a)
   ``refit_quantiles`` as a subprocess on a copy of the flagship, its file
   byte-equal to an in-process refit's, then served through
   ``CAETurboCore`` on phase 3's 16 tiles with phase 3's checks (launches
   exact, symbols lossless, the plain versions within its tolerances),
   bpp before and after; (b) ``transfer_weights -m torch2jax`` on phase
   9's reference ``.pth``, its file byte-equal to an in-process
   conversion's and its model serving frames byte-equal to the msgpack
   model's (launches counted), ``cae2cai`` then ``cai2cae`` on the
   ``.pth`` giving back every encoder and decoder key and tensor; (c) the
   flagship's latent of phase 7's 4096^2 slide (its encoder on 4 batches:
   K4 and K1 4 each) as two zarr arrays, ``compute_embeddings`` (PCA,
   t-SNE, Isomap) at 2000 points a store and 500 iterations on the card,
   each timed, ``select_in_rect`` mapped back to the stores, and the same
   functions on the CPU at 150 points a store (PCA and Isomap within 1e-5
   up to sign, 30 t-SNE iterations from one start within 1e-6, a full
   t-SNE's KL within 10 %); (d) ``compute_metrics``' array function on
   phase 3's tiles and their round trip through the converted model, card
   against CPU (1e-10, MS-SSIM 1e-5), its stats file dumped by
   ``dump_metrics_jpeg`` and the CSV rows checked; (e) ``compute_mask``,
   ``compute_labels``, ``zarr2dataset``, ``compare_compressors`` (on the
   latent's first 64 rows) and ``dump_training_stats`` (on the log and
   checkpoint of a one-step train CLI run, counted) as subprocesses, each
   output equal to the same function's in-process.
15. The JAX package's precisions and precision switches: (a) K4 in
   modes 1 (the Pallas function in bf16), 4 (float32 rows, one bf16 pass)
   and 5 (bf16_3x) at the flagship's (16, 256, 256, 128) -> 128 and at
   (2, 18, 14, 72) -> 41, its bf16 default route (modes 3 and 2) re-timed
   beside them (``rounded_check`` on the training variant, the serving
   variant's out equal to its), K1 and K2 on bf16 rows with the float32
   pool at (16 256^2,
   128), (16 128^2, 128) and (77, 131), each against its plain version,
   timed against its bound; (b) phase 3's 16 tiles through
   ``CAETurboCore`` and ``CAECodecCore`` at "default", at "high", and in
   bf16 with ``CAE_TPU_BF16_ACTIVATIONS=0``, ``CAE_TPU_GDN_FAST=0``,
   ``CAE_TPU_NATIVE_CONV_OUT=0`` and ``CAE_TPU_PALLAS=1``: launches exact,
   symbols lossless, phase 3's tolerances against the plain versions,
   decodes bit-equal, bpp and |delta PSNR| against float32 (0.05 dB); (c)
   phase 5's bf16 step under ``CAE_TPU_GDN_FAST=0`` (the down stage
   unfused: K2 with the float32 pool 4, K3 4 a step), losses against the
   plain versions within 2e-2, step-1 gradients finite and non-zero; (d)
   one float32 flagship step under each ``CAE_TPU_ANALYTIC_ENT`` mode,
   gradients against mode 0's within 3e-2 of each tensor's max, ms a step.
16. Training at the low precisions, the polyphase conv and the RD sweep:
   (a) K4's training variant in modes 4 (``conv_gdn_train_fwd_bf16x1``)
   and 5 (``..._bf16x3``) at (16, 128, 128, 128) -> 128 and at (2, 18,
   14, 72) -> 41 against ``conv_gdn_train_plain`` (out and y within 1e-4
   of max |out| and max |y|), timed against the plain version and the
   bound; (b) phase 5's float32 step at "default" and at "high", 3 steps
   each: launches exact (K1 3, K4 ``want_y`` in mode 4 or 5 1 a step),
   every step-1 gradient finite and non-zero, losses against the plain
   versions' run (``LOW_PRECISION_LIMITS``: "high" within 1e-5, "default",
   whose operands are rounded to bf16, within the bf16 mode's 2e-2), ms a
   step and device time; (c) the train CLI's ``main`` at ``CAE_TPU_PRECISION=default`` on
   phase 8's slides, 2 steps and a validation, launches exact, losses as
   (b)'s at "default";
   (d) ``CAE_TPU_POLYPHASE_CONV=1`` in bf16: phase 3's 16 tiles through
   both cores as in phase 15 (b) (K1 on bf16 rows 4, no K4, a round trip)
   and one bf16 step (K2 4, K3 4) within 2e-2 of the plain versions'; (e)
   the RD sweep's CAE half (``tools/rd_sweep.py:run_cae``, bf16 as
   ``CAE_TPU_PRECISION`` is unset) on 2 zarr holdouts of 1024^2, launches
   exact, and its merge: the CSV row the harness's stats as formatted.
17. The model mesh axis (channel tensor parallelism) on the one card,
   ranks over gloo: (a) the train CLI's ``main`` over ``devices=["cuda:0"]
   * 2`` under ``CAE_TPU_MODEL_PARALLEL=2`` (data 1 x model 2), flagship
   float32 and bf16, 3 steps and a validation, against one process:
   losses within 1e-5 / 2e-2 relative, every rank's launches one
   process's, step-1 gradients finite and non-zero, only rank 0 writing,
   ``last_`` with one process's keys and shapes and served through
   ``CAETurboCore`` on phase 3's 16 tiles with phase 3's checks; ms a step
   and a rank's parameter bytes beside one process's; (b) phase 5's float32
   step over a (2, 2) mesh of four ranks (subprocesses), 3 steps against
   one process within 1e-5, launches exact per rank, ms a step, the model
   axis's gathers and partial sums timed in a fourth step, a rank's
   parameter and optimizer bytes; (c) phase 3's 16 tiles through both
   cores over a (2, 2) mesh, float32 and bf16: frames byte-equal to one
   device's, launches a data shard as phase 13 (a) counts them.  (b)'s
   ranks start once phase 8's slides and phase 10's R and B checkpoints
   are written, and go on to phase 18 (a).
18. The model axis for the other architectures, in phase 17 (b)'s four
   ranks (data 2 x model 2): (a) the bare step, 3 Adam steps each against
   one process, of R and B at the flagship's widths from phase 10's
   checkpoints (float32 and bf16), the grouped model at 4 / 4 / 4 from
   seed 0 (float32; its kernels shard by whole groups), and phase 11's
   ViT (64 of 32^2) and JNet heads trained alone on the frozen flagship,
   8 x 256^2 (4 rows a data index); then the eval forwards of phase 11
   (d)'s ResNet-152 cut 3 and InceptionV3 on 2 latents (one a data
   index), their norms' leaves and InceptionV3's running statistics held
   as shards: losses within 1e-5 / 2e-2 relative (floored elements left
   out, as phase 9), launches a rank exactly one process's and the
   table's, step-1 gradients finite and non-zero (the attention's key
   biases finite), B's running statistics after step 1 within 1e-4 of
   one process's, logits within 1e-4 of the largest; ms a step, the
   axis's gathers and partial sums timed in a fourth step, a rank's
   parameter, buffer and optimizer bytes; (b) B in bf16 through the train
   CLI under ``CAE_TPU_MODEL_PARALLEL=2`` (data 1 x model 2), 3 steps and
   a validation: launches a rank, both ranks' losses equal, only rank 0
   writing, ``last_`` with one process's keys and shapes (running
   statistics included), served through ``CAETurboCore`` as phase 10 (b)
   serves, and over a (2, 2) mesh with frames byte-equal to one device's.
19. One JSON line ``{"kernels": [...]}`` (launches summed over the counted
   runs of phases 3, 5, 8 (a), 9, 10, 11, 12 (b), 13, 14, 15 (b), (c),
   16 (b)-(e), 17 and 18), then the last line ``{"ok": true, "device":
   {...}}``.

It needs a CUDA card and the repository around it; without either it exits
non-zero and prints no result.
"""

import contextlib
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(ROOT, "benchmarks", "bench_flagship.msgpack")
TILES = 16          # tiles of 512^2 in the serving batch
TRAIN_BATCH, TRAIN_PATCH, TRAIN_STEPS, TRAIN_LR = 16, 256, 3, 1e-4
TIMED_STEPS = 10

# H100 SXM peaks (NVIDIA data sheet; at the full 700 W power limit)
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12        # float32 on the CUDA cores (no tensor cores)
PEAK_BF16_S = 989e12      # bf16 on the tensor cores, dense
PEAK_TF32_S = 495e12      # TF32 on the tensor cores, dense
# 32-bit integer operations issue on 64 of the 128 lanes of each SM
# (Hopper white paper): half the float32 rate
PEAK_I32_S = PEAK_F32_S / 2
# K1 against gdn_plain, max relative error: the three-pass kernel reads
# about 1.2e-6 at most, one TF32 pass about 1e-5
K1_REL_LIMIT = 3e-6
# the rANS state pass stages its table (8 bytes an entry, 4 an offset) in
# shared memory up to this size (kEncSmemMax, csrc/rans.cu)
ENC_SMEM_MAX = 200 * 1024
K1_PROBE_SOURCE = os.path.join(ROOT, "cnn_autoencoder_tpu_torch", "csrc",
                               "probes", "gdn_tc_probe.cu")
# K1's probe builds and their defines (csrc/gdn_tc.cu)
K1_PROBES = {"one_pass": ["-DGDN_TC_PASSES=1"],
             "no_io": ["-DGDN_TC_NO_IO=1"],
             "no_io_one_pass": ["-DGDN_TC_NO_IO=1", "-DGDN_TC_PASSES=1"]}
# K2 on float32 rows (the same source): r stored from the registers, the
# design its r tile is timed against
K2F_PROBES = {"k2f_r_regs": ["-DGDN_TC_R_TILE=0"]}
K4_PROBE_SOURCE = os.path.join(ROOT, "cnn_autoencoder_tpu_torch", "csrc",
                               "probes", "conv_gdn_probe.cu")
# K4's probe builds and their defines (csrc/conv_gdn.cu)
K4_PROBES = {"k4_one_pass": ["-DCONV_GDN_PASSES=1"],
             "k4_no_io": ["-DCONV_GDN_NO_IO=1"],
             "k4_no_io_one_pass": ["-DCONV_GDN_NO_IO=1",
                                   "-DCONV_GDN_PASSES=1"],
             "k4_no_io_no_lds": ["-DCONV_GDN_NO_IO=1", "-DCONV_GDN_NO_LDS=1"]}
K2_PROBE_SOURCE = os.path.join(ROOT, "cnn_autoencoder_tpu_torch", "csrc",
                               "probes", "gdn_fwd_probe.cu")
# K2's probe builds and their defines (csrc/gdn_fwd_bf16_tc.cu); all count
# the cycles of each part of a tile
K2_PROBES = {"k2_laps": [], "k2_no_io": ["-DGDN_FWD_NO_IO=1"]}
K3_PROBE_SOURCE = os.path.join(ROOT, "cnn_autoencoder_tpu_torch", "csrc",
                               "probes", "gdn_bwd_probe.cu")
# K3's probe builds and their defines (csrc/gdn_bf16_tc.cu); both count the
# cycles of each part of a tile
K3_PROBES = {"k3_laps": [], "k3_no_io": ["-DGDN_BWD_NO_IO=1"]}
RANS_PROBE_SOURCE = os.path.join(ROOT, "cnn_autoencoder_tpu_torch", "csrc",
                                 "probes", "rans_probe.cu")
PROBES = {}  # probe name -> its loaded library (phase 1)
# K4's edge geometries ((B, H, W, Cin), Cout): ragged Cin and Cout, Cin < 32,
# and Cout past one 128-channel block up to 1024
K4_EDGE_CASES = (((2, 18, 14, 72), 40), ((1, 4, 6, 64), 128),
                 ((1, 2, 2, 3), 5), ((2, 10, 12, 64), 129),
                 ((2, 8, 8, 64), 192), ((1, 8, 8, 128), 256),
                 ((1, 6, 4, 64), 512), ((1, 4, 4, 32), 1024),
                 ((1, 4, 6, 33), 200))

# (name, TPU kernel it replaces)
REPLACES = {
    "gdn_fwd": "cnn_autoencoder_tpu/ops/pallas/gdn_kernel.py:71",
    "gdn_fwd_bf16": "cnn_autoencoder_tpu/ops/pallas/gdn_kernel.py:71",
    "gdn_train_fwd": "cnn_autoencoder_tpu/ops/pallas/gdn_kernel.py:230",
    "gdn_train_fwd_f32": "cnn_autoencoder_tpu/ops/pallas/gdn_kernel.py:230",
    "gdn_train_bwd": "cnn_autoencoder_tpu/ops/pallas/gdn_kernel.py:279",
    "conv_gdn_fwd": "cnn_autoencoder_tpu/ops/pallas/conv_gdn_kernel.py:53",
    "conv_gdn_train_fwd":
        "cnn_autoencoder_tpu/ops/pallas/conv_gdn_kernel.py:53",
    "rans_encode_states": "cnn_autoencoder_tpu/ops/pallas/rans_kernel.py:319",
    "rans_compact": "cnn_autoencoder_tpu/ops/pallas/rans_kernel.py:319",
    "rans_decode": "cnn_autoencoder_tpu/ops/pallas/rans_kernel.py:119",
    "gdn_fwd_bf16_f32pool": "cnn_autoencoder_tpu/ops/pallas/gdn_kernel.py:71",
    "gdn_train_fwd_bf16_f32pool":
        "cnn_autoencoder_tpu/ops/pallas/gdn_kernel.py:230",
    "conv_gdn_fwd_pallas_bf16":
        "cnn_autoencoder_tpu/ops/pallas/conv_gdn_kernel.py:53",
    "conv_gdn_fwd_bf16x1":
        "cnn_autoencoder_tpu/ops/pallas/conv_gdn_kernel.py:53",
    "conv_gdn_fwd_bf16x3":
        "cnn_autoencoder_tpu/ops/pallas/conv_gdn_kernel.py:53",
    "conv_gdn_fwd_bf16": "cnn_autoencoder_tpu/ops/pallas/conv_gdn_kernel.py:53",
    "conv_gdn_train_fwd_bf16":
        "cnn_autoencoder_tpu/ops/pallas/conv_gdn_kernel.py:53",
    "conv_gdn_train_fwd_bf16x1":
        "cnn_autoencoder_tpu/ops/pallas/conv_gdn_kernel.py:53",
    "conv_gdn_train_fwd_bf16x3":
        "cnn_autoencoder_tpu/ops/pallas/conv_gdn_kernel.py:53",
}
SOURCES = {
    "gdn_fwd": "cnn_autoencoder_tpu_torch/csrc/gdn_tc.cu",
    "gdn_fwd_bf16": "cnn_autoencoder_tpu_torch/csrc/gdn_fwd_bf16_tc.cu",
    "gdn_train_fwd": "cnn_autoencoder_tpu_torch/csrc/gdn_fwd_bf16_tc.cu",
    "gdn_train_fwd_f32": "cnn_autoencoder_tpu_torch/csrc/gdn_tc.cu",
    "gdn_train_bwd": "cnn_autoencoder_tpu_torch/csrc/gdn_bf16_tc.cu",
    "conv_gdn_fwd": "cnn_autoencoder_tpu_torch/csrc/conv_gdn.cu",
    "conv_gdn_train_fwd": "cnn_autoencoder_tpu_torch/csrc/conv_gdn.cu",
    "rans_encode_states": "cnn_autoencoder_tpu_torch/csrc/rans.cu",
    "rans_compact": "cnn_autoencoder_tpu_torch/csrc/rans.cu",
    "rans_decode": "cnn_autoencoder_tpu_torch/csrc/rans.cu",
    "gdn_fwd_bf16_f32pool": "cnn_autoencoder_tpu_torch/csrc/gdn_tc.cu",
    "gdn_train_fwd_bf16_f32pool": "cnn_autoencoder_tpu_torch/csrc/gdn_tc.cu",
    "conv_gdn_fwd_pallas_bf16": "cnn_autoencoder_tpu_torch/csrc/conv_gdn.cu",
    "conv_gdn_fwd_bf16x1": "cnn_autoencoder_tpu_torch/csrc/conv_gdn.cu",
    "conv_gdn_fwd_bf16x3": "cnn_autoencoder_tpu_torch/csrc/conv_gdn.cu",
    "conv_gdn_fwd_bf16": "cnn_autoencoder_tpu_torch/csrc/conv_gdn.cu",
    "conv_gdn_train_fwd_bf16": "cnn_autoencoder_tpu_torch/csrc/conv_gdn.cu",
    "conv_gdn_train_fwd_bf16x1": "cnn_autoencoder_tpu_torch/csrc/conv_gdn.cu",
    "conv_gdn_train_fwd_bf16x3": "cnn_autoencoder_tpu_torch/csrc/conv_gdn.cu",
}
# K4's serving variant by precision: float32 (mode 0) or the bf16 mode's
# default route (modes 2 and 3)
K4_SERVING = {"float32": "conv_gdn_fwd", "bf16": "conv_gdn_fwd_bf16"}
# the 'cae' codec's round trip (CAECodecCore), by precision: the model's
# GDN and fused conv + GDN layers, no device rANS
CAE_KERNELS = {"float32": ("gdn_fwd", "conv_gdn_fwd"),
               "bf16": ("gdn_fwd_bf16", "conv_gdn_fwd_bf16")}
CAE_ROUNDS = 5      # timed 'cae' round trips in phase 6
# the 'cae_tpu' round trip's kernels by precision; the GDN layers (down_0,
# up_0, up_1) take K1 three times, on float32 or on bf16 rows
SERVING_KERNELS = {"float32": ("gdn_fwd", "conv_gdn_fwd", "rans_encode_states",
                               "rans_compact", "rans_decode"),
                   "bf16": ("gdn_fwd_bf16", "conv_gdn_fwd_bf16",
                            "rans_encode_states", "rans_compact",
                            "rans_decode")}
# bf16 serving's PSNR against float32 serving's (tests/test_bf16_rd.py's
# budget)
BF16_PSNR_DB = 0.05
# launches per train step, by compute mode; every other kernel launches 0
STEP_LAUNCHES = {
    "float32": {"gdn_fwd": 3, "conv_gdn_train_fwd": 1},
    # the fused stage's GDN backward is K3 too (the JAX default route's
    # gdn_mixed)
    "bf16": {"gdn_train_fwd": 3, "gdn_train_bwd": 4,
             "conv_gdn_train_fwd_bf16": 1},
}


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def log(msg):
    print(msg, flush=True)


def bound_ms(nbytes, ops, op_rate=None):
    """(least time in ms, 'bytes' or 'operations').  ``ops`` is a count
    at ``op_rate``, or a list of (count, rate) pairs by operation type."""
    pairs = ops if op_rate is None else [(ops, op_rate)]
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, sum(n / r for n, r in pairs)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(torch, fn, reps):
    """Mean ms per call over ``reps`` calls after one warm-up, CUDA events."""
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


def device_ms(torch, fn, reps):
    """Mean device ms per call of the kernels ``fn`` launches, over ``reps``
    calls after one warm-up (torch.profiler's kernel times): for kernels of
    a few microseconds, CUDA events around the calls would time the
    wrappers' host work instead."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(evt.self_device_time_total for evt in prof.key_averages()
             if evt.device_type == torch.autograd.DeviceType.CUDA
             and evt.key != "Activity Buffer Request")
    return us / reps / 1e3


def image(h, w, seed):
    """Smooth field + seeded noise, after the JAX package's turbo test
    tiles, with the field shifted per seed."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = (np.sin(yy / 9.0 + seed) + np.cos(xx / 11.0))[:, :, None] * 55 + 128
    img = img + np.random.RandomState(seed).randn(h, w, 3) * 4
    return np.clip(img, 0, 255).astype(np.uint8)


def sample_symbols(tables, ch_map, batch, seed):
    """(B, T, S) int32 symbols drawn from each position's channel table."""
    rng = np.random.RandomState(seed)
    freq = tables.freq.cpu().numpy().astype(np.float64)
    length = tables.length.cpu().numpy()
    offset = tables.offset.cpu().numpy()
    ch = ch_map.cpu().numpy()
    out = np.empty((batch,) + ch.shape, np.int32)
    for c in np.unique(ch):
        p = freq[c, :length[c]] / freq[c, :length[c]].sum()
        sel = ch == c
        out[:, sel] = rng.choice(length[c], size=(batch, int(sel.sum())),
                                 p=p) + offset[c]
    return out


# -- phase 1 -----------------------------------------------------------------


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    global CARD
    CARD = smi.stdout.strip().splitlines()[0]
    log(CARD)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    from cnn_autoencoder_tpu_torch.ops.kernels import build
    t0 = time.perf_counter()
    probes = start_probes(build)
    try:
        build.load_library()
    finally:
        PROBES.update(finish_probes(build, probes))
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {build.build_seconds:.1f} s), K1's, K2's, K3's, K4's and the "
        "rANS probes with them")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas " + line.strip())
    check_tc_sass(build)


def start_probes(build):
    """Start one nvcc for each of K1's, K2's, K3's, K4's and the rANS
    kernels' probe builds (into build/probes); returns {name: (process,
    library path)}."""
    out = os.path.join(ROOT, "build", "probes")
    os.makedirs(out, exist_ok=True)
    procs = {}
    builds = ([(name, K1_PROBE_SOURCE, d) for name, d in
               {**K1_PROBES, **K2F_PROBES}.items()]
              + [(name, K2_PROBE_SOURCE, d) for name, d in K2_PROBES.items()]
              + [(name, K3_PROBE_SOURCE, d) for name, d in K3_PROBES.items()]
              + [(name, K4_PROBE_SOURCE, d) for name, d in K4_PROBES.items()]
              + [("rans_probe", RANS_PROBE_SOURCE, [])])
    for name, source, defines in builds:
        path = os.path.join(out, f"{name}.so")
        cmd = ([build.cuda_tool()] + build.ARCH_FLAGS
               + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared"]
               + defines + [source, "-o", path])
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       path)
    return procs


def finish_probes(build, procs):
    """Wait for every probe build; returns {name: loaded library}."""
    outs = {name: (p.communicate()[0], p.returncode, path)
            for name, (p, path) in procs.items()}
    libs = {}
    for name, (out, rc, path) in outs.items():
        check(rc == 0, f"probe build {name} failed:\n{out}")
        lib = ctypes.CDLL(path)
        if name == "rans_probe":
            for fn in ("cae_rans_encode_states", "cae_rans_decode"):
                getattr(lib, fn).argtypes = build.SIGNATURES[fn]
            lib.cae_rans_probe_read.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                                ctypes.c_int]
            lib.cae_rans_probe_laps.argtypes = [ctypes.c_void_p, ctypes.c_int]
        elif name in K2_PROBES:
            lib.cae_gdn_train_fwd.argtypes = build.SIGNATURES[
                "cae_gdn_train_fwd"]
            lib.cae_gdn_fwd_probe_laps.argtypes = [ctypes.c_void_p]
            lib.cae_gdn_fwd_probe_groups.argtypes = []
        elif name in K3_PROBES:
            lib.cae_gdn_train_bwd.argtypes = build.SIGNATURES[
                "cae_gdn_train_bwd"]
            lib.cae_gdn_bwd_probe_laps.argtypes = [ctypes.c_void_p]
        elif name in K4_PROBES:
            lib.cae_conv_gdn_fwd.argtypes = build.SIGNATURES[
                "cae_conv_gdn_fwd"]
        else:
            for fn in ("cae_gdn_fwd", "cae_gdn_train_fwd_f32"):
                getattr(lib, fn).argtypes = build.SIGNATURES[fn]
            lib.cae_gdn_mma_probe.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                              ctypes.c_int, ctypes.c_void_p]
            lib.cae_gdn_fwd_layout.argtypes = [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
        libs[name] = lib
    return libs


def check_tc_sass(build):
    """K1's, K2's, K3's and K4's instantiations in the built library's SASS
    (cuobjdump), each of which must hold HMMA (tensor-core) instructions."""
    lib = build.load_library()._name
    dump = subprocess.run([build.cuda_tool("cuobjdump"), "-sass", lib],
                          capture_output=True, text=True, timeout=300)
    check(dump.returncode == 0, f"cuobjdump failed: {dump.stderr.strip()}")
    counts = {"gdn_tc_kernel": {}, "gdn_fwd_tc": {}, "gdn_bwd_tc": {},
              "conv_gdn_mma_kernel": {}}
    without_r = 0  # K1's bf16 instantiations: the template's kWantR false
    with_r = 0     # K2's float32 ones: gdn_tc_kernel's last, kWantR, true
    for part in dump.stdout.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        for kind, found in counts.items():
            if kind in name:
                found[name] = sum(" HMMA." in line
                                  for line in part.splitlines())
                without_r += kind == "gdn_fwd_tc" and "ELb0EE" in name
                with_r += kind == "gdn_tc_kernel" and "ELb1EE" in name
    check(without_r == 4, f"gdn_fwd_tc: {without_r} instantiations without "
          "r (K1 on bf16 rows), expected 4")
    check(with_r == 10, f"gdn_tc_kernel: {with_r} instantiations with r (K2 "
          "on float32 rows and on bf16 rows with the float32 pool), "
          "expected 10")
    # K1 and K2 on float32 rows and on bf16 rows with the float32 pool
    # (gdn_tc_kernel without and with r): five layouts each; K2 and K1 on
    # bf16 rows (gdn_fwd_tc with and without r): resident and streamed
    # layouts, each for GDN and IGDN; K3: its resident and streamed
    # layouts, each for bf16 and float32 g; K4: three layouts in modes 0,
    # 1 and 3, two in modes 2, 4 and 5 (csrc/conv_gdn.cu:kernel_of)
    for kind, want in (("gdn_tc_kernel", 20), ("gdn_fwd_tc", 8),
                       ("gdn_bwd_tc", 4), ("conv_gdn_mma_kernel", 15)):
        found = counts[kind]
        log(f"{kind} SASS: {len(found)} instantiations, HMMA instructions "
            f"{sorted(found.values())}")
        check(len(found) == want and all(found.values()),
              f"{kind} SASS lacks HMMA: {found}")


# -- phase 2 -----------------------------------------------------------------


def edge_geometries(torch, rng):
    """GDN and conv+GDN at small ragged shapes (rows and channels that fill
    no tile), and what the conv+GDN kernel refuses."""
    from cnn_autoencoder_tpu_torch.ops.kernels import (conv_gdn_kernel,
                                                       gdn_kernel)

    def params(c):
        gamma = torch.from_numpy((0.1 * rng.rand(c, c)).astype(np.float32))
        beta = torch.from_numpy((1.0 + rng.rand(c)).astype(np.float32))
        return gamma.cuda(), beta.cuda()

    # K1: ragged rows and channels; C = 136, 256, 500, 1000, 1552, 1553
    # and 2048 take each shared-memory layout of csrc/gdn_tc.cu (gamma
    # resident or streamed, 64- or 32-row tiles, double- or
    # single-buffered, x in K-slices); the last case has rows 4 bytes off
    # 16-byte alignment (4-byte copies)
    for n, c in ((1000, 48), (77, 130), (5, 3), (300, 136), (300, 256),
                 (100, 500), (70, 1000), (33, 1552), (67, 1553),
                 (100, 2048), (131, 128)):
        x = torch.from_numpy(rng.randn(n * c + 1).astype(np.float32)).cuda()
        x = x[1:].view(n, c) if (n, c) == (131, 128) else x[:-1].view(n, c)
        gamma, beta = params(c)
        rels = []
        for inverse in (False, True):
            got = gdn_kernel.gdn_cuda(x, gamma, beta, inverse)
            ref = gdn_kernel.gdn_plain(x, gamma, beta, inverse)
            rels.append(float(((got - ref).abs()
                               / ref.abs().clamp_min(1e-30)).max()))
            check(rels[-1] <= K1_REL_LIMIT, f"gdn_fwd ({n}, {c}) "
                  f"inverse={inverse}: max relative error {rels[-1]:.3e}")
        log(f"gdn_fwd ({n}, {c}): max rel {rels[0]:.3e} / {rels[1]:.3e} "
            f"(GDN / IGDN); layout {k1_layout(c)}")
    bad = k1_root_mismatches(torch)
    log(f"gdn_fwd epilogue roots against sqrtf and 1.0f / s over every "
        f"positive float32 in range: {bad[0]} and {bad[1]} mismatches")
    check(bad == (0, 0), f"gdn_fwd epilogue roots: {bad} mismatches")
    # K4: ragged Cin and Cout, and Cout past one 128-channel block (the
    # layout that passes y through device memory), both variants and types
    for shape, cout in K4_EDGE_CASES:
        x = torch.from_numpy(rng.rand(*shape).astype(np.float32)).cuda()
        kernel = torch.from_numpy((rng.randn(3, 3, shape[3], cout) * 0.05)
                                  .astype(np.float32)).cuda()
        gamma, beta = params(cout)
        for dt in (torch.float32, torch.bfloat16):
            check_conv_case(torch, x.to(dt), kernel, gamma, beta,
                            f"{shape} -> {cout} {str(dt)[6:]}")
    x = torch.zeros((1, 5, 4, 64), device="cuda")
    gamma, beta = params(64)
    try:
        conv_gdn_kernel.conv_gdn_cuda(
            x, torch.zeros((3, 3, 64, 64), device="cuda"), gamma, beta)
        raise SmokeError("conv_gdn_fwd took odd H")
    except ValueError:
        pass
    torch.cuda.synchronize()
    log("gdn_fwd and conv_gdn_fwd agree with their plain versions at ragged "
        "shapes, conv_gdn_fwd and conv_gdn_train_fwd up to Cout = 1024 in "
        "float32 and bf16; conv_gdn_fwd refuses odd H")


def k1_layout(c, want_r=False, probe="one_pass"):
    """The layout K1 (K2 on float32 rows: ``want_r``) takes for c channels,
    from its launch plan in the probe build ``probe``
    (csrc/probes/gdn_tc_probe.cu:cae_gdn_fwd_layout)."""
    from cnn_autoencoder_tpu_torch.ops.kernels import build
    out = (ctypes.c_int * 8)()
    build.check_launch(PROBES[probe].cae_gdn_fwd_layout(
        c, int(want_r), ctypes.addressof(out)), "gdn_fwd layout")
    return dict(zip(("groups", "rows", "gamma_resident", "x_sliced",
                     "x_buffers", "smem_bytes", "most_blocks", "r_tiles"),
                    out))


def k1_probe(torch, name, x, gamma, beta, inverse, out):
    """K1 as the probe build ``name`` computes it, into ``out``."""
    from cnn_autoencoder_tpu_torch.ops.kernels import build
    n, c = x.shape
    build.check_launch(PROBES[name].cae_gdn_fwd(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), n,
        c, int(inverse), torch.cuda.current_stream().cuda_stream), name)
    return out


def k1_root_mismatches(torch):
    """Over every positive float32 value in K1's fast range: how many give
    an epilogue square root, and a reciprocal of it, other than sqrtf and
    1.0f / s (csrc/gdn_tc.cu:cae_gdn_root_check)."""
    from cnn_autoencoder_tpu_torch.ops.kernels import build
    bad = torch.zeros(2, dtype=torch.int64, device="cuda")
    build.check_launch(build.load_library().cae_gdn_root_check(
        0, 1 << 31, bad.data_ptr(), torch.cuda.current_stream().cuda_stream),
        "gdn_fwd root check")
    return tuple(bad.tolist())


def mma_tf32_tflops(torch):
    """TFLOP/s of the mma.sync TF32 products K1 issues, with one 8-warp
    block per SM as K1 runs (csrc/probes/gdn_tc_probe.cu:
    cae_gdn_mma_probe): the ceiling of its three passes on this card."""
    from cnn_autoencoder_tpu_torch.ops.kernels import build
    lib = PROBES["one_pass"]
    blocks = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(blocks * 256, device="cuda")
    iters = 4096
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        build.check_launch(lib.cae_gdn_mma_probe(out.data_ptr(), blocks,
                                                 iters, stream), "mma probe")
    ms = cuda_ms(torch, run, 3)
    return blocks * 8 * iters * 8 * (2 * 16 * 8 * 8) / ms / 1e9


def k1_serving(torch, model, b, h, w, rng):
    """K1 at the round trip's shapes with the flagship's parameters: down_0
    (GDN) and up_1 (IGDN) over (B 256^2, 128) rows, up_0 (IGDN) over
    (B 128^2, 128); each against its plain version and against the
    one-pass control, down_0 and up_0 timed, down_0 beside K1's probes.
    Returns down_0's record."""
    from cnn_autoencoder_tpu_torch.ops.kernels import gdn_kernel
    rows = b * (h // 2) * (w // 2)
    rec = None
    mma_tflops = mma_tf32_tflops(torch)
    log(f"mma.sync TF32 on this card: {mma_tflops:.1f} TFLOP/s (one 8-warp "
        "block per SM)")
    with torch.no_grad():
        for inverse, unit, n in ((False, model.encoder.down_0, rows),
                                 (True, model.decoder.up_1, rows),
                                 (True, model.decoder.up_0, rows // 4)):
            mod = unit.gdn_up if inverse else unit.gdn_down
            gamma, beta = mod.effective_params()
            c = gamma.shape[0]
            x = torch.from_numpy(rng.randn(n, c).astype(np.float32)
                                 * 0.5).cuda()
            got = gdn_kernel.gdn_cuda(x, gamma, beta, inverse)
            ref = gdn_kernel.gdn_plain(x, gamma, beta, inverse)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), "gdn_fwd: non-finite")
            err = (got - ref).abs()
            rel = float((err / ref.abs().clamp_min(1e-30)).max())
            # the one-pass control must fail the limit the kernel holds
            gamma, beta = gamma.detach().contiguous(), beta.detach()
            one = k1_probe(torch, "one_pass", x, gamma, beta, inverse,
                           torch.empty_like(x))
            rel_one = float(((one - ref).abs()
                             / ref.abs().clamp_min(1e-30)).max())
            del one
            log(f"gdn_fwd inverse={inverse} {tuple(x.shape)}: max abs "
                f"{float(err.max()):.3e} max rel {rel:.3e}; one-pass "
                f"control max rel {rel_one:.3e} (limit {K1_REL_LIMIT:.0e})")
            check(rel <= K1_REL_LIMIT, f"gdn_fwd inverse={inverse}: max "
                  f"relative error {rel:.3e} > {K1_REL_LIMIT:.0e}")
            check(rel_one > K1_REL_LIMIT, f"gdn_fwd inverse={inverse}: the "
                  f"one-pass control passed ({rel_one:.3e})")
            if unit is model.decoder.up_1:
                continue
            ms = cuda_ms(torch, lambda: gdn_kernel.gdn_cuda(
                x, gamma, beta, inverse), 20)
            plain_ms = cuda_ms(torch, lambda: gdn_kernel.gdn_plain(
                x, gamma, beta, inverse), 10)
            nbytes = 8 * n * c + 4 * c * (c + 1)
            # the pool as three TF32 passes, the rest in float32
            bms, by = bound_ms(nbytes, [(3 * 2 * n * c * c, PEAK_TF32_S),
                                        (5 * n * c, PEAK_F32_S)])
            log(f"gdn_fwd {(n, c)} inverse={inverse}: kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms; bytes bound "
                f"{nbytes / PEAK_BYTES_S * 1e3:.4f} ms, three-pass TF32 "
                f"operations {6 * n * c * c / PEAK_TF32_S * 1e3:.4f} ms, "
                f"bound {bms:.4f} ms ({by}), {100 * bms / ms:.1f}% of it; "
                "the three passes at the mma.sync rate "
                f"{6 * n * c * c / mma_tflops / 1e9:.4f} ms; "
                "the earlier CUDA-core design's float32 ceiling "
                f"{n * c * (2 * c + 5) / PEAK_F32_S * 1e3:.4f} ms; layout "
                f"{k1_layout(c)}")
            if not inverse:
                k1_probe_times(torch, x, gamma, beta, ms)
                rec = dict(max_abs_err=float(err.max()), ms=ms,
                           plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                           shape=list(x.shape))
            del x, got, ref, err
    return rec


def k1_probe_times(torch, x, gamma, beta, ms):
    """K1's time split by its probes at x's shape (GDN): one TF32 pass,
    and both pass counts without x's and y's device-memory traffic, beside
    a device copy of x (the bytes K1 moves)."""
    out = torch.empty_like(x)
    t = {name: cuda_ms(torch, lambda: k1_probe(torch, name, x, gamma, beta,
                                               False, out), 20)
         for name in K1_PROBES}
    copy_ms = cuda_ms(torch, lambda: out.copy_(x), 20)
    two_low = t["no_io"] - t["no_io_one_pass"]
    log(f"gdn_fwd {tuple(x.shape)} probes: kernel {ms:.4f} ms, one pass "
        f"{t['one_pass']:.4f} ms; without device-memory traffic "
        f"{t['no_io']:.4f} ms (three passes), {t['no_io_one_pass']:.4f} ms "
        f"(one pass); a device copy of x {copy_ms:.4f} ms. In the SM: the "
        f"two low passes {two_low:.4f} ms, so three passes about "
        f"{1.5 * two_low:.4f} ms and the rest (x^2 split, fragment loads, "
        f"epilogue, barriers) about {t['no_io'] - 1.5 * two_low:.4f} ms")


def k1_bf16_bound(n, c):
    """K1 on bf16 rows: its bytes (x in and y out, 2 bytes each, and the
    float32 parameters) against its operations (the pool in one bf16
    pass at the bf16 rate, five float32 operations an element after it)."""
    return bound_ms(4 * n * c + 4 * c * (c + 1),
                    [(2 * n * c * c, PEAK_BF16_S), (5 * n * c, PEAK_F32_S)])


def k1_bf16_edges(torch, rng):
    """K1 on bf16 rows against gdn_plain (one bf16 ulp) at ragged rows,
    every shared-memory layout of its C range (gamma resident for C <= 128,
    streamed in 64-deep slices above) and rows one element past a 16-byte
    boundary (staged element by element)."""
    from cnn_autoencoder_tpu_torch.ops.kernels import gdn_kernel as gk
    for n, c in ((1000, 48), (77, 130), (5, 3), (9, 128), (300, 256),
                 (33, 512), (131, 128)):
        buf = torch.from_numpy(rng.randn(n * c + 8).astype(np.float32))
        buf = buf.cuda().to(torch.bfloat16)
        misaligned = (n, c) == (131, 128)
        x = buf[1:1 + n * c] if misaligned else buf[:n * c]
        x = x.view(n, c)
        check(not misaligned or x.data_ptr() % 16 != 0,
              "misaligned K1 bf16 case: the view is aligned")
        gamma = torch.from_numpy((0.1 * rng.rand(c, c)).astype(np.float32))
        beta = torch.from_numpy((1.0 + rng.rand(c)).astype(np.float32))
        gamma, beta = gamma.cuda(), beta.cuda()
        for inverse in (False, True):
            got = gk.gdn_cuda(x, gamma, beta, inverse)
            ref = gk.gdn_plain(x, gamma, beta, inverse)
            torch.cuda.synchronize()
            check(got.dtype == torch.bfloat16
                  and bool(torch.isfinite(got.float()).all())
                  and bf16_ulps(got, ref) <= 1,
                  f"gdn_fwd_bf16 ({n}, {c}) inverse={inverse}: more than "
                  "one bf16 ulp from gdn_plain")
    log("gdn_fwd_bf16 within one bf16 ulp of gdn_plain at (1000, 48), "
        "(77, 130), (5, 3), (9, 128), (300, 256), (33, 512) and misaligned "
        "(131, 128) rows, GDN and IGDN")


def k1_bf16_serving(torch, model, b, h, w):
    """K1 on bf16 rows at the bf16 round trip's three calls with the
    flagship's parameters: down_0 (GDN) and up_1 (IGDN) over (B 256^2,
    128) rows, up_0 (IGDN) over (B 128^2, 128); each within one bf16 ulp of
    gdn_plain and timed by CUDA events beside it, its bound and cuBLAS's
    bf16 (N, C) @ (C, C) product (a yardstick).  Returns down_0's
    record."""
    from cnn_autoencoder_tpu_torch.ops.kernels import gdn_kernel as gk
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = b * (h // 2) * (w // 2)
    rec, total_ms, total_bms = None, 0.0, 0.0
    with torch.no_grad():
        for inverse, unit, n in ((False, model.encoder.down_0, rows),
                                 (True, model.decoder.up_1, rows),
                                 (True, model.decoder.up_0, rows // 4)):
            mod = unit.gdn_up if inverse else unit.gdn_down
            gamma, beta = (t.detach() for t in mod.effective_params())
            c = gamma.shape[0]
            x = (0.5 * torch.randn(n, c, device="cuda", generator=gen)
                 ).to(torch.bfloat16)
            got = gk.gdn_cuda(x, gamma, beta, inverse)
            ref = gk.gdn_plain(x, gamma, beta, inverse)
            torch.cuda.synchronize()
            ulps = bf16_ulps(got, ref)
            err = float((got.float() - ref.float()).abs().max())
            check(bool(torch.isfinite(got.float()).all()) and ulps <= 1,
                  f"gdn_fwd_bf16 inverse={inverse} ({n}, {c}): {ulps} bf16 "
                  "ulps from gdn_plain")
            ms = cuda_ms(torch, lambda: gk.gdn_cuda(x, gamma, beta, inverse),
                         20)
            plain_ms = cuda_ms(torch, lambda: gk.gdn_plain(
                x, gamma, beta, inverse), 10)
            gb = gamma.to(torch.bfloat16)
            mm_ms = cuda_ms(torch, lambda: torch.matmul(x, gb), 20)
            bms, by = k1_bf16_bound(n, c)
            total_ms += ms
            total_bms += bms
            log(f"gdn_fwd_bf16 inverse={inverse} ({n}, {c}): {ulps} ulp, max "
                f"abs {err:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                f"ms, bound {bms:.4f} ms ({by}), {100 * bms / ms:.1f}% of "
                f"it; cuBLAS bf16 ({n}, {c}) @ ({c}, {c}) alone {mm_ms:.4f} "
                "ms (a yardstick)")
            if rec is None:
                rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=bms, bound_by=by, shape=[n, c])
            del x, got, ref
    log(f"gdn_fwd_bf16: the bf16 round trip's three calls {total_ms:.4f} ms "
        f"against their bound {total_bms:.4f} ms")
    return rec


def k4_bound(x, cout, want_y, mode=None):
    """K4's bound at x's shape in ``mode`` (None: the mode now): its bytes
    (x, out in x's type, y where wanted: float32, or y and r in bf16 in
    modes 2 and 3, the parameters) against its operations at the card's
    rate for their type: three TF32 passes for each float32 product (mode
    0), bf16 products at the bf16 rate (one a product in modes 1-4, three
    in mode 5), the pool in three TF32 passes (one bf16 pass in modes 2 and
    3), and five float32 operations an output in the epilogue.  Returns
    (bound ms, what bounds it, design ms): the last is the operations as
    the design issues them (every pass a TF32 one), its ceiling."""
    from cnn_autoencoder_tpu_torch.ops.kernels import conv_gdn_kernel as cg
    mode = cg.conv_gdn_mode(x.dtype) if mode is None else mode
    b, h, w, cin = x.shape
    npix = b * (h // 2) * (w // 2)
    size = x.element_size()
    conv_ops = npix * 2 * 9 * cin * cout
    pool_ops = npix * 2 * cout * cout
    epilogue = (5 * npix * cout, PEAK_F32_S)
    conv_passes = {cg.F32: 3, cg.F32_BF16X3: 3}.get(mode, 1)
    conv = (conv_passes * conv_ops,
            PEAK_TF32_S if mode == cg.F32 else PEAK_BF16_S)
    pool_passes = 1 if mode in cg.ROUNDED else 3
    pool = (pool_passes * pool_ops,
            PEAK_BF16_S if mode in cg.ROUNDED else PEAK_TF32_S)
    nbytes = (size * (x.numel() + npix * cout) + 4 * npix * cout * want_y
              + 4 * (9 * cin * cout + cout * (cout + 1)))
    bms, by = bound_ms(nbytes, [conv, pool, epilogue])
    design_ms = ((conv_passes * conv_ops + pool_passes * pool_ops)
                 / PEAK_TF32_S + epilogue[0] / PEAK_F32_S) * 1e3
    return bms, by, design_ms


def k4_probe_times(torch, x, kernel, gamma, beta, ms):
    """K4's serving time split by its probes at x's shape (float32): one
    TF32 pass for the conv, and both pass counts without the copies into
    the ring, beside a device copy of x and the three passes' time at the
    mma.sync rate.  The one-pass build is also the control of K4's
    accuracy limits: its out and y must fail the 1e-4 of max |out| and of
    max |y| that the kernel holds."""
    from cnn_autoencoder_tpu_torch.ops.kernels import build
    from cnn_autoencoder_tpu_torch.ops.kernels import conv_gdn_kernel as cg
    b, h, w, cin = x.shape
    cout = kernel.shape[3]
    kernel, gamma, beta = (t.detach().float().contiguous()
                           for t in (kernel, gamma, beta))
    npix = b * (h // 2) * (w // 2)
    work = torch.empty(build.load_library().cae_conv_gdn_workspace(
        b, h, w, cin, cout, cg.F32, 1), dtype=torch.uint8, device="cuda")
    out = torch.empty((b, h // 2, w // 2, cout), device="cuda")
    y = torch.empty_like(out)
    stream = torch.cuda.current_stream().cuda_stream

    def run(name, y_ptr=None):
        build.check_launch(PROBES[name].cae_conv_gdn_fwd(
            x.data_ptr(), kernel.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), out.data_ptr(), y_ptr, None, work.data_ptr(), b,
            h, w, cin, cout, cg.F32, stream), name)

    run("k4_one_pass", y.data_ptr())
    out_p, y_p, _ = cg.conv_gdn_train_plain(x, kernel, gamma, beta)
    torch.cuda.synchronize()
    ok_o, o_err = close(out, out_p, 0.0, 1e-4)
    ok_y, y_err = close(y, y_p, 0.0, 1e-4)
    log(f"conv_gdn_fwd {tuple(x.shape)} one-pass control: out max abs "
        f"{o_err:.3e} (limit {1e-4 * float(out_p.abs().max()):.3e}), y max "
        f"abs {y_err:.3e} (limit {1e-4 * float(y_p.abs().max()):.3e})")
    check(not ok_o and not ok_y, "conv_gdn_fwd: the one-pass control passes "
          "K4's limits, which then cannot tell three passes from one")
    del out_p, y_p, y
    t = {name: cuda_ms(torch, lambda: run(name), 10) for name in K4_PROBES}
    copy_ms = cuda_ms(torch, lambda: torch.empty_like(x).copy_(x), 10)
    passes = 3 * npix * 2 * cout * (9 * cin + cout)
    two_low = t["k4_no_io"] - t["k4_no_io_one_pass"]
    log(f"conv_gdn_fwd {tuple(x.shape)} probes: kernel {ms:.4f} ms, one "
        f"pass {t['k4_one_pass']:.4f} ms; without copies into the ring "
        f"{t['k4_no_io']:.4f} ms (three passes), "
        f"{t['k4_no_io_one_pass']:.4f} ms (one pass); a device copy of x "
        f"{copy_ms:.4f} ms; without copies or fragment loads (operands in "
        f"registers) {t['k4_no_io_no_lds']:.4f} ms; the three passes at the "
        f"mma.sync rate {passes / mma_tf32_tflops(torch) / 1e9:.4f} ms. "
        "In the SM: "
        f"the conv's two low passes and x's split {two_low:.4f} ms, the "
        f"fragment loads and splits "
        f"{t['k4_no_io'] - t['k4_no_io_no_lds']:.4f} ms; the copies' share "
        f"{ms - t['k4_no_io']:.4f} ms")


def k4_wide_time(torch, rng):
    """K4's serving variant at a Cout past one 128-channel block, (8, 128,
    128, 192) -> 192 float32 (y passes through device memory), against its
    plain version, timed."""
    from cnn_autoencoder_tpu_torch.ops.kernels import conv_gdn_kernel as cg
    cin = cout = 192
    x = torch.from_numpy(rng.rand(8, 128, 128, cin).astype(np.float32)).cuda()
    kernel = torch.from_numpy((rng.randn(3, 3, cin, cout) * 0.03)
                              .astype(np.float32)).cuda()
    gamma = torch.from_numpy((0.01 * rng.rand(cout, cout))
                             .astype(np.float32)).cuda()
    beta = torch.from_numpy((1.0 + rng.rand(cout)).astype(np.float32)).cuda()
    got = cg.conv_gdn_cuda(x, kernel, gamma, beta)
    ref = cg.conv_gdn_plain(x, kernel, gamma, beta)
    torch.cuda.synchronize()
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    check(err <= 1e-4 * scale, f"conv_gdn_fwd {tuple(x.shape)} -> {cout}: "
          f"error {err:.3e} above 1e-4 max|out|")
    ms = cuda_ms(torch, lambda: cg.conv_gdn_cuda(x, kernel, gamma, beta), 10)
    plain_ms = cuda_ms(torch, lambda: cg.conv_gdn_plain(
        x, kernel, gamma, beta), 5)
    bms, by, _ = k4_bound(x, cout, want_y=False)
    log(f"conv_gdn_fwd {tuple(x.shape)} -> {cout} float32: max abs "
        f"{err:.3e} (max|out| {scale:.3e}); kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bms:.4f} ms ({by}), "
        f"{100 * bms / ms:.1f}% of it")


def phase_kernels(torch, model, core, tiles):
    """Every kernel against its plain version at the serving path's shapes;
    returns {name: record}."""
    from cnn_autoencoder_tpu_torch.ops.kernels import conv_gdn_kernel
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    b, h, w = tiles, 512, 512
    out = {}
    edge_geometries(torch, rng)

    out["gdn_fwd"] = k1_serving(torch, model, b, h, w, rng)
    k1_bf16_edges(torch, rng)
    out["gdn_fwd_bf16"] = k1_bf16_serving(torch, model, b, h, w)

    # K4: reflect pad + 3x3/s2 conv + GDN, flagship down_1: (B, 256, 256,
    # 128) -> (B, 128, 128, 128)
    with torch.no_grad():
        unit = model.encoder.down_1
        kernel = unit.conv_down.kernel_hwio()
        gamma, beta = unit.gdn_down.effective_params()
        cin, cout = kernel.shape[2], kernel.shape[3]
        x = torch.from_numpy(rng.rand(b, h // 2, w // 2, cin)
                             .astype(np.float32)).to(dev)
        got = conv_gdn_kernel.conv_gdn_cuda(x, kernel, gamma, beta)
        ref = conv_gdn_kernel.conv_gdn_plain(x, kernel, gamma, beta)
        torch.cuda.synchronize()
        check(got.shape == ref.shape == (b, h // 4, w // 4, cout),
              f"conv_gdn_fwd: shape {tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()), "conv_gdn_fwd: non-finite")
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        log(f"conv_gdn_fwd {tuple(x.shape)} -> {tuple(got.shape)}: max abs "
            f"{err:.3e} (tolerance 1e-4 * max|out| = {1e-4 * scale:.3e})")
        check(err <= 1e-4 * scale, "conv_gdn_fwd: error above 1e-4 max|out|")
        ms = cuda_ms(torch, lambda: conv_gdn_kernel.conv_gdn_cuda(
            x, kernel, gamma, beta), 10)
        plain_ms = cuda_ms(torch, lambda: conv_gdn_kernel.conv_gdn_plain(
            x, kernel, gamma, beta), 5)
        bms, by, _ = k4_bound(x, cout, want_y=False)
        log(f"conv_gdn_fwd {tuple(x.shape)} -> {cout} float32: kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms "
            f"({by}), {100 * bms / ms:.1f}% of it")
        out["conv_gdn_fwd"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                   bound_ms=bms, bound_by=by,
                                   shape=list(x.shape))
        k4_probe_times(torch, x, kernel, gamma, beta, ms)
        # the bf16 serving variant, which the bf16 round trip launches
        xb = x.to(torch.bfloat16)
        err_b = check_conv_case(torch, xb, kernel, gamma, beta,
                                f"{tuple(x.shape)} -> {cout} bf16")
        ms_b = cuda_ms(torch, lambda: conv_gdn_kernel.conv_gdn_cuda(
            xb, kernel, gamma, beta), 10)
        plain_b = cuda_ms(torch, lambda: conv_gdn_kernel.conv_gdn_plain(
            xb, kernel, gamma, beta), 5)
        bms_b, by_b, design_b = k4_bound(xb, cout, want_y=False)
        out["conv_gdn_fwd_bf16"] = dict(
            max_abs_err=err_b, ms=ms_b, plain_ms=plain_b, bound_ms=bms_b,
            bound_by=by_b, shape=list(xb.shape))
        log(f"conv_gdn_fwd {tuple(x.shape)} -> {cout} bf16: kernel "
            f"{ms_b:.4f} ms, plain {plain_b:.4f} ms, bound {bms_b:.4f} ms "
            f"({by_b}), "
            f"{100 * bms_b / ms_b:.1f}% of it; the design's one-pass TF32 "
            f"ceiling {design_b:.4f} ms")
        del x, xb, got, ref
        k4_wide_time(torch, rng)

    out.update(rans_kernels(torch, core, b))
    for name, rec in out.items():
        log(f"{name} {rec['shape']}: kernel {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']})")
    return out


def rans_cases(torch, core, b, rng):
    """(label, symbols (B, T, S), channel map (T, S), tables) of the rANS
    checks, symbols drawn from each position's channel table: the serving
    geometry (latent 64x64x48, S = 1024: T = 192, B tiles), a peaked table
    (freq > 2^11, states above 2^31), a 60x60 plane (not a multiple of S:
    steps that span two channels), 100 streams, and the serving latent at
    more than 1024 streams: 2048, 3000 (not a multiple of 32; steps span
    channels) and 65535 (the frame's largest S, 16 channels a step); and
    192 channels of 255 values at S = 1024 (the state pass's unstaged
    table)."""
    from cnn_autoencoder_tpu_torch.coding.device_rans import (
        DeviceTables, pack_streams, stream_channel_map)
    dev = torch.device("cuda")
    tables = core.tables
    s = core.num_streams

    def drawn(cmap, batch, seed):
        return torch.from_numpy(sample_symbols(tables, cmap, batch,
                                               seed)).to(dev)

    ch_map = core._ch_map(64, 64, s)
    cases = [("flagship 64x64", drawn(ch_map, b, 1), ch_map, tables)]
    freq = torch.tensor([[3968, 64, 32, 32]], dtype=torch.int32)
    peaked = DeviceTables(
        freq=freq, start=torch.tensor([[0, 3968, 4032, 4064]],
                                      dtype=torch.int32),
        slot=torch.repeat_interleave(torch.arange(4, dtype=torch.int32),
                                     freq[0].long())[None],
        offset=torch.tensor([-1], dtype=torch.int32),
        length=torch.tensor([4], dtype=torch.int32), support=4).to(dev)
    pk_map = torch.zeros((64, s), dtype=torch.int32, device=dev)
    pk_sym = torch.from_numpy(rng.randint(0, 4, (4, 64, s)).astype(np.int32)
                              - 1).to(dev)
    cases.append(("peaked freq 3968", pk_sym, pk_map, peaked))
    odd_map = core._ch_map(60, 60, s)
    n_odd = tables.freq.shape[0] * 60 * 60
    odd = sample_symbols(tables, odd_map, 4, 2).reshape(4, -1)[:, :n_odd]
    check(bool((odd_map != odd_map[:, :1]).any()),
          "the 60x60 geometry should have multi-channel steps")
    cases.append(("plane 60x60 (not a multiple of S)",
                  pack_streams(torch.from_numpy(odd), s).to(dev), odd_map,
                  tables))
    s100_map = torch.from_numpy(stream_channel_map(48, (8, 8), 100)).to(dev)
    cases.append(("100 streams", drawn(s100_map, 3, 3), s100_map, tables))
    for streams, batch in ((2048, 4), (3000, 4), (65535, 2)):
        cmap = torch.from_numpy(stream_channel_map(48, (64, 64),
                                                   streams)).to(dev)
        cases.append((f"{streams} streams 64x64", drawn(cmap, batch, streams),
                      cmap, tables))
    # 192 channels (the factory's default channels_bn) whose tables reach
    # 255 values: the flagship's tables four times over, widened from its
    # support to 255 columns by an entry no symbol takes; past ENC_SMEM_MAX
    # staged bytes, so the state pass reads its table from device memory
    def widen(a, value):
        a = a.repeat(4, 1)
        return torch.cat([a, torch.full((a.shape[0], 255 - a.shape[1]),
                                        value, dtype=a.dtype,
                                        device=a.device)], dim=1)

    wide = DeviceTables(
        freq=widen(tables.freq, 1), start=widen(tables.start, 4095),
        slot=tables.slot.repeat(4, 1), offset=tables.offset.repeat(4),
        length=tables.length.repeat(4), support=255)
    check(wide.freq.numel() * 8 + wide.offset.numel() * 4 > ENC_SMEM_MAX,
          "the 192-channel table should exceed the state pass's staging")
    cmap = torch.from_numpy(stream_channel_map(192, (64, 64), s)).to(dev)
    cases.append(("192 channels 64x64", torch.from_numpy(sample_symbols(
        wide, cmap, 2, 5)).to(dev), cmap, wide))
    return cases


def u16_equal(torch, a, b):
    """Bit equality of two uint16 tensors (compared as int16)."""
    return a.dtype == b.dtype == torch.uint16 and torch.equal(
        a.view(torch.int16), b.view(torch.int16))


def u16_prefix(torch, words, n, width=None):
    """The first n words of each row, zero-padded to width (int16 views:
    the copy kernels need no uint16 support)."""
    rows = words.shape[0]
    out = torch.zeros((rows, width or n), dtype=torch.int16,
                      device=words.device)
    out[:, :n] = words.view(torch.int16)[:, :n]
    return out.view(torch.uint16)


def check_rans_case(torch, label, sym, cmap, tab):
    """K6's passes and K5 against their plain versions on one case: the
    state pass's buffers, one state pass compacted at a short capacity, then again at the worst case
    (the re-compaction an overflowing batch takes); the decode of the whole
    queue, the whole queue padded to 128 words as the codec uploads it
    (staged through K5's window), and queues cut short (reads clamp to the
    last word), at an odd length and at a multiple of 8.  Returns the
    worst-case words and totals."""
    from cnn_autoencoder_tpu_torch.ops.kernels import rans_kernel as rk
    t, s = cmap.shape
    args = (sym, cmap, tab.freq, tab.start, tab.offset)
    state = rk.encode_states_cuda(*args)
    plain = rk.rans_encode_states_plain(*args)
    torch.cuda.synchronize()
    check(u16_equal(torch, state.words, plain.words)
          and all(torch.equal(getattr(state, k), getattr(plain, k))
                  for k in ("flags", "final", "counts")),
          f"rans_encode {label}: the state pass differs from the plain "
          "version")
    worst = 2 * s + t * s
    for cap in (2 * s + 100, worst):
        words, totals = rk.compact_cuda(state, cap)
        words_p, totals_p = rk.rans_compact_plain(plain, cap)
        torch.cuda.synchronize()
        check(torch.equal(totals, totals_p), f"rans_encode {label} "
              f"capacity {cap}: totals differ from the plain version")
        check(u16_equal(torch, words, words_p), f"rans_encode {label} "
              f"capacity {cap}: words differ from the plain version")
    lut = rk.pack_dec_lut(tab.freq, tab.start, tab.slot)
    keep = int(totals.min()) // 2
    queues = [("whole", words),
              ("padded", u16_prefix(torch, words, worst,
                                    -(-worst // 128) * 128)),
              (f"cut to {keep}", u16_prefix(torch, words, keep)),
              (f"cut to {keep & ~7}", u16_prefix(torch, words, keep & ~7))]
    for qlabel, q in queues:
        vals = rk.decode_interleaved_cuda(q, cmap, lut, t)
        vals_p = rk.rans_decode_plain(q, cmap, lut, t)
        torch.cuda.synchronize()
        check(torch.equal(vals, vals_p), f"rans_decode {label} {qlabel} "
              "queue: differs from the plain version")
        if qlabel in ("whole", "padded"):
            check(torch.equal(vals + tab.offset[cmap.long()][None], sym),
                  f"rans_decode {label}: does not give back the symbols")
    log(f"rans {label}: {tuple(sym.shape)} {int(totals.sum())} words; "
        "encode (one state pass, compacted at two capacities) and decode "
        "(whole, padded and cut queues) bit-identical to the plain versions")
    return words, totals


def rans_times(torch, label, sym, cmap, tab, words, totals, plain):
    """Device times of K6's two passes and of K5 on one case, compacted at
    the capacity its totals fill, beside their bounds; with ``plain`` also
    the plain versions' times and {name: record} of the three (else
    None).  Returns (records, K6 ms, K5 ms, K6 bound, K5 bound, queue)."""
    from cnn_autoencoder_tpu_torch.ops.kernels import rans_kernel as rk
    t, s = cmap.shape
    bsz = sym.shape[0]
    args = (sym, cmap, tab.freq, tab.start, tab.offset)
    # the capacity the codec's last compaction of this batch takes
    cap = int(totals.max())
    state = rk.encode_states_cuda(*args)
    queue = u16_prefix(torch, words, cap, -(-cap // 128) * 128)
    lut = rk.pack_dec_lut(tab.freq, tab.start, tab.slot)
    st_ms = device_ms(torch, lambda: rk.encode_states_cuda(*args), 20)
    cp_ms = device_ms(torch, lambda: rk.compact_cuda(state, cap), 20)
    k6_ms = st_ms + cp_ms
    dec_ms = device_ms(torch, lambda: rk.decode_interleaved_cuda(
        queue, cmap, lut, t), 20)
    # the same calls with their wrappers' host work (CUDA events)
    k6_wall = cuda_ms(torch, lambda: rk.compact_cuda(
        rk.encode_states_cuda(*args), cap), 20)
    dec_wall = cuda_ms(torch, lambda: rk.decode_interleaved_cuda(
        queue, cmap, lut, t), 20)
    n_words = int(totals.sum())
    # K6 as one function: symbols, map and tables in, words and totals
    # out; about a dozen integer operations per symbol.  The scratch
    # between its two passes is the design's, not the function's: the
    # passes share this one bound, the state pass the inputs' part, the
    # compaction the outputs'.
    k6_in = (4 * (sym.numel() + cmap.numel() + tab.offset.numel())
             + 8 * tab.freq.numel())
    k6_out = 2 * n_words + 4 * bsz
    k6_bms, k6_by = bound_ms(k6_in + k6_out, 12 * sym.numel(), PEAK_I32_S)
    dec_bms, dec_by = bound_ms(2 * n_words + 4 * (cmap.numel() + lut.numel()
                                                  + sym.numel()),
                               12 * sym.numel(), PEAK_I32_S)
    log(f"rans {label} {tuple(sym.shape)}, device time: state pass "
        f"{st_ms:.4f} ms, compaction {cp_ms:.4f} ms (capacity {cap}), "
        f"both {k6_ms:.4f} ms against K6's bound {k6_bms:.4f} ms "
        f"({k6_by}); decode {dec_ms:.4f} ms against {dec_bms:.4f} ms "
        f"({dec_by}); with the wrappers' host work (CUDA events) "
        f"{k6_wall:.4f} and {dec_wall:.4f} ms")
    records = None
    if plain:
        st_plain = cuda_ms(torch, lambda: rk.rans_encode_states_plain(
            *args), 3)
        plain_state = rk.rans_encode_states_plain(*args)
        cp_plain = cuda_ms(torch, lambda: rk.rans_compact_plain(
            plain_state, cap), 3)
        dec_plain = cuda_ms(torch, lambda: rk.rans_decode_plain(
            queue, cmap, lut, t), 3)
        shape = list(sym.shape)
        records = {
            "rans_encode_states": dict(
                max_abs_err=0.0, ms=st_ms, plain_ms=st_plain,
                bound_ms=k6_bms * k6_in / (k6_in + k6_out), bound_by=k6_by,
                shape=shape),
            "rans_compact": dict(
                max_abs_err=0.0, ms=cp_ms, plain_ms=cp_plain,
                bound_ms=k6_bms * k6_out / (k6_in + k6_out), bound_by=k6_by,
                shape=shape),
            "rans_decode": dict(
                max_abs_err=0.0, ms=dec_ms, plain_ms=dec_plain,
                bound_ms=dec_bms, bound_by=dec_by, shape=shape)}
        log(f"rans {label}: plain state pass {st_plain:.4f} ms, plain "
            f"compaction {cp_plain:.4f} ms, plain decode {dec_plain:.4f} ms "
            "(CUDA events)")
    return records, k6_ms, dec_ms, k6_bms, dec_bms, queue


def rans_kernels(torch, core, b):
    """K6 (state pass and compaction) and K5 against their plain versions
    on every case of rans_cases, timed on each but the peaked table and
    the plane, with their bounds and (at the serving geometry) the probe's
    serial-chain figure; returns {name: record} for the serving
    geometry."""
    cases = rans_cases(torch, core, b, np.random.RandomState(4))
    out = {}
    for label, sym, cmap, tab in cases:
        words, totals = check_rans_case(torch, label, sym, cmap, tab)
        if label.startswith("peaked") or label.startswith("plane"):
            continue
        serving = label == "flagship 64x64"
        records, k6_ms, dec_ms, k6_bms, dec_bms, queue = rans_times(
            torch, label, sym, cmap, tab, words, totals, serving)
        if not serving:
            continue
        out.update(records)
        log(f"K6 at {tuple(sym.shape)}: both passes {k6_ms:.4f} ms, bound "
            f"{k6_bms:.4f} ms; K5 {dec_ms:.4f} ms, bound {dec_bms:.4f} ms")
        rans_chain_probe(torch, sym, cmap, tab, queue, k6_ms, dec_ms,
                         k6_bms, dec_bms)
    return out


def rans_chain_probe(torch, sym, cmap, tab, queue, k6_ms, dec_ms, k6_bms,
                     dec_bms):
    """The serial chain of K6's state pass and of K5 from their probe build
    (csrc/probes/rans_probe.cu: thread 0 of each block reads clock64 and
    the nanosecond timer around its loop): cycles a step in the kernel at
    the serving geometry, and with one warp of 32 streams on one tile (the
    step's dependent chain alone, nothing else on its SM); the chain
    figure is the latter's T steps at the clock read beside it."""
    from cnn_autoencoder_tpu_torch.ops.kernels import build
    from cnn_autoencoder_tpu_torch.ops.kernels import rans_kernel as rk
    lib = PROBES["rans_probe"]
    stream = torch.cuda.current_stream().cuda_stream

    def read(which, blocks, steps):
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (4 * blocks))()
        build.check_launch(lib.cae_rans_probe_read(
            which, ctypes.addressof(buf), blocks), "rans probe read")
        rec = np.ctypeslib.as_array(buf).astype(np.float64).reshape(
            blocks, 4)
        cycles, ns = rec[:, 1] - rec[:, 0], rec[:, 3] - rec[:, 2]
        return float(cycles.mean() / steps), float(cycles.sum() / ns.sum())

    def probe(sym, cmap, q):
        b, t, s = sym.shape
        st = rk.encode_states_cuda(sym, cmap, tab.freq, tab.start,
                                   tab.offset)
        lut = rk.pack_dec_lut(tab.freq, tab.start, tab.slot)
        vals = torch.empty((b, t, s), dtype=torch.int32, device="cuda")
        scratch = torch.empty((b, s), dtype=torch.int32, device="cuda")
        blocks = b * -(-(-(-s // 32) * 32) // 256)
        for _ in range(2):  # the second launch is read
            build.check_launch(lib.cae_rans_encode_states(
                sym.data_ptr(), cmap.data_ptr(), tab.freq.data_ptr(),
                tab.start.data_ptr(), tab.offset.data_ptr(),
                tab.freq.shape[0], tab.freq.shape[1], b, t, s,
                st.words.data_ptr(), st.flags.data_ptr(),
                st.final.data_ptr(), st.counts.data_ptr(), stream),
                "rans probe state pass")
        enc = read(0, blocks, t)
        for _ in range(2):
            build.check_launch(lib.cae_rans_decode(
                q.data_ptr(), b, q.shape[1], cmap.data_ptr(),
                lut.data_ptr(), lut.shape[0], vals.data_ptr(),
                scratch.data_ptr(), t, s, stream), "rans probe decode")
        dec = read(1, b, t)
        laps = (ctypes.c_ulonglong * (4 * b))()
        build.check_launch(lib.cae_rans_probe_laps(ctypes.addressof(laps), b),
                           "rans probe laps")
        laps = np.ctypeslib.as_array(laps).astype(np.float64).reshape(b, 4)
        check(torch.equal(vals, rk.decode_interleaved_cuda(q, cmap, lut, t)),
              "rans probe build: decode differs from the library's")
        return enc, dec, laps.mean(axis=0) / t

    t = cmap.shape[0]
    (enc_step, enc_ghz), (dec_step, dec_ghz), laps = probe(sym, cmap, queue)
    one_sym = sym[:1, :, :32].contiguous()
    one_map = cmap[:, :32].contiguous()
    one_words, one_tot = rk.compact_cuda(rk.encode_states_cuda(
        one_sym, one_map, tab.freq, tab.start, tab.offset), 64 + t * 32)
    (enc_chain, enc_ghz1), (dec_chain, dec_ghz1), _ = probe(
        one_sym, one_map, u16_prefix(torch, one_words, 64 + t * 32,
                                     -(-(64 + t * 32) // 128) * 128))
    for name, step, ghz, chain, ghz1, ms, bms in (
            ("rans_encode_states", enc_step, enc_ghz, enc_chain, enc_ghz1,
             k6_ms, k6_bms),
            ("rans_decode", dec_step, dec_ghz, dec_chain, dec_ghz1, dec_ms,
             dec_bms)):
        log(f"{name} probe {tuple(sym.shape)}: {step:.1f} cycles a step in "
            f"the kernel ({step * t / ghz / 1e6:.4f} ms over {t} steps at "
            f"{ghz:.3f} GHz); one warp alone {chain:.1f} cycles a step, so "
            f"the serial chain of {t} steps takes "
            f"{chain * t / ghz1 / 1e6:.4f} ms at {ghz1:.3f} GHz; kernel "
            f"{ms:.4f} ms (K6: both passes), byte bound {bms:.4f} ms")
    log(f"rans_decode probe {tuple(sym.shape)}: a step's cycles by part "
        f"(thread 0 of each block, mean): the states' decode {laps[0]:.1f}, "
        f"the wait for copies and the barrier {laps[1]:.1f}, the counts of "
        f"the warps before {laps[2]:.1f}, the refills {laps[3]:.1f}")


# -- phase 3 -----------------------------------------------------------------


def plain_reconstruct(torch, model, core, tiles_u8, symbols):
    """The serving round trip through the plain versions only, on the card,
    at the core's compute type: (symbols (B, C, lh, lw), u8 reconstruction
    (B, H, W, 3)).  The plain rANS round trip runs on the plain encoder's
    own symbols; the plain decoder synthesizes ``symbols`` (the kernels'
    path's), so the two reconstructions come from the same quantized
    latent, as tests/test_rd_parity.py compares them."""
    from cnn_autoencoder_tpu_torch.coding.device_rans import (
        pack_streams, unpack_streams)
    from cnn_autoencoder_tpu_torch.ops.kernels.conv_gdn_kernel import (
        conv_gdn_mode, conv_gdn_plain)
    from cnn_autoencoder_tpu_torch.ops.kernels.gdn_kernel import gdn_plain
    from cnn_autoencoder_tpu_torch.ops.kernels.rans_kernel import (
        pack_dec_lut, rans_decode_plain, rans_encode_plain)

    def gdn(x, mod, inverse):
        gamma, beta = mod.effective_params()
        c = x.shape[-1]
        return gdn_plain(x.reshape(-1, c), gamma, beta,
                         inverse).reshape(x.shape)

    dtype = core.base.compute_dtype
    mode = core.base.precision  # the layers' compute_dtype, as the core's
    with torch.no_grad():
        x = (torch.from_numpy(tiles_u8).cuda().float() / 255.0).to(dtype)
        for name in model.encoder.names:
            unit = getattr(model.encoder, name)
            fused = conv_gdn_mode(x.dtype, mode) if unit.fused else None
            if fused is not None:
                gamma, beta = unit.gdn_down.effective_params()
                x = conv_gdn_plain(x, unit.conv_down.kernel_hwio(), gamma,
                                   beta, fused)
            elif unit.act == "GDN":
                x = gdn(unit.conv_down(x, mode), unit.gdn_down, False)
            else:
                check(unit.act is None, f"{name}: activation {unit.act}")
                x = unit.conv_down(x, mode)
        sym = torch.round(x - core.base._med).to(torch.int32)
        sym = sym.permute(0, 3, 1, 2).contiguous()
        bsz, c, lh, lw = sym.shape
        s = core.num_streams
        cmap = core._ch_map(lh, lw, s)
        tab = core.tables
        packed = pack_streams(sym.reshape(bsz, -1), s)
        t = packed.shape[1]
        words, totals = rans_encode_plain(packed, cmap, tab.freq, tab.start,
                                          tab.offset, 2 * s + t * s)
        vals = rans_decode_plain(words, cmap, pack_dec_lut(
            tab.freq, tab.start, tab.slot), t)
        dec = unpack_streams(vals + tab.offset[cmap.long()][None],
                             c * lh * lw).reshape(sym.shape)
        check(torch.equal(dec, sym), "plain rANS round trip lost symbols")
        y = (symbols.permute(0, 2, 3, 1).float() + core.base._med).to(dtype)
        for name in model.decoder.names:
            unit = getattr(model.decoder, name)
            y = unit.deconv_up(y, mode)
            if unit.act == "GDN":
                y = gdn(y, unit.gdn_up, True)
            else:
                check(unit.act is None, f"{name}: activation {unit.act}")
        rec = torch.clamp(y.float() * 255.0, 0, 255).to(torch.uint8)
    return sym, rec.cpu().numpy()


def serving_round_trip(torch, model, core, imgs, mode, expect=None):
    """One counted, timed round trip of the tiles through ``core`` at its
    precision ``mode`` (launch counts reset just before and read just
    after), symbols lossless, then the same tiles through the plain
    versions on the card.  ``expect``: the model's kernels and their
    launches (None: K1 3 and K4 1 of ``mode``).  Returns (launches, record
    of the round trip)."""
    from cnn_autoencoder_tpu_torch.ops.kernels import (kernel_wrappers,
                                                       reset_launch_counts)
    from cnn_autoencoder_tpu_torch.storage.turbo_codec import is_turbo_frame
    tiles = imgs.shape[0]
    mpix = tiles * 512 * 512 / 1e6

    # warm-up pass (cuDNN plans, allocator), then the counted, timed pass
    core.decode_tiles(core.encode_tiles(imgs))
    torch.cuda.synchronize()
    retries = core.capacity_retries
    reset_launch_counts()
    t0 = time.perf_counter()
    frames = core.encode_tiles(imgs)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rec = core.decode_tiles(frames)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {fn.kernel_name: fn.launches for fn in kernel_wrappers()}
    retries = core.capacity_retries - retries
    log(f"serving path ({mode}) launches: {launches}; {retries} capacity "
        f"retries: {launches['rans_encode_states']} state pass and "
        f"{launches['rans_compact']} compactions in the round trip")
    if expect is None:
        expect = {SERVING_KERNELS[mode][0]: 3, SERVING_KERNELS[mode][1]: 1}
    for name, n in launches.items():
        check((n > 0) == (name in expect or name in RANS_KERNELS),
              f"kernel {name}: {n} launches on the {mode} serving path")
    got = {name: launches[name] for name in expect}
    check(got == expect and launches["rans_decode"] == 1,
          f"{mode} serving path: launches {got}, rans_decode "
          f"{launches['rans_decode']}; expected {expect} and 1")
    check(launches["rans_encode_states"] == 1
          and launches["rans_compact"] == 1 + retries,
          "the encode should run one state pass and one compaction per "
          "capacity tried")

    check(len(frames) == tiles and all(is_turbo_frame(f) for f in frames),
          "not every frame is a turbo frame")
    check(rec.shape == imgs.shape and rec.dtype == np.uint8,
          f"reconstruction {rec.shape} {rec.dtype}")
    with torch.no_grad():
        sym_enc = core.latent_symbols(imgs)
        sym_dec = core.symbols_from_frames(
            frames, core.num_streams, 512, 512)
    check(torch.equal(sym_enc, sym_dec), "decoded symbols differ from the "
          "encoded ones")
    mse = np.mean((rec.astype(np.float64) - imgs) ** 2)
    psnr = 10 * np.log10(255.0 ** 2 / mse)
    bpp = 8.0 * sum(len(f) for f in frames) / (tiles * 512 * 512)
    log(f"end to end ({mode}): {tiles} tiles of 512^2, all turbo, symbols "
        f"lossless; PSNR {psnr:.3f} dB, {bpp:.4f} bpp; encode "
        f"{mpix / (t1 - t0):.3f} MP/s ({(t1 - t0) * 1e3:.1f} ms), decode "
        f"{mpix / (t2 - t1):.3f} MP/s ({(t2 - t1) * 1e3:.1f} ms)")

    sym_p, rec_p = plain_reconstruct(torch, model, core, imgs, sym_enc)
    flips = float((sym_p != sym_enc).float().mean())
    diff = np.abs(rec_p.astype(np.int32) - rec)
    frac = float(np.mean(diff != 0))
    log(f"plain versions on the card ({mode}): symbol flips {flips:.3e}; "
        f"from the same symbols, u8 pixels differing {frac:.3e}, max "
        f"difference {int(diff.max())}")
    check(flips <= 1e-4, f"{mode}: symbol flips {flips:.3e} > 1e-4")
    check(frac < 5e-3 and int(diff.max()) <= 1, f"{mode}: plain and kernel "
          "reconstructions differ beyond 0.5% / 1 level")
    return launches, dict(frames=frames, rec=rec, sym=sym_enc, psnr=psnr,
                          bpp=bpp, encode_ms=(t1 - t0) * 1e3,
                          decode_ms=(t2 - t1) * 1e3)


def phase_end_to_end(torch, model, core, tiles):
    """Phase 3: the float32 and bf16 round trips, each with its own launch
    counts, the deconvolutions and decodes bit-equal from run to run;
    returns (launches summed over both round trips, the bf16 core)."""
    from cnn_autoencoder_tpu_torch.storage.turbo_codec import (
        CAETurboCore, ConvolutionalAutoencoderTurbo)

    imgs = np.stack([image(512, 512, seed) for seed in range(tiles)])
    launches, f32 = serving_round_trip(torch, model, core, imgs, "float32")
    frames, rec, sym_enc = f32["frames"], f32["rec"], f32["sym"]

    # the codec object a zarr store holds, on one tile
    codec = ConvolutionalAutoencoderTurbo(CHECKPOINT, num_streams=1024)
    buf = codec.encode(imgs[0])
    check(buf == frames[0], "codec.encode differs from encode_tiles")
    # cuBLAS may pick another algorithm for the products of a batch of
    # one, so the reconstruction is held to the u8 tolerance, not bit
    # equality
    diff = np.abs(codec.decode(buf).astype(np.int32) - rec[0])
    check(np.mean(diff != 0) < 5e-3 and int(diff.max()) <= 1,
          "codec.decode differs from decode_tiles beyond 0.5% / 1 level")
    round_trip_2048(torch, model, imgs, sym_enc, rec)
    profile_device(torch, lambda: core.decode_tiles(core.encode_tiles(imgs)),
                   "one more round trip", copies=True)

    deconv_times(torch, model, tiles)
    core16 = CAETurboCore(model, num_streams=1024, device="cuda",
                          compute_dtype=torch.bfloat16)
    bf16_launches, bf16 = serving_round_trip(torch, model, core16, imgs,
                                             "bf16")
    d_psnr = bf16["psnr"] - f32["psnr"]
    mpix = tiles * 512 * 512 / 1e6
    log(f"bf16 against float32 serving: PSNR {bf16['psnr']:.3f} / "
        f"{f32['psnr']:.3f} dB (delta {d_psnr:+.4f}, limit "
        f"{BF16_PSNR_DB}), {bf16['bpp']:.4f} / {f32['bpp']:.4f} bpp; "
        f"encode {mpix / bf16['encode_ms'] * 1e3:.3f} / "
        f"{mpix / f32['encode_ms'] * 1e3:.3f} MP/s, decode "
        f"{mpix / bf16['decode_ms'] * 1e3:.3f} / "
        f"{mpix / f32['decode_ms'] * 1e3:.3f} MP/s")
    check(abs(d_psnr) <= BF16_PSNR_DB, f"bf16 serving PSNR differs from "
          f"float32's by {d_psnr:+.4f} dB")
    for name, n in bf16_launches.items():
        launches[name] += n
    for label, c, fr in (("float32", core, frames),
                         ("bf16", core16, bf16["frames"])):
        decodes_bit_equal(torch, c, fr, label)
    profile_device(torch, lambda: core16.decode_tiles(
        core16.encode_tiles(imgs)), "one more bf16 round trip", copies=True)
    return launches, core16


def deconv_times(torch, model, tiles):
    """The decoder's transposed convolutions at the round trip's shapes,
    float32 and bf16, three ways: the port's (a fixed order of sums),
    cuDNN's ``F.conv_transpose2d`` at its default algorithms, and the same
    with ``torch.backends.cudnn.deterministic`` (timings only, set for the
    call and restored)."""
    import torch.nn.functional as F
    from cnn_autoencoder_tpu_torch.ops.convops import _conv_operands
    from cnn_autoencoder_tpu_torch.utils.device import full_f32
    gen = torch.Generator(device="cuda").manual_seed(12)

    def cudnn(x, weight, bias):
        with full_f32():
            return F.conv_transpose2d(x.permute(0, 3, 1, 2), weight, bias,
                                      stride=2, padding=1, output_padding=1)

    def cudnn_deterministic(x, weight, bias):
        saved = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            return cudnn(x, weight, bias)
        finally:
            torch.backends.cudnn.deterministic = saved

    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            totals = np.zeros(3)
            for i, name in enumerate(model.decoder.names):
                mod = getattr(model.decoder, name).deconv_up
                side = 64 * 2 ** i
                x = (0.5 * torch.randn(tiles, side, side, mod.weight.shape[0],
                                       device="cuda", generator=gen)
                     ).to(dtype)
                weight, bias = _conv_operands(x, mod.weight, mod.bias)
                t = np.array([cuda_ms(torch, lambda: mod(x), 10)]
                             + [cuda_ms(torch, lambda: fn(x, weight, bias), 10)
                                for fn in (cudnn, cudnn_deterministic)])
                totals += t
                log(f"deconv {name} {tuple(x.shape)} -> "
                    f"{mod.weight.shape[1]} {str(dtype)[6:]}: port "
                    f"{t[0]:.4f} ms, cuDNN default {t[1]:.4f} ms, cuDNN "
                    f"deterministic {t[2]:.4f} ms")
                del x
            log(f"deconv: the three layers {str(dtype)[6:]}: port "
                f"{totals[0]:.4f} ms, cuDNN default {totals[1]:.4f} ms, cuDNN "
                f"deterministic {totals[2]:.4f} ms")
    torch.cuda.empty_cache()


def decodes_bit_equal(torch, core, frames, label):
    """Three decodes of the same frames, bit-equal, with cuDNN's
    deterministic switch off (fault 5: cuDNN's default transposed
    convolutions add in a varying order; the port's do not)."""
    check(not torch.backends.cudnn.deterministic,
          "cudnn.deterministic is set")
    recs = [core.decode_tiles(frames) for _ in range(3)]
    check(all(np.array_equal(recs[0], r) for r in recs[1:]),
          f"{label}: three decodes of the same symbols differ")
    log(f"{label}: three decodes of the same {len(frames)} frames are "
        f"bit-equal ({recs[0].size} values each)")


def round_trip_2048(torch, model, imgs, sym_enc, rec):
    """The same tiles through a CAETurboCore of 2048 streams (above the
    1024 the earlier rANS kernels took): symbols lossless, the
    reconstruction that of the 1024-stream core within the u8 tolerance."""
    from cnn_autoencoder_tpu_torch.storage.turbo_codec import CAETurboCore
    core = CAETurboCore(model, num_streams=2048, device="cuda")
    core.decode_tiles(core.encode_tiles(imgs))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = core.encode_tiles(imgs)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rec2 = core.decode_tiles(frames)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    with torch.no_grad():
        sym_dec = core.symbols_from_frames(frames, 2048, 512, 512)
    check(torch.equal(sym_dec, sym_enc), "2048 streams: decoded symbols "
          "differ from the encoded ones")
    diff = np.abs(rec2.astype(np.int32) - rec)
    check(np.mean(diff != 0) < 5e-3 and int(diff.max()) <= 1,
          "2048 streams: reconstruction differs from 1024 streams'")
    mpix = imgs.shape[0] * 512 * 512 / 1e6
    bpp = 8.0 * sum(len(f) for f in frames) / (imgs.shape[0] * 512 * 512)
    log(f"end to end at 2048 streams: symbols lossless, {bpp:.4f} bpp, "
        f"{core.capacity_retries} capacity retries over two round trips; "
        f"encode {mpix / (t1 - t0):.3f} MP/s ({(t1 - t0) * 1e3:.1f} ms), "
        f"decode {mpix / (t2 - t1):.3f} MP/s ({(t2 - t1) * 1e3:.1f} ms)")


def profile_device(torch, fn, label, copies=False):
    """Device time by operation over one more call of ``fn`` (the 15
    largest rows and every row of the port's own kernels), and the share
    of the wall time the device was busy; with ``copies``, the host<->device
    copies' time, count and bytes from the trace.  Returns the busy
    seconds."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for evt in prof.key_averages():
        # device-side entries only (kernels and copies): an operator's row
        # repeats the device time of the kernels it launched
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or evt.key == "Activity Buffer Request"):
            continue
        rows.append((evt.self_device_time_total, evt.count, evt.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    log(f"profile of {label}: wall {wall * 1e3:.3f} ms, device busy "
        f"{busy * 1e3:.3f} ms ({100 * busy / wall:.1f}%)")
    for us, count, key in rows[:15]:
        log(f"  {us / 1e3:9.3f} ms  {count:5d}x  {key[:90]}")
    # the port's own kernels (csrc/, anonymous namespaces) below those rows
    ours = [r for r in rows[15:] if "(anonymous namespace)::" in r[2]
            and "at::native" not in r[2]]
    if ours:
        log("  ... the port's kernels below them:")
    for us, count, key in ours:
        log(f"  {us / 1e3:9.3f} ms  {count:5d}x  {key[:90]}")
    if copies:
        copy_rows(prof)
    return busy


def copy_rows(prof):
    """Host<->device copies of a profile, from its trace (the bytes are
    only there): ms, count and bytes by direction."""
    path = os.path.join(ROOT, "build", "profile_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    rows = {}
    for evt in events:
        name = evt.get("name", "")
        if evt.get("cat") != "gpu_memcpy" or ("HtoD" not in name
                                               and "DtoH" not in name):
            continue
        row = rows.setdefault(name, [0.0, 0, 0])
        row[0] += evt.get("dur", 0.0) / 1e3
        row[1] += 1
        row[2] += int(evt.get("args", {}).get("bytes", 0))
    for name, (ms, count, nbytes) in sorted(rows.items()):
        log(f"  copies {name}: {ms:.3f} ms, {count}x, {nbytes} bytes")


# -- phase 4 -----------------------------------------------------------------


def bf16_ulps(a, b):
    """Largest distance in bf16 ulps between two bf16 tensors whose
    elements share their signs."""
    import torch
    return int((a.view(torch.int16).int() - b.view(torch.int16).int())
               .abs().max())


def close(got, ref, rel, slack):
    """max |got - ref| <= rel * |ref| + slack * max |ref|, elementwise;
    returns (ok, max abs error)."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    ok = bool((err <= rel * ref.abs() + slack * ref.abs().max()).all())
    return ok, float(err.max())


# K4's bf16 default route (modes 2 and 3) rounds y to bf16: mode 2 once,
# mode 3 at the border form's five points (the interior sum; on output row
# 0 and column 0 the corrections dr and dc and the adds after them).  Where
# a sum lies on a rounding boundary the kernel's and the plain version's
# orders of float32 sums round it one ulp apart.  Such values are few: at
# most this share of y may differ
ROUNDED_SHARE = 1e-3


def border_terms(torch, x, kernel):
    """The plain border form's rounded terms of K4 mode 3 at bf16 x (NHWC),
    as float32 NCHW: the interior sum s1, row 0's correction dr (B, Cout,
    1, W/2), s2 = bf16(s1 + dr) on row 0 (s1 elsewhere), and column 0's
    correction dc (B, Cout, H/2, 1) (``convops.border_form``)."""
    import torch.nn.functional as F
    from cnn_autoencoder_tpu_torch.utils.device import full_f32
    xn = x.permute(0, 3, 1, 2).float()
    w = kernel.permute(3, 2, 0, 1).float().to(torch.bfloat16).float()

    def conv(inp, wt, stride, padding):
        with full_f32():
            return F.conv2d(inp, wt, stride=stride, padding=padding).to(
                torch.bfloat16).float()

    s1 = conv(xn, w, 2, 1)
    row = torch.cat([xn[:, :, 1:2, 1:2], xn[:, :, 1:2]], 3)
    col = F.pad(xn[:, :, :, 1:2], (0, 0, 1, 0))
    dr = conv(row, w[:, :, :1], (1, 2), 0)
    dc = conv(col, w[:, :, :, :1], (2, 1), 0)
    s2 = s1.clone()
    s2[:, :, :1] = (s1[:, :, :1] + dr).to(torch.bfloat16).float()
    return s1, dr, s2, dc


def rounded_check(torch, x, kernel, gamma, beta, mode, out, y, r, label):
    """K4's training variant in mode 2 or 3 (out, y, r) against its plain
    version: each value of y within one bf16 ulp (at most 2^-7 of the
    magnitude) of each rounded term it sums (mode 3's border terms on row
    0 and column 0, so a one-ulp step of a large term that a later add
    cancels passes, and nothing larger), plus 2^-16 of max |y| for sums
    at zero, with at most ROUNDED_SHARE of y differing; then r and out
    within one bf16 ulp of the plain GDN of the kernel's own y.  Logs the
    share of y that differs on the border (row 0 or column 0) and inside.
    Returns (max abs error of out against the plain run, of y, share of y
    that differs)."""
    from cnn_autoencoder_tpu_torch.ops.kernels import conv_gdn_kernel as cg
    out_p, y_p, _ = cg.conv_gdn_train_plain(x, kernel, gamma, beta, mode)
    yk, yp = y.float(), y_p.float()
    terms = yp.abs().permute(0, 3, 1, 2).clone()
    if mode == cg.BORDER_BF16:
        s1, dr, s2, dc = border_terms(torch, x, kernel)
        terms[:, :, :1] += s1[:, :, :1].abs() + dr.abs()
        terms[:, :, :, :1] += s2[:, :, :, :1].abs() + dc.abs()
        del s1, dr, s2, dc
    terms = terms.permute(0, 2, 3, 1)
    limit = 2.0 ** -7 * terms + 2.0 ** -16 * float(yp.abs().max())
    err_y = (yk - yp).abs()
    differ = yk != yp
    border = torch.zeros_like(differ)
    border[:, :1] = True
    border[:, :, :1] = True
    share = float(differ.float().mean())
    share_b = float(differ[border].float().mean())
    share_i = float(differ[~border].float().mean())
    ok_y = bool((err_y <= limit).all()) and share <= ROUNDED_SHARE
    out_c, r_c = cg.rounded_gdn_plain(y, gamma, beta)
    ok_r, r_err = close(r, r_c, 2.0 ** -7, 0.0)
    ok_o, o_err = close(out, out_c, 2.0 ** -7, 0.0)
    y_err = float(err_y.max())
    worst = float((err_y / limit).max())
    log(f"{label} mode {mode}: y max abs {y_err:.3e} ({worst:.3f} of its "
        f"limit), {share:.3e} of y differs ({share_b:.3e} of row 0 and "
        f"column 0, {share_i:.3e} inside); r {r_err:.3e} and out "
        f"{o_err:.3e} from the plain GDN of the kernel's y")
    check(ok_y and ok_r and ok_o,
          f"{label} mode {mode}: y error {y_err:.3e} ({worst:.3f} of its "
          f"limit, {share:.3e} of y differs), r error {r_err:.3e}, out "
          f"error {o_err:.3e}")
    return float((out.float() - out_p.float()).abs().max()), y_err, share


def check_gdn_fwd_case(torch, x, gamma, beta, inverse, label):
    """K2 against its plain version: y to K1_REL_LIMIT relative and equal
    to K1's on the same rows (float32, K1's kernel with r) or to one bf16
    ulp, r to one bf16 ulp.  Returns (max abs error of y, r)."""
    from cnn_autoencoder_tpu_torch.ops.kernels import gdn_kernel as gk
    bf16 = x.dtype == torch.bfloat16
    fwd = gk.gdn_train_fwd_cuda if bf16 else gk.gdn_train_fwd_f32_cuda
    y, rb = fwd(x, gamma, beta, inverse)
    y_p, rb_p = gk.gdn_train_fwd_plain(x, gamma, beta, inverse)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(y.float()).all()), f"{label}: y not finite")
    if bf16:
        check(bf16_ulps(y, y_p) <= 1, f"gdn_train_fwd {label}: y differs "
              "from the plain version by more than one bf16 ulp")
        ok, y_err = close(y, y_p, 1, 0)
    else:
        ok, y_err = close(y, y_p, K1_REL_LIMIT, 0.0)
        check(torch.equal(y, gk.gdn_cuda(x, gamma, beta, inverse)),
              f"gdn_train_fwd_f32 {label}: y differs from gdn_fwd's")
    check(ok, f"gdn_train_fwd {label}: y error {y_err:.3e}")
    check(bf16_ulps(rb, rb_p) <= 1, f"gdn_train_fwd {label}: r differs "
          "by more than one bf16 ulp")
    return y_err, rb


def check_gdn_train_case(torch, x, gamma, beta, inverse, label, rng):
    """K2 then K3 on the same rows, each against its plain version: K2 by
    check_gdn_fwd_case, dnb to one bf16 ulp, dx to one bf16 ulp (2^-7
    relative) or 1e-5 relative, plus 1e-5 of max |dx| for the sums' order;
    K3's dbeta (the float32 dnorm's column sums) to 1e-4 of the column
    sums of |dnorm| (float32 sums in another order), with dx and dnb
    bit-equal to the run without it.  Returns the max abs errors of y and
    dx."""
    from cnn_autoencoder_tpu_torch.ops.kernels import gdn_kernel as gk
    bf16 = x.dtype == torch.bfloat16
    y_err, rb = check_gdn_fwd_case(torch, x, gamma, beta, inverse, label)
    g = torch.from_numpy(rng.randn(*x.shape).astype(np.float32)).cuda()
    g = g.to(x.dtype)
    xb = x.to(torch.bfloat16)
    dx, dnb = gk.gdn_train_bwd_cuda(g, xb, rb, gamma, inverse)
    dx_p, dnb_p = gk.gdn_train_bwd_plain(g, xb, rb, gamma, inverse)
    torch.cuda.synchronize()
    check(bf16_ulps(dnb, dnb_p) <= 1, f"gdn_train_bwd {label}: dnb differs "
          "by more than one bf16 ulp")
    ok, dx_err = close(dx, dx_p, 2.0 ** -7 if bf16 else 1e-5, 1e-5)
    check(ok, f"gdn_train_bwd {label}: dx error {dx_err:.3e}")
    dx_s, dnb_s, db = gk.gdn_train_bwd_cuda(g, xb, rb, gamma, inverse,
                                            want_dbeta=True)
    db_p = gk.gdn_train_bwd_plain(g, xb, rb, gamma, inverse, True)[2]
    # |dnorm| = dnorm of |g| and |x| up to its sign (r > 0)
    mag = gk.gdn_train_bwd_plain(g.abs(), xb.abs(), rb, gamma, inverse,
                                 True)[2].abs()
    torch.cuda.synchronize()
    db_err = float((db - db_p).abs().max())
    check(torch.equal(dx_s, dx) and torch.equal(dnb_s, dnb),
          f"gdn_train_bwd {label}: dx or dnb changed with dbeta's sums")
    check(bool(((db - db_p).abs() <= 1e-4 * mag).all()),
          f"gdn_train_bwd {label}: dbeta error {db_err:.3e}")
    log(f"gdn_train_fwd/bwd {label}: y max abs {y_err:.3e}, dx max abs "
        f"{dx_err:.3e}, dnb identical on "
        f"{float((dnb == dnb_p).float().mean()):.6f} of elements, dbeta "
        f"max abs {db_err:.3e} (max column sum of |dnorm| "
        f"{float(mag.max()):.3e})")
    return y_err, dx_err


def check_gdn_train_misaligned(torch, rng):
    """K2 and K3 on inputs whose rows start one element past a 16-byte
    boundary (views into larger buffers), which they stage element by
    element: held to their plain versions with check_gdn_train_case's
    limits."""
    from cnn_autoencoder_tpu_torch.ops.kernels import gdn_kernel as gk
    rows, c = 131, 128
    gamma = torch.from_numpy((0.1 * rng.rand(c, c)).astype(np.float32)).cuda()
    beta = torch.from_numpy((1.0 + rng.rand(c)).astype(np.float32)).cuda()

    def shifted(a, dt):
        buf = torch.empty(a.size + 8, dtype=dt, device="cuda")
        view = buf[1:1 + a.size].view(rows, c)
        view.copy_(torch.from_numpy(a).to(dt))
        return view

    for dtype in (torch.bfloat16, torch.float32):
        bf16 = dtype == torch.bfloat16
        x = shifted(rng.randn(rows, c).astype(np.float32), dtype)
        g = shifted(rng.randn(rows, c).astype(np.float32), dtype)
        xb = shifted(rng.randn(rows, c).astype(np.float32), torch.bfloat16)
        rb = shifted((0.5 + rng.rand(rows, c)).astype(np.float32),
                     torch.bfloat16)
        check(x.data_ptr() % 16 != 0 and g.data_ptr() % 16 != 0
              and xb.data_ptr() % 16 != 0,
              "misaligned K2/K3 case: the views are aligned")
        for inverse in (False, True):
            label = f"misaligned ({rows}, {c}) {str(dtype)[6:]} " \
                    f"inverse={inverse}"
            y_err, _ = check_gdn_fwd_case(torch, x, gamma, beta, inverse,
                                          label)
            dx, dnb = gk.gdn_train_bwd_cuda(g, xb, rb, gamma, inverse)
            dx_p, dnb_p = gk.gdn_train_bwd_plain(g, xb, rb, gamma, inverse)
            torch.cuda.synchronize()
            check(bf16_ulps(dnb, dnb_p) <= 1, f"gdn_train_bwd {label}: dnb "
                  "differs by more than one bf16 ulp")
            ok, err = close(dx, dx_p, 2.0 ** -7 if bf16 else 1e-5, 1e-5)
            check(ok, f"gdn_train_bwd {label}: dx error {err:.3e}")
            log(f"gdn_train_fwd/bwd {label}: y max abs {y_err:.3e}, dx max "
                f"abs {err:.3e}")


def k2f_probe(torch, name, x, gamma, beta, inverse, y, rb):
    """K2 on float32 rows as the probe build ``name`` computes it, into
    ``y`` and ``rb``."""
    from cnn_autoencoder_tpu_torch.ops.kernels import build
    n, c = x.shape
    build.check_launch(PROBES[name].cae_gdn_train_fwd_f32(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
        rb.data_ptr(), n, c, int(inverse),
        torch.cuda.current_stream().cuda_stream), name)
    return y, rb


def check_k2f_layouts(torch, rng):
    """K2 on float32 rows at K1's wider layouts (C = 136: gamma resident
    without r tiles; 1000 and 1552: gamma streamed, 64- and 32-row tiles;
    1553: x in K-slices), GDN and IGDN, by check_gdn_fwd_case (y equal to
    K1's); then its plan at the flagship's C = 128, which must keep gamma
    resident with an r tile a group."""
    for n, c in ((300, 136), (70, 1000), (33, 1552), (67, 1553)):
        gamma = torch.from_numpy((0.1 * rng.rand(c, c)).astype(np.float32)) \
            .cuda()
        beta = torch.from_numpy((1.0 + rng.rand(c)).astype(np.float32)).cuda()
        x = torch.from_numpy(rng.randn(n, c).astype(np.float32)).cuda()
        errs = [check_gdn_fwd_case(torch, x, gamma, beta, inverse,
                                   f"({n}, {c}) float32 inverse={inverse}")[0]
                for inverse in (False, True)]
        log(f"gdn_train_fwd_f32 ({n}, {c}): y max abs {errs[0]:.3e} / "
            f"{errs[1]:.3e} (GDN / IGDN), equal to gdn_fwd's, r within one "
            f"bf16 ulp; layout {k1_layout(c, want_r=True)}")
    plan = k1_layout(128, want_r=True)
    log(f"gdn_train_fwd_f32 plan at C = 128: {plan}; K1's "
        f"{k1_layout(128)}; r from the registers (probe k2f_r_regs) "
        f"{k1_layout(128, want_r=True, probe='k2f_r_regs')}")
    check(plan["groups"] == 2 and plan["gamma_resident"] == 1
          and plan["r_tiles"] == 1, "gdn_train_fwd_f32 at C = 128: not the "
          f"resident layout with r tiles: {plan}")


def time_probes(torch, kernel, probes, call, laps_fn, parts, tiles, shape):
    """Each probe build of ``probes`` (``call(lib, name)`` launches it once)
    timed by CUDA events, with the clock64 cycles of each part of a tile
    that its ``laps_fn`` reads and zeroes (thread 0 of a block, over
    ``tiles`` tiles a launch); returns {name: ms}."""
    from cnn_autoencoder_tpu_torch.ops.kernels import build
    reps, times = 20, {}
    for name in probes:
        lib = PROBES[name]
        laps = (ctypes.c_ulonglong * 4)()
        read = getattr(lib, laps_fn)
        build.check_launch(read(laps), name)  # zero
        times[name] = cuda_ms(torch, lambda: call(lib, name), reps)
        build.check_launch(read(laps), name)
        per_tile = [v / ((reps + 1) * tiles) for v in laps]
        log(f"{kernel} probe {name} {shape} bf16: {times[name]:.4f} ms; "
            "cycles a 32-row tile (thread 0 of a block) by part: "
            + ", ".join(f"{p} {v:.1f}" for p, v in zip(parts, per_tile)))
    return times


def k2_yardsticks(torch, xb, gamma, beta, ms, dev_ms, bms, mm_ms):
    """K2 at the timed shape (CUDA events around the wrapper ``ms``, the
    device time of its kernels ``dev_ms``) beside its probes (the kernel
    with cycle counts by part of a tile; the same without device-memory
    traffic, what the SM spends) and beside cuBLAS's bf16 product of the
    same shape alone (``mm_ms``)."""
    from cnn_autoencoder_tpu_torch.ops.kernels import build
    n, c = xb.shape
    y = torch.empty_like(xb)
    rb = torch.empty_like(xb)
    g32 = gamma.detach().float().contiguous()
    b32 = beta.detach().float().contiguous()
    work = torch.empty(build.load_library().cae_gdn_train_fwd_workspace(c),
                       dtype=torch.uint8, device=xb.device)

    def call(lib, name):
        build.check_launch(lib.cae_gdn_train_fwd(
            xb.data_ptr(), g32.data_ptr(), b32.data_ptr(), y.data_ptr(),
            rb.data_ptr(), work.data_ptr(), n, c, 0,
            torch.cuda.current_stream().cuda_stream), name)

    # thread 0 is in the first of a block's groups: one tile in as many as
    # the probe's resident block holds
    groups = PROBES["k2_laps"].cae_gdn_fwd_probe_groups()
    time_probes(torch, "gdn_train_fwd", K2_PROBES, call,
                "cae_gdn_fwd_probe_laps",
                ("wait for copies", "x^2", "product", "epilogue"),
                -(-n // (32 * groups)), [n, c])
    log(f"gdn_train_fwd {[n, c]} bf16: kernel {ms:.4f} ms by CUDA events "
        f"around the wrapper ({dev_ms:.4f} ms device time), "
        f"{100 * bms / ms:.1f}% of its bound {bms:.4f} ms; cuBLAS bf16 "
        f"({n}, {c}) @ ({c}, {c}) alone {mm_ms:.4f} ms (a yardstick)")


def k3_yardsticks(torch, g, xb, rb, gamma, ms, bms, mm_ms):
    """K3 at the timed shape beside its probes (the kernel with cycle
    counts by part of a tile; the same without device-memory traffic, what
    the SM spends) and beside cuBLAS's bf16 product of the same shape
    alone (``mm_ms``)."""
    from cnn_autoencoder_tpu_torch.ops.kernels import build
    n, c = g.shape
    dx = torch.empty_like(g)
    dnb = torch.empty(g.shape, dtype=torch.bfloat16, device=g.device)
    g32 = gamma.detach().float().contiguous()
    main = build.load_library()
    work = torch.empty(main.cae_gdn_train_bwd_workspace(c),
                       dtype=torch.uint8, device=g.device)
    is_bf16 = int(g.dtype == torch.bfloat16)
    # dbeta's partial sums, as the training path asks for them
    part = torch.empty(main.cae_gdn_train_bwd_partials(n, c, is_bf16), c,
                       dtype=torch.float32, device=g.device)

    def call(lib, name):
        build.check_launch(lib.cae_gdn_train_bwd(
            g.data_ptr(), xb.data_ptr(), rb.data_ptr(), g32.data_ptr(),
            dx.data_ptr(), dnb.data_ptr(), part.data_ptr(), work.data_ptr(),
            n, c, 0, is_bf16, torch.cuda.current_stream().cuda_stream), name)

    # thread 0 is in the first of a block's two groups: half the 32-row tiles
    time_probes(torch, "gdn_train_bwd", K3_PROBES, call,
                "cae_gdn_bwd_probe_laps",
                ("wait for copies", "dnb", "product", "dx"), -(-n // 64),
                [n, c])
    log(f"gdn_train_bwd {[n, c]} bf16: kernel {ms:.4f} ms; cuBLAS bf16 "
        f"({n}, {c}) @ ({c}, {c}) alone {mm_ms:.4f} ms (a yardstick); "
        f"bound {bms:.4f} ms")


def check_conv_train_case(torch, x, kernel, gamma, beta, label, mode=None):
    """K4's training variant against its plain version in ``mode`` (None:
    the mode now): y to 1e-4 of max |y| and out to 1e-4 of max |out|
    (float32) or one bf16 ulp plus that; in modes 2 and 3 (y and r rounded
    to bf16) by ``rounded_check``.  Returns the max abs error of out."""
    from cnn_autoencoder_tpu_torch.ops.kernels import conv_gdn_kernel as cg
    mode = cg.conv_gdn_mode(x.dtype) if mode is None else mode
    out, y, r = cg.conv_gdn_train_cuda(x, kernel, gamma, beta, mode)
    out_p, y_p, r_p = cg.conv_gdn_train_plain(x, kernel, gamma, beta, mode)
    torch.cuda.synchronize()
    check(out.shape == out_p.shape and out.dtype == x.dtype
          and y.dtype == y_p.dtype and (r is None) == (r_p is None),
          f"conv_gdn_train_fwd {label}: {tuple(out.shape)} {out.dtype} "
          f"{y.dtype}")
    check(bool(torch.isfinite(out.float()).all()), f"{label}: not finite")
    if mode in cg.ROUNDED:
        return rounded_check(torch, x, kernel, gamma, beta, mode, out, y, r,
                             f"conv_gdn_train_fwd {label}")[0]
    ok_y, y_err = close(y, y_p, 0.0, 1e-4)
    ok_o, o_err = close(out, out_p, 2.0 ** -7 if x.dtype == torch.bfloat16
                        else 0.0, 1e-4)
    check(ok_y and ok_o, f"conv_gdn_train_fwd {label}: y error {y_err:.3e}, "
          f"out error {o_err:.3e}")
    log(f"conv_gdn_train_fwd {label} mode {mode}: out max abs {o_err:.3e}, "
        f"y max abs {y_err:.3e}")
    return o_err


def check_conv_case(torch, x, kernel, gamma, beta, label):
    """K4 in both variants at one geometry: the training variant by
    check_conv_train_case, the serving variant equal to the training
    variant's out (and, in float32, within 1e-4 of max |out| of the plain
    version).  Returns the training variant's max abs error of out."""
    from cnn_autoencoder_tpu_torch.ops.kernels import conv_gdn_kernel as cg
    err = check_conv_train_case(torch, x, kernel, gamma, beta, label)
    got = cg.conv_gdn_cuda(x, kernel, gamma, beta)
    ref = cg.conv_gdn_plain(x, kernel, gamma, beta)
    torch.cuda.synchronize()
    ok = (got.shape == ref.shape
          and (x.dtype == torch.bfloat16 or close(got, ref, 0.0, 1e-4)[0]))
    check(ok, f"conv_gdn_fwd {label}: out error "
          f"{float((got.float() - ref.float()).abs().max()):.3e}")
    check(torch.equal(got, cg.conv_gdn_train_cuda(x, kernel, gamma, beta)[0]),
          f"conv_gdn_fwd {label}: differs from the training variant's out")
    return err


def phase_train_kernels(torch, model):
    """K2, K3 and K4's training variant against their plain versions at the
    training path's shapes and at ragged ones, then timed at the path's
    shapes; returns {name: record}."""
    from cnn_autoencoder_tpu_torch.ops.kernels import conv_gdn_kernel as cg
    from cnn_autoencoder_tpu_torch.ops.kernels import gdn_kernel as gk
    rng = np.random.RandomState(1)
    b, h = TRAIN_BATCH, TRAIN_PATCH
    n = b * (h // 2) ** 2           # rows of down_0 and up_1
    out = {}
    with torch.no_grad():
        # K2/K3 at the path's shapes: down_0 (forward, n rows), up_0
        # (inverse, n / 4 rows) and up_1 (inverse, n rows)
        errs = {}
        for rows, inverse, unit, gdn_name in (
                (n, False, model.encoder.down_0, "gdn_down"),
                (n // 4, True, model.decoder.up_0, "gdn_up"),
                (n, True, model.decoder.up_1, "gdn_up")):
            gamma, beta = getattr(unit, gdn_name).effective_params()
            c = gamma.shape[0]
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.from_numpy(rng.randn(rows, c).astype(np.float32)
                                     * 0.5).cuda().to(dtype)
                errs[(rows, inverse, dtype)] = check_gdn_train_case(
                    torch, x, gamma, beta, inverse,
                    f"({rows}, {c}) {str(dtype)[6:]} inverse={inverse}", rng)
                del x
        # C = 48 (the latent's width), ragged C and rows (K3's resident
        # layout up to C = 128, its streamed one above)
        for rows, c in ((1000, 48), (203, 3), (1001, 128), (9, 128),
                        (77, 130), (130, 256), (70, 512)):
            gamma = torch.from_numpy((0.1 * rng.rand(c, c))
                                     .astype(np.float32)).cuda()
            beta = torch.from_numpy((1.0 + rng.rand(c))
                                    .astype(np.float32)).cuda()
            for dtype in (torch.bfloat16, torch.float32):
                for inverse in (False, True):
                    x = torch.from_numpy(rng.randn(rows, c).astype(
                        np.float32)).cuda().to(dtype)
                    check_gdn_train_case(
                        torch, x, gamma, beta, inverse,
                        f"({rows}, {c}) {str(dtype)[6:]} inverse={inverse}",
                        rng)
        # K2 at norms below the range of its branch-free square root (beta
        # 1e-35 and rows of zeros), where its IGDN falls back to sqrtf (K3's
        # function overflows there: r^3 of those rows is past float32)
        c = 128
        gamma = torch.from_numpy((0.1 * rng.rand(c, c)).astype(np.float32)) \
            .cuda()
        beta = torch.full((c,), 1e-35, device="cuda")
        x32 = rng.randn(67, c).astype(np.float32)
        x32[::3] = 0.0
        for dtype in (torch.bfloat16, torch.float32):
            for inverse in (False, True):
                label = f"(67, {c}) beta 1e-35 {str(dtype)[6:]} " \
                        f"inverse={inverse}"
                y_err, _ = check_gdn_fwd_case(
                    torch, torch.from_numpy(x32).cuda().to(dtype), gamma,
                    beta, inverse, label)
                log(f"gdn_train_fwd {label}: y max abs {y_err:.3e}")
        check_gdn_train_misaligned(torch, rng)
        check_k2f_layouts(torch, rng)

        # K4 training variant: down_1 at the path's shape, and ragged
        unit = model.encoder.down_1
        kernel = unit.conv_down.kernel_hwio()
        gamma, beta = unit.gdn_down.effective_params()
        cin, cout = kernel.shape[2], kernel.shape[3]
        x32 = torch.from_numpy(rng.rand(b, h // 2, h // 2, cin)
                               .astype(np.float32)).cuda()
        conv_err = {dt: check_conv_train_case(
            torch, x32.to(dt), kernel, gamma, beta,
            f"{tuple(x32.shape)} {str(dt)[6:]}")
            for dt in (torch.float32, torch.bfloat16)}
        for shape, co in (((2, 18, 14, 72), 40), ((1, 4, 6, 64), 128)):
            xr = torch.from_numpy(rng.rand(*shape).astype(np.float32)).cuda()
            kr = torch.from_numpy((rng.randn(3, 3, shape[3], co) * 0.05)
                                  .astype(np.float32)).cuda()
            gr = torch.from_numpy((0.1 * rng.rand(co, co))
                                  .astype(np.float32)).cuda()
            br = torch.from_numpy((1.0 + rng.rand(co))
                                  .astype(np.float32)).cuda()
            for dt in (torch.float32, torch.bfloat16):
                check_conv_train_case(torch, xr.to(dt), kr, gr, br,
                                      f"{shape} -> {co} {str(dt)[6:]}")
                # the serving variant in bf16 (eval in bf16) gives the
                # training variant's output
                served = cg.conv_gdn_cuda(xr.to(dt), kr, gr, br)
                check(torch.equal(served, cg.conv_gdn_train_cuda(
                    xr.to(dt), kr, gr, br)[0]),
                    f"conv_gdn_fwd {shape} {dt}: differs from the training "
                    "variant's output")

        # timing at the path's shapes (bf16 rows for K2/K3, their mode)
        gamma0, beta0 = model.encoder.down_0.gdn_down.effective_params()
        c = gamma0.shape[0]
        xb = torch.from_numpy(rng.randn(n, c).astype(np.float32) * 0.5) \
            .cuda().to(torch.bfloat16)
        _, rb = gk.gdn_train_fwd_cuda(xb, gamma0, beta0)
        gb = torch.from_numpy(rng.randn(n, c).astype(np.float32)).cuda() \
            .to(torch.bfloat16)
        nc = n * c
        # K2 by CUDA events around the wrapper, as K1, K3 and K4 are timed;
        # the device time of its prep and main kernel beside it, in the log
        def k2():
            return gk.gdn_train_fwd_cuda(xb, gamma0, beta0)

        ms, dev_ms = cuda_ms(torch, k2, 20), device_ms(torch, k2, 20)
        plain_ms = cuda_ms(torch, lambda: gk.gdn_train_fwd_plain(
            xb, gamma0, beta0), 10)
        bms, by = bound_ms(6 * nc + 4 * c * (c + 1),
                           [(2 * nc * c, PEAK_BF16_S), (5 * nc, PEAK_F32_S)])
        out["gdn_train_fwd"] = dict(
            max_abs_err=errs[(n, False, torch.bfloat16)][0], ms=ms,
            plain_ms=plain_ms, bound_ms=bms, bound_by=by, shape=[n, c])
        # cuBLAS's bf16 product of K2's and K3's shape alone: a yardstick
        # for the log (torch.matmul; no single library call computes
        # either function)
        a = torch.randn(n, c, device="cuda").to(torch.bfloat16)
        b = gamma0.detach().to(torch.bfloat16)
        mm_ms = cuda_ms(torch, lambda: torch.matmul(a, b), 20)
        del a
        k2_yardsticks(torch, xb, gamma0, beta0, ms, dev_ms, bms, mm_ms)
        # as the training path calls it: with dbeta's partial sums
        ms = cuda_ms(torch, lambda: gk.gdn_train_bwd_cuda(
            gb, xb, rb, gamma0, want_dbeta=True), 20)
        ms_no = cuda_ms(torch, lambda: gk.gdn_train_bwd_cuda(
            gb, xb, rb, gamma0), 20)
        plain_ms = cuda_ms(torch, lambda: gk.gdn_train_bwd_plain(
            gb, xb, rb, gamma0, want_dbeta=True), 10)
        log(f"gdn_train_bwd {[n, c]} bf16: {ms:.4f} ms with dbeta's partial "
            f"sums, {ms_no:.4f} ms without")
        bms, by = bound_ms(10 * nc + 4 * c * (c + 1),
                           [(2 * nc * c, PEAK_BF16_S), (13 * nc, PEAK_F32_S)])
        out["gdn_train_bwd"] = dict(
            max_abs_err=errs[(n, False, torch.bfloat16)][1], ms=ms,
            plain_ms=plain_ms, bound_ms=bms, bound_by=by, shape=[n, c])
        k3_yardsticks(torch, gb, xb, rb, gamma0, ms, bms, mm_ms)
        del xb, gb, rb
        # K2 on float32 rows (a GDN after a batch norm in the bf16 mode):
        # K1's three-pass TF32 kernel with r (csrc/gdn_tc.cu), at the
        # batch-norm model's down_0 and up_0 shapes, beside K1 on the same
        # rows and the build that stores r from the registers
        gf, bf = gamma0.detach().contiguous(), beta0.detach().contiguous()
        for rows in (n, n // 4):
            x32r = torch.from_numpy(rng.randn(rows, c).astype(np.float32)
                                    * 0.5).cuda()
            yp = torch.empty_like(x32r)
            rp = torch.empty(x32r.shape, dtype=torch.bfloat16, device="cuda")
            ms = cuda_ms(torch, lambda: gk.gdn_train_fwd_f32_cuda(
                x32r, gamma0, beta0), 20)
            k1_ms = cuda_ms(torch, lambda: gk.gdn_cuda(x32r, gamma0, beta0),
                            20)
            regs_ms = cuda_ms(torch, lambda: k2f_probe(
                torch, "k2f_r_regs", x32r, gf, bf, False, yp, rp), 20)
            plain_ms = cuda_ms(torch, lambda: gk.gdn_train_fwd_plain(
                x32r, gamma0, beta0), 10)
            # x in, y out as float32 and r as bf16; the pool as K1's float32
            # bound takes it (three TF32 passes), the rest in float32
            bms, by = bound_ms(10 * rows * c + 4 * c * (c + 1),
                               [(3 * 2 * rows * c * c, PEAK_TF32_S),
                                (5 * rows * c, PEAK_F32_S)])
            log(f"gdn_train_fwd_f32 {(rows, c)}: kernel {ms:.4f} ms "
                f"({100 * bms / ms:.1f}% of its bound {bms:.4f} ms, {by}); "
                f"r from the registers (three x tiles a ring) {regs_ms:.4f} "
                f"ms; K1 on the same rows {k1_ms:.4f} ms; plain "
                f"{plain_ms:.4f} ms")
            if rows == n:
                y_p, _ = gk.gdn_train_fwd_plain(x32r, gamma0, beta0)
                one, _ = k2f_probe(torch, "one_pass", x32r, gf, bf, False,
                                   yp, rp)
                rel_one = float(((one - y_p).abs()
                                 / y_p.abs().clamp_min(1e-30)).max())
                log(f"gdn_train_fwd_f32 {(rows, c)}: one-pass control max "
                    f"rel {rel_one:.3e} (limit {K1_REL_LIMIT:.0e})")
                check(rel_one > K1_REL_LIMIT, "gdn_train_fwd_f32: the "
                      f"one-pass control passed ({rel_one:.3e})")
                out["gdn_train_fwd_f32"] = dict(
                    max_abs_err=errs[(n, False, torch.float32)][0], ms=ms,
                    plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                    shape=[rows, c])
                del y_p, one
            del x32r, yp, rp

        for dt, name in ((torch.bfloat16, "bf16"),
                         (torch.float32, "float32")):
            xt = x32.to(dt)
            ms = cuda_ms(torch, lambda: cg.conv_gdn_train_cuda(
                xt, kernel, gamma, beta), 10)
            plain_ms = cuda_ms(torch, lambda: cg.conv_gdn_train_plain(
                xt, kernel, gamma, beta), 5)
            bms, by, design_ms = k4_bound(xt, cout, want_y=True)
            log(f"conv_gdn_train_fwd {name} {tuple(xt.shape)}: kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms "
                f"({by}), {100 * bms / ms:.1f}% of it; design ceiling "
                f"(its TF32 passes) {design_ms:.4f} ms")
            out[{"bf16": "conv_gdn_train_fwd_bf16"}.get(
                name, "conv_gdn_train_fwd")] = dict(
                max_abs_err=conv_err[dt], ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, shape=list(xt.shape))
        del x32
    for name in ("gdn_train_fwd", "gdn_train_bwd", "gdn_train_fwd_f32"):
        rec = out[name]
        kind = "float32" if name.endswith("f32") else "bf16"
        log(f"{name} {rec['shape']} {kind}: kernel {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}), {100 * rec['bound_ms'] / rec['ms']:.1f}% "
            "of it")
    return out


# -- phase 5 -----------------------------------------------------------------


def synthetic_batch(torch):
    """scripts/bench_train.py's synthetic patches: uniform 60..220 plus
    seeded noise, in [0, 1]."""
    rng = np.random.RandomState(0)
    b, p = TRAIN_BATCH, TRAIN_PATCH
    x = np.clip(rng.rand(b, p, p, 3) * 160 + 60
                + rng.randn(b, p, p, 3) * 6, 0, 255).astype(np.float32)
    return torch.from_numpy(x / 255.0).cuda()


@contextlib.contextmanager
def plain_versions():
    """Swap the training path's CUDA wrappers for their plain versions in
    the kernel modules' namespaces for the block: the comparison run."""
    from cnn_autoencoder_tpu_torch.ops.kernels import conv_gdn_kernel as cg
    from cnn_autoencoder_tpu_torch.ops.kernels import gdn_kernel as gk
    swaps = [(gk, "gdn_cuda", gk.gdn_plain),
             (gk, "gdn_bf16_cuda", gk.gdn_plain),
             (gk, "gdn_bf16_f32pool_cuda", gk.gdn_plain),
             (gk, "gdn_train_fwd_cuda", gk.gdn_train_fwd_plain),
             (gk, "gdn_train_fwd_f32_cuda", gk.gdn_train_fwd_plain),
             (gk, "gdn_train_fwd_bf16_f32pool_cuda", gk.gdn_train_fwd_plain),
             (gk, "gdn_train_bwd_cuda", gk.gdn_train_bwd_plain),
             (cg, "conv_gdn_cuda", cg.conv_gdn_plain),
             (cg, "conv_gdn_train_cuda", cg.conv_gdn_train_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def train_setup(torch, compute_dtype, x):
    """A fresh flagship model from the checkpoint with its optimizers and
    train step; returns (model, criterion, step(i) -> (stats, grads))."""
    from cnn_autoencoder_tpu_torch.criteria.loss import setup_loss
    from cnn_autoencoder_tpu_torch.models.factory import \
        autoencoder_from_state_dict
    from cnn_autoencoder_tpu_torch.training.loop import make_train_step
    from cnn_autoencoder_tpu_torch.training.optim import setup_optimizers
    model = autoencoder_from_state_dict(CHECKPOINT, device="cuda").train()
    trainable = ["encoder", "decoder", "fact_ent"]
    criterion = setup_loss("RateMSE", distortion_lambda=0.01)
    optimizers = setup_optimizers(model, trainable)
    train_step = make_train_step(model, criterion, optimizers,
                                 trainable_modules=trainable,
                                 compute_dtype=compute_dtype)
    lrs = {k: TRAIN_LR for k in optimizers}
    gen = torch.Generator(device="cuda").manual_seed(0)
    return model, criterion, lambda i: train_step(x, lrs, i, generator=gen)


def phase_training(torch):
    """The counted train steps in both modes, the plain comparison, the
    step time, an eval step and a profile; returns the launch counts and
    the ms per step of each mode."""
    from cnn_autoencoder_tpu_torch.ops.kernels import (kernel_wrappers,
                                                       reset_launch_counts)
    from cnn_autoencoder_tpu_torch.training.loop import make_eval_step
    x = synthetic_batch(torch)
    totals, step_ms = {}, {}
    for mode, dtype, rtol in (("float32", torch.float32, 1e-5),
                              ("bf16", torch.bfloat16, 2e-2)):
        model, criterion, step = train_setup(torch, dtype, x)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()  # this mode's peak alone
        reset_launch_counts()
        losses, times = [], []
        for i in range(1, TRAIN_STEPS + 1):
            t0 = time.perf_counter()
            stats, grads = step(i)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(stats["loss"]))
            if i == 1:
                for module, gs in grads.items():
                    for name, g in gs.items():
                        check(bool(torch.isfinite(g).all())
                              and float(g.abs().max()) > 0,
                              f"{mode} step 1: the gradient of "
                              f"{module}.{name} is zero or not finite")
                n_grads = sum(len(gs) for gs in grads.values())
        launches = {fn.kernel_name: fn.launches for fn in kernel_wrappers()}
        expected = {name: STEP_LAUNCHES[mode].get(name, 0) * TRAIN_STEPS
                    for name in launches}
        log(f"train {mode}: launches over {TRAIN_STEPS} steps {launches}")
        check(launches == expected, f"train {mode}: launches {launches}, "
              f"expected {expected}")
        for name, n in launches.items():
            totals[name] = totals.get(name, 0) + n
        check(all(np.isfinite(losses)), f"train {mode}: losses {losses}")
        log(f"train {mode}: losses {losses}; step times (ms) "
            f"{[round(t * 1e3, 3) for t in times]}; all {n_grads} "
            "step-1 gradients finite and non-zero")

        t0 = time.perf_counter()
        for i in range(TRAIN_STEPS + 1, TRAIN_STEPS + TIMED_STEPS + 1):
            step(i)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / TIMED_STEPS * 1e3
        step_ms[mode] = ms
        log(f"train {mode}: {ms:.3f} ms per step over {TIMED_STEPS} steps, "
            f"{TRAIN_BATCH / ms * 1e3:.2f} images/s "
            f"(batch {TRAIN_BATCH} x {TRAIN_PATCH}^2); peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        eval_stats = make_eval_step(model, criterion, compute_dtype=dtype)(x)
        check(np.isfinite(float(eval_stats["loss"])),
              f"eval {mode}: loss not finite")
        log(f"eval {mode}: loss {float(eval_stats['loss']):.6f}, rate "
            f"{float(eval_stats['rate_loss']):.6f} bpp")
        busy = profile_device(
            torch, lambda: step(TRAIN_STEPS + TIMED_STEPS + 1),
            f"one {mode} train step")
        # the profiler slows the host, so the busy share is also taken
        # against the unprofiled step time
        log(f"train {mode}: device busy {busy * 1e3:.3f} ms of the "
            f"unprofiled {ms:.3f} ms step ({100 * busy * 1e3 / ms:.1f}%)")
        del model, step

        with plain_versions():
            _, _, plain_step = train_setup(torch, dtype, x)
            plain = [float(plain_step(i)[0]["loss"])
                     for i in range(1, TRAIN_STEPS + 1)]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain))
        log(f"train {mode}: plain versions on the card: losses {plain}, "
            f"max relative difference {rel:.3e} (limit {rtol})")
        check(rel <= rtol, f"train {mode}: losses differ from the plain "
              f"versions' by {rel:.3e} > {rtol}")
        del plain_step
        torch.cuda.empty_cache()
    return totals, step_ms


# -- phase 6 -----------------------------------------------------------------


def scaled_checkpoint(factor, path=CHECKPOINT):
    """A checkpoint's state (the flagship's by default) with the encoder's
    last conv scaled by ``factor``: its latent leaves the coding tables."""
    from cnn_autoencoder_tpu_torch.training.checkpoint import load_checkpoint
    state = dict(load_checkpoint(path))
    enc = state["encoder"]["params"]
    last = sorted(enc)[-1]
    kernel = enc[last]["conv_down"]["kernel"]
    state["encoder"] = {"params": {**enc, last: {"conv_down": {
        "kernel": kernel * np.float32(factor)}}}}
    return state


def v3_frame_bytes(bufs, lengths, cap, s, true_hw):
    """Legacy frame v3 chunks from a v3 writer's (B, S, cap) per-stream word
    buffers and (B, S) word counts: header, byte-length table, then each
    stream's words in turn."""
    import struct
    from cnn_autoencoder_tpu_torch.storage.turbo_codec import (
        LEGACY_VERSION, TURBO_FLAG)
    bufs = np.asarray(bufs).astype("<u2")
    lengths = np.asarray(lengths)
    check(int(lengths.max()) <= cap, "v3 writer: overflow")
    out = []
    for i, (h, w) in enumerate(true_hw):
        used = np.arange(cap)[None, :] < lengths[i][:, None]
        out.append(b"".join([struct.pack(">QQ", h | TURBO_FLAG, w),
                             struct.pack(">BH", LEGACY_VERSION, s),
                             (lengths[i] * 2).astype(">u4").tobytes(),
                             bufs[i][used].tobytes()]))
    return out


def v3_frames(core, sym, true_hw, s=None):
    """Legacy frame v3 of (B, C, lh, lw) symbols over ``s`` streams (the
    core's by default), built with the port's v3 writer
    (``encode_device``) as the JAX package's v3 test builds them."""
    from cnn_autoencoder_tpu_torch.coding.device_rans import (encode_device,
                                                              pack_streams)
    b, _, lh, lw = sym.shape
    s = s or core.num_streams
    packed = pack_streams(sym.reshape(b, -1), s)
    cap = 2 * packed.shape[1] + 8
    bufs, lengths, esc = encode_device(packed, core._ch_map(lh, lw, s),
                                       core.tables, cap)
    check(int(esc) == 0, "v3 writer: escapes")
    return v3_frame_bytes(bufs.cpu().numpy(), lengths.cpu().numpy(), cap, s,
                          true_hw)


def host_coder_check(torch, core):
    """(a) The host coder built from the repository's source, held byte for
    byte to the plain Python coder on one 64^2 crop's symbols, with and
    without escapes."""
    from cnn_autoencoder_tpu_torch.coding import _rans_py, rans
    from cnn_autoencoder_tpu_torch.storage.turbo_codec import is_turbo_frame
    t0 = time.perf_counter()
    rans.load_library()
    log(f"host coder: built in {rans.build_seconds:.2f} s (load "
        f"{time.perf_counter() - t0:.2f} s), {rans.num_threads()} OpenMP "
        f"threads; host CPU {rans.cpu_name()}, {os.cpu_count()} cores")
    base = core.base
    sym = core.latent_symbols(image(64, 64, 99)[None]).cpu().numpy()
    c, lh, lw = sym.shape[1:]
    idx = np.repeat(np.arange(c, dtype=np.int32), lh * lw)
    flat = sym.reshape(-1).astype(np.int32)
    esc = flat.copy()
    rng = np.random.RandomState(5)
    at = rng.choice(esc.size, 24, replace=False)
    esc[at[:8]] = base.offset[idx[at[:8]]] - 1 - rng.randint(0, 500, 8)
    esc[at[8:16]] = (base.offset[idx[at[8:16]]] + base.cdf_length[idx[at[8:16]]]
                     + rng.randint(0, 5000, 8))
    esc[at[16:]] = [-(2 ** 31), 2 ** 31 - 1, -70000, 90000, -1000000,
                    3000000, -(2 ** 30), 2 ** 30]
    for label, s in (("in-table", flat), ("escapes", esc)):
        t0 = time.perf_counter()
        ours = rans.encode_with_indexes(s, idx, base.cdf, base.cdf_length,
                                        base.offset)
        t1 = time.perf_counter()
        plain = _rans_py.encode_with_indexes(
            s.tolist(), idx.tolist(), base.cdf.tolist(),
            base.cdf_length.tolist(), base.offset.tolist())
        t2 = time.perf_counter()
        check(ours == plain, f"host coder ({label}): C++ and plain streams "
              "differ")
        back = rans.decode_with_indexes(ours, idx, base.cdf, base.cdf_length,
                                        base.offset)
        check(np.array_equal(back, s), f"host coder ({label}): round trip "
              "lost symbols")
        log(f"host coder ({label}, {s.size} symbols): byte-identical to the "
            f"plain coder, {len(ours)} bytes; C++ {(t1 - t0) * 1e3:.3f} ms, "
            f"plain {(t2 - t1) * 1e3:.3f} ms")
    check(not is_turbo_frame(base.entropy_encode(sym, [(64, 64)])[0]),
          "a host frame reads as a turbo frame")


def cae_round_trip(torch, core, imgs, mode):
    """(b) The flagship tiles through the CAECodecCore of ``core`` (a
    CAETurboCore at precision ``mode``) on the card: symbols, lossless host
    coding, two decodes of the same symbols bit-equal, reconstructions
    bit-equal to the turbo decode of the same symbols, and MP/s with the
    host coder's share.  Launch counts are reset after the warm-up and read
    just after the timed round trips: the 'cae' path runs K1 (on the
    precision's rows) and K4 and no rANS kernel."""
    from cnn_autoencoder_tpu_torch.ops.kernels import (kernel_wrappers,
                                                       reset_launch_counts)
    base = core.base
    n = imgs.shape[0]
    mpix = n * imgs.shape[1] * imgs.shape[2] / 1e6
    base.decode_tiles(base.encode_tiles(imgs))          # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    enc_s, dec_s = [], []
    for _ in range(CAE_ROUNDS):
        t0 = time.perf_counter()
        frames = base.encode_tiles(imgs)
        t1 = time.perf_counter()
        rec = base.decode_tiles(frames)
        t2 = time.perf_counter()
        enc_s.append(t1 - t0)
        dec_s.append(t2 - t1)
    launches = {fn.kernel_name: fn.launches for fn in kernel_wrappers()}
    log(f"cae path ({mode}) launches over {CAE_ROUNDS} round trips: "
        f"{launches}")
    for name, count in launches.items():
        check((count > 0) == (name in CAE_KERNELS[mode]),
              f"cae path ({mode}): kernel {name} launched {count} times")
    # the stages of the same round trip, one at a time, over as many rounds
    stages = np.zeros(4)
    for _ in range(CAE_ROUNDS):
        s0 = time.perf_counter()
        sym = base.fetch_symbols(base.encode_tiles_device(imgs))
        s1 = time.perf_counter()
        again = base.entropy_encode(sym, [imgs.shape[1:3]] * n)
        s2 = time.perf_counter()
        sym_d, _ = base.entropy_decode(frames)
        s3 = time.perf_counter()
        rec2 = base.decode_tiles_device(sym_d).cpu().numpy()
        s4 = time.perf_counter()
        stages += np.diff([s0, s1, s2, s3, s4]) * 1e3 / CAE_ROUNDS
    check(again == frames, f"cae ({mode}): the staged encode differs")
    sym_turbo = core.latent_symbols(imgs).cpu().numpy()
    check(sym.dtype == np.int8 and np.array_equal(sym, sym_turbo),
          f"cae ({mode}): symbols differ from CAETurboCore.latent_symbols")
    check(np.array_equal(sym_d, sym), f"cae ({mode}): decoded symbols differ")
    turbo_frames = core.encode_tiles(imgs)
    check(not torch.backends.cudnn.deterministic,
          "cudnn.deterministic is set")
    check(np.array_equal(rec2, rec), f"cae ({mode}): two decodes of the "
          "same symbols differ")
    check(np.array_equal(core.decode_tiles(turbo_frames), rec),
          f"cae ({mode}): reconstructions differ from the turbo decode of "
          "the same symbols")
    cae_bytes = sum(len(f) for f in frames) / n
    turbo_bytes = sum(len(f) for f in turbo_frames) / n
    enc, dec = np.mean(enc_s), np.mean(dec_s)
    log(f"cae codec ({mode}): {n} tiles of {imgs.shape[1]}x{imgs.shape[2]}, "
        f"symbols equal to the turbo core's, lossless; mean of {CAE_ROUNDS} "
        "rounds: "
        f"encode {mpix / enc:.3f} MP/s ({enc * 1e3:.1f} ms, rounds "
        f"{min(enc_s) * 1e3:.1f} to {max(enc_s) * 1e3:.1f}), decode "
        f"{mpix / dec:.3f} MP/s ({dec * 1e3:.1f} ms, rounds "
        f"{min(dec_s) * 1e3:.1f} to {max(dec_s) * 1e3:.1f}); "
        "two decodes bit-equal, and to the turbo decode")
    log(f"cae stages ({mode}), mean of {CAE_ROUNDS} rounds: device encode + "
        "int8 "
        f"fetch {stages[0]:.1f} ms, host rANS encode {stages[1]:.1f} ms, "
        f"host rANS decode {stages[2]:.1f} ms, upload + device decode + "
        f"fetch {stages[3]:.1f} ms; {cae_bytes:.1f} bytes a tile "
        f"({8 * cae_bytes / (imgs.shape[1] * imgs.shape[2]):.4f} bpp) "
        f"against the turbo frames' {turbo_bytes:.1f}")


def fallback_checks(torch, model, core, imgs):
    """(c) Batches the device coder cannot take: one symbol pushed out of
    its table, a flagship copy whose encoder's last conv is scaled (whole
    tiles escape), and six capacities that all overflow at S = 16.  Each
    writes host frames that decode to the reconstruction of its
    symbols."""
    from cnn_autoencoder_tpu_torch.models.factory import \
        autoencoder_from_state_dict
    from cnn_autoencoder_tpu_torch.storage.turbo_codec import (
        CAETurboCore, is_turbo_frame)

    def held(label, core, sym, frames, retries=None):
        hw = [imgs.shape[1:3]] * sym.shape[0]
        check(not any(is_turbo_frame(f) for f in frames),
              f"{label}: not every frame is a host frame")
        check(np.array_equal(core.base.entropy_decode(frames)[0],
                             sym.cpu().numpy()), f"{label}: lost symbols")
        rec = core.decode_tiles(frames)
        want = core.reconstruct(sym, *hw[0])
        check(np.array_equal(rec, want), f"{label}: reconstruction differs "
              "from that of its symbols")
        log(f"fallback ({label}): {len(frames)} host frames, "
            f"{sum(len(f) for f in frames) / len(frames):.1f} bytes a tile, "
            f"lossless, reconstruction equal"
            + ("" if retries is None else f"; {retries} capacity retries"))

    hw = [imgs.shape[1:3]] * 2
    sym = core.latent_symbols(imgs[:2])
    sym[0, 3, 0, 0] = int(core.tables.offset[3]) - 5
    before = core.host_fallbacks
    frames = core.frames_from_symbols(sym, hw)
    check(core.host_fallbacks == before + 1, "one-symbol escape: no fallback")
    held("one symbol out", core, sym, frames)

    scaled = CAETurboCore(autoencoder_from_state_dict(
        scaled_checkpoint(100.0), device="cuda"), num_streams=1024,
        device="cuda")
    sym = scaled.latent_symbols(imgs[:2])
    n_esc = int(scaled.escapes(sym).sum())
    frames = scaled.encode_tiles(imgs[:2])
    check(scaled.host_fallbacks == 1, "scaled encoder: no fallback")
    held(f"scaled encoder, {n_esc} of {sym.numel()} symbols escape",
         scaled, sym, frames)
    del scaled

    narrow = CAETurboCore(model, num_streams=16, device="cuda")
    narrow.expected_bits = 0.0
    sym = narrow.latent_symbols(imgs[:2])
    frames = narrow.encode_tiles(imgs[:2])
    check(narrow.host_fallbacks == 1 and narrow.capacity_retries == 5,
          f"six capacities at S = 16: {narrow.host_fallbacks} fallbacks, "
          f"{narrow.capacity_retries} retries")
    held("six capacities at S = 16", narrow, sym, frames,
         narrow.capacity_retries)


def mixed_batch_check(torch, core, imgs):
    """(d) One decode batch of v4, host and v3 frames and a 500 x 300 tile:
    each tile equal to its own format's decode."""
    from cnn_autoencoder_tpu_torch.storage.turbo_codec import is_turbo_frame
    tiles = imgs[:3]
    hw = [tiles.shape[1:3]] * 3
    v4 = core.encode_tiles(tiles)
    host = core.base.encode_tiles(tiles)
    v3 = v3_frames(core, core.latent_symbols(tiles), hw)
    odd = image(500, 300, 77)
    odd_frame = core.encode_tiles(odd[None])[0]
    check(all(is_turbo_frame(f) for f in v4 + v3 + [odd_frame])
          and not any(is_turbo_frame(f) for f in host),
          "mixed batch: frame formats")
    batch = [v4[0], host[1], v3[2], odd_frame, host[0], v3[0], v4[1]]
    t0 = time.perf_counter()
    core.decode_tiles(batch)
    ms = (time.perf_counter() - t0) * 1e3
    groups = {"v4": ([0, 6], [v4[0], v4[1]]), "host": ([1, 4],
                                                      [host[1], host[0]]),
              "v3": ([2, 5], [v3[2], v3[0]]), "odd": ([3], [odd_frame])}
    recs = core.decode_tiles(batch)
    check(isinstance(recs, list) and len(recs) == len(batch),
          "mixed batch: not a list of 7 tiles")
    for name, (where, frames) in groups.items():
        alone = core.decode_tiles(frames)
        for i, r in zip(where, alone):
            check(np.array_equal(recs[i], r),
                  f"mixed batch: tile {i} ({name}) differs from its own "
                  "format's decode")
    check(recs[3].shape == (500, 300, 3), "mixed batch: odd tile shape")
    sym_v3 = core.symbols_from_frames_v3(v3, core.num_streams,
                                         *tiles.shape[1:3])
    check(torch.equal(sym_v3, core.latent_symbols(tiles)),
          "v3 frames: decoded symbols differ")
    log(f"mixed batch (v4, host, v3 and a 500x300 tile, 7 frames): each "
        f"tile equal to its own format's decode, {ms:.1f} ms; v3 symbols "
        "lossless")


def bottleneck_check(torch, model, imgs):
    """(e) 'cae_bn' on one tile's float latent: a lossless round trip past
    quantization."""
    from cnn_autoencoder_tpu_torch.storage.cae_codec import \
        ConvolutionalAutoencoderBottleneck
    from cnn_autoencoder_tpu_torch.storage.codecs import get_codec
    with torch.no_grad():
        y = model.encoder(torch.from_numpy(imgs[:1]).cuda().float() / 255.0)
    y = y[0].cpu().numpy()
    codec = ConvolutionalAutoencoderBottleneck(
        model.channels_bn, fact_ent=model.fact_ent.params())
    t0 = time.perf_counter()
    buf = codec.encode(y)
    t1 = time.perf_counter()
    out = get_codec(codec.get_config()).decode(buf)
    t2 = time.perf_counter()
    want = np.round(y - codec.medians) + codec.medians
    check(np.array_equal(out, want), "cae_bn: round trip differs from the "
          "quantized latent")
    log(f"cae_bn: {y.shape} float latent, {len(buf)} bytes, lossless past "
        f"quantization; encode {(t1 - t0) * 1e3:.2f} ms, decode "
        f"{(t2 - t1) * 1e3:.2f} ms")


def phase_codecs(torch, model, core, core16):
    """Phase 6: the host coder and every CAE codec; the 'cae' round trip
    at both precisions (``core16``: the bf16 turbo core)."""
    t0 = time.perf_counter()
    host_coder_check(torch, core)
    imgs = np.stack([image(512, 512, seed) for seed in range(TILES)])
    cae_round_trip(torch, core, imgs, "float32")
    cae_round_trip(torch, core16, imgs, "bf16")
    fallback_checks(torch, model, core, imgs)
    mixed_batch_check(torch, core, imgs)
    bottleneck_check(torch, model, imgs)
    log(f"codec phase: {time.perf_counter() - t0:.1f} s")


# -- phase 7 -----------------------------------------------------------------

SLIDE = 4096        # side of the synthetic slide
SLIDE_PATCH = 512   # its chunks and the pipeline's tiles
SLIDE_BATCHES = 4   # default_batch_tiles(512, n_tiles=64) = 16 tiles a batch
FUSED_CHUNK = 16    # tiles a chunk of the fused paths: the pipeline's batch
CARD = ""           # nvidia-smi's name and power limit, set in phase 1


def synth_histology(h, w, seed=0):
    """The synthetic slide: the port's copy of the JAX package's
    ``bench.py:127`` in ``tools/rd_sweep.py`` (this script imports no
    JAX)."""
    from cnn_autoencoder_tpu_torch.tools.rd_sweep import synth_histology
    return synth_histology(h, w, seed=seed)


def psnr_db(rec, ref):
    mse = np.mean((rec.astype(np.float64) - ref) ** 2)
    return 10 * np.log10(255.0 ** 2 / mse)


def slide_chunks(arr):
    return {ij: arr.read_chunk_raw(ij) for ij in arr.chunk_ids()}


def serial_batches(img, p, batch, hal=0):
    """(grid ids, (B, p + 2 hal, p + 2 hal, 3) tiles) of each batch in the
    pipeline's order and padding, each tile with a halo of ``hal`` real
    neighbouring pixels (zeros past the image)."""
    h, w, c = img.shape
    grid = [(i, j) for i in range(-(-h // p)) for j in range(-(-w // p))]
    pe = p + 2 * hal
    out = []
    for k in range(0, len(grid), batch):
        ids = grid[k:k + batch]
        tiles = np.zeros((batch, pe, pe, c), np.uint8)
        for t, (i, j) in enumerate(ids):
            y0, x0 = i * p - hal, j * p - hal
            ys, xs = max(0, y0), max(0, x0)
            ye, xe = min(h, y0 + pe), min(w, x0 + pe)
            tiles[t, ys - y0:ye - y0, xs - x0:xe - x0] = img[ys:ye, xs:xe]
        tiles[len(ids):] = tiles[len(ids) - 1]
        out.append((ids, tiles))
    return out


def stitch(shape, ids_recs, p, hal=0):
    out = np.zeros(shape, np.uint8)
    for ids, rec in ids_recs:
        for (i, j), r in zip(ids, rec):
            if hal:
                r = r[hal:-hal, hal:-hal]
            blk = out[i * p:(i + 1) * p, j * p:(j + 1) * p]
            blk[...] = r[:blk.shape[0], :blk.shape[1]]
    return out


def slide_launches(torch, label, expect, retries):
    """Read the launch counts of the pass just run, log them on their own
    line and hold them to ``expect`` ({kernel: count}; every other kernel
    0; ``rans_compact`` one more per capacity retry)."""
    from cnn_autoencoder_tpu_torch.ops.kernels import kernel_wrappers
    launches = {fn.kernel_name: fn.launches for fn in kernel_wrappers()}
    log(f"slide {label} launches: {launches} ({retries} capacity retries)")
    for name, n in launches.items():
        want = expect.get(name, 0)
        if name == "rans_compact" and want:
            want += retries
        check(n == want, f"slide {label}: kernel {name} launched {n} times, "
              f"expected {want}")
    return launches


def stage_report(timer, t0, t1, t2):
    """``GLOBAL_TIMER.report()`` of a compress pass [t0, t1) and a
    decompress pass [t1, t2), with the share of each pass that some
    thread spent inside one of its stages."""
    return (f"{timer.report()}; in stages "
            f"{timer.busy_fraction(('compress/',), t0, t1):.3f} of the "
            f"compress, {timer.busy_fraction(('decompress/',), t1, t2):.3f} "
            "of the decompress")


def slide_turbo(torch, core, img, work, mode):
    """(a) The slide through ``compress_pixels_to_cae_turbo`` and
    ``decompress_cae_turbo_array``: chunks equal to ``encode_tiles`` of the
    same batches called serially on one thread, the stitched image bit-equal
    to ``decode_tiles`` of those frames, launches counted over the timed
    pass; then ``roundtrip_cae_turbo`` to the same bytes and image."""
    from cnn_autoencoder_tpu_torch.ops.kernels import reset_launch_counts
    from cnn_autoencoder_tpu_torch.pipeline.tiles import (
        compress_pixels_to_cae_turbo, decompress_cae_turbo_array,
        default_batch_tiles, roundtrip_cae_turbo)
    from cnn_autoencoder_tpu_torch.utils.profiling import GLOBAL_TIMER
    p = SLIDE_PATCH
    n_tiles = (SLIDE // p) ** 2
    batch = default_batch_tiles(p, core, n_tiles)
    check(batch * SLIDE_BATCHES == n_tiles, f"batch {batch} for {n_tiles} "
          "tiles")
    serial = serial_batches(img, p, batch)
    frames, recs = {}, []
    for ids, tiles in serial:      # one thread, in order: the reference
        bufs = core.encode_tiles(tiles)
        frames.update({(i, j, 0): b for (i, j), b in zip(ids, bufs)})
        recs.append((ids, core.decode_tiles(bufs)))
    rec_serial = stitch(img.shape, recs, p)
    torch.cuda.synchronize()

    gdn = "gdn_fwd" if mode == "float32" else "gdn_fwd_bf16"
    retries, fallbacks = core.capacity_retries, core.host_fallbacks
    GLOBAL_TIMER.reset()
    reset_launch_counts()
    t0 = time.perf_counter()
    arr = compress_pixels_to_cae_turbo(core, img, os.path.join(
        work, f"tpu_{mode}.zarr"), patch_size=p, checkpoint_id=CHECKPOINT)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rec = decompress_cae_turbo_array(arr, core=core)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    retries = core.capacity_retries - retries
    check(core.host_fallbacks == fallbacks, f"cae_tpu ({mode}): a batch "
          "fell back to host frames")
    n = SLIDE_BATCHES
    slide_launches(torch, f"cae_tpu ({mode}) compress + decompress", {
        gdn: 3 * n, K4_SERVING[mode]: n, "rans_encode_states": n,
        "rans_compact": n, "rans_decode": n}, retries)
    report = stage_report(GLOBAL_TIMER, t0, t1, t2)
    chunks = slide_chunks(arr)
    check(chunks == frames, f"cae_tpu ({mode}): pipeline chunks differ from "
          "encode_tiles called serially")
    check(np.array_equal(rec, rec_serial), f"cae_tpu ({mode}): pipeline "
          "image differs from decode_tiles of the serial frames")

    t3 = time.perf_counter()
    arr_rt, rec_rt = roundtrip_cae_turbo(core, img, os.path.join(
        work, f"tpu_rt_{mode}.zarr"), patch_size=p, checkpoint_id=CHECKPOINT)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    check(slide_chunks(arr_rt) == chunks and np.array_equal(rec_rt, rec),
          f"cae_tpu ({mode}): roundtrip_cae_turbo differs from compress "
          "then decompress")
    mpix = SLIDE * SLIDE / 1e6
    bpp = 8.0 * sum(len(b) for b in chunks.values()) / (SLIDE * SLIDE)
    log(f"slide cae_tpu ({mode}) [{CARD}]: {SLIDE}^2 in {n} batches of "
        f"{batch} x {p}^2; chunks equal to serial encode_tiles, image "
        f"bit-equal to serial decode_tiles; PSNR {psnr_db(rec, img):.3f} dB,"
        f" {bpp:.4f} bpp; encode {mpix / (t1 - t0):.3f} MP/s "
        f"({(t1 - t0) * 1e3:.1f} ms), decode {mpix / (t2 - t1):.3f} MP/s "
        f"({(t2 - t1) * 1e3:.1f} ms); roundtrip_cae_turbo "
        f"{mpix / (t4 - t3):.3f} MP/s ({(t4 - t3) * 1e3:.1f} ms), same "
        "bytes and image")
    log(f"slide cae_tpu ({mode}) GLOBAL_TIMER [{CARD}]: {report}")
    return arr.path, rec


def slide_cae(torch, core, img, work, mode, hal):
    """(b) The slide through ``compress_pixels_to_cae`` (``offset`` = hal)
    and ``decompress_cae_array``, held to ``encode_tiles`` / ``decode_tiles``
    of the same batches called serially; launches counted over the pass."""
    from cnn_autoencoder_tpu_torch.ops.kernels import reset_launch_counts
    from cnn_autoencoder_tpu_torch.pipeline.tiles import (
        compress_pixels_to_cae, decompress_cae_array, default_batch_tiles)
    from cnn_autoencoder_tpu_torch.utils.profiling import GLOBAL_TIMER
    base = core.base
    p = SLIDE_PATCH
    batch = default_batch_tiles(p, base, (SLIDE // p) ** 2)
    frames, recs = {}, []
    for ids, tiles in serial_batches(img, p, batch, hal):
        bufs = base.encode_tiles(tiles)
        frames.update({(i, j, 0): b for (i, j), b in zip(ids, bufs)})
        recs.append((ids, base.decode_tiles(bufs[:len(ids)])))
    rec_serial = stitch(img.shape, recs, p, hal)
    torch.cuda.synchronize()

    GLOBAL_TIMER.reset()
    reset_launch_counts()
    t0 = time.perf_counter()
    arr = compress_pixels_to_cae(base, img, os.path.join(
        work, f"cae_{mode}_{hal}.zarr"), patch_size=p,
        checkpoint_id=CHECKPOINT, offset=hal)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rec = decompress_cae_array(arr, core=base)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    n = SLIDE_BATCHES
    gdn = "gdn_fwd" if mode == "float32" else "gdn_fwd_bf16"
    slide_launches(torch, f"cae ({mode}, offset {hal}) compress + "
                   "decompress", {gdn: 3 * n, K4_SERVING[mode]: n}, 0)
    report = stage_report(GLOBAL_TIMER, t0, t1, t2)
    chunks = slide_chunks(arr)
    check(chunks == frames, f"cae ({mode}, offset {hal}): pipeline chunks "
          "differ from encode_tiles called serially")
    check(np.array_equal(rec, rec_serial), f"cae ({mode}, offset {hal}): "
          "pipeline image differs from decode_tiles of the serial frames")
    mpix = SLIDE * SLIDE / 1e6
    bpp = 8.0 * sum(len(b) for b in chunks.values()) / (SLIDE * SLIDE)
    log(f"slide cae ({mode}, offset {hal}) [{CARD}]: chunks equal to serial "
        f"encode_tiles, image bit-equal to serial decode_tiles; PSNR "
        f"{psnr_db(rec, img):.3f} dB, {bpp:.4f} bpp; encode "
        f"{mpix / (t1 - t0):.3f} MP/s ({(t1 - t0) * 1e3:.1f} ms), decode "
        f"{mpix / (t2 - t1):.3f} MP/s ({(t2 - t1) * 1e3:.1f} ms)")
    log(f"slide cae ({mode}, offset {hal}) GLOBAL_TIMER [{CARD}]: {report}")
    return arr.path, rec


def slide_bottleneck(torch, core, img, work, mode, rec_cae):
    """(c) 'cae_bn' on a 1024^2 crop: ``compress_pixels_to_bottleneck``
    stores the latents of ``CAECodecCore.latents`` losslessly past
    quantization; ``decompress_latents_to_pixels`` with a latent halo of 2
    gives the crop's size and a PSNR within 0.5 dB of the 'cae' path's on
    the same pixels (``rec_cae``, the slide's 'cae' reconstruction)."""
    from cnn_autoencoder_tpu_torch.pipeline.tiles import (
        compress_pixels_to_bottleneck, decompress_latents_to_pixels)
    from cnn_autoencoder_tpu_torch.storage import zarr as zarrlib
    base = core.base
    p = SLIDE_PATCH
    crop = np.ascontiguousarray(img[:2 * p, :2 * p])
    t0 = time.perf_counter()
    arr = compress_pixels_to_bottleneck(base, crop, os.path.join(
        work, f"bn_{mode}.zarr"), patch_size=p)
    t1 = time.perf_counter()
    out = decompress_latents_to_pixels(
        base, zarrlib.open(arr.path, device="cuda"), os.path.join(
            work, f"bn_rec_{mode}.zarr"), "rec/0", batch_tiles=4, halo=2)
    rec = out[...]
    t2 = time.perf_counter()
    med = base.medians
    for (i, j, _) in arr.chunk_ids():
        tile = crop[i * p:(i + 1) * p, j * p:(j + 1) * p][None]
        y = base.latents(tile)[0].cpu().numpy()
        check(np.array_equal(arr.read_chunk((i, j, 0)),
                             np.round(y - med) + med),
              f"cae_bn ({mode}): chunk {(i, j)} is not the tile's quantized "
              "latent")
    check(rec.shape == crop.shape, f"cae_bn ({mode}): {rec.shape}")
    p_bn, p_cae = psnr_db(rec, crop), psnr_db(rec_cae[:2 * p, :2 * p], crop)
    check(abs(p_bn - p_cae) <= 0.5, f"cae_bn ({mode}): PSNR {p_bn:.3f} dB "
          f"against the cae path's {p_cae:.3f}")
    log(f"slide cae_bn ({mode}) [{CARD}]: {2 * p}^2 crop, 4 latent chunks "
        f"equal to the tiles' quantized latents; halo 2 decode PSNR "
        f"{p_bn:.3f} dB (cae path {p_cae:.3f}); compress "
        f"{(t1 - t0) * 1e3:.1f} ms, decompress {(t2 - t1) * 1e3:.1f} ms")


def host_copy_times(torch, img):
    """The pieces of moving the slide's bytes to and from the card, in ms
    (host clock around work that ends in a synchronize, 3 repetitions
    each): a fresh host buffer of its size written once (new pages, as the
    JAX design's padded copy), the same write again (resident pages), the
    pageable upload of the slide into a new device tensor, of a buffer
    written just before into a new one, of the slide into one allocated
    once, a new device tensor of its size after
    ``empty_cache`` (new device memory), a pinned buffer's allocation and
    upload, the fetch into a new host tensor and into a resident one."""
    n = img.nbytes
    dev = torch.device("cuda")
    src = torch.from_numpy(np.ascontiguousarray(img).reshape(-1))
    into_dev = torch.empty(n, dtype=torch.uint8, device=dev)
    into_host = torch.empty(n, dtype=torch.uint8)
    into_host.fill_(1)
    resident = np.ones(n, np.uint8)
    pinned = []

    def fresh():
        np.zeros(n, np.uint8)[:] = 7

    def device_alloc():
        torch.cuda.empty_cache()
        torch.empty(n, dtype=torch.uint8, device=dev).fill_(3)

    def pin():
        pinned[:] = [torch.empty(n, dtype=torch.uint8, pin_memory=True)]

    rows = {"host fresh": fresh,
            "host again": lambda: resident.__setitem__(slice(None), 7),
            "h2d new": lambda: src.to(dev),
            "h2d recent": lambda: torch.from_numpy(resident).to(dev),
            "h2d into": lambda: into_dev.copy_(src),
            "device alloc": device_alloc,
            "pin": pin,
            "h2d pinned": lambda: into_dev.copy_(pinned[0]),
            "d2h new": lambda: into_dev.cpu(),
            "d2h into": lambda: into_host.copy_(into_dev)}
    out = []
    for name, f in rows.items():
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            f()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        out.append(f"{name} {', '.join(f'{t:.1f}' for t in ms)}")
    log(f"host copies of {n} bytes [{CARD}] (ms, 3 repetitions): "
        + "; ".join(out))


def slide_fused(torch, core, img, work, mode, ref_path, ref_rec):
    """(e) The whole-image fused paths on the slide, ``chunk`` 16: chunks
    byte-equal to ``compress_pixels_to_cae``'s store of (b) at offset 0
    (``ref_path``), the decode bit-equal to ``decompress_cae_array``'s
    (``ref_rec``), launches exactly 4 chunks' worth; encode and decode MP/s
    beside the pipeline's timed again in this call, the stages of each fused
    pass and the device busy share of each (its kernels' and copies' time
    in one more profiled pass over the timed pass); in float32, the pieces
    of moving the slide's bytes (``host_copy_times``) and one compress
    under ``trace`` whose file must name K4's and K1's kernels."""
    import shutil

    from cnn_autoencoder_tpu_torch.ops.kernels import reset_launch_counts
    from cnn_autoencoder_tpu_torch.pipeline.tiles import (
        compress_image_fused, compress_pixels_to_cae, decompress_cae_array,
        decompress_image_fused)
    from cnn_autoencoder_tpu_torch.storage import zarr as zarrlib
    from cnn_autoencoder_tpu_torch.utils.profiling import GLOBAL_TIMER, trace
    base = core.base
    p, n = SLIDE_PATCH, SLIDE_BATCHES
    path = os.path.join(work, f"fused_{mode}.zarr")

    def fused_compress():
        return compress_image_fused(base, img, path, patch_size=p,
                                    chunk=FUSED_CHUNK,
                                    checkpoint_id=CHECKPOINT)

    t0 = time.perf_counter()
    piped = compress_pixels_to_cae(base, img, os.path.join(
        work, f"fused_ref_{mode}.zarr"), patch_size=p,
        checkpoint_id=CHECKPOINT)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    decompress_cae_array(piped, core=base)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    GLOBAL_TIMER.reset()
    reset_launch_counts()
    t3 = time.perf_counter()
    arr = fused_compress()
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    rec = decompress_image_fused(arr, core=base, chunk=FUSED_CHUNK)
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    report = stage_report(GLOBAL_TIMER, t3, t4, t5)
    gdn = "gdn_fwd" if mode == "float32" else "gdn_fwd_bf16"
    slide_launches(torch, f"fused ({mode}) compress + decompress",
                   {gdn: 3 * n, K4_SERVING[mode]: n}, 0)
    check(slide_chunks(arr) == slide_chunks(zarrlib.open(ref_path)),
          f"fused ({mode}): chunks differ from compress_pixels_to_cae's")
    check(np.array_equal(rec, ref_rec), f"fused ({mode}): image differs "
          "from decompress_cae_array's")
    busy_c = device_ms(torch, fused_compress, 1) / 1e3
    busy_d = device_ms(torch, lambda: decompress_image_fused(
        arr, core=base, chunk=FUSED_CHUNK), 1) / 1e3
    mpix = SLIDE * SLIDE / 1e6
    log(f"slide fused ({mode}) [{CARD}]: {SLIDE}^2 in {n} chunks of "
        f"{FUSED_CHUNK} x {p}^2; chunks byte-equal to "
        "compress_pixels_to_cae's, image bit-equal to decompress_cae_array's;"
        f" encode {mpix / (t4 - t3):.3f} MP/s ({(t4 - t3) * 1e3:.1f} ms), "
        f"decode {mpix / (t5 - t4):.3f} MP/s ({(t5 - t4) * 1e3:.1f} ms); the "
        f"pipeline in this call {mpix / (t1 - t0):.3f} / "
        f"{mpix / (t2 - t1):.3f} MP/s; device busy {busy_c * 1e3:.3f} ms a "
        f"compress ({100 * busy_c / (t4 - t3):.1f} % of the timed pass), "
        f"{busy_d * 1e3:.3f} ms a decompress "
        f"({100 * busy_d / (t5 - t4):.1f} %)")
    log(f"slide fused ({mode}) GLOBAL_TIMER [{CARD}]: {report}")
    if mode != "float32":
        return
    host_copy_times(torch, img)
    trace_dir = os.path.join(ROOT, "build", "phase7_trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    try:
        with trace(trace_dir):
            fused_compress()
            torch.cuda.synchronize()
        files = os.listdir(trace_dir)
        check(len(files) == 1 and files[0].endswith(".pt.trace.json"),
              f"trace wrote {files}")
        with open(os.path.join(trace_dir, files[0])) as f:
            text = f.read()
        names = ("conv_gdn_mma_kernel", "gdn_tc_kernel")
        check(all(k in text for k in names), f"the trace names none of "
              f"{[k for k in names if k not in text]}")
        log(f"trace of one fused compress: {files[0]}, {len(text)} bytes, "
            f"names {', '.join(names)}")
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)


def run_cli(args, env, label):
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m"] + args, cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"{label} exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    return time.perf_counter() - t0


def slide_clis(torch, slide_path, stores, work):
    """(d) ``python -m cnn_autoencoder_tpu_torch.cli.compress`` and
    ``... .cli.decompress`` as subprocesses, zarr in and zarr out, in each
    precision, the four compresses started at once and then the four
    decompresses: each compressed store's chunks byte-equal to the
    pipeline's store of (a) / (b), and each decompressed image bit-equal
    to the pipeline's decode."""
    from cnn_autoencoder_tpu_torch.storage import zarr as zarrlib
    envs, outs, recs = {}, {}, {}
    for codec, mode in stores:
        envs[codec, mode] = dict(os.environ, CAE_TPU_PRECISION=(
            "highest" if mode == "float32" else "bf16"))
        outs[codec, mode] = os.path.join(work, f"cli_{codec}_{mode}.zarr")
        recs[codec, mode] = os.path.join(work,
                                         f"cli_rec_{codec}_{mode}.zarr")
    t0 = time.perf_counter()
    finish_tools({f"compress CLI {key}": subprocess.Popen(
        [sys.executable, "-m", "cnn_autoencoder_tpu_torch.cli.compress",
         "-dd", slide_path, "-o", outs[key], "-if", "zarr", "-cod", key[0],
         "-chk", CHECKPOINT, "-ps", str(SLIDE_PATCH), "-da", "YXC", "-dg",
         "0/0", "-ld", work], cwd=ROOT, env=envs[key],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for key in stores})
    t1 = time.perf_counter()
    finish_tools({f"decompress CLI {key}": subprocess.Popen(
        [sys.executable, "-m", "cnn_autoencoder_tpu_torch.cli.decompress",
         "-dd", outs[key], "-o", recs[key], "-of", "zarr", "-dg", "0/0",
         "-ld", work], cwd=ROOT, env=envs[key], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for key in stores})
    t2 = time.perf_counter()
    for (codec, mode), (ref_path, ref_rec) in stores.items():
        got = slide_chunks(zarrlib.open(outs[codec, mode])["0/0"])
        want = slide_chunks(zarrlib.open(ref_path))
        check(got == want, f"compress CLI ({codec}, {mode}): chunks differ "
              "from the pipeline's store")
        rec = zarrlib.open(recs[codec, mode])["decompressed/0/0"][...]
        check(np.array_equal(rec, ref_rec), f"decompress CLI ({codec}, "
              f"{mode}): image differs from the pipeline's decode")
        log(f"CLI {codec} ({mode}): {len(got)} chunks byte-equal to the "
            "pipeline's, image bit-equal to the pipeline's decode")
    log(f"CLIs [{CARD}]: {len(stores)} compress subprocesses at once "
        f"{t1 - t0:.1f} s, then {len(stores)} decompress subprocesses at "
        f"once {t2 - t1:.1f} s")


def phase_slide(torch, core, core16):
    """Phase 7: a 4096^2 synthetic slide, stored as a port zarr store (YXC,
    512^2 chunks, raw), through the pipeline and the CLIs, in float32
    (``core``) and bf16 (``core16``)."""
    import shutil

    from cnn_autoencoder_tpu_torch.storage import zarr as zarrlib
    t0 = time.perf_counter()
    work = os.path.join(ROOT, "build", "phase7")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        img = synth_histology(SLIDE, SLIDE, seed=0)
        slide_path = os.path.join(work, "slide.zarr")
        arr = zarrlib.Group.create(slide_path).create_dataset(
            "0/0", shape=img.shape, chunks=(SLIDE_PATCH, SLIDE_PATCH, 3),
            dtype=np.uint8, compressor=None)
        arr[...] = img
        stores = {}
        for mode, c in (("float32", core), ("bf16", core16)):
            stores["CAETPU", mode] = slide_turbo(torch, c, img, work, mode)
            stores["CAE", mode] = slide_cae(torch, c, img, work, mode, 0)
            slide_cae(torch, c, img, work, mode, 2 ** c.base.level)
            slide_bottleneck(torch, c, img, work, mode,
                             stores["CAE", mode][1])
            slide_fused(torch, c, img, work, mode, *stores["CAE", mode])
        slide_clis(torch, slide_path, stores, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"slide phase: {time.perf_counter() - t0:.1f} s")


# -- phase 8 -----------------------------------------------------------------

# the training CLI's synthetic slides: (name, side, synth_histology seed)
CLI_SLIDES = (("train_0", 2048, 11), ("train_1", 2048, 12),
              ("val_0", 1024, 13))
CLI_BATCH, CLI_PATCH = 16, 256
# -s 6 -cs 3 with the default early warm-up of -1: a validation at steps 2
# and 5 ((step + 1) % 3 == 0), the check before step 7 stops (7 updates of
# the early-stopping count reach -s 6 only then), so step 7 runs, validates
# and writes the last checkpoint; the resumed run's -s 2 gives 3 steps and
# validations at steps 2 and 3
CLI_STEPS, CLI_VALIDATIONS = 7, 3
RESUME_STEPS, RESUME_VALIDATIONS = 3, 2
VAL_BATCHES = 1     # the 1024^2 slide's 16 patches of 256^2
# launches per validation batch (the eval step: serving variants), by mode
VAL_LAUNCHES = {"float32": {"gdn_fwd": 3, "conv_gdn_fwd": 1},
                "bf16": {"gdn_fwd_bf16": 3, "conv_gdn_fwd_bf16": 1}}


def cli_argv(work, log_dir, steps, extra=()):
    files = [os.path.join(work, f"{name}.zarr") for name, _, _ in CLI_SLIDES]
    return (["-ds", "Zarr", "-dd"] + files
            + ["-dg", "0/0", "-da", "YXC", "-chk", CHECKPOINT, "-bs",
               str(CLI_BATCH), "-vbs", str(CLI_BATCH), "-ps", str(CLI_PATCH),
               "-s", str(steps), "-cs", "3", "-cr", "RateMSE", "-act", "GDN",
               "-trm", "encoder", "decoder", "fact_ent", "-rs", "0",
               "-esp", "100", "-ld", log_dir] + list(extra))


@contextlib.contextmanager
def recorded_steps(torch, cli, rec=None):
    """Record each train step's loss and its time (host clock around the
    step and a synchronize) while ``cli.main`` runs; into ``rec`` (a dict)
    also each step's number (sub-steps of one batch share it) and energy,
    and the first step's gradients and the model's buffers (batch norms'
    running statistics) after it."""
    make_step = cli.make_train_step
    losses, times = [], []

    def recording(*a, **k):
        step = make_step(*a, **k)

        def run(*sa, **sk):
            t0 = time.perf_counter()
            out = step(*sa, **sk)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(out[0]["loss"]))
            if rec is not None and "grads" not in rec:
                rec["grads"] = {m: {n: g.detach().clone()
                                    for n, g in gs.items()}
                                for m, gs in out[1].items()}
                rec["buffers"] = {n: b.detach().clone()
                                  for n, b in a[0].named_buffers()}
            if rec is not None:
                rec.setdefault("steps", []).append(int(sa[2]))
                energy = out[0].get("energy")
                rec.setdefault("energy", []).append(
                    None if energy is None else float(energy))
            return out
        return run

    cli.make_train_step = recording
    try:
        yield losses, times
    finally:
        cli.make_train_step = make_step


def cli_run(torch, work, mode, label, steps=CLI_STEPS - 1, extra=(),
            rec=None, argv=None):
    """One in-process ``main`` of the train CLI on the card, in ``mode``'s
    precision ("float32" the highest, else a precision's name); returns
    (log dir, losses, step times, launches, wall s).  ``rec``: as in
    ``recorded_steps``; ``argv(log_dir)``, when given, the CLI's arguments
    in place of phase 8's."""
    from cnn_autoencoder_tpu_torch.cli import train_cae as cli
    from cnn_autoencoder_tpu_torch.ops import convops
    from cnn_autoencoder_tpu_torch.ops.kernels import (kernel_wrappers,
                                                       reset_launch_counts)
    from cnn_autoencoder_tpu_torch.utils.args import get_args
    from cnn_autoencoder_tpu_torch.utils.loggers import setup_logger
    log_dir = os.path.join(work, label)
    args = get_args("autoencoder", "training",
                    args_list=(argv(log_dir) if argv else
                               cli_argv(work, log_dir, steps, extra)))
    setup_logger(args)
    saved = convops.get_default_precision()
    convops.set_default_precision({"float32": "highest"}.get(mode, mode))
    try:
        with recorded_steps(torch, cli, rec) as (losses, times):
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            cli.main(args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            # inside plain_versions() the plain functions stand in for the
            # wrappers and count nothing
            launches = {fn.kernel_name: fn.launches
                        for fn in kernel_wrappers()
                        if hasattr(fn, "kernel_name")}
    finally:
        convops.set_default_precision(saved)
    check(all(np.isfinite(losses)), f"CLI {label}: losses {losses}")
    return log_dir, list(losses), list(times), launches, wall


def cli_expected(mode, steps, validations):
    want = {}
    for name, k in STEP_LAUNCHES[mode].items():
        want[name] = want.get(name, 0) + k * steps
    for name, k in VAL_LAUNCHES[mode].items():
        want[name] = want.get(name, 0) + k * validations * VAL_BATCHES
    return want


def cli_checkpoints(log_dir):
    """{"last" | "best": path} of a run's checkpoints."""
    out = {}
    for fn in os.listdir(log_dir):
        if fn.endswith(".msgpack"):
            out[fn.split("_")[0]] = os.path.join(log_dir, fn)
    return out


def cli_serves(torch, path, img):
    """(d) a checkpoint loads into ``CAECodecCore`` on the card and
    round-trips a 512^2 tile; returns its PSNR."""
    from cnn_autoencoder_tpu_torch.models.factory import \
        autoencoder_from_state_dict
    from cnn_autoencoder_tpu_torch.storage.cae_codec import CAECodecCore
    core = CAECodecCore(autoencoder_from_state_dict(path, device="cuda"),
                        device="cuda")
    tile = img[None, :512, :512]
    rec = core.decode_tiles(core.encode_tiles(tile))
    check(rec.shape == tile.shape, f"served tile {rec.shape}")
    db = psnr_db(rec[0], tile[0])
    check(np.isfinite(db) and db > 20, f"served tile PSNR {db:.3f} dB")
    return db


def cli_resume(torch, work, last):
    """(e) restore the slots and schedulers from ``last`` as ``main`` does
    under ``--resume-optimizers``: count, mu and nu equal to the saved ones,
    bit for bit; then resume training from it."""
    from cnn_autoencoder_tpu_torch.cli import train_cae as cli
    from cnn_autoencoder_tpu_torch.training.checkpoint import load_checkpoint
    from cnn_autoencoder_tpu_torch.training.optim import optimizer_state_dict
    from cnn_autoencoder_tpu_torch.utils.args import get_args
    args = get_args("autoencoder", "training", args_list=cli_argv(
        work, os.path.join(work, "resume"), 2, ["-chk", last, "-reso",
                                                 "true"]))
    model = cli.setup_network(args, device="cuda")
    optimizers, schedulers, _ = cli.setup_optim(model, args)
    cli.resume_optimizer(optimizers, schedulers, last, model)
    saved = load_checkpoint(last)

    def same(a, b, where):
        if isinstance(a, dict):
            check(isinstance(b, dict) and set(a) == set(b),
                  f"resume: keys differ at {where}")
            for k in a:
                same(a[k], b[k], f"{where}/{k}")
        else:
            check((a is None and b is None) or np.array_equal(a, b),
                  f"resume: {where} differs from the checkpoint's")
    counts = set()
    for name, slot in optimizers.items():
        same(optimizer_state_dict(slot, model), saved["optimizer_" + name],
             name)
        counts.add(slot.count)
    check(counts == {CLI_STEPS}, f"resume: Adam counts {counts}")
    del model, optimizers
    return cli_run(torch, work, "float32", "resume", 2,
                   ["-chk", last, "-reso", "true"])


def write_cli_slides(work):
    from cnn_autoencoder_tpu_torch.storage import zarr as zarrlib
    for name, side, seed in CLI_SLIDES:
        img = synth_histology(side, side, seed=seed)
        arr = zarrlib.Group.create(os.path.join(work, f"{name}.zarr")) \
            .create_dataset("0/0", shape=img.shape,
                            chunks=(CLI_PATCH, CLI_PATCH, 3),
                            dtype=np.uint8, compressor=None)
        arr[...] = img
    return img


def loader_time(work):
    """Host seconds per batch of one pass over the train loader, and its
    batch count."""
    from cnn_autoencoder_tpu_torch.data.datautils import get_data
    from cnn_autoencoder_tpu_torch.utils.args import get_args
    args = get_args("autoencoder", "training", args_list=cli_argv(
        work, os.path.join(work, "loader"), 1))
    train_data, _, _ = get_data(args, device="cuda")
    t0 = time.perf_counter()
    n = sum(1 for _ in train_data)
    return (time.perf_counter() - t0) / n, n


def phase_train_cli(torch, step_ms):
    """Phase 8: the training CLI on the card at the flagship's width and
    depth; returns the launches of the counted float32 and bf16 runs and
    their ms per step after the first."""
    import shutil
    t0 = time.perf_counter()
    work = os.path.join(ROOT, "build", "phase8")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    totals, cli_ms = {}, {}
    try:
        val_img = write_cli_slides(work)
        per_batch, n_batches = loader_time(work)
        for mode, rtol in (("float32", 1e-5), ("bf16", 2e-2)):
            # (a) the counted run, (c) its launches
            torch.cuda.reset_peak_memory_stats()
            log_dir, losses, times, launches, wall = cli_run(
                torch, work, mode, mode)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            want = cli_expected(mode, CLI_STEPS, CLI_VALIDATIONS)
            log(f"CLI train {mode}: launches {launches}")
            check(len(losses) == CLI_STEPS, f"CLI {mode}: {len(losses)} "
                  f"steps, expected {CLI_STEPS}")
            check(launches == {k: want.get(k, 0) for k in launches},
                  f"CLI {mode}: launches {launches}, expected {want}")
            for name, n in launches.items():
                totals[name] = totals.get(name, 0) + n
            # (b) the same run through the plain versions
            with plain_versions():
                _, plain, _, _, _ = cli_run(torch, work, mode,
                                            f"{mode}_plain")
            rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain))
            check(len(plain) == len(losses) and rel <= rtol,
                  f"CLI {mode}: losses {losses} against the plain versions' "
                  f"{plain} (max relative {rel:.3e} > {rtol})")
            # (d) the checkpoints
            chk = cli_checkpoints(log_dir)
            check(set(chk) == {"last", "best"}, f"CLI {mode}: {chk}")
            db = cli_serves(torch, chk["last"], val_img)
            ms = float(np.mean(times[1:])) * 1e3
            med = float(np.median(times[1:])) * 1e3
            cli_ms[mode] = ms
            log(f"CLI train {mode} [{CARD}]: {CLI_STEPS} steps of "
                f"{CLI_BATCH} x {CLI_PATCH}^2, {CLI_VALIDATIONS} validations;"
                f" losses {losses}; step times (ms) "
                f"{[round(t * 1e3, 3) for t in times]}; plain versions "
                f"{plain}, max relative "
                f"{rel:.3e} (limit {rtol}); {ms:.3f} ms per step after the "
                f"first (train step + synchronize; median {med:.3f}), "
                f"{CLI_BATCH / ms * 1e3:.2f} images/s, against phase 5's "
                f"bare step {step_ms[mode]:.3f} ms "
                f"({CLI_BATCH / step_ms[mode] * 1e3:.2f} images/s); main() "
                f"{wall:.2f} s in all; peak memory {peak:.2f} GiB; last_ "
                f"serves a 512^2 tile at {db:.3f} dB")
        log(f"CLI loader [{CARD}]: {per_batch * 1e3:.1f} ms of host time a "
            f"batch of {CLI_BATCH} x {CLI_PATCH}^2 ({n_batches} batches "
            "from 2 raw zarr slides, one pass)")
        # (e) resume from the float32 run's last_ checkpoint
        last = cli_checkpoints(os.path.join(work, "float32"))["last"]
        _, losses, _, launches, _ = cli_resume(torch, work, last)
        want = cli_expected("float32", RESUME_STEPS, RESUME_VALIDATIONS)
        check(launches == {k: want.get(k, 0) for k in launches},
              f"CLI resume: launches {launches}, expected {want}")
        log(f"CLI resume: count, mu and nu of every slot equal to last_'s; "
            f"{len(losses)} more steps, losses {losses}")
        # (f) the real entry point
        secs = run_cli(["cnn_autoencoder_tpu_torch.cli.train_cae"]
                       + cli_argv(work, os.path.join(work, "sub"), 1),
                       dict(os.environ), "train CLI subprocess")
        check("last" in cli_checkpoints(os.path.join(work, "sub")),
              "train CLI subprocess wrote no last_ checkpoint")
        log(f"CLI subprocess: python -m cnn_autoencoder_tpu_torch.cli."
            f"train_cae, 2 steps, exited 0 in {secs:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"train CLI phase: {time.perf_counter() - t0:.1f} s")
    return totals, cli_ms


# -- phase 9 -----------------------------------------------------------------

# the counted runs of phase 9: -s 2 gives 3 batches and validations after
# the second and the third (phase 8's resume)
EC_STEPS, EC_BATCHES, EC_VALIDATIONS = 2, 3, 2
SUB_STEPS = 3
# PA iterates on a batch while its largest energy share is <= -el and PB
# while its one-hot decode's variance is >= -el; shares are at most 1 and
# variances at least 0, so every batch takes all -ss sub-steps in both
# runs of a comparison, whatever their last digits
PENALTY_FLAGS = {"RateMSEPA": ["-ss", str(SUB_STEPS), "-el", "1.0"],
                 "RateMSEPB": ["-ss", str(SUB_STEPS), "-el", "0"]}
MULTISCALE_FLAGS = ["-cr", "MultiscaleRateMSSSIM", "-dl", "0.01", "0.01",
                    "0.01"]
# DistMSSSIM's (window, zero padding) at 256^2 patches, scales 0 to 2 (the
# pyramid's 256^2, 128^2 and 64^2)
MSSSIM_GEOMETRY = [(11, 0), (9, 8), (7, 24)]
# PB's decode of its one-hot code through the two IGDN layers: per
# sub-step (with a gradient) and per validation batch
PB_STEP_LAUNCHES = {"float32": {"gdn_fwd": 2},
                    "bf16": {"gdn_train_fwd": 2, "gdn_train_bwd": 2}}
PB_VAL_LAUNCHES = {"float32": {"gdn_fwd": 2}, "bf16": {"gdn_fwd_bf16": 2}}
COARSE_LEVELS = (2, 1)
# the bottleneck's likelihood floor (models/entropy.py, likelihood_bound)
LIKELIHOOD_BOUND = 1e-9


def write_reference_pth(torch, path):
    """(a) The flagship as a reference training checkpoint: its config
    scalars and a torch state dict per module under the reference's names
    (``analysis_track.i.model.j``, ``synthesis_track.i.model.j``,
    ``_matrixK``, ``quantiles``; ``tests/torch_ref_cae.py`` writes the
    same), laid out from the msgpack's arrays by the inverse of the
    importer's GDN unit layout: conv then GDN at indices 0 and 1, HWIO
    kernels to OIHW, the flipped deconv kernels to (in, out, kh, kw),
    gamma to (C, C, 1, 1)."""
    from cnn_autoencoder_tpu_torch.training.checkpoint import load_checkpoint
    state = load_checkpoint(CHECKPOINT)
    chk = {k: v for k, v in state.items() if not isinstance(v, dict)}
    level = int(state["compression_level"])

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    for module, track, unit, conv, gdn in (
            ("encoder", "analysis_track", "down", "conv_down", "gdn_down"),
            ("decoder", "synthesis_track", "up", "deconv_up", "gdn_up")):
        sd = {}
        for i in range(level):
            layers = state[module]["params"][f"{unit}_{i}"]
            k = np.asarray(layers[conv]["kernel"])
            sd[f"{track}.{i}.model.0.weight"] = t(
                np.transpose(k, (3, 2, 0, 1)) if module == "encoder"
                else np.transpose(k[::-1, ::-1], (2, 3, 0, 1)))
            if gdn in layers:
                g = np.asarray(layers[gdn]["gamma"])
                sd[f"{track}.{i}.model.1.beta"] = t(layers[gdn]["beta"])
                sd[f"{track}.{i}.model.1.gamma"] = t(g.reshape(g.shape
                                                              + (1, 1)))
        chk[module] = sd
    chk["fact_ent"] = {(n if n == "quantiles" else "_" + n.replace("_", "")):
                       t(v) for n, v in state["fact_ent"]["params"].items()}
    torch.save(chk, path)


def pth_serving(torch, model, core, imgs, pth, label=".pth"):
    """(a) The ``.pth`` model (or another checkpoint of the flagship's
    weights, named ``label`` in the log) through ``CAETurboCore`` on phase
    3's tiles: weights, frames and decodes equal to the msgpack model's,
    launches counted over its round trip."""
    from cnn_autoencoder_tpu_torch.models.factory import \
        autoencoder_from_state_dict
    from cnn_autoencoder_tpu_torch.ops.kernels import (kernel_wrappers,
                                                       reset_launch_counts)
    from cnn_autoencoder_tpu_torch.storage.turbo_codec import CAETurboCore
    pmodel = autoencoder_from_state_dict(pth, device="cuda")
    ref = model.state_dict()
    got = pmodel.state_dict()
    check(set(got) == set(ref) and all(torch.equal(v, ref[k])
                                       for k, v in got.items()),
          f"{label} model: weights differ from the msgpack model's")
    pcore = CAETurboCore(pmodel, num_streams=1024, device="cuda")
    want = core.encode_tiles(imgs)
    rec_want = core.decode_tiles(want)
    pcore.decode_tiles(pcore.encode_tiles(imgs))     # warm-up
    torch.cuda.synchronize()
    retries = pcore.capacity_retries
    reset_launch_counts()
    frames = pcore.encode_tiles(imgs)
    rec = pcore.decode_tiles(frames)
    torch.cuda.synchronize()
    launches = {fn.kernel_name: fn.launches for fn in kernel_wrappers()}
    retries = pcore.capacity_retries - retries
    expect = {"gdn_fwd": 3, "conv_gdn_fwd": 1, "rans_encode_states": 1,
              "rans_compact": 1 + retries, "rans_decode": 1}
    log(f"{label} serving launches: {launches}")
    check(launches == {k: expect.get(k, 0) for k in launches},
          f"{label} serving: launches {launches}, expected {expect}")
    check(frames == want, f"{label} model: frames differ from the msgpack "
          "model's")
    check(np.array_equal(rec, rec_want), f"{label} model: decodes differ "
          "from the msgpack model's")
    log(f"{label} import: {len(got)} weights equal to the msgpack model's; "
        f"{len(frames)} frames of 512^2 byte-equal and the decodes "
        "bit-equal")
    return launches


def pth_cli(torch, core, img, slide_path, work, pth):
    """(a) ``cli.compress -chk <the .pth>`` on phase 7's slide, in-process
    (phase 7 runs the entry point as a subprocess): every chunk equal to
    the msgpack core's pipeline store of the same slide."""
    from cnn_autoencoder_tpu_torch.cli.compress import compress
    from cnn_autoencoder_tpu_torch.pipeline.tiles import \
        compress_pixels_to_cae_turbo
    from cnn_autoencoder_tpu_torch.storage import zarr as zarrlib
    from cnn_autoencoder_tpu_torch.utils.args import get_args
    ref = compress_pixels_to_cae_turbo(core, img, os.path.join(
        work, "ref.zarr"), patch_size=SLIDE_PATCH, checkpoint_id=CHECKPOINT)
    out = os.path.join(work, "pth_cli.zarr")
    t0 = time.perf_counter()
    compress(get_args("encoder", "inference", args_list=[
        "-dd", slide_path, "-o", out, "-if", "zarr", "-cod", "CAETPU",
        "-chk", pth, "-ps", str(SLIDE_PATCH), "-da", "YXC", "-dg", "0/0",
        "-ld", work]))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = slide_chunks(zarrlib.open(out)["0/0"])
    check(got == slide_chunks(ref), "compress CLI from the .pth: chunks "
          "differ from the msgpack model's store")
    log(f"CLI compress -chk .pth [{CARD}]: {secs:.2f} s in-process, "
        f"{len(got)} chunks byte-equal to the msgpack model's")


@contextlib.contextmanager
def step_likelihoods(rec, always=False):
    """Keep each train step's likelihoods (float32, on the card) in
    ``rec["p_y"]`` while a CLI run builds its criterion and trains: the
    rate loss of the run's criterion records them when a gradient flows
    (validation batches are not recorded), or at every call with
    ``always`` (a head's step on a frozen codec)."""
    from cnn_autoencoder_tpu_torch.criteria import ratedist
    rate = ratedist.RATE_LOSS_LIST["Rate"]

    def recording(x, p_y):
        if always or p_y.requires_grad:
            rec.setdefault("p_y", []).append(p_y.detach().float())
            rec["pixels"] = x.shape[0] * x.shape[1] * x.shape[2]
        return rate(x, p_y)

    ratedist.RATE_LOSS_LIST["Rate"] = recording
    try:
        yield
    finally:
        ratedist.RATE_LOSS_LIST["Rate"] = rate


def off_floor_losses(torch, losses, rec, ref_losses, ref):
    """The two runs' losses step by step without the rate of the elements
    whose likelihood sits at its 1e-9 floor in either run, and the count of
    those elements.  The reference's likelihood (compressai's, as the JAX
    package's) takes the sign of lower + upper, which is exactly 0 for an
    element at its median now and then: that element's likelihood is 0,
    floored at 1e-9, some 30 bits, and which run it happens in follows the
    last bits of y."""
    floor = torch.tensor(LIKELIHOOD_BOUND, dtype=torch.float32)
    a_out, b_out, n_out = [], [], 0
    for la, lb, pa, pb in zip(losses, ref_losses, rec["p_y"], ref["p_y"]):
        at = (pa <= floor.to(pa.device)) | (pb <= floor.to(pb.device))
        n = int(at.sum())
        if n:
            la -= float(-torch.log2(pa[at]).sum()) / rec["pixels"]
            lb -= float(-torch.log2(pb[at]).sum()) / ref["pixels"]
        a_out.append(la)
        b_out.append(lb)
        n_out += n
    return a_out, b_out, n_out


def ec_expected(mode, criterion, sub_steps, validations):
    """Launches of a phase 9 train run: phase 8's per step and validation
    batch, and PB's decodes."""
    want = cli_expected(mode, sub_steps, validations)
    if criterion == "RateMSEPB":
        for name, k in PB_STEP_LAUNCHES[mode].items():
            want[name] = want.get(name, 0) + k * sub_steps
        for name, k in PB_VAL_LAUNCHES[mode].items():
            want[name] = want.get(name, 0) + k * validations * VAL_BATCHES
    return want


def ec_train(torch, work, mode, criterion, flags):
    """(b) / (c) One counted run of the train CLI with ``criterion`` in
    ``mode`` and the same run through the plain versions: launches exact,
    the same sub-steps per batch, losses within phase 8's limits.  Returns
    (launches, log dir, record, ms per sub-step, peak GiB)."""
    rtol = 1e-5 if mode == "float32" else 2e-2
    label = f"{criterion}_{mode}"
    rec, plain_rec = {}, {}
    torch.cuda.reset_peak_memory_stats()
    with step_likelihoods(rec):
        log_dir, losses, times, launches, _ = cli_run(
            torch, work, mode, label, EC_STEPS, flags, rec)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    subs = [rec["steps"].count(s) for s in sorted(set(rec["steps"]))]
    want = ec_expected(mode, criterion, len(losses), EC_VALIDATIONS)
    log(f"{label}: launches {launches}; sub-steps per batch {subs}")
    check(subs == [SUB_STEPS if criterion in PENALTY_FLAGS else 1]
          * EC_BATCHES, f"{label}: sub-steps per batch {subs}")
    check(launches == {k: want.get(k, 0) for k in launches},
          f"{label}: launches {launches}, expected {want}")
    with plain_versions(), step_likelihoods(plain_rec):
        _, plain, _, _, _ = cli_run(torch, work, mode, label + "_plain",
                                    EC_STEPS, flags, plain_rec)
    check(plain_rec["steps"] == rec["steps"], f"{label}: sub-steps "
          f"{rec['steps']} against the plain versions' {plain_rec['steps']}")
    check(len(plain) == len(losses) == len(rec["p_y"])
          == len(plain_rec["p_y"]), f"{label}: {len(losses)} steps, "
          f"{len(plain)} plain")
    raw = max(abs(a - b) / abs(b) for a, b in zip(losses, plain))
    got, want, floored = off_floor_losses(torch, losses, rec, plain,
                                          plain_rec)
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    check(rel <= rtol, f"{label}: losses {got} against the plain versions' "
          f"{want}, {floored} floored elements left out (max relative "
          f"{rel:.3e} > {rtol}; {raw:.3e} with them)")
    del rec["p_y"], plain_rec["p_y"]
    ms = float(np.mean(times[1:])) * 1e3
    energy = [round(e, 6) for e in rec["energy"]] \
        if rec["energy"][0] is not None else None
    log(f"{label} [{CARD}]: {len(losses)} sub-steps of {CLI_BATCH} x "
        f"{CLI_PATCH}^2 over {EC_BATCHES} batches, {EC_VALIDATIONS} "
        f"validations; losses {losses}; energies {energy}; plain versions "
        f"max relative {rel:.3e} (limit {rtol}) without the {floored} "
        f"elements whose likelihood sat at its floor in either run "
        f"({raw:.3e} with them); {ms:.3f} ms per sub-step "
        f"after the first, {CLI_BATCH / ms * 1e3:.2f} images/s; peak memory "
        f"{peak:.2f} GiB")
    return launches, log_dir, rec, ms, peak


def multiscale_flagship(torch, work, val_img):
    """(b) The flagship with color layers, saved as a msgpack checkpoint:
    each ``color_i``'s centre tap is the least-squares map (float64 normal
    equations) from the decoder's stage-i features of the val slide's
    patches to the target pyramid at that scale, its other taps 0.  From
    seed-0 color layers MS-SSIM's coarse contrast terms sit at or below 0
    (relu'd) and their gradients are ill-conditioned: Adam's sign-like
    first steps then carry the kernels' float32-accurate rounding to the
    step-2 loss, 3.8e-5 from the plain versions' run
    (``scripts/torch_train_parity.py`` measures both starts)."""
    from cnn_autoencoder_tpu_torch.criteria.ratedist import \
        downsample_pyramid
    from cnn_autoencoder_tpu_torch.models.factory import \
        autoencoder_from_state_dict
    from cnn_autoencoder_tpu_torch.training.checkpoint import (
        load_checkpoint, save_checkpoint)
    from cnn_autoencoder_tpu_torch.utils.weights import state_to_jax
    state = dict(load_checkpoint(CHECKPOINT), multiscale_analysis=True)
    model = autoencoder_from_state_dict(state, device="cuda")
    p, n = CLI_PATCH, val_img.shape[0] // CLI_PATCH
    x = torch.from_numpy(np.stack([
        val_img[i * p:(i + 1) * p, j * p:(j + 1) * p]
        for i in range(n) for j in range(n)]).astype(np.float32) / 255.0)
    level = model.compression_level
    with torch.no_grad():
        x = x.cuda()
        _, feats = model.decoder(torch.round(model.encoder(x)))
        targets = [x]
        for _ in range(level - 1):
            targets.append(downsample_pyramid(targets[-1]))
        for i in range(level - 1):
            a = feats[i].reshape(-1, feats[i].shape[-1]).double()
            b = targets[level - 1 - i].reshape(-1, 3).double()
            w = torch.linalg.solve(a.T @ a, a.T @ b)
            conv = getattr(model.decoder, f"color_{i}")
            conv.weight.zero_()
            conv.weight[:, :, 1, 1] = w.T.float()
    path = os.path.join(work, "multiscale.msgpack")
    save_checkpoint(path, {**model.config,
                           **state_to_jax(model.state_dict(), model.config)})
    return path


def multiscale_geometry(work):
    """(b) The criterion the CLI builds: MS-SSIM at three scales with
    windows 11 / 9 / 7 and zero padding 0 / 8 / 24."""
    from cnn_autoencoder_tpu_torch.cli import train_cae as cli
    from cnn_autoencoder_tpu_torch.utils.args import get_args
    args = get_args("autoencoder", "training", args_list=cli_argv(
        work, os.path.join(work, "geometry"), EC_STEPS, MULTISCALE_FLAGS))
    criterion, _ = cli.setup_criteria(args)
    got = [(c.win_size, c.padding)
           for c in criterion.dist_loss._dist_criteria]
    check(got == MSSSIM_GEOMETRY, f"MS-SSIM windows and paddings {got}")


def coarse_decodes(torch, img, work, last):
    """(d) A 'cae_bn' store of the slide from the multiscale ``last_``
    checkpoint, decoded by ``cli.decompress -rl 2`` and ``-rl 1``, each
    twice in-process (phase 7 runs the entry point as a subprocess) with
    the launches counted: 1/2 and 1/4 of the slide's side, bit-equal from
    run to run.  Returns the launches of the first runs."""
    from cnn_autoencoder_tpu_torch.cli.decompress import decompress
    from cnn_autoencoder_tpu_torch.models.factory import \
        autoencoder_from_state_dict
    from cnn_autoencoder_tpu_torch.ops.kernels import (kernel_wrappers,
                                                       reset_launch_counts)
    from cnn_autoencoder_tpu_torch.pipeline.tiles import (
        compress_pixels_to_bottleneck, default_batch_tiles)
    from cnn_autoencoder_tpu_torch.storage import zarr as zarrlib
    from cnn_autoencoder_tpu_torch.storage.cae_codec import CAECodecCore
    from cnn_autoencoder_tpu_torch.utils.args import get_args
    ms_core = CAECodecCore(autoencoder_from_state_dict(last, device="cuda"),
                           device="cuda")
    check(ms_core.model.config.get("multiscale_analysis") is True,
          f"{last} is not a multiscale model")
    bn = os.path.join(work, "bn.zarr")
    compress_pixels_to_bottleneck(ms_core, img, bn, patch_size=SLIDE_PATCH)
    del ms_core
    lp = SLIDE_PATCH // 8
    n_chunks = (SLIDE // SLIDE_PATCH) ** 2
    totals = {}

    def argv(rl, out):
        return ["-dd", bn, "-o", out, "-of", "zarr", "-dg", "0/0", "-chk",
                last, "-rl", str(rl), "-ld", work]

    for rl in COARSE_LEVELS:
        side = SLIDE >> (3 - rl)
        batches = -(-n_chunks // default_batch_tiles(lp << rl))
        runs = []
        for k in range(2):
            out = os.path.join(work, f"rl{rl}_{k}")
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            decompress(get_args("decoder", "inference",
                                args_list=argv(rl, out)))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = {fn.kernel_name: fn.launches
                        for fn in kernel_wrappers()}
            want = {"gdn_fwd": 2 * batches}
            check(launches == {k2: want.get(k2, 0) for k2 in launches},
                  f"-rl {rl}: launches {launches}, expected {want}")
            if k == 0:
                for name, n in launches.items():
                    totals[name] = totals.get(name, 0) + n
            rec = zarrlib.open(os.path.join(out, "bn.zarr"))[
                "decompressed/0/0"][...]
            check(rec.shape == (side, side, 3) and rec.dtype == np.uint8,
                  f"-rl {rl}: {rec.shape} {rec.dtype}")
            runs.append((rec, secs))
        check(np.array_equal(runs[0][0], runs[1][0]),
              f"-rl {rl}: two decodes differ")
        f = SLIDE // side
        ref = img.reshape(side, f, side, f, 3).mean(axis=(1, 3))
        log(f"decompress -rl {rl} [{CARD}]: {side}^2 ({SLIDE // side}x "
            f"below the slide), {batches} batch(es), launches {want}, two "
            f"runs bit-equal ({runs[0][1]:.2f} / {runs[1][1]:.2f} s "
            f"in-process); PSNR against the slide's {f}x{f} means "
            f"{psnr_db(runs[0][0], ref):.3f} dB")
    return totals


def phase_energy_multiscale(torch, model, core, cli_ms):
    """Phase 9: the reference ``.pth`` import, multiscale MS-SSIM training,
    penalties A and B with their sub-iterations, and reconstruction at
    coarser levels, at the flagship's width on the card; returns the
    launches of the counted runs."""
    import shutil

    from cnn_autoencoder_tpu_torch.storage import zarr as zarrlib
    t0 = time.perf_counter()
    work = os.path.join(ROOT, "build", "phase9")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    totals = {}

    def add(launches):
        for name, n in launches.items():
            totals[name] = totals.get(name, 0) + n

    try:
        # (a) the .pth import
        pth = os.path.join(work, "flagship.pth")
        write_reference_pth(torch, pth)
        imgs = np.stack([image(512, 512, seed) for seed in range(TILES)])
        add(pth_serving(torch, model, core, imgs, pth))
        img = synth_histology(SLIDE, SLIDE, seed=0)
        slide_path = os.path.join(work, "slide.zarr")
        zarrlib.Group.create(slide_path).create_dataset(
            "0/0", shape=img.shape, chunks=(SLIDE_PATCH, SLIDE_PATCH, 3),
            dtype=np.uint8, compressor=None)[...] = img
        pth_cli(torch, core, img, slide_path, work, pth)

        # (b) multiscale MS-SSIM training, (c) penalties A and B
        val_img = write_cli_slides(work)
        multiscale_geometry(work)
        ms_flags = MULTISCALE_FLAGS + ["-chk", multiscale_flagship(
            torch, work, val_img)]
        lines, last = [], None
        for mode in ("float32", "bf16"):
            launches, log_dir, rec, ms, peak = ec_train(
                torch, work, mode, "MultiscaleRateMSSSIM", ms_flags)
            add(launches)
            colors = {n: g for n, g in rec["grads"]["decoder"].items()
                      if n.startswith("color_")}
            check(len(colors) == 2 and all(
                bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
                for g in colors.values()), f"MultiscaleRateMSSSIM {mode}: "
                f"step-1 color-layer gradients {sorted(colors)} zero or "
                "not finite")
            if mode == "float32":
                last = cli_checkpoints(log_dir)["last"]
            lines.append(f"MultiscaleRateMSSSIM {mode} {ms:.3f} ms "
                         f"({peak:.2f} GiB)")
            for crit, flags in PENALTY_FLAGS.items():
                launches, _, _, ms, peak = ec_train(
                    torch, work, mode, crit, ["-cr", crit] + flags)
                add(launches)
                lines.append(f"{crit} {mode} {ms:.3f} ms ({peak:.2f} GiB)")
            lines.append(f"phase 8's RateMSE {mode} step "
                         f"{cli_ms[mode]:.3f} ms")
        log(f"phase 9 train steps [{CARD}], batch {CLI_BATCH} x "
            f"{CLI_PATCH}^2, ms per sub-step (peak memory): "
            + "; ".join(lines))

        # (d) reconstruction at coarser levels
        add(coarse_decodes(torch, img, work, last))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"energy compaction and multiscale phase: "
        f"{time.perf_counter() - t0:.1f} s")
    return totals


# -- phase 10 ----------------------------------------------------------------

# the flagship's widths with the remaining architecture options: R, residual
# GDN units; B, plain GDN units with batch norm and dropout 0.1
ARCH_OPTIONS = {"R": {"use_residual": True},
                "B": {"batch_norm": True, "dropout": 0.1}}
ARCH_FLAGS = {"R": ["-res"], "B": ["-bn", "-do", "0.1"]}
# -s 2 with -cs 5: 3 steps and one validation, when the run stops
ARCH_STEPS, ARCH_VALIDATIONS = 3, 1
ARCH_RUN_FLAGS = ["-cs", "5"]
# launches per train step and per eval pass (a validation batch, or a
# serving round trip's encoder and decoder), by model and mode: R's eight
# GDN layers (gdn_res and gdn_down / gdn_up in the first two units of each
# track), B's four, none fused (residual units, batch norm); B's GDN layers
# take float32 rows from their batch norms, so its bf16 step runs K2 on
# float32 rows and its bf16 eval K1 on float32 rows
ARCH_STEP_LAUNCHES = {
    ("R", "float32"): {"gdn_fwd": 8},
    ("R", "bf16"): {"gdn_train_fwd": 8, "gdn_train_bwd": 8},
    ("B", "float32"): {"gdn_fwd": 4},
    ("B", "bf16"): {"gdn_train_fwd_f32": 4, "gdn_train_bwd": 4}}
ARCH_EVAL_LAUNCHES = {
    ("R", "float32"): {"gdn_fwd": 8}, ("R", "bf16"): {"gdn_fwd_bf16": 8},
    ("B", "float32"): {"gdn_fwd": 4}, ("B", "bf16"): {"gdn_fwd": 4}}
# R's step with remat: the encoder's and decoder's forwards run again in
# the backward, so every forward GDN kernel launches twice
REMAT_LAUNCHES = {"float32": {"gdn_fwd": 16},
                  "bf16": {"gdn_train_fwd": 16, "gdn_train_bwd": 8}}
REMAT_TIMED = 5     # steps timed after the compared one, with and without
# the grouped model the JAX package builds (channels_org a multiple of
# channels_net): 3 / 3 / 3, each convolution in as many groups as inputs
GROUPED = dict(channels_org=3, channels_net=3, channels_bn=3,
               compression_level=3, K=4, r=3, act_layer_type="GDN",
               groups=True)


def arch_checkpoint(torch, kind, path, val_img):
    """R or B at the flagship's widths, saved as a msgpack checkpoint: the
    flagship's trained layers (every conv, deconv and GDN of its units and
    the bottleneck, under the same names), so that the latents stay inside
    the flagship's tables; R's residual branches drawn from seed 0 at a
    hundredth of their initial scale; B's batch norms made the identity on
    the flagship's features of the val slide's 16 patches: running mean and
    bias their inputs' mean, running var their variance and scale
    sqrt(var + eps) (from flax's initial values, where a train-mode batch
    norm would rescale every feature of the trained model to unit
    variance)."""
    from cnn_autoencoder_tpu_torch.models.factory import build_model
    from cnn_autoencoder_tpu_torch.ops.batchnorm import EPSILON, BatchNorm
    from cnn_autoencoder_tpu_torch.training.checkpoint import (
        load_checkpoint, save_checkpoint)
    from cnn_autoencoder_tpu_torch.utils.weights import state_from_jax
    state = load_checkpoint(CHECKPOINT)
    config = {k: v for k, v in state.items() if not isinstance(v, dict)}
    flagship = state_from_jax(state, config)
    config.update(ARCH_OPTIONS[kind])
    model = build_model(config, torch.Generator().manual_seed(0),
                        device="cuda")
    p, n = CLI_PATCH, val_img.shape[0] // CLI_PATCH
    x = torch.from_numpy(np.stack([
        val_img[i * p:(i + 1) * p, j * p:(j + 1) * p]
        for i in range(n) for j in range(n)]).astype(np.float32) / 255.0)
    seen = {}
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.setdefault(mod, args[0].float()))
        for m in model.modules() if isinstance(m, BatchNorm)]
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name in flagship:
                t.copy_(flagship[name])
            elif ".res_" in name and name.endswith(".weight"):
                t.mul_(0.01)
        model.decoder(model.encoder(x.cuda()))
        for mod, inp in seen.items():
            mean = inp.mean((0, 1, 2))
            var = inp.var((0, 1, 2), correction=0)
            mod.mean.copy_(mean)
            mod.bias.copy_(mean)
            mod.var.copy_(var)
            mod.scale.copy_(torch.sqrt(var + EPSILON))
    for h in hooks:
        h.remove()
    check(len(seen) == (6 if kind == "B" else 0),
          f"{kind}: {len(seen)} batch norms calibrated")
    save_checkpoint(path, model)
    return path


@contextlib.contextmanager
def drawn_masks(rec):
    """Keep every dropout keep-mask a run draws (``Dropout.draw``) in
    ``rec["masks"]``, in draw order."""
    from cnn_autoencoder_tpu_torch.ops import dropout
    draw = dropout.Dropout.draw

    def recording(self, *a, **k):
        mask = draw(self, *a, **k)
        rec.setdefault("masks", []).append(mask.clone())
        return mask

    dropout.Dropout.draw = recording
    try:
        yield
    finally:
        dropout.Dropout.draw = draw


def arch_expected(kind, mode, steps, evals):
    want = {}
    for table, n in ((ARCH_STEP_LAUNCHES, steps), (ARCH_EVAL_LAUNCHES,
                                                    evals)):
        for name, k in table[(kind, mode)].items():
            want[name] = want.get(name, 0) + k * n
    return want


def arch_train(torch, work, kind, mode, chk):
    """(a) One counted run of the train CLI on ``kind`` in ``mode`` and the
    same run through the plain versions: launches exact, losses within
    phase 8's limits (elements at the likelihood floor left out), every
    step-1 gradient finite and non-zero, B's running statistics moved by
    step 1 and equal to the plain run's, the same dropout masks in both
    runs.  Returns (launches, log dir, ms per step, peak GiB)."""
    rtol = 1e-5 if mode == "float32" else 2e-2
    label = f"{kind}_{mode}"
    flags = ARCH_FLAGS[kind] + ARCH_RUN_FLAGS + ["-chk", chk]
    rec, plain_rec = {}, {}
    torch.cuda.reset_peak_memory_stats()
    with step_likelihoods(rec), drawn_masks(rec):
        log_dir, losses, times, launches, _ = cli_run(
            torch, work, mode, label, ARCH_STEPS - 1, flags, rec)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = arch_expected(kind, mode, ARCH_STEPS,
                         ARCH_VALIDATIONS * VAL_BATCHES)
    log(f"{label}: launches {launches}")
    check(len(losses) == ARCH_STEPS, f"{label}: {len(losses)} steps")
    check(launches == {k: want.get(k, 0) for k in launches},
          f"{label}: launches {launches}, expected {want}")
    with plain_versions(), step_likelihoods(plain_rec), \
            drawn_masks(plain_rec):
        _, plain, _, _, _ = cli_run(torch, work, mode, label + "_plain",
                                    ARCH_STEPS - 1, flags, plain_rec)
    got, ref, floored = off_floor_losses(torch, losses, rec, plain,
                                         plain_rec)
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, ref))
    check(len(plain) == len(losses) and rel <= rtol,
          f"{label}: losses {got} against the plain versions' {ref}, "
          f"{floored} floored elements left out (max relative {rel:.3e} > "
          f"{rtol})")
    n_grads = 0
    for module, gs in rec["grads"].items():
        for name, g in gs.items():
            check(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0,
                  f"{label} step 1: the gradient of {module}.{name} is zero "
                  "or not finite")
            n_grads += 1
    masks = rec.get("masks", [])
    check(len(masks) == len(plain_rec.get("masks", [])) and all(
        torch.equal(a, b) for a, b in zip(masks, plain_rec.get("masks", []))),
        f"{label}: dropout masks differ from the plain versions' run")
    stats_note = ""
    if kind == "B":
        check(len(masks) == 6 * ARCH_STEPS and not all(
            bool(m.all()) for m in masks), f"{label}: {len(masks)} masks")
        moved, worst = 0, 0.0
        for name, b in rec["buffers"].items():
            start = 0.0 if name.endswith(".mean") else 1.0
            moved += int(bool((b != start).any()))
            p = plain_rec["buffers"][name]
            worst = max(worst, float((b - p).abs().max()
                                     / p.abs().max().clamp_min(1e-30)))
        check(moved == len(rec["buffers"]), f"{label}: {moved} of "
              f"{len(rec['buffers'])} running statistics moved at step 1")
        check(worst <= max(rtol, 1e-4), f"{label}: running statistics "
              f"after step 1 {worst:.3e} from the plain run's")
        stats_note = (f"; all {moved} running statistics moved at step 1, "
                      f"within {worst:.3e} (relative to each one's max) of "
                      f"the plain run's; {len(masks)} dropout masks, the "
                      "same in both runs")
    del rec["p_y"], plain_rec["p_y"]
    ms = float(np.mean(times[1:])) * 1e3
    log(f"{label} [{CARD}]: {ARCH_STEPS} steps of {CLI_BATCH} x "
        f"{CLI_PATCH}^2, {ARCH_VALIDATIONS} validation; losses {losses}; "
        f"plain versions {plain}, max relative {rel:.3e} (limit {rtol}) "
        f"without {floored} floored elements; all {n_grads} step-1 "
        f"gradients finite and non-zero{stats_note}; {ms:.3f} ms per step "
        f"after the first, {CLI_BATCH / ms * 1e3:.2f} images/s; peak memory "
        f"{peak:.2f} GiB")
    return launches, log_dir, ms, peak


def arch_serve(torch, kind, last, imgs):
    """(b) ``last`` through ``CAETurboCore`` on phase 3's tiles in float32
    and bf16: launches exact, symbols lossless, two decodes bit-equal, the
    plain versions within phase 3's tolerances.  Returns the launches."""
    from cnn_autoencoder_tpu_torch.models.factory import \
        autoencoder_from_state_dict
    from cnn_autoencoder_tpu_torch.ops.kernels import (kernel_wrappers,
                                                       reset_launch_counts)
    from cnn_autoencoder_tpu_torch.storage.turbo_codec import (
        CAETurboCore, is_turbo_frame)
    model = autoencoder_from_state_dict(last, device="cuda").train()
    totals = {}
    for mode, dtype in (("float32", torch.float32),
                        ("bf16", torch.bfloat16)):
        label = f"{kind} serving ({mode})"
        core = CAETurboCore(model, num_streams=1024, device="cuda",
                            compute_dtype=dtype)
        core.decode_tiles(core.encode_tiles(imgs))      # warm-up
        torch.cuda.synchronize()
        retries = core.capacity_retries
        reset_launch_counts()
        frames = core.encode_tiles(imgs)
        rec = core.decode_tiles(frames)
        torch.cuda.synchronize()
        launches = {fn.kernel_name: fn.launches for fn in kernel_wrappers()}
        retries = core.capacity_retries - retries
        want = arch_expected(kind, mode, 0, 1)
        want.update(rans_encode_states=1, rans_compact=1 + retries,
                    rans_decode=1)
        check(launches == {k: want.get(k, 0) for k in launches},
              f"{label}: launches {launches}, expected {want}")
        for name, n in launches.items():
            totals[name] = totals.get(name, 0) + n
        check(len(frames) == len(imgs) and all(map(is_turbo_frame, frames)),
              f"{label}: not every frame is a turbo frame")
        with torch.no_grad():
            sym = core.latent_symbols(imgs)
            check(torch.equal(sym, core.symbols_from_frames(
                frames, core.num_streams, 512, 512)),
                f"{label}: decoded symbols differ from the encoded ones")
        check(np.array_equal(rec, core.decode_tiles(frames)),
              f"{label}: two decodes differ")
        with torch.no_grad(), plain_versions():
            sym_p = core.latent_symbols(imgs)
            rec_p = core.base.decode_tiles_device(sym).cpu().numpy()
        flips = float((sym_p != sym).float().mean())
        diff = np.abs(rec_p.astype(np.int32) - rec)
        frac = float(np.mean(diff != 0))
        check(flips <= 1e-4 and frac < 5e-3 and int(diff.max()) <= 1,
              f"{label}: plain versions: symbol flips {flips:.3e}, u8 "
              f"pixels differing {frac:.3e} by up to {int(diff.max())}")
        db = psnr_db(rec, imgs)
        bpp = 8.0 * sum(len(f) for f in frames) / (len(imgs) * 512 * 512)
        log(f"{label} [{CARD}]: {len(imgs)} tiles of 512^2 from a "
            f"train-mode model, launches {launches}, all turbo frames, "
            f"symbols lossless, two decodes bit-equal; PSNR {db:.3f} dB, "
            f"{bpp:.4f} bpp; plain versions: symbol flips {flips:.3e}, u8 "
            f"pixels differing {frac:.3e} (max {int(diff.max())})")
        del core
    return totals


def remat_steps(torch, chk):
    """(c) R's bare train step with and without remat from the same state,
    batch and generator seed, float32 and bf16, cuDNN's deterministic
    switch on for the comparison: one step each, loss within 1e-6 relative
    and every parameter within 1e-5 (the JAX package's remat test), the
    step-1 gradients compared, the recompute's launches counted, the peak
    memory of both; then the device time by operation of one more step
    without remat, and the mean time of 5 more steps of each.  Returns
    the launches of the remat steps."""
    from cnn_autoencoder_tpu_torch.criteria.loss import setup_loss
    from cnn_autoencoder_tpu_torch.models.factory import \
        autoencoder_from_state_dict
    from cnn_autoencoder_tpu_torch.ops.kernels import (kernel_wrappers,
                                                       reset_launch_counts)
    from cnn_autoencoder_tpu_torch.training.loop import make_train_step
    from cnn_autoencoder_tpu_torch.training.optim import setup_optimizers
    x = synthetic_batch(torch)
    trainable = ["encoder", "decoder", "fact_ent"]
    totals = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for mode, dtype in (("float32", torch.float32),
                            ("bf16", torch.bfloat16)):
            runs = {}
            for remat in (False, True):
                model = autoencoder_from_state_dict(chk, device="cuda")
                opt = setup_optimizers(model, trainable)
                step = make_train_step(
                    model, setup_loss("RateMSE", distortion_lambda=0.01),
                    opt, trainable_modules=trainable, compute_dtype=dtype,
                    remat=remat)
                gen = torch.Generator(device="cuda").manual_seed(0)
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                reset_launch_counts()
                stats, grads = step(x, {k: TRAIN_LR for k in opt}, 1,
                                    generator=gen)
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                launches = {fn.kernel_name: fn.launches
                            for fn in kernel_wrappers()}
                want = (REMAT_LAUNCHES[mode] if remat
                        else ARCH_STEP_LAUNCHES[("R", mode)])
                check(launches == {k: want.get(k, 0) for k in launches},
                      f"R {mode} remat={remat}: launches {launches}, "
                      f"expected {want}")
                if remat:
                    for name, n in launches.items():
                        totals[name] = totals.get(name, 0) + n
                runs[remat] = (float(stats["loss"]), peak, {
                    k: v.detach().clone()
                    for k, v in model.named_parameters()}, {
                    f"{m}.{n}": g.detach().clone()
                    for m, gs in grads.items() for n, g in gs.items()})
                lrs = {k: TRAIN_LR for k in opt}
                if not remat:
                    # where the step's device time goes (cuDNN's algorithms
                    # for the residual branches' stride-1 convs)
                    profile_device(torch, lambda: step(x, lrs, 2,
                                                       generator=gen),
                                   f"one more R {mode} step")
                t0 = time.perf_counter()
                for i in range(3, 3 + REMAT_TIMED):
                    step(x, lrs, i, generator=gen)
                torch.cuda.synchronize()
                step_ms = (time.perf_counter() - t0) / REMAT_TIMED * 1e3
                runs[remat] += (step_ms,)
                del model, opt, step, grads
            (l0, p0, w0, g0, ms0), (l1, p1, w1, g1, ms1) = (runs[False],
                                                            runs[True])
            beyond = {k: float(((w1[k] - w0[k]).abs()
                                - 1e-5 * w0[k].abs()).max()) for k in w0}
            worst = max(beyond, key=beyond.get)
            same = sum(int(torch.equal(g1[k], g0[k])) for k in g0)
            g_rel = {k: float((g1[k] - g0[k]).abs().max()
                              / g0[k].abs().max().clamp_min(1e-30))
                     for k in g0}
            g_worst = max(g_rel, key=g_rel.get)
            grad_note = (f"step-1 gradients bit-equal in {same} of "
                         f"{len(g0)} parameters, the largest difference "
                         f"{g_rel[g_worst]:.3e} of its max ({g_worst})")
            check(abs(l1 - l0) <= 1e-6 * abs(l0) and beyond[worst] <= 1e-7,
                  f"R {mode}: remat loss {l1} against {l0}, {worst} beyond "
                  f"1e-5 relative by {beyond[worst]:.3e}; {grad_note}")
            log(f"R remat {mode} [{CARD}]: one step of {TRAIN_BATCH} x "
                f"{TRAIN_PATCH}^2, loss {l1} against {l0} without remat "
                f"(relative {abs(l1 - l0) / abs(l0):.3e}), every parameter "
                f"within 1e-5 relative; {grad_note}; launches "
                f"{REMAT_LAUNCHES[mode]} "
                f"against {ARCH_STEP_LAUNCHES[('R', mode)]}; peak memory "
                f"{p1:.3f} GiB with remat, {p0:.3f} GiB without "
                f"({100 * (1 - p1 / p0):.1f} % less); {ms1:.3f} ms a step "
                f"with remat, {ms0:.3f} ms without (mean of "
                f"{REMAT_TIMED} more steps, host clock and a synchronize)")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return totals


def grouped_round_trip(torch, imgs):
    """(d) A grouped GDN model (3 / 3 / 3, from seed 0) through the 'cae'
    core's device encode and decode of the 16 tiles: K1 four times at
    C = 3 (two GDN layers a track; K4 does not take groups), against the
    plain versions within phase 3's tolerances.  Returns the launches."""
    from cnn_autoencoder_tpu_torch.models.factory import build_model
    from cnn_autoencoder_tpu_torch.ops.kernels import (kernel_wrappers,
                                                       reset_launch_counts)
    from cnn_autoencoder_tpu_torch.storage.cae_codec import CAECodecCore
    model = build_model(GROUPED, torch.Generator().manual_seed(0),
                        device="cuda")
    core = CAECodecCore(model, device="cuda")
    with torch.no_grad():
        core.decode_tiles_device(core.latent_symbols(imgs))     # warm-up
        torch.cuda.synchronize()
        reset_launch_counts()
        sym = core.latent_symbols(imgs)
        rec = core.decode_tiles_device(sym).cpu().numpy()
        launches = {fn.kernel_name: fn.launches for fn in kernel_wrappers()}
        check(launches == {k: 4 if k == "gdn_fwd" else 0 for k in launches},
              f"grouped round trip: launches {launches}")
        with plain_versions():
            sym_p = core.latent_symbols(imgs)
            rec_p = core.decode_tiles_device(sym).cpu().numpy()
    flips = float((sym_p != sym).float().mean())
    diff = np.abs(rec_p.astype(np.int32) - rec)
    frac = float(np.mean(diff != 0))
    check(flips <= 1e-4 and frac < 5e-3 and int(diff.max()) <= 1,
          f"grouped round trip: plain versions: symbol flips {flips:.3e}, "
          f"u8 pixels differing {frac:.3e} by up to {int(diff.max())}")
    log(f"grouped 3/3/3 round trip [{CARD}]: {len(imgs)} tiles of 512^2, "
        f"launches {launches} (K1 at C = 3 on {len(imgs) * 256 * 256} "
        f"rows); plain versions: symbol flips {flips:.3e}, u8 pixels "
        f"differing {frac:.3e} (max {int(diff.max())}); PSNR "
        f"{psnr_db(rec, imgs):.3f} dB (random weights)")
    return launches


def phase_arch_options(torch, cli_ms):
    """Phase 10: residual units, batch norm with dropout, remat and
    grouped convolutions at the flagship's width on the card; returns the
    launches of the counted runs."""
    import shutil
    t0 = time.perf_counter()
    work = os.path.join(ROOT, "build", "phase10")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    totals = {}

    def add(launches):
        for name, n in launches.items():
            totals[name] = totals.get(name, 0) + n

    try:
        val_img = write_cli_slides(work)
        imgs = np.stack([image(512, 512, seed) for seed in range(TILES)])
        lines = []
        for kind in ("R", "B"):
            chk = arch_checkpoint(torch, kind,
                                  os.path.join(work, f"{kind}.msgpack"),
                                  val_img)
            for mode in ("float32", "bf16"):
                launches, log_dir, ms, peak = arch_train(torch, work, kind,
                                                         mode, chk)
                add(launches)
                lines.append(f"{kind} {mode} {ms:.3f} ms ({peak:.2f} GiB)")
                if mode == "float32":
                    last = cli_checkpoints(log_dir)["last"]
            add(arch_serve(torch, kind, last, imgs))
            if kind == "R":
                add(remat_steps(torch, chk))
        log(f"phase 10 train steps [{CARD}], batch {CLI_BATCH} x "
            f"{CLI_PATCH}^2, ms per step (peak memory): " + "; ".join(lines)
            + f"; phase 8's RateMSE step {cli_ms['float32']:.3f} / "
            f"{cli_ms['bf16']:.3f} ms float32 / bf16")
        add(grouped_round_trip(torch, imgs))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"architecture options phase: {time.perf_counter() - t0:.1f} s")
    return totals


# -- phase 11 ----------------------------------------------------------------

# (a) the RD harness over phase 7's slide: one 'cae' round trip is 4
# batches of 16 tiles, each K4 and K1 (down_0) in the encode and K1 twice
# (up_0, up_1) in the decode; the metrics launch no kernel
RD_LAUNCHES = {"float32": {"gdn_fwd": 12, "conv_gdn_fwd": 4},
               "bf16": {"gdn_fwd_bf16": 12, "conv_gdn_fwd_bf16": 4}}
RD_METRICS = ("dist", "rate", "ms-ssim", "ssim", "psnr", "delta_cielab")
# the JAX harness's stats file, key for key (tests/test_harnesses.py:68-85)
RD_KEYS = (set(RD_METRICS) | {"execution_time", "evaluation_time"}
           | {k + "_stats" for k in RD_METRICS + ("execution_time",
                                                  "evaluation_time")}
           | {"codec", "seed"})
# the kernel run against the plain versions' run: bpp relative (at most
# 1e-4 of the symbols flipped), PSNR in dB, the rest absolute
RD_LIMITS = {"rate": 1e-3, "psnr": 0.01, "ssim": 1e-4, "ms-ssim": 1e-4,
             "delta_cielab": 1e-4}
# (b), (c): a head trains on the frozen codec, so nothing upstream of it
# asks for a gradient and the encoder and decoder run their serving
# kernels in a train step as in a validation batch (VAL_LAUNCHES); -s 2
# with -cs 5 gives 3 steps and one validation
HEAD_STEPS, HEAD_VALIDATIONS = 3, 1
HEAD_RUN_FLAGS = ["-s", "2", "-cs", "5", "-esp", "100", "-rs", "0",
                  "-act", "GDN"]
# (b) the CIFAR-10-layout set: 5 train pickles of 128 images (576 train,
# 64 val after the loader's split) and a test pickle of 128
CIFAR_PER_BATCH, VIT_BATCH, VIT_CLASSES = 128, 64, 10
VIT_FLAGS = ["-cmt", "ViT", "-ccp", "6", "-cr", "RateMSECE", "-trm",
             "class_model"]
# (c) JNet with the CLI's -snch / -sbch / -sech defaults (128 / 48 / 1),
# one class, BCE on phase 8's slides with a label group
JNET_FLAGS = ["-smt", "JNet", "-cr", "RateMSEBCE", "-trm", "seg_model",
              "-ncl", "1", "-ldn", "1", "-lda", "YXC"]
# the attention's key biases: softmax ignores them, so their exact
# gradient is 0 and the computed one is rounding noise
ZERO_GRAD = ".self_attention.key.bias"


def same_metrics(a, b):
    """Two metric dicts equal key for key, NaN equal to NaN."""
    return set(a) == set(b) and all(
        a[k] == b[k] or (np.isnan(a[k]) and np.isnan(b[k])) for k in a)


def head_cli_launches(mode, steps, validations):
    return {k: n * (steps + validations)
            for k, n in VAL_LAUNCHES[mode].items()}


def rd_run(torch, slide_path, work, mode, label):
    """One ``cli/test_cae.py:test_cae`` over the slide in ``mode``; returns
    (saved stats, per-image metrics with their seconds, launches, wall s,
    the reconstruction)."""
    from cnn_autoencoder_tpu_torch.cli import test_cae as tc
    from cnn_autoencoder_tpu_torch.ops import convops
    from cnn_autoencoder_tpu_torch.ops.kernels import (kernel_wrappers,
                                                       reset_launch_counts)
    from cnn_autoencoder_tpu_torch.storage import zarr as zarrlib
    from cnn_autoencoder_tpu_torch.utils.args import get_args
    from cnn_autoencoder_tpu_torch.utils.loggers import setup_logger
    log_dir = os.path.join(work, label)
    out = os.path.join(work, f"{label}.zarr")
    args = get_args("autoencoder", "test", args_list=[
        "-dd", slide_path, "-if", "zarr", "-dg", "0/0", "-da", "YXC",
        "-chk", CHECKPOINT, "-ps", str(SLIDE_PATCH), "-o", out, "-ld",
        log_dir, "-rs", "0"])
    setup_logger(args)
    saved_precision = convops.get_default_precision()
    convops.set_default_precision("highest" if mode == "float32" else "bf16")
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        _, per_image = tc.test_cae(args, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {fn.kernel_name: fn.launches for fn in kernel_wrappers()
                    if hasattr(fn, "kernel_name")}
    finally:
        convops.set_default_precision(saved_precision)
    saved = torch.load(os.path.join(log_dir, "metrics_stats_0_CAE_.pth"),
                       weights_only=False)
    check(set(saved) == RD_KEYS, f"RD {label}: stats keys "
          f"{sorted(set(saved) ^ RD_KEYS)} differ from the JAX harness's")
    check(saved["codec"] == "CAE" and saved["seed"] == 0
          and all(len(saved[k]) == 1 and set(saved[k + "_stats"]) ==
                  {"avg", "std", "med", "min", "max"}
                  for k in RD_KEYS if k + "_stats" in RD_KEYS),
          f"RD {label}: stats schema")
    one = per_image[0]
    check(one["compress_time"] > 0 and one["decompress_time"] > 0 and abs(
        one["compress_time"] + one["decompress_time"]
        - one["execution_time"]) <= 1e-6 * one["execution_time"],
        f"RD {label}: stage times {one}")
    rec = zarrlib.open(out, mode="r")["decompressed/0/0"][...]
    return saved, one, launches, wall, rec


def store_symbols(core, path):
    """The latent symbols of a 'cae' store's chunks (host-decoded frames)."""
    from cnn_autoencoder_tpu_torch.storage import zarr as zarrlib
    arr = zarrlib.open(path, mode="r")["0/0"]
    return core.entropy_decode([arr.read_chunk_raw(ij)
                                for ij in sorted(arr.chunk_ids())])[0]


def rd_harness(torch, work, model, totals):
    """(a) The RD harness over the 4096^2 slide in both modes, each against
    the same run through the plain versions: the metrics and the symbols
    of the two stores."""
    from cnn_autoencoder_tpu_torch.storage import zarr as zarrlib
    from cnn_autoencoder_tpu_torch.storage.cae_codec import CAECodecCore
    core = CAECodecCore(model, device="cuda")
    img = synth_histology(SLIDE, SLIDE, seed=0)
    slide_path = os.path.join(work, "slide.zarr")
    arr = zarrlib.Group.create(slide_path).create_dataset(
        "0/0", shape=img.shape, chunks=(SLIDE_PATCH, SLIDE_PATCH, 3),
        dtype=np.uint8, compressor=None)
    arr[...] = img
    mp = SLIDE * SLIDE / 1e6
    for mode in ("float32", "bf16"):
        saved, one, launches, wall, rec = rd_run(torch, slide_path, work,
                                                 mode, f"rd_{mode}")
        want = RD_LAUNCHES[mode]
        log(f"RD harness {mode}: launches {launches}")
        check(launches == {k: want.get(k, 0) for k in launches},
              f"RD harness {mode}: launches {launches}, expected {want}")
        for name, n in launches.items():
            totals[name] = totals.get(name, 0) + n
        with plain_versions():
            ref, _, _, _, ref_rec = rd_run(torch, slide_path, work, mode,
                                           f"rd_{mode}_plain")
        diffs = {}
        for key, limit in RD_LIMITS.items():
            a, b = saved[key][0], ref[key][0]
            diffs[key] = abs(a - b) / abs(b) if key == "rate" else abs(a - b)
            check(np.isfinite(a) and diffs[key] <= limit,
                  f"RD harness {mode}: {key} {a} against the plain "
                  f"versions' {b} ({diffs[key]:.3e} > {limit})")
        sym, ref_sym = (store_symbols(core, os.path.join(work, f"{n}.zarr"))
                        for n in (f"rd_{mode}", f"rd_{mode}_plain"))
        flips = float(np.mean(sym != ref_sym))
        check(sym.shape == ref_sym.shape and flips <= 1e-4,
              f"RD harness {mode}: {flips:.3e} of the symbols flipped "
              "against the plain versions' run (limit 1e-4)")
        d = np.abs(rec.astype(np.int32) - ref_rec)
        times = ", ".join(f"{k} {one[k + '_time']:.3f} s"
                          for k in RD_METRICS)
        log(f"RD harness {mode} [{CARD}]: {SLIDE}^2 slide, patch "
            f"{SLIDE_PATCH}: test_cae {wall:.2f} s, round trip "
            f"{one['execution_time']:.3f} s ({mp / one['execution_time']:.2f}"
            f" MP/s: compress_image {one['compress_time']:.3f} s, "
            f"decompress_image {one['decompress_time']:.3f} s with its "
            f"Blosc-zlib level-9 store), metrics {one['evaluation_time']:.3f}"
            f" s ({times}); "
            + ", ".join(f"{k} {saved[k][0]:.6f}" for k in RD_METRICS)
            + "; against the plain versions' run: "
            + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items())
            + f" (limits {RD_LIMITS}); symbols flipped {flips:.3e} of "
            f"{sym.size} (limit 1e-4), u8 pixels differing "
            f"{np.mean(d != 0):.3e} (by up to {d.max()}); stats file keys "
            "equal to the JAX harness's")


def write_cifar(work):
    """A synthetic 10-class set in the CIFAR-10 pickle layout: each class a
    mean color and a stripe period, with seeded noise."""
    import pickle
    root = os.path.join(work, "cifar")
    os.makedirs(root)
    rng = np.random.RandomState(17)
    colors = rng.rand(VIT_CLASSES, 3) * 160 + 48
    yy, xx = np.mgrid[0:32, 0:32]
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        labels = rng.randint(0, VIT_CLASSES, CIFAR_PER_BATCH)
        stripes = np.stack([np.sin((xx + yy) * (c + 1) / 6.0)
                            for c in labels])[..., None] * 30
        imgs = (colors[labels][:, None, None, :] + stripes
                + rng.randn(CIFAR_PER_BATCH, 32, 32, 3) * 12)
        data = np.clip(imgs, 0, 255).astype(np.uint8).transpose(0, 3, 1, 2)
        with open(os.path.join(root, name), "wb") as f:
            pickle.dump({b"data": data.reshape(CIFAR_PER_BATCH, -1),
                         b"labels": labels.tolist()}, f)
    return root


def write_labels(work):
    """A label group (``labels/0/0``, YXC, one channel) in each of phase
    8's slides: the darker 32^2 blocks of the slide (a few connected
    regions, not the noise's speckle)."""
    from cnn_autoencoder_tpu_torch.storage import zarr as zarrlib
    for name, side, seed in CLI_SLIDES:
        img = synth_histology(side, side, seed=seed)
        n = side // 32
        dark = img.astype(np.float32).mean(-1).reshape(n, 32, n, 32) \
            .mean((1, 3)) < 150
        labels = np.repeat(np.repeat(dark, 32, 0), 32, 1)[..., None] \
            .astype(np.uint8)
        arr = zarrlib.Group.create(os.path.join(work, f"{name}.zarr")) \
            .create_dataset("labels/0/0", shape=labels.shape,
                            chunks=(CLI_PATCH, CLI_PATCH, 1),
                            dtype=np.uint8, compressor=None)
        arr[...] = labels


def head_train(torch, work, model, kind, mode, argv):
    """One counted train-CLI run of a head on the frozen flagship and the
    same run through the plain versions: launches exact, losses within
    phase 8's limits, every step-1 head gradient finite and non-zero (the
    attention's key biases finite), the encoder bit-equal after training.
    Returns (launches, log dir, ms per step, images/s, losses)."""
    from cnn_autoencoder_tpu_torch.models.factory import \
        autoencoder_from_state_dict
    rtol = 1e-5 if mode == "float32" else 2e-2
    module = "class_model" if kind == "ViT" else "seg_model"
    label = f"{kind}_{mode}"
    rec = {}
    log_dir, losses, times, launches, _ = cli_run(
        torch, work, mode, label, rec=rec, argv=argv)
    want = head_cli_launches(mode, HEAD_STEPS, HEAD_VALIDATIONS)
    log(f"{label}: launches {launches}")
    check(len(losses) == HEAD_STEPS, f"{label}: {len(losses)} steps")
    check(launches == {k: want.get(k, 0) for k in launches},
          f"{label}: launches {launches}, expected {want}")
    with plain_versions():
        _, plain, _, _, _ = cli_run(torch, work, mode, label + "_plain",
                                    argv=argv)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain))
    check(len(plain) == len(losses) and rel <= rtol,
          f"{label}: losses {losses} against the plain versions' {plain} "
          f"(max relative {rel:.3e} > {rtol})")
    check(set(rec["grads"]) == {module}, f"{label}: gradients of "
          f"{sorted(rec['grads'])}")
    zero = 0.0
    for name, g in rec["grads"][module].items():
        check(bool(torch.isfinite(g).all()), f"{label} step 1: the gradient "
              f"of {name} is not finite")
        if name.endswith(ZERO_GRAD):
            zero = max(zero, float(g.abs().max()))
        else:
            check(float(g.abs().max()) > 0, f"{label} step 1: the gradient "
                  f"of {name} is zero")
    last = cli_checkpoints(log_dir)["last"]
    trained = autoencoder_from_state_dict(last, device="cuda")
    for name, p in model.encoder.state_dict().items():
        check(torch.equal(trained.encoder.state_dict()[name], p),
              f"{label}: the encoder's {name} moved")
    ms = float(np.mean(times[1:])) * 1e3
    batch = VIT_BATCH if kind == "ViT" else CLI_BATCH
    keys = (f" but the attention's key biases' (max {zero:.3e})"
            if kind == "ViT" else "")
    log(f"{label} [{CARD}]: {HEAD_STEPS} steps of {batch} and "
        f"{HEAD_VALIDATIONS} validation on the frozen flagship; losses "
        f"{losses}; plain versions {plain}, max relative {rel:.3e} (limit "
        f"{rtol}); all {len(rec['grads'][module])} step-1 head gradients "
        f"finite and non-zero{keys}; encoder bit-equal; {ms:.3f} ms per "
        f"step after the first, {batch / ms * 1e3:.2f} images/s")
    return launches, last, ms


def classifier_run(torch, work, label, argv):
    """``cli/test_cae_classifier.py:test`` on the card; returns (metrics,
    the prediction tree's arrays by path, object-level metrics or None)."""
    from cnn_autoencoder_tpu_torch.cli import test_cae_classifier as tcc
    from cnn_autoencoder_tpu_torch.storage import zarr as zarrlib
    from cnn_autoencoder_tpu_torch.utils.args import get_args
    from cnn_autoencoder_tpu_torch.utils.loggers import setup_logger
    log_dir = os.path.join(work, label)
    args = get_args("autoencoder", "test", args_list=argv(log_dir))
    setup_logger(args)
    metrics = tcc.test(args, device="cuda")
    objects = metrics.pop("object_level", None)
    tree = {}

    def walk(node, prefix):
        for key in node.keys():
            child = node[key]
            path = f"{prefix}/{key}" if prefix else key
            if isinstance(child, zarrlib.Group):
                walk(child, path)
            else:
                tree[path] = child[...]
    walk(zarrlib.open(os.path.join(log_dir, "output.zarr"), mode="r"), "")
    return metrics, tree, objects


def vit_phase(torch, work, model, totals):
    """(b) ViT-B/16 cut 6 through the train CLI on the CIFAR-10-layout set,
    both modes, then the classifier harness on the float32 checkpoint."""
    root = write_cifar(work)

    def train_argv(log_dir):
        return (["-ds", "CIFAR10", "-dd", root, "-chk", CHECKPOINT, "-bs",
                 str(VIT_BATCH), "-vbs", str(VIT_BATCH), "-ps", "32",
                 "-ld", log_dir] + HEAD_RUN_FLAGS + VIT_FLAGS)
    ms = {}
    for mode in ("float32", "bf16"):
        launches, last, ms[mode] = head_train(torch, work, model, "ViT",
                                              mode, train_argv)
        for name, n in launches.items():
            totals[name] = totals.get(name, 0) + n
        if mode == "float32":
            chk = last

    def test_argv(log_dir):
        return ["-ds", "CIFAR10", "-dd", root, "-chk", chk, "-bs",
                str(VIT_BATCH), "-ps", "32", "-ld", log_dir]
    metrics, tree, _ = classifier_run(torch, work, "vit_test", test_argv)
    with plain_versions():
        ref, ref_tree, _ = classifier_run(torch, work, "vit_test_plain",
                                          test_argv)
    check({k.split("/")[0] for k in tree} == {"target", "scores", "class",
                                              "topk"}
          and set(tree) == set(ref_tree),
          f"ViT harness: prediction tree {sorted(tree)}")
    clear = tied = 0
    differ = {"class": 0, "topk": 0}
    for path, scores in tree.items():
        if not path.startswith("scores/"):
            continue
        top2 = np.sort(scores, -1)[:, -2:]
        ok = top2[:, 1] - top2[:, 0] > 1e-4
        sub = path.split("/", 1)[1]
        check(np.array_equal(tree["class/" + sub][ok],
                             ref_tree["class/" + sub][ok]),
              f"ViT harness: classes of {sub} differ from the plain run's")
        clear, tied = clear + int(ok.sum()), tied + int((~ok).sum())
        for group in differ:
            a, b = tree[f"{group}/{sub}"], ref_tree[f"{group}/{sub}"]
            differ[group] += int(np.any((a != b).reshape(len(a), -1),
                                        1).sum())
    # an image whose class (top-k) differs moves acc (top_acc) by 1 / p at
    # most; where none differs, every metric is the plain run's
    if differ["class"] == differ["topk"] == 0:
        check(same_metrics(metrics, ref), f"ViT harness: metrics {metrics} "
              f"against the plain versions' {ref}")
    for key, group in (("acc", "class"), ("top_acc", "topk")):
        bound = differ[group] / metrics["p"] + 1e-12
        check(abs(metrics[key] - ref[key]) <= bound, f"ViT harness: {key} "
              f"{metrics[key]} against the plain versions' {ref[key]} "
              f"({differ[group]} images' {group} differ)")
    log(f"ViT harness [{CARD}]: {metrics['p']} test images, acc "
        f"{metrics['acc']:.4f}, top-5 {metrics['top_acc']:.4f} (plain "
        f"versions {ref['acc']:.4f} / {ref['top_acc']:.4f}); classes equal "
        f"on {clear} untied images ({tied} tied within 1e-4); class / top-5 "
        f"differing on {differ['class']} / {differ['topk']} images, "
        "metrics held to the plain run's within those")
    return ms


def jnet_phase(torch, work, model, totals):
    """(c) JNet through the train CLI on phase 8's slides with a label
    group, both modes, then the harness on the float32 checkpoint
    (``jnet_harness``)."""
    write_cli_slides(work)
    write_labels(work)
    val = os.path.join(work, "val_0.zarr")

    def train_argv(log_dir):
        return (cli_argv(work, log_dir, 2) + HEAD_RUN_FLAGS + JNET_FLAGS)
    ms = {}
    for mode in ("float32", "bf16"):
        launches, last, ms[mode] = head_train(torch, work, model, "JNet",
                                              mode, train_argv)
        for name, n in launches.items():
            totals[name] = totals.get(name, 0) + n
        if mode == "float32":
            chk = last
    jnet_harness(torch, work, val, chk)
    return ms


def jnet_harness(torch, work, val, chk):
    """(c) ``cli/test_cae_classifier.py`` with ``-ccm`` on JNet's
    checkpoint over the val slide: at a threshold that gives positives,
    twice (bit-equal) and through the plain versions."""
    def test_argv(thr):
        def argv(log_dir):
            return (["-ds", "Zarr", "-dd", val, "-dg", "0/0", "-da", "YXC",
                     "-chk", chk, "-bs", str(CLI_BATCH), "-ps",
                     str(CLI_PATCH), "-ccm", "-thr", repr(thr), "-ld",
                     log_dir] + JNET_FLAGS[-6:])
        return argv
    # 3 steps from seed 0 leave every score below the default 0.5; the
    # threshold that marks as many pixels positive as the labels hold
    # gives the object-level path true and false positives to count
    _, first, _ = classifier_run(torch, work, "jnet_test_0.5",
                                 test_argv(0.5))
    scores = np.concatenate([v.ravel() for k, v in first.items()
                             if k.startswith("scores/") and k.endswith("/0")])
    labels = np.concatenate([v.ravel() for k, v in first.items()
                             if k.startswith("target/") and k.endswith("/0")])
    thr = float(np.quantile(scores, 1.0 - float(np.mean(labels > 0))))
    runs = [classifier_run(torch, work, f"jnet_test_{i}", test_argv(thr))
            for i in range(2)]
    (metrics, tree, objects), (again, tree2, again_objects) = runs
    for key in ("image_level/fpr", "image_level/tpr", "image_level/thrsh",
                "object_level/fpr", "object_level/tpr"):
        check(key in tree, f"JNet harness: no {key} in the tree")
    crops = [k for k in tree if k.startswith("scores/")
             and not k.endswith("/0")]
    check(set(tree) == set(tree2) and all(
        np.array_equal(tree[k], tree2[k]) for k in tree),
        "JNet harness: two runs' prediction trees differ")
    check(np.isfinite(metrics["auc"]) and objects is not None
          and same_metrics(metrics, again)
          and same_metrics(objects, again_objects),
          f"JNet harness: metrics {metrics} and {again}")
    check(metrics["f1"] > 0 and objects["f1"] > 0, f"JNet harness at "
          f"{thr}: no true positive ({metrics}, objects {objects})")
    with plain_versions():
        ref, ref_tree, ref_objects = classifier_run(
            torch, work, "jnet_test_plain", test_argv(thr))
    # a symbol flipped between the two runs' latents moves the scores
    # around it: held as a share of the pixels, and the metrics to within
    # a share of that order
    check(set(tree) == set(ref_tree), "JNet harness: the plain run's "
          "tree has other arrays")
    n = sum(tree[k].size for k in tree if k.startswith("class/"))
    moved = sum(int(np.sum(np.abs(tree[k] - ref_tree[k]) > 1e-4))
                for k in tree if k.startswith("scores/"))
    flipped = sum(int(np.sum(tree[k] != ref_tree[k]))
                  for k in tree if k.startswith("class/"))
    check(all(np.array_equal(tree[k], ref_tree[k]) for k in tree
              if k.startswith("target/")), "JNet harness: targets differ")
    check(moved <= 1e-3 * n and flipped <= 1e-3 * n, f"JNet harness: "
          f"{moved} scores moved by more than 1e-4 and {flipped} classes "
          f"of {n} differ from the plain run's (limit 1e-3 of them)")
    gaps = {f"{level} {k}": (0.0 if np.isnan(a[k]) and np.isnan(b[k])
                             else abs(a[k] - b[k]))
            for level, a, b in (("image", metrics, ref),
                                ("object", objects, ref_objects))
            for k in ("acc", "prec", "rec", "f1", "auc") if k in a}
    check(all(v <= 1e-3 for v in gaps.values()), f"JNet harness: metrics "
          f"against the plain versions' {gaps} (limit 1e-3)")
    log(f"JNet harness [{CARD}]: {CLI_SLIDES[2][1]}^2 val slide, "
        f"{len(crops)} component crops, threshold {thr:.6f} (the "
        f"labels' {np.mean(labels > 0):.4f} positive share); image level "
        f"acc {metrics['acc']:.4f}, f1 {metrics['f1']:.4f}, auc "
        f"{metrics['auc']:.4f} ({len(tree['image_level/fpr'])} ROC points);"
        f" object level acc {objects['acc']:.4f}, f1 {objects['f1']:.4f}, "
        f"auc {objects.get('auc', float('nan')):.4f}; two runs bit-equal; "
        f"against the plain versions' run: {moved} scores moved by more "
        f"than 1e-4 and {flipped} classes differ of {n}, largest metric "
        f"gap {max(gaps.values()):.3e} (limit 1e-3)")


def head_modules(torch):
    """The four heads at full width on the flagship's latent (48 channels,
    32^2 for 256^2 inputs), from seed 0."""
    from cnn_autoencoder_tpu_torch.models.classifiers import (
        InceptionV3ClassifierHead, ResNetClassifierHead, ViTClassifierHead)
    from cnn_autoencoder_tpu_torch.models.segmenters import JNet
    side = TRAIN_PATCH // 8
    heads = {
        "ViT-B/16 cut 6": ViTClassifierHead(
            channels_bn=48, cut_position=6, num_classes=VIT_CLASSES,
            input_size=(side, side)),
        "ResNet-152 cut 3": ResNetClassifierHead(
            channels_bn=48, cut_position=3, num_classes=VIT_CLASSES),
        "InceptionV3 cut from the patch": InceptionV3ClassifierHead(
            channels_bn=48, cut_position=None, patch_size=TRAIN_PATCH,
            compression_level=3, num_classes=VIT_CLASSES),
        "JNet": JNet(channels_bn=48, seg_channels_net=128,
                     seg_channels_bn=48, seg_channels_expansion=1,
                     compression_level=3, num_classes=1, batch_norm=False),
    }
    gen = torch.Generator().manual_seed(0)
    for head in heads.values():
        for m in head.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)
        head.cuda().eval()
    return heads


def head_forwards(torch, model):
    """(d) Each head's forward at full width on the flagship's latent of a
    16 x 256^2 batch, float32 and bf16: ms (CUDA events), device busy
    share (torch.profiler) and peak memory."""
    from cnn_autoencoder_tpu_torch.models.tasks import make_forward_fn
    x = synthetic_batch(torch)
    forward = make_forward_fn(model, ["encoder", "fact_ent"])
    heads = head_modules(torch)
    lines = []
    for mode, dtype in (("float32", torch.float32),
                        ("bf16", torch.bfloat16)):
        with torch.no_grad():
            y_q = forward(x.to(dtype), compute_dtype=dtype)[0]["y_q"]
        for name, head in heads.items():
            def run():
                with torch.no_grad():
                    return head(y_q)[0]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            out = run()
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            check(bool(torch.isfinite(out).all()), f"{name} {mode}: "
                  "logits not finite")
            ms = cuda_ms(torch, run, 5)
            busy = profile_device(torch, run, f"{name} forward, {mode}")
            lines.append(f"{name} {mode} {ms:.3f} ms, busy "
                         f"{busy * 1e3 / ms:.2f} of the call (profiled), "
                         f"{peak:.3f} GiB over the latent, out "
                         f"{tuple(out.shape)}")
    log(f"head forwards [{CARD}], the flagship's latent of {TRAIN_BATCH} x "
        f"{TRAIN_PATCH}^2 (the heads compute in float32 in both modes): "
        + "; ".join(lines))


def phase_eval_heads(torch, model):
    """Phase 11: the RD harness, a ViT and a JNet head trained through the
    train CLI on the frozen flagship, the classifier harness, and each
    head's forward at full width; returns the launches of the counted
    runs."""
    import shutil
    t0 = time.perf_counter()
    work = os.path.join(ROOT, "build", "phase11")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    totals = {}
    try:
        rd_harness(torch, work, model, totals)
        t1 = time.perf_counter()
        vit_ms = vit_phase(torch, work, model, totals)
        t2 = time.perf_counter()
        jnet_ms = jnet_phase(torch, work, model, totals)
        t3 = time.perf_counter()
        head_forwards(torch, model)
        log(f"phase 11 train steps [{CARD}], ms per step: ViT "
            f"{vit_ms['float32']:.3f} / {vit_ms['bf16']:.3f}, JNet "
            f"{jnet_ms['float32']:.3f} / {jnet_ms['bf16']:.3f} float32 / "
            f"bf16; seconds: RD harness {t1 - t0:.1f}, ViT {t2 - t1:.1f}, "
            f"JNet {t3 - t2:.1f}, forwards {time.perf_counter() - t3:.1f}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"evaluation and heads phase: {time.perf_counter() - t0:.1f} s")
    return totals


# -- phase 12 ----------------------------------------------------------------

PIXEL_BATCH = 16    # the slide pipeline's batch: 16 tiles of 512^2


def pixel_kernels(torch, img):
    """(a) K6 and K5 at the pixel transport's geometry: the zigzag residuals
    of the slide's first batch (16 tiles of 512^2 RGB, T = 768 steps of
    S = 1024 streams, one channel of 256 values) under the table the coded
    upload calibrates from those tiles.  The state pass, the compaction at
    two capacities and the decode of whole and cut queues bit-identical to
    the plain versions (``check_rans_case``); the transport's own encode at
    its capacity, its words equal to the host C++ coder's and decoded back
    to the tiles on the card and on the host; timed.  Returns {name:
    record}."""
    from cnn_autoencoder_tpu_torch.coding.device_rans import pack_streams
    from cnn_autoencoder_tpu_torch.coding.pixel_rans import (
        STREAMS, PixelRansTransport, decode_residuals_device,
        encode_residuals_device, residual_zigzag_device)
    tiles = serial_batches(img, SLIDE_PATCH, PIXEL_BATCH)[0][1]
    tr = PixelRansTransport("cuda")
    tr.calibrate_from_tiles(tiles)
    snap = tr.snapshot()
    x = torch.from_numpy(tiles).cuda()
    n = tiles[0].size
    sym = pack_streams(residual_zigzag_device(x, snap.pred_mode).reshape(
        PIXEL_BATCH, n), STREAMS).contiguous()
    t = sym.shape[1]
    check(tuple(sym.shape) == (PIXEL_BATCH, 768, STREAMS),
          f"pixel transport geometry {tuple(sym.shape)}")
    cmap = torch.zeros((t, STREAMS), dtype=torch.int32, device="cuda")
    label = (f"pixel transport {SLIDE_PATCH}^2 (predictor {snap.pred_mode}, "
             f"{tr.bits_per_value:.4f} bits a value)")
    words, totals = check_rans_case(torch, label, sym, cmap, snap.tables)
    cap = tr.capacity(n)
    q, tot = encode_residuals_device(x, snap.tables, cap, snap.pred_mode)
    torch.cuda.synchronize()
    check(torch.equal(tot, totals) and int(tot.max()) <= cap,
          f"{label}: totals {tot.tolist()} at capacity {cap}")
    check(u16_equal(torch, q, u16_prefix(torch, words, cap)),
          f"{label}: the transport's words differ from the compaction's")
    q_host, tot_host = tr.encode_host(tiles, cap, snap.freq, snap.start,
                                      snap.pred_mode)
    q_np = q.view(torch.int16).cpu().numpy().view(np.uint16)
    check(np.array_equal(tot_host, tot.cpu().numpy())
          and np.array_equal(q_host, q_np),
          f"{label}: the host C++ coder's words differ from K6's")
    rec = decode_residuals_device(q, snap.dec_lut, tiles.shape,
                                  snap.pred_mode)
    check(np.array_equal(rec.cpu().numpy(), tiles),
          f"{label}: K5's decode does not give back the tiles")
    for i in range(PIXEL_BATCH):
        back = tr.decode_host(q_np[i], int(tot_host[i]),
                              (1,) + tiles.shape[1:], snap.freq, snap.start,
                              snap.pred_mode)
        check(np.array_equal(back[0], tiles[i]),
              f"{label}: the host decode of tile {i} differs")
    log(f"{label}: capacity {cap}, {int(tot.sum())} words for "
        f"{PIXEL_BATCH} tiles ({16.0 * int(tot.sum()) / tiles.size:.4f} bits "
        "a value with the flush); K6's words equal the host C++ coder's, "
        "K5 and the host decode give back the tiles")
    records = rans_times(torch, label, sym, cmap, snap.tables, words, totals,
                         True)[0]
    for name, rec_ in records.items():
        log(f"phase 12 (a) {name} at {tuple(sym.shape)} [{CARD}]: "
            f"{rec_['ms']:.4f} ms (device time), plain {rec_['plain_ms']:.4f}"
            f" ms, bound {rec_['bound_ms']:.4f} ms ({rec_['bound_by']})")
    return records


# the switches of the pixel transports (coding/link_probe.py, pipeline/tiles)
PIXEL_SWITCHES = ("CAE_TPU_CODED_UPLOAD", "CAE_TPU_PACKED_FETCH",
                  "CAE_TPU_FETCH_CODEC")
RANS_KERNELS = ("rans_encode_states", "rans_compact", "rans_decode")


@contextlib.contextmanager
def pixel_switches(**env):
    """Run a block with exactly these transport switches set."""
    saved = {k: os.environ.pop(k, None) for k in PIXEL_SWITCHES}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def plus(*dicts):
    out = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


def slide_transport(torch, kind, core, img, work, mode):
    """(b) The slide through ``kind``'s pipeline ('cae': ``core.base``;
    'cae_tpu': ``core``), after one untimed untransported pass each way:
    untransported, with the coded upload (a fresh transport, which
    calibrates, then the persisted one), untransported again; then the
    same for the fetch by rANS (calibrating, persisted) and by the
    bit-plane packer.  Each pass is timed on the host clock with the
    launch counts and ``GLOBAL_TIMER`` reset just before; chunks equal to
    the untransported store's, pixels equal to the raw fetch's, launches
    exact (the transport's K5 and K6 on top of the untransported pass's),
    no overflow.  Returns the transport's launches ({kernel: count})."""
    from cnn_autoencoder_tpu_torch.ops.kernels import reset_launch_counts
    from cnn_autoencoder_tpu_torch.pipeline import tiles
    from cnn_autoencoder_tpu_torch.utils.profiling import GLOBAL_TIMER
    c = core.base if kind == "cae" else core
    compress, decompress = ((tiles.compress_pixels_to_cae,
                             tiles.decompress_cae_array) if kind == "cae"
                            else (tiles.compress_pixels_to_cae_turbo,
                                  tiles.decompress_cae_turbo_array))
    for attr in ("_up_transport", "_fetch_transport"):
        if hasattr(c, attr):
            delattr(c, attr)
    n = SLIDE_BATCHES
    gdn = "gdn_fwd" if mode == "float32" else "gdn_fwd_bf16"
    enc, dec = {gdn: n, K4_SERVING[mode]: n}, {gdn: 2 * n}
    if kind == "cae_tpu":
        enc.update(rans_encode_states=n, rans_compact=n)
        dec["rans_decode"] = n
    # the fetch calibration's probe: one batch decoded raw ('cae_tpu': its
    # latent decoded by K5, its pixels by the packer)
    probe = {gdn: 2, "rans_decode": 1 if kind == "cae_tpu" else 0}
    coded_fetch = {"rans_encode_states": n, "rans_compact": n}
    label = f"{kind} ({mode})"
    runs = {}
    counters = ("capacity_retries", "host_fallbacks")
    before = {k: getattr(c, k, 0) for k in counters}

    def path(name):
        return os.path.join(work, f"{kind}_{mode}_{name}.zarr")

    def squeeze(p_):
        return compress(c, img, path(p_), patch_size=SLIDE_PATCH,
                        checkpoint_id=CHECKPOINT)

    def run(name, env, fn, expect, base):
        retries = getattr(c, "capacity_retries", 0)
        with pixel_switches(**env):
            GLOBAL_TIMER.reset()
            reset_launch_counts()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = slide_launches(
                torch, f"{label} {name}", expect,
                getattr(c, "capacity_retries", 0) - retries)
        runs[name] = dict(s=secs, launches=launches, base=base,
                          link=GLOBAL_TIMER.link_bytes(),
                          stages=GLOBAL_TIMER.totals())
        return out

    with pixel_switches():
        decompress(squeeze("warm"), core=c)     # untimed warm-up
        torch.cuda.synchronize()
    arr = run("raw compress", {}, lambda: squeeze("raw"), enc, None)
    up_env = {"CAE_TPU_CODED_UPLOAD": "1"}
    for name in ("coded upload, calibrating", "coded upload"):
        up = run(name, up_env, lambda: squeeze(f"up{len(runs)}"),
                 plus(enc, {"rans_decode": n}), "raw compress")
        check(slide_chunks(up) == slide_chunks(arr), f"{label} {name}: "
              "chunks differ from the untransported store's")
    run("raw compress again", {}, lambda: squeeze("raw2"), enc, None)
    rec = run("raw decompress", {}, lambda: decompress(arr, core=c), dec,
              None)
    for name, codec, expect in (
            ("rans fetch, calibrating", "rans", plus(dec, probe,
                                                     coded_fetch)),
            ("rans fetch", "rans", plus(dec, coded_fetch)),
            ("pack fetch", "pack", dec)):
        got = run(name, {"CAE_TPU_PACKED_FETCH": "1",
                         "CAE_TPU_FETCH_CODEC": codec},
                  lambda: decompress(arr, core=c), expect, "raw decompress")
        check(np.array_equal(got, rec), f"{label} {name}: the pixels differ "
              "from the raw fetch's")
    run("raw decompress again", {}, lambda: decompress(arr, core=c), dec,
        None)
    trs = {d: getattr(c, f"_{d}_transport") for d in ("up", "fetch")}
    check(all(tr.calibrated() and tr.fallbacks == 0 for tr in trs.values()),
          f"{label}: a transport overflowed: "
          f"{[(d, tr.fallbacks) for d, tr in trs.items()]}")

    mpix = SLIDE * SLIDE / 1e6
    values = SLIDE * SLIDE * 3
    parts = []
    transport = {}
    for name, r in runs.items():
        way, back = (("h2d", "d2h") if "compress" in name or "upload" in name
                     else ("d2h", "h2d"))
        host = {k.split("/")[1]: v for k, v in r["stages"].items()
                if "host_" in k}
        parts.append(
            f"{name} {mpix / r['s']:.3f} MP/s ({r['s'] * 1e3:.1f} ms), "
            f"{way} {r['link'][way]} bytes "
            f"({8.0 * r['link'][way] / values:.4f} bits a value; {back} "
            f"{r['link'][back]})"
            + "".join(f", {k} {v:.3f} s" for k, v in sorted(host.items())))
        if r["base"]:
            for k in RANS_KERNELS:
                extra = r["launches"][k] - runs[r["base"]]["launches"][k]
                transport[k] = transport.get(k, 0) + extra
    log(f"phase 12 (b) slide {label} [{CARD}]: {SLIDE}^2 in {n} batches; "
        + "; ".join(parts))
    log(f"phase 12 (b) slide {label}: upload predictor "
        f"{trs['up'].pred_mode}, {trs['up'].bits_per_value:.4f} bits a "
        f"value calibrated; fetch predictor {trs['fetch'].pred_mode}, "
        f"{trs['fetch'].bits_per_value:.4f}; overflows and raw fallbacks "
        "0 in every pass; the latent coder's capacity retries and host "
        f"fallbacks {[getattr(c, k, 0) - before[k] for k in counters]} "
        "over the passes; chunks equal to the untransported store's, "
        f"pixels to the raw fetch's; the transport's launches {transport}")
    return transport


def phase_pixel_transport(torch, core, core16):
    """Phase 12: the pixel transport at full width on phase 7's 4096^2
    slide; returns the transport's launches for the ``kernels`` line."""
    import shutil

    from cnn_autoencoder_tpu_torch.coding import link_probe
    t0 = time.perf_counter()
    work = os.path.join(ROOT, "build", "phase12")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    totals = {}
    try:
        img = synth_histology(SLIDE, SLIDE, seed=0)
        pixel_kernels(torch, img)
        t1 = time.perf_counter()
        for kind, c, mode in (("cae", core, "float32"),
                              ("cae_tpu", core, "float32"),
                              ("cae_tpu", core16, "bf16")):
            totals = plus(totals, slide_transport(torch, kind, c, img, work,
                                                  mode))
        t2 = time.perf_counter()
        solo = [link_probe.probe_link_mbps(force=True, mb=mb)
                for mb in (4, 64)]
        duplex = link_probe.probe_link_duplex_mbps(mb=64)
        with pixel_switches():
            auto = (link_probe.coded_fetch_enabled(),
                    link_probe.coded_upload_enabled())
        log(f"phase 12 link probe [{CARD}]: d2h / h2d "
            f"{solo[0][0]:.1f} / {solo[0][1]:.1f} MB/s (4 MB), "
            f"{solo[1][0]:.1f} / {solo[1][1]:.1f} MB/s (64 MB), both at once "
            f"{duplex[0]:.1f} / {duplex[1]:.1f} MB/s (64 MB); thresholds "
            f"{link_probe._threshold('d2h'):.0f} / "
            f"{link_probe._threshold('h2d'):.0f} MB/s; auto codes the fetch "
            f"{auto[0]}, the upload {auto[1]}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"pixel transport phase: {time.perf_counter() - t0:.1f} s ((a) "
        f"{t1 - t0:.1f} s with the slide's synthesis, (b) {t2 - t1:.1f} s)")
    return totals


# -- phase 13 ----------------------------------------------------------------

MESH_SHARDS = 2         # the one card's data mesh: two shards or ranks on it
RAGGED = 13             # a batch that does not divide over the shards
# (b) the train CLI's runs: phase 8's slides, 3 steps and one validation
# (phase 10's -s 2 -cs 5), flagship float32 and bf16, B bf16
MESH_RUNS = (("flagship", "float32"), ("flagship", "bf16"), ("B", "bf16"))
ALLREDUCE_REPS = 10     # gradient all-reduces timed on the last step
SERVE_REPS = 3          # timed round trips a core in (a)


def busy_share(torch, fn):
    """(wall ms, device busy ms) of one more call of ``fn`` under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(evt.self_device_time_total for evt in prof.key_averages()
               if evt.device_type == torch.autograd.DeviceType.CUDA
               and evt.key != "Activity Buffer Request") / 1e3
    return wall * 1e3, busy


def counted(torch, fn):
    """(fn's result, its launches by kernel), the counts reset just before
    and read just after."""
    from cnn_autoencoder_tpu_torch.ops.kernels import (kernel_wrappers,
                                                       reset_launch_counts)
    torch.cuda.synchronize()
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {f.kernel_name: f.launches for f in kernel_wrappers()}


def expect_launches(label, launches, want):
    check(launches == {k: want.get(k, 0) for k in launches},
          f"{label}: launches {launches}, expected {want}")


def mesh_turbo(torch, one, mesh_core, imgs, mode, totals, tag="(a)"):
    """One counted round trip of ``imgs`` through the mesh's turbo core:
    frames byte-equal to the one-device core's, decodes bit-equal,
    symbols lossless, launches per shard exact.  Returns (frames, rec)."""
    n = MESH_SHARDS
    gdn = "gdn_fwd" if mode == "float32" else "gdn_fwd_bf16"
    label = f"{tag} cae_tpu {mode}, {len(imgs)} tiles over {n} shards"
    retries = mesh_core.capacity_retries
    (frames, rec), launches = counted(torch, lambda: (
        lambda f: (f, mesh_core.decode_tiles(f)))(
            mesh_core.encode_tiles(imgs)))
    retries = mesh_core.capacity_retries - retries
    expect_launches(label, launches, {
        gdn: 3 * n, K4_SERVING[mode]: n, "rans_encode_states": n,
        "rans_compact": n * (1 + retries), "rans_decode": n})
    plus_into(totals, launches)
    check(frames == one.encode_tiles(imgs), f"{label}: frames differ from "
          "the one-device core's")
    check(np.array_equal(rec, one.decode_tiles(frames)), f"{label}: the "
          "decode differs from the one-device core's")
    with torch.no_grad():
        check(torch.equal(mesh_core.latent_symbols(imgs),
                          mesh_core.symbols_from_frames(frames, 1024, 512,
                                                        512)),
              f"{label}: decoded symbols differ from the encoded ones")
    log(f"{label}: frames byte-equal to one device's, decode bit-equal, "
        f"symbols lossless; launches {launches} ({retries} capacity "
        "retries)")
    return frames, rec


def mesh_cae(torch, one, mesh_core, imgs, mode, totals, tag="(a)"):
    """The 'cae' core over the mesh: host frames byte-equal to the
    one-device core's, decodes bit-equal, K1 and K4 per shard."""
    n = MESH_SHARDS
    gdn = "gdn_fwd" if mode == "float32" else "gdn_fwd_bf16"
    label = f"{tag} cae {mode}, {len(imgs)} tiles over {n} shards"
    (frames, rec), launches = counted(torch, lambda: (
        lambda f: (f, mesh_core.decode_tiles(f)))(
            mesh_core.encode_tiles(imgs)))
    expect_launches(label, launches, {gdn: 3 * n, K4_SERVING[mode]: n})
    plus_into(totals, launches)
    check(frames == one.encode_tiles(imgs) and np.array_equal(
        rec, one.decode_tiles(frames)), f"{label}: frames or decode differ "
        "from the one-device core's")
    log(f"{label}: frames byte-equal, decode bit-equal; launches {launches}")


def mesh_rans_fetch(torch, mesh_core, frames, rec, mode, totals):
    """The rANS fetch through the mesh: one pooled head a shard, decoding
    to the raw fetch's pixels."""
    from cnn_autoencoder_tpu_torch.coding.pixel_rans import \
        PixelRansTransport
    from cnn_autoencoder_tpu_torch.storage.cae_codec import CAECodecCore
    n, b = MESH_SHARDS, len(frames)
    gdn = "gdn_fwd" if mode == "float32" else "gdn_fwd_bf16"
    tr = PixelRansTransport("cuda")
    tr.calibrate_from_tiles(rec)
    res, launches = counted(torch, lambda: mesh_core.base.decode_tiles_device(
        mesh_core.symbols_from_frames(frames, 1024, 512, 512), transport=tr))
    expect_launches(f"(a) rANS fetch {mode}", launches, {
        gdn: 2 * n, "rans_decode": n, "rans_encode_states": n,
        "rans_compact": n})
    plus_into(totals, launches)
    pb = mesh_core.per_shard_batch(b) * n
    check(tuple(res.head.shape[:1]) == (n,) and res.totals.shape[0] == pb,
          f"(a) rANS fetch: head {tuple(res.head.shape)}, totals "
          f"{tuple(res.totals.shape)}")
    px = CAECodecCore.fetch_pixels(res, (pb, 512, 512, 3), tr)[:b]
    check(np.array_equal(px, rec) and tr.fallbacks == 0, "(a) rANS fetch: "
          "the pixels differ from the raw fetch's, or it fell back")
    log(f"(a) rANS fetch {mode}: head {tuple(res.head.shape)} (one pooled "
        f"head a shard), {tr.bits_per_value:.4f} bits a value calibrated, "
        "pixels equal to the raw fetch's; launches " + str(launches))


def plus_into(totals, launches):
    for k, v in launches.items():
        totals[k] = totals.get(k, 0) + v


def mesh_serving(torch, model, core, core16, totals):
    """(a) Sharded serving on the card: phase 3's 16 tiles and a ragged 13
    through both cores over a two-shard mesh of the one card, float32 and
    bf16; the rANS fetch's per-shard heads; the plain versions on a
    two-shard CPU mesh; rates beside the one-device cores'."""
    from cnn_autoencoder_tpu_torch.models.factory import \
        autoencoder_from_state_dict
    from cnn_autoencoder_tpu_torch.parallel.mesh import (create_mesh,
                                                         serving_mesh)
    from cnn_autoencoder_tpu_torch.storage.cae_codec import CAECodecCore
    from cnn_autoencoder_tpu_torch.storage.turbo_codec import CAETurboCore
    check(serving_mesh() is None, "serving_mesh() is not None on one card")
    mesh = create_mesh(data=MESH_SHARDS, devices=["cuda:0"] * MESH_SHARDS)
    imgs = np.stack([image(512, 512, seed) for seed in range(TILES)])
    mpix = TILES * 512 * 512 / 1e6
    rates = []
    for mode, one in (("float32", core), ("bf16", core16)):
        dtype = one.base.compute_dtype
        m_turbo = CAETurboCore(model, num_streams=1024, mesh=mesh,
                               compute_dtype=dtype)
        m_cae = CAECodecCore(model, mesh=mesh, compute_dtype=dtype)
        m_turbo.decode_tiles(m_turbo.encode_tiles(imgs))    # warm-up
        frames, rec = mesh_turbo(torch, one, m_turbo, imgs, mode, totals)
        mesh_turbo(torch, one, m_turbo, imgs[:RAGGED], mode, totals)
        mesh_cae(torch, one.base, m_cae, imgs, mode, totals)
        mesh_cae(torch, one.base, m_cae, imgs[:RAGGED], mode, totals)
        mesh_rans_fetch(torch, m_turbo, frames, rec, mode, totals)
        for name, c in (("one device", one), (f"{MESH_SHARDS} shards",
                                              m_turbo)):
            enc, dec = [], []
            for _ in range(SERVE_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fr = c.encode_tiles(imgs)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                c.decode_tiles(fr)
                torch.cuda.synchronize()
                enc.append(t1 - t0)
                dec.append(time.perf_counter() - t1)
            wall, busy = busy_share(torch, lambda: c.decode_tiles(
                c.encode_tiles(imgs)))
            rates.append(
                f"{mode} {name}: encode {mpix / max(enc):.3f}–"
                f"{mpix / min(enc):.3f}, decode {mpix / max(dec):.3f}–"
                f"{mpix / min(dec):.3f} MP/s ({SERVE_REPS} round trips), "
                f"busy {100 * busy / wall:.1f}% of {wall:.1f} ms")
        if mode == "float32":
            cpu_model = autoencoder_from_state_dict(CHECKPOINT, device="cpu")
            cpu_core = CAETurboCore(cpu_model, num_streams=1024,
                                    mesh=create_mesh(data=MESH_SHARDS,
                                                     devices=["cpu"] * 2))
            sym = m_turbo.latent_symbols(imgs).cpu()
            flips = float((cpu_core.latent_symbols(imgs) != sym)
                          .float().mean())
            diff = np.abs(cpu_core.decode_tiles(frames).astype(np.int32)
                          - rec)
            frac = float(np.mean(diff != 0))
            log(f"(a) plain versions on a {MESH_SHARDS}-shard CPU mesh "
                f"(float32): symbol flips {flips:.3e}; u8 pixels differing "
                f"{frac:.3e}, max difference {int(diff.max())}")
            check(flips <= 1e-4 and frac < 5e-3 and int(diff.max()) <= 1,
                  "(a) the CPU mesh's plain versions miss phase 3's "
                  "tolerances")
    log(f"(a) serving [{CARD}], {TILES} tiles of 512^2: " + "; ".join(rates))


class StepProbe:
    """The train CLI's ``on_step`` in phase 13 (b), picklable into the
    ranks ``main`` spawns: each step's loss and host clock; at step 1
    whether every gradient is finite and non-zero, and the batch norms'
    running statistics (folded from step 1's batch, before any update
    reaches them: the comparison phase 10 makes); at the last step, in a
    multi-rank run, the host time of ``ALLREDUCE_REPS`` all-reduces of one
    bucket of the gradients' size (both ranks call it at the same step)."""

    def __init__(self, last_step):
        self.last_step = last_step

    def __call__(self, step, stats, grads, model):
        import torch
        import torch.distributed as dist

        from cnn_autoencoder_tpu_torch.ops.batchnorm import BatchNorm
        out = {"step": step, "loss": float(stats["loss"]),
               "t": time.perf_counter()}
        leaves = [g for gs in grads.values() for g in gs.values()]
        if step == 1:
            out["grads_ok"] = all(bool(torch.isfinite(g).all())
                                  and float(g.abs().max()) > 0
                                  for g in leaves)
            out["norms"] = {f"{name}.{k}": getattr(m, k).float().tolist()
                            for name, m in model.named_modules()
                            if isinstance(m, BatchNorm)
                            for k in ("mean", "var")}
            out["param_bytes"] = sum(p.numel() * p.element_size()
                                     for p in model.parameters())
        if step == self.last_step and dist.is_initialized():
            flat = torch.cat([g.reshape(-1).float() for g in leaves])
            dist.all_reduce(flat)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(ALLREDUCE_REPS):
                dist.all_reduce(flat)
            torch.cuda.synchronize()
            out["allreduce_ms"] = (time.perf_counter() - t0) * 1e3 \
                / ALLREDUCE_REPS
            out["bucket_bytes"] = flat.numel() * 4
        return out


def mesh_cli_run(torch, work, kind, mode, chk, devices, label):
    """One train CLI ``main`` over ``devices`` in ``mode``: its reports."""
    from cnn_autoencoder_tpu_torch.cli import train_cae as cli
    from cnn_autoencoder_tpu_torch.ops import convops
    from cnn_autoencoder_tpu_torch.ops.kernels import reset_launch_counts
    from cnn_autoencoder_tpu_torch.utils.args import get_args
    from cnn_autoencoder_tpu_torch.utils.loggers import setup_logger
    log_dir = os.path.join(work, label)
    extra = ARCH_RUN_FLAGS + (ARCH_FLAGS["B"] + ["-chk", chk]
                              if kind == "B" else [])
    args = get_args("autoencoder", "training", args_list=cli_argv(
        work, log_dir, ARCH_STEPS - 1, extra))
    setup_logger(args)
    saved = convops.get_default_precision()
    convops.set_default_precision("highest" if mode == "float32" else "bf16")
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        reports = cli.main(args, devices=devices,
                           on_step=StepProbe(ARCH_STEPS))
        wall = time.perf_counter() - t0
    finally:
        convops.set_default_precision(saved)
    return log_dir, reports, wall


def tree_leaves(tree, path=""):
    """(path, leaf) of a nested dict."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, f"{path}/{k}")
    else:
        yield path, tree


def mesh_training(torch, work, totals, started=None):
    """(b) Data-parallel training through the train CLI: two ranks on the
    one card (gloo: they share it) against one process, per run of
    ``MESH_RUNS``; ``started(work)`` is called once the slides are
    written."""
    from cnn_autoencoder_tpu_torch.training.checkpoint import load_checkpoint
    val_img = write_cli_slides(work)
    if started is not None:
        started(work)
    chk = arch_checkpoint(torch, "B", os.path.join(work, "B.msgpack"),
                          val_img)
    lines = []
    for kind, mode in MESH_RUNS:
        label = f"{kind}_{mode}"
        rtol = 1e-5 if mode == "float32" else 2e-2
        one_dir, one, one_wall = mesh_cli_run(torch, work, kind, mode, chk,
                                              ["cuda:0"], label + "_one")
        two_dir, two, two_wall = mesh_cli_run(
            torch, work, kind, mode, chk, ["cuda:0"] * MESH_SHARDS,
            label + "_two")
        check([r["rank"] for r in two] == list(range(MESH_SHARDS))
              and all(r["ranks"] == MESH_SHARDS for r in two),
              f"(b) {label}: reports {[(r['rank'], r['ranks']) for r in two]}")
        if kind == "B":
            want = arch_expected("B", mode, ARCH_STEPS, ARCH_VALIDATIONS
                                 * VAL_BATCHES)
        else:
            want = cli_expected(mode, ARCH_STEPS, ARCH_VALIDATIONS)
        ref = [s["loss"] for s in one[0]["on_step"]]
        for r in [one[0]] + two:
            tag = f"(b) {label} rank {r['rank']} of {r['ranks']}"
            expect_launches(tag, r["launches"], want)
            plus_into(totals, r["launches"])
            steps = r["on_step"]
            check(len(steps) == ARCH_STEPS and steps[0]["grads_ok"],
                  f"{tag}: {len(steps)} steps, step-1 gradients finite and "
                  f"non-zero: {steps[0].get('grads_ok')}")
            losses = [s["loss"] for s in steps]
            rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
            check(rel <= rtol, f"{tag}: losses {losses} against one "
                  f"process's {ref} (max relative {rel:.3e} > {rtol})")
        if kind == "B":
            # relative to each statistic's largest value, as phase 10
            ref_n = one[0]["on_step"][0]["norms"]
            worst = max(float(np.abs(np.subtract(r["on_step"][0]["norms"][k],
                                                 v)).max()
                              / max(float(np.abs(v).max()), 1e-30))
                        for r in two for k, v in ref_n.items())
            check(len(ref_n) > 0 and worst <= 1e-4, f"(b) {label}: step 1's "
                  f"running statistics {worst:.3e} (relative) from one "
                  "process's")
            a, b = ({p: np.asarray(v) for p, v in tree_leaves({
                m: load_checkpoint(cli_checkpoints(d)["last"])[m][
                    "batch_stats"] for m in ("encoder", "decoder")})}
                for d in (two_dir, one_dir))
            last = max(float(np.abs(a[k] - b[k]).max()
                             / max(float(np.abs(b[k]).max()), 1e-30))
                       for k in b)
            lines.append(f"{label}: running statistics after step 1 within "
                         f"{worst:.3e} (relative to each one's max) of one "
                         f"process's, after step {ARCH_STEPS} {last:.3e}")
        with open(next(os.path.join(two_dir, f) for f in os.listdir(two_dir)
                       if f.endswith(".log"))) as f:
            logs = f.read()
        check(set(cli_checkpoints(two_dir)) == {"last", "best"}
              and "Rank 0 of 2" in logs and "Rank 1" not in logs
              and not any(f.startswith(".rendezvous")
                          for f in os.listdir(two_dir)),
              f"(b) {label}: the files of the two-rank run: "
              f"{sorted(os.listdir(two_dir))}")

        def step_ms(report):
            t = [s["t"] for s in report["on_step"]]
            return 1e3 * (t[-1] - t[0]) / (len(t) - 1)

        ar = two[0]["on_step"][-1]
        lines.append(
            f"{label}: {step_ms(one[0]):.3f} ms a step on one process, "
            f"{step_ms(two[0]):.3f} / {step_ms(two[1]):.3f} on the two ranks "
            f"(steps 2-3, host clock); the gradient all-reduce over gloo "
            f"{ar['allreduce_ms']:.3f} ms for {ar['bucket_bytes']} bytes; "
            f"main() {one_wall:.1f} / {two_wall:.1f} s; losses "
            f"{[round(s['loss'], 6) for s in two[0]['on_step']]}")
    log(f"(b) data-parallel training [{CARD}], global batch {CLI_BATCH} x "
        f"{CLI_PATCH}^2 ({CLI_BATCH // MESH_SHARDS} a rank), {ARCH_STEPS} "
        "steps and 1 validation; every rank's launches exact, step-1 "
        "gradients finite and non-zero, only rank 0 wrote: "
        + "; ".join(lines))


def nccl_child(work):
    """(c)'s subprocess: join the group ``COORDINATOR_ADDRESS`` names (one
    process), one all-reduce, one train CLI step; prints its report."""
    import torch
    import torch.distributed as dist
    from cnn_autoencoder_tpu_torch.cli import train_cae as cli
    from cnn_autoencoder_tpu_torch.parallel.distributed import \
        initialize_multihost
    from cnn_autoencoder_tpu_torch.utils.args import get_args
    from cnn_autoencoder_tpu_torch.utils.loggers import setup_logger
    check(initialize_multihost(), "initialize_multihost formed no group")
    try:
        backend, world = dist.get_backend(), dist.get_world_size()
        x = torch.arange(4, dtype=torch.float32, device="cuda")
        dist.all_reduce(x)
        check(x.tolist() == [0.0, 1.0, 2.0, 3.0], f"all-reduce {x}")
        args = get_args("autoencoder", "training", args_list=cli_argv(
            work, os.path.join(work, "nccl"), 0))
        setup_logger(args)
        reports = cli.main(args, on_step=StepProbe(1))
    finally:
        dist.destroy_process_group()
    print("NCCL_REPORT " + json.dumps(dict(
        backend=backend, world=world, reports=reports)), flush=True)


def mesh_nccl_start(work):
    """(c) NCCL at world size 1: a subprocess started as rank 0 of 1 (on
    phase 8's slides, which (b) writes first); it runs beside (b)."""
    env = dict(os.environ, COORDINATOR_ADDRESS="file://" + os.path.join(
        work, "nccl_rendezvous"), NUM_PROCESSES="1", PROCESS_ID="0")
    return subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "chip_smoke.nccl_child(sys.argv[1])", work], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def mesh_nccl(proc, t0, totals):
    """(c)'s checks on the subprocess of ``mesh_nccl_start``."""
    try:
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
    check(proc.returncode == 0, f"(c) NCCL subprocess exited "
          f"{proc.returncode}: {stdout[-2000:]} {stderr[-3000:]}")
    out = json.loads(stdout.split("NCCL_REPORT ", 1)[1].splitlines()[0])
    (report,) = out["reports"]
    check(out["backend"] == "nccl" and out["world"] == 1
          and report["ranks"] == 1
          and report["on_step"][0]["grads_ok"],
          f"(c) backend {out['backend']}, report {report}")
    want = cli_expected("float32", 1, 1)
    expect_launches("(c) NCCL CLI step", report["launches"], want)
    plus_into(totals, report["launches"])
    log(f"(c) NCCL at world size 1: initialize_multihost from "
        "COORDINATOR_ADDRESS / NUM_PROCESSES=1 / PROCESS_ID=0, one all-reduce"
        f" and one CLI step over {out['backend']} on {report['device']}, "
        f"loss {report['on_step'][0]['loss']:.6f}, launches "
        f"{report['launches']}; subprocess {time.perf_counter() - t0:.1f} s")


def phase_mesh(torch, model, core, core16):
    """Phase 13: the data mesh on the one card; returns its launches for
    the ``kernels`` line."""
    import shutil
    t0 = time.perf_counter()
    work = os.path.join(ROOT, "build", "phase13")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    totals, nccl = {}, []
    try:
        mesh_serving(torch, model, core, core16, totals)
        t1 = time.perf_counter()
        mesh_training(torch, work, totals, started=lambda w: nccl.append(
            (mesh_nccl_start(w), time.perf_counter())))
        t2 = time.perf_counter()
        mesh_nccl(*nccl[0], totals)
    finally:
        for proc, _ in nccl:
            if proc.poll() is None:
                proc.kill()
        shutil.rmtree(work, ignore_errors=True)
    log(f"mesh phase: {time.perf_counter() - t0:.1f} s ((a) {t1 - t0:.1f} "
        f"s, (b) {t2 - t1:.1f} s with (c) beside it, then (c)'s end "
        f"{time.perf_counter() - t2:.1f} s)")
    return totals


# -- phase 14 ----------------------------------------------------------------

EMBED_POINTS = 2000     # points a latent store in (c), visualize_groups'
EMBED_ITERS = 500       # and t-SNE iterations: its defaults
EMBED_KINDS = ("pca", "tsne", "isomap")
EMBED_CPU_POINTS = 150  # points a store in the comparison with the CPU
TSNE_SHORT_ITERS = 30   # t-SNE iterations held elementwise to the CPU's
# card against CPU, relative to the embedding's largest value: PCA and
# Isomap up to each column's sign (float64 inside, float32 out), a short
# t-SNE from one start; a full t-SNE only by its KL(P || Q), because the
# gains' sign tests grow last-bit differences about a billionfold in 50
# iterations (tests/test_torch_manifold.py)
EMBED_TOL, TSNE_SHORT_TOL, TSNE_KL_RTOL = 1e-5, 1e-6, 0.1
# the image metrics, card against CPU: float64 but MS-SSIM (float32), the
# tolerances of tests/test_torch_metrics.py and tests/test_torch_msssim.py
METRIC_RTOL = {"ms-ssim": 1e-5}
METRIC_CODEC, METRIC_QUALITY = "CAETPU", 100
LABEL = 2               # compute_labels' label in (e)
COMPRESSOR_ROWS = 64    # rows of the first latent store compare_compressors
                        # recompresses in (e): one row of tiles, 6 MB
DATASET_TILES = 4       # tiles of the slide zarr2dataset splits in (e)


def tool_argv(name, *args):
    return [sys.executable, "-m", f"cnn_autoencoder_tpu_torch.tools.{name}",
            *map(str, args)]


def start_tools(cmds, env):
    """Start every ``{label: argv}`` at once from the checkout's root."""
    return {label: subprocess.Popen(argv, cwd=ROOT, env=env,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
            for label, argv in cmds.items()}


def finish_tools(procs, timeout=300):
    """{label: stdout} of the started tools; fails if one exits non-zero.
    Kills whatever is still running on the way out."""
    out = {}
    try:
        for label, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=timeout)
            check(proc.returncode == 0, f"the {label} subprocess "
                  f"exited {proc.returncode}: {stderr[-3000:]}")
            out[label] = stdout
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
    return out


def tree_files(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


def same_tree(torch, a, b):
    """Two trees of dicts, tensors and scalars equal key for key."""
    if isinstance(b, dict):
        return (isinstance(a, dict) and list(a) == list(b)
                and all(same_tree(torch, a[k], b[k]) for k in b))
    if isinstance(b, torch.Tensor):
        return isinstance(a, torch.Tensor) and torch.equal(a, b)
    return a == b


def up_to_sign(got, want):
    s = np.sign(np.sum(got * want, axis=0))
    s[s == 0] = 1
    return got * s


def tsne_kl(torch, x, y):
    """KL(P || Q) of an embedding ``y`` of ``x`` at the perplexity t-SNE
    uses (on the CPU)."""
    from cnn_autoencoder_tpu_torch.utils.manifold import (
        _pairwise_sq_dists, _perplexity_probabilities)
    x = torch.as_tensor(np.asarray(x, np.float64))
    n = x.shape[0]
    p = _perplexity_probabilities(_pairwise_sq_dists(x),
                                  min(30.0, max(2.0, (n - 1) / 3.0)))
    p = ((p + p.T) / (2.0 * n)).clamp(min=1e-12)
    num = 1.0 / (1.0 + _pairwise_sq_dists(torch.as_tensor(
        np.asarray(y, np.float64))))
    num.fill_diagonal_(0.0)
    q = (num / num.sum()).clamp(min=1e-12)
    return float((p * torch.log(p / q)).sum())


def slide_latents(torch, core, img, work, totals):
    """(c) The flagship's latent of the slide (the encoder on its 4 batches
    of 16 tiles: K4 and K1 each once a batch), stored as raw zarr arrays:
    the slide's top and bottom halves, and its first COMPRESSOR_ROWS rows
    for (e).  Returns their paths."""
    from cnn_autoencoder_tpu_torch.storage import zarr as zarrlib
    f = 2 ** core.base.level
    lp = SLIDE_PATCH // f
    batches = serial_batches(img, SLIDE_PATCH, TILES)
    lats, launches = counted(torch, lambda: [
        (ids, core.base.latents(tiles)) for ids, tiles in batches])
    expect_launches("(c) the slide's latents", launches,
                    {"gdn_fwd": len(batches), "conv_gdn_fwd": len(batches)})
    plus_into(totals, launches)
    latent = np.zeros((SLIDE // f, SLIDE // f, core.base.channels_bn),
                      np.float32)
    for ids, lat in lats:
        for (i, j), t in zip(ids, lat.cpu().numpy()):
            latent[i * lp:(i + 1) * lp, j * lp:(j + 1) * lp] = t
    half = latent.shape[0] // 2
    paths = []
    for name, part in (("latent_0", latent[:half]),
                       ("latent_1", latent[half:]),
                       ("latent_rows", latent[:COMPRESSOR_ROWS])):
        paths.append(os.path.join(work, f"{name}.zarr"))
        zarrlib.Array.create(paths[-1], shape=part.shape, chunks=part.shape,
                             dtype=np.float32, compressor=None)[...] = part
    return paths


def tool_embeddings(paths):
    """(c) ``compute_embeddings`` on the card at EMBED_POINTS a store and
    EMBED_ITERS t-SNE iterations, timed; ``select_in_rect`` mapped back to
    the stores' vectors.  Returns the stores' latents."""
    from cnn_autoencoder_tpu_torch.storage import zarr as zarrlib
    from cnn_autoencoder_tpu_torch.tools.visualize_groups import (
        compute_embeddings, sample_vectors, select_in_rect)
    lats = [zarrlib.open(p)[...] for p in paths]
    samples = [sample_vectors(lat, EMBED_POINTS) for lat in lats]
    vectors = np.concatenate([v for v, _ in samples])
    positions = np.concatenate([np.stack([np.full(len(sel), k), sel], 1)
                                for k, (_, sel) in enumerate(samples)])
    times = {}
    emb = compute_embeddings(vectors, EMBED_KINDS, EMBED_ITERS,
                             device="cuda", times=times)
    host = {k: v.cpu().numpy() for k, v in emb.items()}
    for kind, e in host.items():
        check(e.shape == (len(vectors), 2) and e.dtype == np.float32
              and np.isfinite(e).all(), f"(c) {kind}: {e.shape} {e.dtype}, "
              "finite: " + str(np.isfinite(e).all()))
    t = host["tsne"]
    rect = (float(t[:, 0].min()), float(t[:, 1].min()),
            float(np.median(t[:, 0])), float(np.median(t[:, 1])))
    idx = select_in_rect(emb["tsne"], rect).cpu().numpy()
    inside = np.nonzero((t[:, 0] >= rect[0]) & (t[:, 0] <= rect[2])
                        & (t[:, 1] >= rect[1]) & (t[:, 1] <= rect[3]))[0]
    w = lats[0].shape[1]
    back = np.stack([lats[f][s // w, s % w] for f, s in positions[idx]]) \
        if len(idx) else np.zeros((0, vectors.shape[1]), np.float32)
    check(len(idx) > 0 and np.array_equal(idx, inside)
          and np.array_equal(back, vectors[idx]), f"(c) select_in_rect: "
          f"{len(idx)} points, {len(inside)} inside the rectangle, vectors "
          "at their positions equal: " + str(np.array_equal(
              back, vectors[idx])))
    log(f"(c) embeddings [{CARD}] of {len(vectors)} latent vectors "
        f"({vectors.shape[1]} channels, {EMBED_POINTS} a store of "
        f"{len(paths)}), t-SNE "
        f"{EMBED_ITERS} iterations: seconds " + ", ".join(
            f"{k} {times[k]:.3f}" for k in EMBED_KINDS)
        + f"; select_in_rect took {len(idx)} points of the lower-left "
        "quadrant, each mapped back to its store and position")
    return lats


def embeddings_vs_cpu(torch, lats):
    """(c) The same functions on the card and on the CPU at
    EMBED_CPU_POINTS a store."""
    from cnn_autoencoder_tpu_torch.tools.visualize_groups import (
        compute_embeddings, pca_2d, sample_vectors)
    from cnn_autoencoder_tpu_torch.utils.manifold import isomap, tsne
    x = np.concatenate([sample_vectors(lat, EMBED_CPU_POINTS)[0]
                        for lat in lats])
    pca = pca_2d(x, device="cpu").numpy()
    init = pca * 1e-4 / max(float(pca.std()), 1e-12)
    errs = {}
    for kind, fn in (
            ("pca", lambda d: pca_2d(x, device=d)),
            ("isomap", lambda d: isomap(x, n_neighbors=5, device=d)),
            ("tsne", lambda d: tsne(x, n_iter=TSNE_SHORT_ITERS, init=init,
                                    device=d))):
        card, cpu = fn("cuda").cpu().numpy(), fn("cpu").numpy()
        if kind != "tsne":
            card = up_to_sign(card, cpu)
        errs[kind] = float(np.abs(card - cpu).max() / np.abs(cpu).max())
        lim = TSNE_SHORT_TOL if kind == "tsne" else EMBED_TOL
        check(errs[kind] <= lim, f"(c) {kind} on the card against the CPU: "
              f"{errs[kind]:.3e} of its scale > {lim}")
    kl = [tsne_kl(torch, x, compute_embeddings(
        x, ["tsne"], EMBED_ITERS, device=d)["tsne"].cpu().numpy())
        for d in ("cuda", "cpu")]
    rel = abs(kl[0] - kl[1]) / kl[1]
    check(rel <= TSNE_KL_RTOL, f"(c) a full t-SNE's KL on the card {kl[0]:.4f}"
          f" against the CPU's {kl[1]:.4f}")
    log(f"(c) card against CPU, {len(x)} vectors: PCA {errs['pca']:.3e}, "
        f"Isomap {errs['isomap']:.3e} of their scales up to sign (limit "
        f"{EMBED_TOL}); t-SNE {TSNE_SHORT_ITERS} iterations from one start "
        f"{errs['tsne']:.3e} (limit {TSNE_SHORT_TOL}); {EMBED_ITERS} "
        f"iterations KL(P||Q) {kl[0]:.4f} / {kl[1]:.4f} (relative "
        f"{rel:.3e}, limit {TSNE_KL_RTOL})")


def tool_metrics(torch, core, imgs, work):
    """(d) ``compute_metrics``' array function on phase 3's tiles and their
    ``cae_tpu`` round trip, on the card and on the CPU; the stats file and
    ``dump_metrics_jpeg``'s CSVs."""
    from cnn_autoencoder_tpu_torch.tools.compute_metrics import (
        metrics_arrays, save_metrics_stats)
    from cnn_autoencoder_tpu_torch.tools.dump_metrics_jpeg import \
        main as dump_metrics
    core.decode_tiles(core.encode_tiles(imgs))      # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = core.encode_tiles(imgs)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    rec = core.decode_tiles(frames)
    all_metrics = {"time": []}
    worst, secs = {}, {"cuda": 0.0, "cpu": 0.0}
    for i in range(len(imgs)):
        got = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            got[dev] = metrics_arrays(imgs[i], rec[i], len(frames[i]),
                                      device=dev)
            secs[dev] += time.perf_counter() - t0
        for k, v in got["cpu"].items():
            c = got["cuda"][k]
            rel = abs(c - v) / abs(v) if v else abs(c - v)
            check(np.isfinite(v) and rel <= METRIC_RTOL.get(k, 1e-10),
                  f"(d) tile {i} {k}: card {c!r}, CPU {v!r}")
            worst[k] = max(worst.get(k, 0.0), rel)
            all_metrics.setdefault(k, []).append(c if c > 0.0 else np.nan)
        all_metrics["time"].append(enc_s / len(imgs))
    mdir = os.path.join(work, "metrics")
    os.makedirs(mdir)
    save_metrics_stats(all_metrics, mdir, METRIC_CODEC, METRIC_QUALITY)
    csv = os.path.join(work, "metrics.csv")
    dump_metrics(["-d", mdir, "-m", METRIC_CODEC, "-o", csv])
    with open(csv) as f:
        rows = f.read().splitlines()
    with open(csv[:-4] + "_per_img.csv") as f:
        per = f.read().splitlines()
    keys = [k for k in all_metrics]
    check(len(rows) == 2 and rows[1].startswith(
        f"{METRIC_CODEC},{METRIC_QUALITY},") and per[0] == ",".join(
        ["Method,quality,id"] + keys) and per[1:] == [
        ",".join([METRIC_CODEC, str(METRIC_QUALITY), str(i)]
                 + ["%f" % all_metrics[k][i] for k in keys])
        for i in range(len(imgs))], f"(d) the dumped CSVs: {rows[:2]}, "
        f"{per[:2]}")
    log(f"(d) metrics [{CARD}] of {len(imgs)} tiles and their cae_tpu "
        f"round trip: PSNR {np.mean(all_metrics['psnr']):.3f} dB, MS-SSIM "
        f"{np.mean(all_metrics['ms-ssim']):.5f}, "
        f"{np.mean(all_metrics['rate']):.4f} bpp; card against CPU within " + ", ".join(
            f"{k} {v:.1e}" for k, v in worst.items())
        + f"; seconds card {secs['cuda']:.2f}, CPU {secs['cpu']:.2f}; the "
        f"stats file dumped to {len(rows)} + {len(per)} CSV rows, each "
        "tile's equal to its metrics")


def refit_serving(torch, core, imgs, refit_out, paths, totals):
    """(a) The subprocess's refit file equal to an in-process refit, then
    served through ``CAETurboCore`` (phase 3's checks and launches)."""
    from cnn_autoencoder_tpu_torch.models.factory import \
        autoencoder_from_state_dict
    from cnn_autoencoder_tpu_torch.storage.turbo_codec import CAETurboCore
    from cnn_autoencoder_tpu_torch.tools.refit_quantiles import refit
    from cnn_autoencoder_tpu_torch.training.checkpoint import load_checkpoint
    before, after = refit(paths["inproc"], device="cuda")
    with open(paths["sub"], "rb") as f, open(paths["inproc"], "rb") as g:
        same = f.read() == g.read()
    check(same and refit_out.strip() == f"{paths['sub']}: aux {before:.2f} "
          f"-> {after:.2f}", f"(a) refit_quantiles: {refit_out!r}, "
          f"in-process {before:.2f} -> {after:.2f}, files equal: {same}")
    q0, q1 = (np.asarray(load_checkpoint(p)["fact_ent"]["params"]
                         ["quantiles"]) for p in (CHECKPOINT, paths["sub"]))
    bpp0 = 8.0 * sum(map(len, core.encode_tiles(imgs))) / (
        len(imgs) * 512 * 512)
    model = autoencoder_from_state_dict(paths["sub"], device="cuda")
    rcore = CAETurboCore(model, num_streams=1024, device="cuda")
    log("(a) the refit checkpoint through CAETurboCore:")
    launches, rec = serving_round_trip(torch, model, rcore, imgs, "float32")
    plus_into(totals, launches)
    log(f"(a) refit_quantiles as a subprocess: aux {before:.2f} -> "
        f"{after:.2f}, the file byte-equal to an in-process refit's; "
        f"quantiles moved by up to {np.abs(q1 - q0).max():.4g}, medians by "
        f"{np.abs(q1 - q0)[:, 0, 1].max():.4g}; {len(imgs)} tiles of 512^2: "
        f"{bpp0:.4f} bpp before the refit, {rec['bpp']:.4f} after, PSNR "
        f"{rec['psnr']:.3f} dB")


def transfer_serving(torch, model, core, imgs, work, pth, totals):
    """(b) ``torch2jax``'s file equal to an in-process conversion, its model
    serving the msgpack model's frames; ``cae2cai`` (this wave) equal to
    in-process.  Returns the converted model's core."""
    from cnn_autoencoder_tpu_torch.models.factory import \
        autoencoder_from_state_dict
    from cnn_autoencoder_tpu_torch.storage.turbo_codec import CAETurboCore
    from cnn_autoencoder_tpu_torch.tools.transfer_weights import \
        main as transfer
    conv = os.path.join(work, "converted.msgpack")
    transfer(["-m", "torch2jax", "-s", pth, "-o", conv + ".inproc"])
    with open(conv, "rb") as f, open(conv + ".inproc", "rb") as g:
        check(f.read() == g.read(), "(b) torch2jax: the subprocess's file "
              "differs from the in-process conversion's")
    transfer(["-m", "cae2cai", "-s", pth, "-o",
              os.path.join(work, "cai.inproc.pth")])
    cai, cai_in = (torch.load(os.path.join(work, n), weights_only=False)
                   for n in ("cai.pth", "cai.inproc.pth"))
    check(same_tree(torch, cai, cai_in), "(b) cae2cai: the subprocess's "
          "tree differs from the in-process one")
    plus_into(totals, pth_serving(torch, model, core, imgs, conv,
                                  label="torch2jax"))
    return CAETurboCore(autoencoder_from_state_dict(conv, device="cuda"),
                        num_streams=1024, device="cuda")


def train_log(torch, work, totals):
    """(e) A float32 run of the train CLI (one step and one validation on
    phase 8's slides): its log file and last checkpoint."""
    write_cli_slides(work)
    log_dir, losses, _, launches, wall = cli_run(torch, work, "float32",
                                                 "cli", steps=0)
    expect_launches("(e) the train CLI run", launches,
                    cli_expected("float32", 1, 1))
    plus_into(totals, launches)
    logs = [f for f in os.listdir(log_dir) if f.endswith(".log")]
    check(len(logs) == 1, f"(e) the train CLI's logs: {logs}")
    return (os.path.join(log_dir, logs[0]), cli_checkpoints(log_dir)["last"],
            wall)


def host_tool_checks(torch, work, pth, outs, stack, slide, latents, tlog):
    """(e) Each host tool's subprocess output equal to the same function
    called in-process."""
    import re

    from cnn_autoencoder_tpu_torch.storage import zarr as zarrlib
    from cnn_autoencoder_tpu_torch.tools import (compare_compressors,
                                                 compute_labels,
                                                 compute_mask,
                                                 dump_training_stats,
                                                 transfer_weights,
                                                 zarr2dataset)
    name = os.path.basename(slide)
    compute_mask.mask_zarr(slide, os.path.join(work, "masks_in", name),
                           scaled_mag=1.25, default_mag=20,
                           data_axes="XYZCT")
    compute_labels.label_zarr(os.path.join(work, "masks", name), LABEL,
                              os.path.join(work, "labels_in", name))
    zarr2dataset.convert(*stack, os.path.join(work, "dataset_in"))
    transfer_weights.main(["-m", "cai2cae", "-s", os.path.join(
        work, "cai.pth"), "-d", pth, "-o", os.path.join(work,
                                                        "back.inproc.pth")])
    sizes = compare_compressors.main([latents, "512", "5"],
                                     tmp_dir=os.path.join(work, "tmp_in"))
    csv = os.path.join(work, "stats_in.csv")
    dump_training_stats.main(["-l", tlog[0], "-k", tlog[1], "-o", csv])
    got = {k: int(n) for n, k in re.findall(
        r"compressed into (\d+) bytes using (\w+)", outs["compare"])}
    check(got == sizes, f"(e) compare_compressors: {got} against {sizes}")
    for a, b in (("masks", "masks_in"), ("labels", "labels_in"),
                 ("dataset", "dataset_in")):
        fa, fb = tree_files(os.path.join(work, a)), tree_files(
            os.path.join(work, b))
        check(fa == fb and len(fa) > 0, f"(e) {a}: the subprocess's files "
              f"{sorted(fa)} differ from the in-process call's {sorted(fb)}")
    mask = zarrlib.open(os.path.join(work, "masks", name))["masks/0/0"]
    for a in ("stats", "stats_checkpoint"):
        with open(os.path.join(work, a + ".csv")) as f, open(
                os.path.join(work, a.replace("stats", "stats_in") + ".csv")
        ) as g:
            text = f.read()
            check(text == g.read() and text.count("\n") >= 2,
                  f"(e) dump_training_stats {a}: differs or is empty")
    src = torch.load(pth, weights_only=False)
    back = torch.load(os.path.join(work, "back.pth"), weights_only=False)
    check(same_tree(torch, back, torch.load(os.path.join(
        work, "back.inproc.pth"), weights_only=False)),
        "(e) cai2cae: the subprocess's tree differs from the in-process one")
    check(all(same_tree(torch, back[m], src[m])
              for m in ("encoder", "decoder"))
          and list(back["fact_ent"]) == [".quantiles"]
          and torch.equal(back["fact_ent"][".quantiles"],
                          src["fact_ent"]["quantiles"]),
          f"(b) cae2cai then cai2cae: the encoder's and decoder's keys and "
          f"tensors, and .quantiles alone of fact_ent's, should come back: "
          f"{sorted(back['fact_ent'])}")
    log(f"(b) cae2cai then cai2cae: {len(src['encoder'])} encoder and "
        f"{len(src['decoder'])} decoder keys and tensors back; of "
        f"{len(src['fact_ent'])} fact_ent keys only '.quantiles' (the JAX "
        "script's 'fact_ent' tag, found in the reference)")
    log(f"(e) host tools as subprocesses, outputs equal to the in-process "
        f"calls': compute_mask ({mask.shape} mask, {int(mask[...].sum())} "
        f"tissue pixels), compute_labels (label {LABEL}), zarr2dataset "
        f"({DATASET_TILES} files), compare_compressors (stored bytes "
        + ", ".join(f"{k} {v}" for k, v in sizes.items())
        + "), dump_training_stats on the train CLI's log and last "
        "checkpoint, transfer_weights torch2jax / cae2cai / cai2cae, "
        "refit_quantiles")


def phase_tools(torch, model, core):
    """Phase 14: the offline tools, on the card and as subprocesses;
    returns the launches of the counted runs."""
    import shutil

    from cnn_autoencoder_tpu_torch.storage import zarr as zarrlib
    t0 = time.perf_counter()
    work = os.path.join(ROOT, "build", "phase14")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(os.path.join(work, "tmp"))
    totals, procs, secs = {}, {}, {}
    try:
        imgs = np.stack([image(512, 512, seed) for seed in range(TILES)])
        img = synth_histology(SLIDE, SLIDE, seed=0)
        slide = os.path.join(work, "slide.zarr")
        zarrlib.Group.create(slide).create_dataset(
            "0/0", shape=img.shape, chunks=(SLIDE_PATCH, SLIDE_PATCH, 3),
            dtype=np.uint8, compressor=None)[...] = img
        tiles = serial_batches(img, SLIDE_PATCH, DATASET_TILES)[0][1]
        stack = (os.path.join(work, "stack_in.zarr"),
                 os.path.join(work, "stack_lbl.zarr"))
        gray = tiles.mean(axis=-1, keepdims=True)
        for path, data in ((stack[0], np.moveaxis(tiles, 0, -1)),
                           (stack[1], np.moveaxis(
                               (gray > gray.mean()).astype(np.uint8), 0,
                               -1))):
            zarrlib.Array.create(path, shape=data.shape, chunks=data.shape,
                                 dtype=np.uint8, compressor=None)[...] = data
        refit_paths = {k: os.path.join(work, f"refit_{k}.msgpack")
                       for k in ("sub", "inproc")}
        for p in refit_paths.values():
            shutil.copy(CHECKPOINT, p)
        pth = os.path.join(work, "flagship.pth")
        write_reference_pth(torch, pth)
        env = dict(os.environ, TMPDIR=os.path.join(work, "tmp"))

        # (c) on the card before the host tools start beside it
        latents = slide_latents(torch, core, img, work, totals)
        t1 = time.perf_counter()
        lats = tool_embeddings(latents[:2])
        secs["embeddings"] = time.perf_counter() - t1
        procs = start_tools({
            "refit_quantiles": tool_argv("refit_quantiles",
                                         refit_paths["sub"]),
            "torch2jax": tool_argv("transfer_weights", "-m", "torch2jax",
                                   "-s", pth, "-o", os.path.join(
                                       work, "converted.msgpack")),
            "cae2cai": tool_argv("transfer_weights", "-m", "cae2cai", "-s",
                                 pth, "-o", os.path.join(work, "cai.pth")),
            "compute_mask": tool_argv("compute_mask", "-i", slide, "-o",
                                      os.path.join(work, "masks")),
            "zarr2dataset": tool_argv("zarr2dataset", "-i", stack[0], "-l",
                                      stack[1], "-o", os.path.join(
                                          work, "dataset")),
            "compare": tool_argv("compare_compressors", latents[2], 512, 5),
        }, env)
        t2 = time.perf_counter()
        embeddings_vs_cpu(torch, lats)
        t3 = time.perf_counter()
        outs = finish_tools(procs)
        t4 = time.perf_counter()
        # (a) and (b) need the refit and converted files
        refit_serving(torch, core, imgs, outs["refit_quantiles"],
                      refit_paths, totals)
        conv_core = transfer_serving(torch, model, core, imgs, work, pth,
                                     totals)
        t5 = time.perf_counter()
        tool_metrics(torch, conv_core, imgs, work)
        t6 = time.perf_counter()
        tlog = train_log(torch, work, totals)
        procs = start_tools({
            "compute_labels": tool_argv("compute_labels", "-i", os.path.join(
                work, "masks", "slide.zarr") + f"::{LABEL}", "-o",
                os.path.join(work, "labels")),
            "dump_training_stats": tool_argv(
                "dump_training_stats", "-l", tlog[0], "-k", tlog[1], "-o",
                os.path.join(work, "stats.csv")),
            "cai2cae": tool_argv("transfer_weights", "-m", "cai2cae", "-s",
                                 os.path.join(work, "cai.pth"), "-d", pth,
                                 "-o", os.path.join(work, "back.pth")),
        }, env)
        outs.update(finish_tools(procs))
        host_tool_checks(torch, work, pth, outs, stack, slide, latents[2],
                         tlog)
        t7 = time.perf_counter()
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
        shutil.rmtree(work, ignore_errors=True)
    log("(e) not driven here (they need PIL or matplotlib, which the "
        "card's machine lacks): zarr2png, convert_dataset, compute_metrics' "
        "image-file sweep and visualize_groups' plots; the CPU tests hold "
        "them to the JAX scripts")
    log(f"tools phase: {time.perf_counter() - t0:.1f} s (inputs and latents "
        f"{t1 - t0:.1f}, (c) on the card {secs['embeddings']:.1f}, the tools' "
        f"start {t2 - t1 - secs['embeddings']:.1f}, (c) against the CPU "
        f"{t3 - t2:.1f}, waiting for the first tools {t4 - t3:.1f}, (a) and "
        f"(b) {t5 - t4:.1f}, (d) {t6 - t5:.1f}, the train CLI run "
        f"{tlog[2]:.1f} and (e) {t7 - t6:.1f})")
    return totals


# -- phase 15 ----------------------------------------------------------------

# (label, precision, switches, the model's kernels and launches a round
# trip): the JAX package's precisions and bf16 switches that change the
# function, each on phase 3's tiles
PRECISION_RUNS = (
    ("default", "default", {}, {"gdn_fwd": 3, "conv_gdn_fwd_bf16x1": 1}),
    ("high", "high", {}, {"gdn_fwd": 3, "conv_gdn_fwd_bf16x3": 1}),
    ("bf16 BF16_ACTIVATIONS=0", "bf16", {"CAE_TPU_BF16_ACTIVATIONS": "0"},
     {"gdn_fwd": 3, "conv_gdn_fwd_bf16x1": 1}),
    ("bf16 GDN_FAST=0", "bf16", {"CAE_TPU_GDN_FAST": "0"},
     {"gdn_fwd_bf16_f32pool": 4}),
    ("bf16 NATIVE_CONV_OUT=0", "bf16", {"CAE_TPU_NATIVE_CONV_OUT": "0"},
     {"gdn_fwd_bf16": 3, "conv_gdn_fwd_bf16": 1}),
    ("bf16 PALLAS=1", "bf16", {"CAE_TPU_PALLAS": "1"},
     {"gdn_fwd_bf16": 3, "conv_gdn_fwd_pallas_bf16": 1}),
)
# launches a bf16 train step under CAE_TPU_GDN_FAST=0: the down stage runs
# unfused, its GDN on K2 with the float32 pool
GDN_FAST_OFF_STEP = {"gdn_train_fwd_bf16_f32pool": 4, "gdn_train_bwd": 4}
ANALYTIC_MODES = ("0", "1", "2", "bf16")
ANALYTIC_TIMED = 3  # steps timed after the compared one, each mode


@contextlib.contextmanager
def switched(precision, env):
    """The serving precision and the CAE_TPU_* switches set for the block,
    restored after it."""
    from cnn_autoencoder_tpu_torch.ops import convops
    old = {k: os.environ.get(k) for k in env}
    prev = convops.get_default_precision()
    os.environ.update(env)
    convops.set_default_precision(precision)
    try:
        yield
    finally:
        convops.set_default_precision(prev)
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def variant_case(torch, name, wrapper, plain, args, tol, bms, by,
                 rounded=None):
    """One kernel variant against its plain version on the same inputs:
    ``tol`` = (rel, slack) for ``close``, or, for K4's serving variant in
    mode ``rounded`` (2 or 3), None: its training variant by
    ``rounded_check`` and its out equal to that; timed by CUDA events.
    Returns its record."""
    from cnn_autoencoder_tpu_torch.ops.kernels import conv_gdn_kernel as cg
    got = wrapper(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    got, ref = (got[0], ref[0]) if isinstance(got, tuple) else (got, ref)
    if tol is not None:
        ok, err = close(got, ref, *tol)
    else:
        out_t, y_t, r_t = cg.conv_gdn_train_cuda(*args, rounded)
        err = rounded_check(torch, *args, rounded, out_t, y_t, r_t, name)[0]
        ok = torch.equal(got, out_t)
        del out_t, y_t, r_t
    check(ok and got.shape == ref.shape and got.dtype == ref.dtype,
          f"{name} {tuple(args[0].shape)}: error {err:.3e}")
    ms = cuda_ms(torch, lambda: wrapper(*args), 10)
    plain_ms = cuda_ms(torch, lambda: plain(*args), 3)
    log(f"{name} {tuple(args[0].shape)}: max abs {err:.3e} (max |ref| "
        f"{float(ref.float().abs().max()):.3e}); kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bms:.4f} ms ({by}), "
        f"{100 * bms / ms:.1f}% of it")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, shape=list(args[0].shape))


def precision_kernels(torch, model, rng):
    """(a) K4 in modes 1, 4 and 5 at the flagship's (16, 256, 256, 128) ->
    128 and at an odd Cout, its bf16 default route (modes 3 and 2) re-timed
    beside them, and K1 and K2 on bf16 rows with the float32 pool at the
    serving and training shapes and at an odd C, each against its plain
    version; returns {name: record}."""
    from cnn_autoencoder_tpu_torch.ops.kernels import conv_gdn_kernel as cg
    from cnn_autoencoder_tpu_torch.ops.kernels import gdn_kernel as gk
    out = {}
    unit = model.encoder.down_1
    with torch.no_grad():
        kernel = unit.conv_down.kernel_hwio()
        gamma, beta = unit.gdn_down.effective_params()
        x32 = torch.from_numpy(rng.rand(TILES, 256, 256, 128)
                               .astype(np.float32)).cuda()
        odd = (torch.from_numpy(rng.rand(2, 18, 14, 72).astype(np.float32))
               .cuda(), torch.from_numpy((rng.randn(3, 3, 72, 41) * 0.05)
                                         .astype(np.float32)).cuda(),
               torch.from_numpy((0.1 * rng.rand(41, 41)).astype(np.float32))
               .cuda(), torch.from_numpy((1 + rng.rand(41))
                                         .astype(np.float32)).cuda())
        for mode in (cg.PALLAS_BF16, cg.F32_BF16X1, cg.F32_BF16X3,
                     cg.BORDER_BF16, cg.ROUND_BF16):
            name = cg.SERVING_NAMES[mode]
            bf = mode in cg.BF16_X
            # bf16 out: one ulp, or rounded_check where y is rounded
            # first; float32: 1e-4 of max |out| (phase 2's limit)
            tol = (None if mode in cg.ROUNDED else
                   (2.0 ** -7, 1e-4) if bf else (0.0, 1e-4))
            for x, kern, g, b in ((x32, kernel, gamma, beta), odd):
                x = x.to(torch.bfloat16) if bf else x
                bms, by, _ = k4_bound(x, kern.shape[3], False, mode)
                rec = variant_case(
                    torch, f"{name} mode {mode}",
                    lambda *a, m=mode: cg.conv_gdn_cuda(*a, m),
                    lambda *a, m=mode: cg.conv_gdn_plain(*a, m),
                    (x, kern, g, b), tol, bms, by, rounded=mode)
                if x.shape[0] == TILES and mode in (
                        cg.PALLAS_BF16, cg.F32_BF16X1, cg.F32_BF16X3):
                    out[name] = rec
        del x32
        n = TILES * 256 * 256
        with switched("highest", {"CAE_TPU_GDN_FAST": "0"}):
            for rows, c in ((n, 128), (n // 4, 128), (77, 131)):
                xb = torch.from_numpy(rng.randn(rows, c).astype(np.float32)
                                      ).cuda().to(torch.bfloat16)
                gc = torch.from_numpy((0.1 * rng.rand(c, c))
                                      .astype(np.float32)).cuda()
                bc = torch.from_numpy((1 + rng.rand(c)).astype(np.float32)
                                      ).cuda()
                ops = [(3 * 2 * rows * c * c, PEAK_TF32_S),
                       (5 * rows * c, PEAK_F32_S)]
                # one bf16 ulp of y (and of r): the kernel's pool is
                # float32-accurate in three TF32 passes
                if rows != n // 4:
                    bms, by = bound_ms(4 * rows * c + 4 * c * (c + 1), ops)
                    rec = variant_case(torch, "gdn_fwd_bf16_f32pool",
                                       gk.gdn_bf16_f32pool_cuda, gk.gdn_plain,
                                       (xb, gc, bc), (2.0 ** -7, 0.0), bms,
                                       by)
                    if rows == n:
                        out["gdn_fwd_bf16_f32pool"] = rec
                if rows != n:
                    bms, by = bound_ms(6 * rows * c + 4 * c * (c + 1), ops)
                    rec = variant_case(
                        torch, "gdn_train_fwd_bf16_f32pool",
                        gk.gdn_train_fwd_bf16_f32pool_cuda,
                        gk.gdn_train_fwd_plain, (xb, gc, bc),
                        (2.0 ** -7, 0.0), bms, by)
                    _, rb = gk.gdn_train_fwd_bf16_f32pool_cuda(xb, gc, bc)
                    _, rb_p = gk.gdn_train_fwd_plain(xb, gc, bc)
                    check(close(rb, rb_p, 2.0 ** -7, 0.0)[0],
                          f"gdn_train_fwd_bf16_f32pool ({rows}, {c}): r")
                    if rows == n // 4:
                        out["gdn_train_fwd_bf16_f32pool"] = rec
                del xb
    torch.cuda.empty_cache()
    return out


def precision_round_trips(torch, model, core, imgs, runs=PRECISION_RUNS,
                          phase="phase 15"):
    """(b) Phase 3's tiles through CAETurboCore and CAECodecCore under each
    of ``runs``: exact launches, lossless symbols, the plain versions
    within phase 3's tolerances, decodes bit-equal, bpp and |delta PSNR|
    against float32; returns the launches summed over the runs."""
    from cnn_autoencoder_tpu_torch.ops.kernels import (kernel_wrappers,
                                                       reset_launch_counts)
    from cnn_autoencoder_tpu_torch.storage.turbo_codec import CAETurboCore
    totals = {}
    rec32 = core.decode_tiles(core.encode_tiles(imgs))
    mse = np.mean((rec32.astype(np.float64) - imgs) ** 2)
    psnr32 = 10 * np.log10(255.0 ** 2 / mse)
    for label, precision, env, expect in runs:
        with switched(precision, env):
            turbo = CAETurboCore(model, num_streams=1024, device="cuda")
            launches, res = serving_round_trip(torch, model, turbo, imgs,
                                               label, expect)
            plus_into(totals, launches)
            decodes_bit_equal(torch, turbo, res["frames"], label)
            base = turbo.base
            base.decode_tiles(base.encode_tiles(imgs))  # warm-up
            reset_launch_counts()
            frames = base.encode_tiles(imgs)
            rec = base.decode_tiles(frames)
            launches = {fn.kernel_name: fn.launches
                        for fn in kernel_wrappers()}
            check({k: n for k, n in launches.items() if n} == expect,
                  f"cae ({label}): launches {launches}, expected {expect}")
            plus_into(totals, launches)
            sym = base.entropy_decode(frames)[0]
            check(np.array_equal(sym, turbo.latent_symbols(imgs).cpu()
                                 .numpy()), f"cae ({label}): symbols")
            check(np.array_equal(base.decode_tiles(frames), rec),
                  f"cae ({label}): two decodes differ")
        d_psnr = res["psnr"] - psnr32
        log(f"{phase} ({label}): precision {turbo.base.precision}, "
            f"activations {turbo.base.compute_dtype}; cae_tpu and cae "
            f"launches {expect} each, symbols lossless; PSNR "
            f"{res['psnr']:.3f} dB against float32's {psnr32:.3f} (delta "
            f"{d_psnr:+.4f}, limit {BF16_PSNR_DB}); {res['bpp']:.4f} bpp; "
            f"encode {res['encode_ms']:.1f} ms, decode "
            f"{res['decode_ms']:.1f} ms")
        check(abs(d_psnr) <= BF16_PSNR_DB, f"{label}: PSNR differs from "
              f"float32's by {d_psnr:+.4f} dB")
        del turbo, base
    return totals


def counted_steps(torch, x, precision, env, compute_dtype, per_step, steps,
                  rel_limit, label):
    """``steps`` flagship train steps at ``precision`` under the switches
    ``env``: launches exactly ``per_step`` a step, every step-1 gradient
    finite and non-zero, losses within ``rel_limit`` relative of the same
    steps through the plain versions on the card; the step-1 gradients'
    largest difference from the plain run's (of each tensor's max) is
    logged.  Returns (launches, losses)."""
    from cnn_autoencoder_tpu_torch.ops.kernels import (kernel_wrappers,
                                                       reset_launch_counts)
    with switched(precision, env):
        _, _, step = train_setup(torch, compute_dtype, x)
        torch.cuda.synchronize()
        reset_launch_counts()
        losses = []
        for i in range(1, steps + 1):
            stats, grads = step(i)
            losses.append(float(stats["loss"]))
            if i == 1:
                first = {f"{m}.{n}": g.clone() for m, gs in grads.items()
                         for n, g in gs.items()}
                for name, g in first.items():
                    check(bool(torch.isfinite(g).all())
                          and float(g.abs().max()) > 0,
                          f"{label} step 1: {name}")
        torch.cuda.synchronize()
        launches = {fn.kernel_name: fn.launches for fn in kernel_wrappers()}
        want = {k: n * steps for k, n in per_step.items()}
        check({k: n for k, n in launches.items() if n} == want,
              f"{label} steps: launches {launches}, expected {want}")
        del step
        with plain_versions():
            _, _, plain_step = train_setup(torch, compute_dtype, x)
            plain = []
            for i in range(1, steps + 1):
                stats, grads = plain_step(i)
                plain.append(float(stats["loss"]))
                if i == 1:
                    worst = max((float((g - first[f"{m}.{n}"]).abs().max())
                                 / float(g.abs().max()), f"{m}.{n}")
                                for m, gs in grads.items()
                                for n, g in gs.items())
        rels = [abs(a - b) / abs(b) for a, b in zip(losses, plain)]
        log(f"{label}: launches over {steps} steps {want}; losses {losses} "
            f"against the plain versions' {plain}, relative differences "
            f"{', '.join(f'{r:.3e}' for r in rels)} (limit {rel_limit:g}); "
            f"step-1 gradients finite and non-zero, the largest difference "
            f"from the plain run's {worst[0]:.3e} of its tensor's max "
            f"({worst[1]})")
        check(max(rels) <= rel_limit, f"{label} losses differ by {rels}")
        del plain_step
    return launches, losses


def precision_training(torch):
    """(c) Phase 5's bf16 step under CAE_TPU_GDN_FAST=0: exact launches,
    step-1 gradients finite and non-zero, losses against the plain
    versions'; (d) one float32 step under each CAE_TPU_ANALYTIC_ENT mode,
    its gradients against mode 0's, and ms a step.  Returns the launches
    of (c)."""
    x = synthetic_batch(torch)
    launches, _ = counted_steps(torch, x, "highest", {"CAE_TPU_GDN_FAST": "0"},
                                torch.bfloat16, GDN_FAST_OFF_STEP,
                                TRAIN_STEPS, 2e-2, "phase 15 (c) bf16 "
                                "GDN_FAST=0")
    grads0 = None
    for mode in ANALYTIC_MODES:
        with switched("highest", {"CAE_TPU_ANALYTIC_ENT": mode}):
            _, _, step = train_setup(torch, torch.float32, x)
            stats, grads = step(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(2, ANALYTIC_TIMED + 2):
                step(i)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / ANALYTIC_TIMED * 1e3
        flat = {f"{m}.{n}": g for m, gs in grads.items()
                for n, g in gs.items()}
        if grads0 is None:
            grads0, worst = flat, (0.0, "")
        else:
            worst = max((float((g - grads0[k]).abs().max())
                         / max(float(grads0[k].abs().max()), 1e-30), k)
                        for k, g in flat.items())
            check(worst[0] <= 3e-2, f"ANALYTIC_ENT={mode}: {worst[1]} "
                  f"differs from autodiff's by {worst[0]:.3e} of its max")
        log(f"phase 15 (d) ANALYTIC_ENT={mode}: loss "
            f"{float(stats['loss']):.6f}, {ms:.3f} ms a float32 step (mean "
            f"of {ANALYTIC_TIMED}); step-1 gradients against mode 0's: "
            f"largest {worst[0]:.3e} of a tensor's max ({worst[1] or '-'})")
        del step
    torch.cuda.empty_cache()
    return launches


def phase_precisions(torch, model, core):
    """Phase 15: the JAX package's precisions and precision switches on the
    card; returns (records of the new kernel variants, the launches of
    the main-path runs)."""
    rng = np.random.RandomState(15)
    t0 = time.perf_counter()
    records = precision_kernels(torch, model, rng)
    imgs = np.stack([image(512, 512, seed) for seed in range(TILES)])
    totals = precision_round_trips(torch, model, core, imgs)
    plus_into(totals, precision_training(torch))
    log(f"phase 15: {time.perf_counter() - t0:.1f} s; launches of its "
        f"round trips and steps {totals}")
    return records, totals


# -- phase 16 ----------------------------------------------------------------

# launches a float32 train step at "default" and "high": K1 on the three
# unfused GDN layers, K4's training variant in mode 4 or 5 on the fused one
LOW_PRECISION_STEPS = {
    "default": {"gdn_fwd": 3, "conv_gdn_train_fwd_bf16x1": 1},
    "high": {"gdn_fwd": 3, "conv_gdn_train_fwd_bf16x3": 1},
}
# the steps' losses against the plain run's, relative.  "default" rounds
# operands to bf16 at every convolution, as the bf16 mode does, so a
# last-bit difference between a kernel and its plain version moves some
# operands by 2^-8: the first loss moved by 2.6e-5 through the CLI, and
# Adam's first update, lr * sign(g), carried step-1 gradients 2.1e-3 apart
# (of a tensor's max) into 2.0e-4 at step 2 (H100 80GB HBM3); it takes
# the bf16 mode's limit.  "high" (bf16_3x, near float32) keeps float32's
LOW_PRECISION_LIMITS = {"default": 2e-2, "high": 1e-5}
# a validation batch at "default": the serving variants
DEFAULT_VALIDATION = {"gdn_fwd": 3, "conv_gdn_fwd_bf16x1": 1}
# -s 1 gives 2 steps, then the last step's validation
LOW_CLI_STEPS, LOW_CLI_VALIDATIONS = 2, 1
# CAE_TPU_POLYPHASE_CONV=1 in bf16: the down stage unfused, so every GDN
# layer takes K1 on bf16 rows in serving and K2 / K3 in training
POLYPHASE_RUNS = (("bf16 POLYPHASE_CONV=1", "bf16",
                   {"CAE_TPU_POLYPHASE_CONV": "1"}, {"gdn_fwd_bf16": 4}),)
POLYPHASE_STEP = {"gdn_train_fwd": 4, "gdn_train_bwd": 4}
# the RD sweep's CAE half: 2 holdouts of 1024^2 through the 'cae' core in
# bf16 (its default without CAE_TPU_PRECISION), each 4 batches of one
# 512^2 tile (``default_batch_tiles`` splits an image into at least 4):
# K4 and K1 a batch in the encode, K1 twice in the decode
SWEEP_IMAGES, SWEEP_SIDE, SWEEP_BATCHES = 2, 1024, 4
SWEEP_LAUNCHES = {"gdn_fwd_bf16": 3 * SWEEP_BATCHES * SWEEP_IMAGES,
                  "conv_gdn_fwd_bf16": SWEEP_BATCHES * SWEEP_IMAGES}
LOW_TIMED = 3       # steps timed after the counted ones, each precision


def low_precision_kernels(torch, model, rng):
    """(a) K4's training variant in modes 4 and 5 at the flagship's train
    shape (16, 128, 128, 128) -> 128 and at (2, 18, 14, 72) -> 41 against
    ``conv_gdn_train_plain`` (out and y within 1e-4 of max |out| and max
    |y|), timed by CUDA events beside the plain version and the bound;
    returns {kernel name: record at the flagship's shape}."""
    from cnn_autoencoder_tpu_torch.ops.kernels import conv_gdn_kernel as cg
    unit = model.encoder.down_1
    out = {}
    with torch.no_grad():
        kernel = unit.conv_down.kernel_hwio()
        gamma, beta = unit.gdn_down.effective_params()
        x = torch.from_numpy(rng.rand(TRAIN_BATCH, TRAIN_PATCH // 2,
                                      TRAIN_PATCH // 2, 128)
                             .astype(np.float32)).cuda()
        odd = (torch.from_numpy(rng.rand(2, 18, 14, 72).astype(np.float32))
               .cuda(), torch.from_numpy((rng.randn(3, 3, 72, 41) * 0.05)
                                         .astype(np.float32)).cuda(),
               torch.from_numpy((0.1 * rng.rand(41, 41)).astype(np.float32))
               .cuda(), torch.from_numpy((1 + rng.rand(41))
                                         .astype(np.float32)).cuda())
        for mode in (cg.F32_BF16X1, cg.F32_BF16X3):
            name = cg.TRAIN_NAMES[mode]
            for args in ((x, kernel, gamma, beta), odd):
                err = check_conv_train_case(
                    torch, *args, f"{name} {tuple(args[0].shape)}", mode)
                ms = cuda_ms(torch, lambda: cg.conv_gdn_train_cuda(*args,
                                                                   mode), 10)
                plain_ms = cuda_ms(torch, lambda: cg.conv_gdn_train_plain(
                    *args, mode), 3)
                bms, by, _ = k4_bound(args[0], args[1].shape[3], True, mode)
                log(f"{name} {tuple(args[0].shape)} -> {args[1].shape[3]} "
                    f"[{CARD}]: max abs {err:.3e}; kernel {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms, bound {bms:.4f} ms ({by}), "
                    f"{100 * bms / ms:.1f}% of it")
                if args[0] is x:
                    out[name] = dict(max_abs_err=err, ms=ms,
                                     plain_ms=plain_ms, bound_ms=bms,
                                     bound_by=by,
                                     shape=list(args[0].shape))
        del x
    torch.cuda.empty_cache()
    return out


def low_precision_steps(torch, x):
    """(b) The flagship's bare float32 step at "default" and "high":
    launches exact, step-1 gradients finite and non-zero, losses against
    the plain versions' run within ``LOW_PRECISION_LIMITS``, ms a step
    (host clock) and the device time of one step (torch.profiler).
    Returns the launches."""
    totals = {}
    for precision, per_step in LOW_PRECISION_STEPS.items():
        launches, losses = counted_steps(
            torch, x, precision, {}, torch.float32, per_step, TRAIN_STEPS,
            LOW_PRECISION_LIMITS[precision], f"phase 16 (b) {precision}")
        plus_into(totals, launches)
        with switched(precision, {}):
            _, _, step = train_setup(torch, torch.float32, x)
            step(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(2, LOW_TIMED + 2):
                step(i)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / LOW_TIMED * 1e3
            dev = device_ms(torch, lambda: step(LOW_TIMED + 2), 1)
            del step
        log(f"phase 16 (b) {precision} [{CARD}]: {ms:.3f} ms a step (mean "
            f"of {LOW_TIMED}, host clock), device time {dev:.3f} ms a step")
    torch.cuda.empty_cache()
    return totals


def low_precision_cli(torch, work):
    """(c) The train CLI's ``main`` at ``CAE_TPU_PRECISION=default`` on
    phase 8's slides: 2 steps and a validation, launches exact, losses
    against the same run through the plain versions within
    ``LOW_PRECISION_LIMITS["default"]``.  Returns the launches."""
    write_cli_slides(work)
    _, losses, times, launches, wall = cli_run(torch, work, "default",
                                               "default", steps=1)
    want = {}
    for per, n in ((LOW_PRECISION_STEPS["default"], LOW_CLI_STEPS),
                   (DEFAULT_VALIDATION, LOW_CLI_VALIDATIONS)):
        for name, k in per.items():
            want[name] = want.get(name, 0) + k * n
    check(len(losses) == LOW_CLI_STEPS and {
        k: n for k, n in launches.items() if n} == want,
        f"CLI default: {len(losses)} steps, launches {launches}, expected "
        f"{want}")
    with plain_versions():
        _, plain, _, _, _ = cli_run(torch, work, "default", "default_plain",
                                    steps=1)
    rels = [abs(a - b) / abs(b) for a, b in zip(losses, plain)]
    limit = LOW_PRECISION_LIMITS["default"]
    log(f"phase 16 (c) train CLI at default [{CARD}]: launches {want}; "
        f"losses {losses} against the plain versions' {plain}, relative "
        f"differences {', '.join(f'{r:.3e}' for r in rels)} (limit "
        f"{limit:g}); main() {wall:.1f} s, step 2 {1e3 * times[-1]:.3f} ms")
    check(max(rels) <= limit, f"CLI default: losses differ by {rels}")
    return launches


def rd_sweep_half(torch, work):
    """(e) The RD sweep's CAE half (``tools/rd_sweep.py:run_cae``, its
    precision bf16 as ``CAE_TPU_PRECISION`` is unset) and its merge on 2
    zarr holdouts of 1024^2: launches exact, the CSV row the harness's
    returned stats as formatted.  Returns the launches."""
    from cnn_autoencoder_tpu_torch.ops import convops
    from cnn_autoencoder_tpu_torch.ops.kernels import (kernel_wrappers,
                                                       reset_launch_counts)
    from cnn_autoencoder_tpu_torch.tools import rd_sweep
    img_dir, log_dir = (os.path.join(work, "holdout"),
                        os.path.join(work, "stats"))
    os.makedirs(log_dir)
    rd_sweep.write_holdout(img_dir, SWEEP_IMAGES, SWEEP_SIDE, fmt="zarr")
    env = os.environ.pop("CAE_TPU_PRECISION", None)
    found = convops.get_default_precision()
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        (stats,) = rd_sweep.run_cae(img_dir, log_dir, work,
                                    rd_sweep.cae_points(CHECKPOINT),
                                    SLIDE_PATCH, device="cuda",
                                    source_format="zarr")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {fn.kernel_name: fn.launches for fn in kernel_wrappers()}
    finally:
        if env is not None:
            os.environ["CAE_TPU_PRECISION"] = env
    check({k: n for k, n in launches.items() if n} == SWEEP_LAUNCHES,
          f"rd_sweep CAE half: launches {launches}, expected "
          f"{SWEEP_LAUNCHES}")
    check(convops.get_default_precision() == found,
          "rd_sweep CAE half: the precision was not restored")
    rows = rd_sweep.merge(work, log_dir)
    row = ("CAE", "1", stats["rate_stats"]["avg"], stats["psnr_stats"]["avg"],
           stats["ms-ssim_stats"]["avg"], stats["ssim_stats"]["avg"],
           stats["delta_cielab_stats"]["avg"])
    with open(os.path.join(work, "rd_sweep.csv")) as f:
        lines = f.read().splitlines()
    want = "%s,%s,%.4f,%.2f,%.4f,%.4f,%.3f" % row
    check(rows == [row] and lines == [rd_sweep.CSV_HEADER.strip(), want],
          f"rd_sweep merge: CSV {lines}, expected {want}")
    log(f"phase 16 (e) rd_sweep CAE half [{CARD}]: {SWEEP_IMAGES} zarr "
        f"holdouts of {SWEEP_SIDE}^2, bf16, launches {SWEEP_LAUNCHES}, "
        f"{wall:.2f} s; CSV row {want}")
    return launches


def phase_low_precision_training(torch, model, core):
    """Phase 16: training at "default" and "high", K4's training variant in
    modes 4 and 5, CAE_TPU_POLYPHASE_CONV=1 in bf16 and the RD sweep's CAE
    half on the card; returns (records of the new kernel variants, the
    launches of the main-path runs)."""
    import shutil
    rng = np.random.RandomState(16)
    t0 = time.perf_counter()
    work = os.path.join(ROOT, "build", "phase16")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        records = low_precision_kernels(torch, model, rng)
        x = synthetic_batch(torch)
        totals = low_precision_steps(torch, x)
        plus_into(totals, low_precision_cli(torch, work))
        imgs = np.stack([image(512, 512, seed) for seed in range(TILES)])
        plus_into(totals, precision_round_trips(
            torch, model, core, imgs, POLYPHASE_RUNS, "phase 16 (d)"))
        launches, _ = counted_steps(
            torch, x, "highest", {"CAE_TPU_POLYPHASE_CONV": "1"},
            torch.bfloat16, POLYPHASE_STEP, 1, 2e-2,
            "phase 16 (d) bf16 POLYPHASE_CONV=1")
        plus_into(totals, launches)
        plus_into(totals, rd_sweep_half(torch, work))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"phase 16: {time.perf_counter() - t0:.1f} s; launches of its steps, "
        f"runs and round trips {totals}")
    return records, totals


# -- phase 17 ----------------------------------------------------------------

AXIS_DATA, AXIS_MODEL = 2, 2    # (b) and (c): four ranks or shards on the card
AXIS_TIMED = 2                  # (b): steps 2-3 timed, then one with the
                                # model axis's collectives timed on their own


def axis_rank(work):
    """(b)'s subprocess: one rank of the bare float32 step over a (2, 2)
    mesh of gloo ranks on the one card (its group from
    ``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` / ``PROCESS_ID``), phase
    5's batch and model, its data index's 8 rows and its model index's
    parameter shards; writes its report to ``work/axis_report<r>.json``,
    then runs phase 18 (a)'s part (``option_rank``)."""
    import torch
    import torch.distributed as dist
    from cnn_autoencoder_tpu_torch.criteria.loss import setup_loss
    from cnn_autoencoder_tpu_torch.models.factory import \
        autoencoder_from_state_dict
    from cnn_autoencoder_tpu_torch.ops.kernels import (kernel_wrappers,
                                                       reset_launch_counts)
    from cnn_autoencoder_tpu_torch.parallel import distributed
    from cnn_autoencoder_tpu_torch.parallel.mesh import shard_model
    from cnn_autoencoder_tpu_torch.training.loop import make_train_step
    from cnn_autoencoder_tpu_torch.training.optim import setup_optimizers
    check(distributed.initialize_multihost(backend="gloo", device="cuda:0"),
          "initialize_multihost formed no group")
    try:
        rank = dist.get_rank()
        group, model_group = distributed.mesh_groups(AXIS_DATA, AXIS_MODEL)
        x = synthetic_batch(torch)[distributed.local_batch_slice(
            TRAIN_BATCH, AXIS_MODEL)]
        model = autoencoder_from_state_dict(CHECKPOINT, device="cuda").train()
        full_bytes = sum(p.numel() * p.element_size()
                         for p in model.parameters())
        shard_model(model, model_group, rank % AXIS_MODEL, AXIS_MODEL)
        trainable = ["encoder", "decoder", "fact_ent"]
        optimizers = setup_optimizers(model, trainable)
        step = make_train_step(model, setup_loss("RateMSE",
                                                 distortion_lambda=0.01),
                               optimizers, trainable_modules=trainable,
                               group=group, model_group=model_group)
        lrs = {k: TRAIN_LR for k in optimizers}
        gen = torch.Generator(device="cuda").manual_seed(0)
        torch.cuda.synchronize()
        reset_launch_counts()
        losses, times, grads_ok = [], [], None
        for i in range(1, TRAIN_STEPS + 1):
            t0 = time.perf_counter()
            stats, grads = step(x, lrs, i, generator=gen)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(stats["loss"]))
            if i == 1:
                grads_ok = all(bool(torch.isfinite(g).all())
                               and float(g.abs().max()) > 0
                               for gs in grads.values() for g in gs.values())
        launches = {fn.kernel_name: fn.launches for fn in kernel_wrappers()}
        instrumented, collectives = timed_collectives(
            torch, lambda: step(x, lrs, TRAIN_STEPS + 1, generator=gen))
        write_json(os.path.join(work, f"axis_report{rank}.json"), dict(
            rank=rank, losses=losses, grads_ok=grads_ok, launches=launches,
            step_ms=1e3 * sum(times[1:]) / AXIS_TIMED,
            instrumented_ms=instrumented, collectives=collectives,
            param_bytes=sum(p.numel() * p.element_size()
                            for p in model.parameters()),
            full_param_bytes=full_bytes, opt_bytes=opt_bytes(optimizers)))
        del model, step, optimizers
        torch.cuda.empty_cache()
        option_rank(torch, work, group, model_group, rank)
    finally:
        dist.destroy_process_group()


def timed_collectives(torch, fn):
    """``fn()`` (one more train step) with the model axis's collectives
    (``distributed``'s gathers and partial sums) timed by host clock, each
    between two synchronizes: (ms of the step, {"gather" | "sum": {ms,
    calls, bytes out}})."""
    from cnn_autoencoder_tpu_torch.parallel import distributed
    spent = {"gather": [0.0, 0, 0], "sum": [0.0, 0, 0]}

    def timed(kind, call):
        def run(t, *args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = call(t, *args)
            torch.cuda.synchronize()
            rec = spent[kind]
            rec[0] += time.perf_counter() - t0
            rec[1] += 1
            rec[2] += out.numel() * out.element_size()
            return out
        return run

    saved = distributed.all_gather_axis, distributed._all_reduce_f32
    distributed.all_gather_axis = timed("gather", saved[0])
    distributed._all_reduce_f32 = timed("sum", saved[1])
    try:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
    finally:
        distributed.all_gather_axis, distributed._all_reduce_f32 = saved
    return ms, {k: dict(ms=1e3 * v[0], calls=v[1], bytes=v[2])
                for k, v in spent.items()}


def opt_bytes(optimizers):
    """The optimizers' state (moments and accumulators) in bytes."""
    return sum(t.numel() * t.element_size() for s in optimizers.values()
               for d in (s.mu, s.nu, s.acc) for t in d.values())


def write_json(path, obj):
    """``obj`` as JSON at ``path``, whole or not at all (a reader polls
    for it)."""
    with open(path + ".tmp", "w") as f:
        json.dump(obj, f)
    os.replace(path + ".tmp", path)


def rank_log(work, r):
    """The end of rank ``r``'s output."""
    try:
        with open(os.path.join(work, f"rank{r}.log")) as f:
            return f.read()[-3000:]
    except OSError:
        return "(no log)"


def wait_reports(procs, work, name, timeout):
    """The ranks' ``<name><r>.json`` reports, read as each rank writes
    its own; fails when a rank exits without it or the time runs out."""
    paths = [os.path.join(work, f"{name}{r}.json") for r in range(len(procs))]
    t0 = time.perf_counter()
    while not all(os.path.exists(p) for p in paths):
        for r, p in enumerate(procs):
            check(p.poll() is None or os.path.exists(paths[r]),
                  f"rank {r} exited {p.returncode} without its {name} "
                  f"report: {rank_log(work, r)}")
        check(time.perf_counter() - t0 < timeout, f"the ranks' {name} "
              f"reports missing after {timeout} s")
        time.sleep(0.1)
    out = []
    for p in paths:
        with open(p) as f:
            out.append(json.load(f))
    return out


def axis_ranks_start(work):
    """(b)'s four ranks as subprocesses through a ``file://`` rendezvous,
    each writing its output to ``work/rank<r>.log``."""
    n = AXIS_DATA * AXIS_MODEL
    env = dict(os.environ, COORDINATOR_ADDRESS="file://" + os.path.join(
        work, "axis_rendezvous"), NUM_PROCESSES=str(n))
    procs = []
    for r in range(n):
        with open(os.path.join(work, f"rank{r}.log"), "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", "import sys, chip_smoke; "
                 "chip_smoke.axis_rank(sys.argv[1])", work], cwd=ROOT,
                env=dict(env, PROCESS_ID=str(r)), stdout=out,
                stderr=subprocess.STDOUT))
    return procs


def axis_reference(torch):
    """(b)'s one process: phase 5's float32 step, 3 counted steps and 2
    timed; (losses, ms a step, parameter bytes, optimizer bytes)."""
    x = synthetic_batch(torch)
    model, _, step = train_setup(torch, torch.float32, x)
    times, losses = [], []
    for i in range(1, TRAIN_STEPS + 1):
        t0 = time.perf_counter()
        losses.append(float(step(i)[0]["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    param = sum(p.numel() * p.element_size() for p in model.parameters())
    del model, step
    torch.cuda.empty_cache()
    return losses, 1e3 * sum(times[1:]) / AXIS_TIMED, param, 3 * param


def axis_ranks_check(torch, procs, work, ref, totals):
    """(b)'s checks on the reports of ``axis_ranks_start``'s ranks (which
    go on to phase 18)."""
    ref_losses, ref_ms, ref_param, ref_opt = ref
    reports = wait_reports(procs, work, "axis_report", 300)
    want = {k: n * TRAIN_STEPS for k, n in STEP_LAUNCHES["float32"].items()}
    lines = []
    for r in sorted(reports, key=lambda r: r["rank"]):
        tag = f"(b) rank {r['rank']} (data {r['rank'] // AXIS_MODEL}, model " \
              f"{r['rank'] % AXIS_MODEL})"
        expect_launches(tag, r["launches"], want)
        plus_into(totals, r["launches"])
        rel = max(abs(a - b) / abs(b) for a, b in zip(r["losses"],
                                                      ref_losses))
        check(r["grads_ok"] and rel <= 1e-5, f"{tag}: step-1 gradients "
              f"finite and non-zero {r['grads_ok']}, losses {r['losses']} "
              f"against one process's {ref_losses} ({rel:.3e} > 1e-5)")
        check(r["param_bytes"] < r["full_param_bytes"], f"{tag}: parameters "
              f"of {r['param_bytes']} bytes, not sharded")
        g, s = r["collectives"]["gather"], r["collectives"]["sum"]
        lines.append(
            f"rank {r['rank']}: losses within {rel:.3e}, {r['step_ms']:.3f} "
            f"ms a step (steps 2-3); step 4 with its model-axis collectives "
            f"timed {r['instrumented_ms']:.3f} ms, gathers {g['ms']:.3f} ms "
            f"({g['calls']} calls, {g['bytes']} bytes out), partial sums "
            f"{s['ms']:.3f} ms ({s['calls']} calls, {s['bytes']} bytes); "
            f"parameters {r['param_bytes']} of {r['full_param_bytes']} "
            f"bytes, optimizer state {r['opt_bytes']} bytes")
    log(f"(b) bare float32 step over a ({AXIS_DATA}, {AXIS_MODEL}) mesh of "
        f"gloo ranks on the one card [{CARD}], {TRAIN_BATCH} x "
        f"{TRAIN_PATCH}^2 ({TRAIN_BATCH // AXIS_DATA} a data index), "
        f"{TRAIN_STEPS} steps against one process (losses {ref_losses}, "
        f"{ref_ms:.3f} ms a step, parameters {ref_param} bytes, optimizer "
        f"state {ref_opt} bytes); launches exact per rank: "
        + "; ".join(lines))


def axis_serving(torch, model, core, core16, totals):
    """(c) Both cores over a (2, 2) mesh of the one card, float32 and
    bf16: each data shard on its model group's first device, frames
    byte-equal to one device's, launches a data shard as phase 13 (a)
    counts them."""
    from cnn_autoencoder_tpu_torch.parallel.mesh import (create_mesh,
                                                         data_devices)
    from cnn_autoencoder_tpu_torch.storage.cae_codec import CAECodecCore
    from cnn_autoencoder_tpu_torch.storage.turbo_codec import CAETurboCore
    mesh = create_mesh(data=AXIS_DATA, model=AXIS_MODEL,
                       devices=["cuda:0"] * (AXIS_DATA * AXIS_MODEL))
    check(mesh.shape == {"data": AXIS_DATA, "model": AXIS_MODEL}
          and len(data_devices(mesh)) == AXIS_DATA == MESH_SHARDS,
          f"(c) mesh {mesh.shape}")
    imgs = np.stack([image(512, 512, seed) for seed in range(TILES)])
    for mode, one in (("float32", core), ("bf16", core16)):
        dtype = one.base.compute_dtype
        m_turbo = CAETurboCore(model, num_streams=1024, mesh=mesh,
                               compute_dtype=dtype)
        check(len(m_turbo.shards) == AXIS_DATA, "(c) turbo core shards")
        m_turbo.decode_tiles(m_turbo.encode_tiles(imgs))    # warm-up
        tag = f"(c) ({AXIS_DATA}, {AXIS_MODEL}) mesh,"
        mesh_turbo(torch, one, m_turbo, imgs, mode, totals, tag)
        mesh_cae(torch, one.base, CAECodecCore(model, mesh=mesh,
                                               compute_dtype=dtype),
                 imgs, mode, totals, tag)


def axis_cli(torch, work, mode, totals):
    """(a) in ``mode``: the train CLI under ``CAE_TPU_MODEL_PARALLEL=2``
    over ``devices=["cuda:0"] * 2`` (data 1 x model 2, gloo) against one
    process: losses, launches a rank, step-1 gradients, the files,
    ``last_``'s keys and shapes, and rank 0's ``last_`` served through
    ``CAETurboCore`` with phase 3's checks.  Returns its log line."""
    from cnn_autoencoder_tpu_torch.models.factory import \
        autoencoder_from_state_dict
    from cnn_autoencoder_tpu_torch.storage.turbo_codec import CAETurboCore
    from cnn_autoencoder_tpu_torch.training.checkpoint import load_checkpoint
    label = f"axis_{mode}"
    one_dir, one, one_wall = mesh_cli_run(torch, work, "flagship", mode,
                                          None, ["cuda:0"], label + "_one")
    os.environ["CAE_TPU_MODEL_PARALLEL"] = str(AXIS_MODEL)
    try:
        two_dir, two, two_wall = mesh_cli_run(
            torch, work, "flagship", mode, None, ["cuda:0"] * AXIS_MODEL,
            label + "_two")
    finally:
        del os.environ["CAE_TPU_MODEL_PARALLEL"]
    rtol = 1e-5 if mode == "float32" else 2e-2
    check([(r["rank"], r["ranks"]) for r in two]
          == [(i, AXIS_MODEL) for i in range(AXIS_MODEL)],
          f"(a) {mode}: reports {[(r['rank'], r['ranks']) for r in two]}")
    want = cli_expected(mode, ARCH_STEPS, ARCH_VALIDATIONS)
    ref = [s["loss"] for s in one[0]["on_step"]]
    worst = 0.0
    for r in [one[0]] + two:
        tag = f"(a) {mode} rank {r['rank']} of {r['ranks']}"
        expect_launches(tag, r["launches"], want)
        plus_into(totals, r["launches"])
        steps = r["on_step"]
        losses = [s["loss"] for s in steps]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
        worst = max(worst, rel)
        check(len(steps) == ARCH_STEPS and steps[0]["grads_ok"]
              and rel <= rtol, f"{tag}: {len(steps)} steps, step-1 "
              f"gradients finite and non-zero {steps[0]['grads_ok']}, "
              f"losses {losses} against one process's {ref} ({rel:.3e} > "
              f"{rtol})")
    with open(next(os.path.join(two_dir, f) for f in os.listdir(two_dir)
                   if f.endswith(".log"))) as f:
        logs = f.read()
    paths = cli_checkpoints(two_dir)
    check(set(paths) == {"last", "best"}
          and f"Training mesh: data=1 x model={AXIS_MODEL}" in logs
          and "Rank 0 of 2" in logs and "Rank 1" not in logs,
          f"(a) {mode}: the files of the model-axis run: "
          f"{sorted(os.listdir(two_dir))}")
    a, b = (dict(tree_leaves({m: load_checkpoint(p)[m] for m in
                              ("encoder", "decoder", "fact_ent")}))
            for p in (paths["last"], cli_checkpoints(one_dir)["last"]))
    check(a.keys() == b.keys() and all(np.shape(a[k]) == np.shape(b[k])
                                       for k in b),
          f"(a) {mode}: rank 0's last_ has other keys or shapes than one "
          "process's")
    served = autoencoder_from_state_dict(paths["last"], device="cuda")
    imgs = np.stack([image(512, 512, seed) for seed in range(TILES)])
    launches, rec = serving_round_trip(
        torch, served, CAETurboCore(served, num_streams=1024,
                                    device="cuda"), imgs, "float32")
    plus_into(totals, launches)

    def step_ms(report):
        t = [s["t"] for s in report["on_step"]]
        return 1e3 * (t[-1] - t[0]) / (len(t) - 1)

    return (f"{mode}: losses {[round(s['loss'], 6) for s in two[0]['on_step']]}"
            f" within {worst:.3e} (limit {rtol}) of one process's; "
            f"{step_ms(one[0]):.3f} ms a step on one process, "
            f"{step_ms(two[0]):.3f} / {step_ms(two[1]):.3f} on the two ranks "
            f"(steps 2-3, host clock); parameters a rank "
            f"{two[0]['on_step'][0]['param_bytes']} of "
            f"{one[0]['on_step'][0]['param_bytes']} bytes; main() "
            f"{one_wall:.1f} / {two_wall:.1f} s; rank 0's last_ serves "
            f"{TILES} tiles at {rec['psnr']:.3f} dB, {rec['bpp']:.4f} bpp")


# -- phase 18 ----------------------------------------------------------------

# (a) the bare step of each architecture the flagship's axis left out, in
# phase 17 (b)'s four ranks one after another: (label, architecture, mode)
OPTION_RUNS = (("R float32", "R", "float32"), ("R bf16", "R", "bf16"),
               ("B float32", "B", "float32"), ("B bf16", "B", "bf16"),
               ("grouped 4/4/4", "G444", "float32"),
               ("ViT", "ViT", "float32"), ("JNet", "JNet", "float32"))
# (trainable modules, criterion) by architecture: the heads train alone on
# the frozen flagship codec, as in phase 11
OPTION_TRAINING = {
    "R": (["encoder", "decoder", "fact_ent"], "RateMSE"),
    "B": (["encoder", "decoder", "fact_ent"], "RateMSE"),
    "G444": (["encoder", "decoder", "fact_ent"], "RateMSE"),
    "ViT": (["class_model"], "RateMSECE"),
    "JNet": (["seg_model"], "RateMSEBCE")}
# phase 11's heads on the flagship, from seed 0
OPTION_HEADS = {
    "ViT": dict(class_model_type="ViT", cut_position=6,
                num_classes=VIT_CLASSES, patch_size=32),
    "JNet": dict(seg_model_type="JNet", seg_channels_net=128,
                 seg_channels_bn=48, seg_channels_expansion=1,
                 num_classes=1)}
# the grouped model at 4 / 4 / 4, whose kernels shard by whole groups
GROUPED_444 = dict(GROUPED, channels_org=4, channels_net=4, channels_bn=4)
# 256^2 patches a step (4 a data index): gloo moves every gathered
# activation through the host; ViT takes phase 11's 64 of 32^2
OPTION_BATCH = 8
# launches a step by architecture and mode: R's and B's as phase 10's, the
# grouped model's four GDN layers, a head's frozen codec serving (K1 3, K4 1)
OPTION_LAUNCHES = {**ARCH_STEP_LAUNCHES,
                   ("G444", "float32"): {"gdn_fwd": 4},
                   ("ViT", "float32"): VAL_LAUNCHES["float32"],
                   ("JNet", "float32"): VAL_LAUNCHES["float32"]}
# eval forwards of phase 11 (d)'s heads on a batch of 2 latents (1 a data
# index): ResNet-152 cut 3 and InceptionV3 with its cut from the patch,
# whose batch norms run from running statistics held as shards
EVAL_HEADS = ("ResNet", "InceptionV3")
EVAL_LATENTS = 2
EVAL_LIMIT = 1e-4   # of the largest logit: float32 sums in another order


def option_model(torch, work, arch):
    """Phase 18's model of ``arch`` on the card in train mode: R and B
    from phase 10's checkpoints in ``work``, the grouped model from seed
    0, ViT and JNet (from seed 0) on the flagship."""
    from cnn_autoencoder_tpu_torch.models.factory import (
        autoencoder_from_state_dict, build_model)
    from cnn_autoencoder_tpu_torch.training.checkpoint import load_checkpoint
    if arch in ("R", "B"):
        return autoencoder_from_state_dict(
            os.path.join(work, f"{arch}.msgpack"), device="cuda").train()
    if arch == "G444":
        return build_model(GROUPED_444, torch.Generator().manual_seed(0),
                           device="cuda")
    state = load_checkpoint(CHECKPOINT)
    state.update(OPTION_HEADS[arch])
    return autoencoder_from_state_dict(state, device="cuda").train()


def option_data(torch, arch):
    """(x, targets or None) of ``arch``'s global batch on the card: phase
    5's patches (with a fourth channel, their mean, for the grouped
    model; a label map for JNet), or phase 11's 32^2 images and labels
    for ViT."""
    if arch == "ViT":
        rng = np.random.RandomState(1)
        x = rng.rand(VIT_BATCH, 32, 32, 3).astype(np.float32)
        t = rng.randint(0, VIT_CLASSES, VIT_BATCH).astype(np.int64)
        return torch.from_numpy(x).cuda(), torch.from_numpy(t).cuda()
    x = synthetic_batch(torch)[:OPTION_BATCH]
    if arch == "G444":
        return torch.cat([x, x.mean(-1, keepdim=True)], -1), None
    if arch == "JNet":
        return x, (x.mean(-1, keepdim=True) > 0.5).float()
    return x, None


def state_bytes(model):
    """(parameter bytes, buffer bytes) of ``model`` as it is held."""
    return (sum(p.numel() * p.element_size() for p in model.parameters()),
            sum(b.numel() * b.element_size() for b in model.buffers()))


def option_steps(torch, model, arch, mode, x, t, group=None,
                 model_group=None):
    """``TRAIN_STEPS`` counted bare steps of ``arch`` in ``mode`` on
    ``model`` (Adam at phase 5's rate, noise and masks from a card
    generator of seed 0), data-parallel over ``group`` with its shards over
    ``model_group``, then with ``model_group`` one more with the model
    axis's collectives timed.  Returns a JSON-able record and each counted
    step's likelihoods (numpy)."""
    from cnn_autoencoder_tpu_torch.criteria.loss import setup_loss
    from cnn_autoencoder_tpu_torch.ops.batchnorm import BatchNorm
    from cnn_autoencoder_tpu_torch.ops.kernels import (kernel_wrappers,
                                                       reset_launch_counts)
    from cnn_autoencoder_tpu_torch.parallel.distributed import full_param
    from cnn_autoencoder_tpu_torch.training.loop import make_train_step
    from cnn_autoencoder_tpu_torch.training.optim import setup_optimizers
    trainable, criterion = OPTION_TRAINING[arch]
    dtype = torch.float32 if mode == "float32" else torch.bfloat16
    rec, losses, times = {}, [], []
    with step_likelihoods(rec, always=True):
        optimizers = setup_optimizers(model, trainable)
        step = make_train_step(
            model, setup_loss(criterion, distortion_lambda=0.01),
            optimizers, trainable_modules=trainable, compute_dtype=dtype,
            group=group, model_group=model_group)
        lrs = {k: TRAIN_LR for k in optimizers}
        gen = torch.Generator(device="cuda").manual_seed(0)
        torch.cuda.synchronize()
        reset_launch_counts()
        for i in range(1, TRAIN_STEPS + 1):
            t0 = time.perf_counter()
            stats, grads = step(x, lrs, i, generator=gen, t=t)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(stats["loss"]))
            if i == 1:
                grads_ok = all(
                    bool(torch.isfinite(g).all()) and (
                        name.endswith(ZERO_GRAD) or float(g.abs().max()) > 0)
                    for gs in grads.values() for name, g in gs.items())
                norms = {f"{n}.{k}": full_param(m, k).float().cpu().tolist()
                         for n, m in model.named_modules()
                         if isinstance(m, BatchNorm) for k in ("mean", "var")}
        launches = {fn.kernel_name: fn.launches for fn in kernel_wrappers()}
    params, buffers = state_bytes(model)
    out = dict(losses=losses, grads_ok=grads_ok, norms=norms,
               launches=launches, step_ms=1e3 * float(np.mean(times[1:])),
               param_bytes=params, buffer_bytes=buffers,
               opt_bytes=opt_bytes(optimizers))
    if model_group is not None:
        out["instrumented_ms"], out["collectives"] = timed_collectives(
            torch, lambda: step(x, lrs, TRAIN_STEPS + 1, generator=gen, t=t))
    return out, [p.float().cpu().numpy() for p in rec["p_y"][:TRAIN_STEPS]]


def head_alone(torch, kind):
    """Phase 11 (d)'s head ``kind`` from seed 0 (its norms and running
    statistics moved off 1 and 0) as the model ``shard_model`` shards:
    its leaves under ``class_model``; on the card, in eval mode."""
    from cnn_autoencoder_tpu_torch.models.classifiers import CLASS_MODELS
    heads = torch.nn.Module()
    heads.config = {}
    heads.class_model = CLASS_MODELS[kind](
        channels_bn=48, cut_position=3 if kind == "ResNet" else None,
        patch_size=TRAIN_PATCH, compression_level=3,
        num_classes=VIT_CLASSES)
    gen = torch.Generator().manual_seed(0)
    for m in heads.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    with torch.no_grad():
        for value in heads.state_dict().values():
            if value.dim() == 1:
                value.add_(torch.rand(value.shape, generator=gen) * 0.2)
    return heads.cuda().eval()


def eval_latents(torch):
    """The eval heads' batch: 2 latents of the flagship's 256^2 shape."""
    gen = torch.Generator().manual_seed(2)
    return torch.randn(EVAL_LATENTS, TRAIN_PATCH // 8, TRAIN_PATCH // 8, 48,
                       generator=gen).cuda()


def eval_head(torch, kind, lat, model_group=None, index=0):
    """``kind``'s eval forward on ``lat``, its leaves sharded over
    ``model_group``: (logits, aux logits or None) as lists, and ms (host
    clock)."""
    from cnn_autoencoder_tpu_torch.parallel.mesh import shard_model
    heads = shard_model(head_alone(torch, kind), model_group, index,
                        AXIS_MODEL if model_group is not None else 1)
    with torch.no_grad():
        heads.class_model(lat)      # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, aux = heads.class_model(lat)
        torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    return (out.cpu().tolist(), None if aux is None else aux.cpu().tolist(),
            ms, state_bytes(heads))


def option_rank(torch, work, group, model_group, rank):
    """Phase 18 (a) in one of phase 17 (b)'s ranks: each run of
    ``OPTION_RUNS`` on its data index's rows with its model index's
    shards, then the eval heads on its data index's latent; writes its
    report to ``work/options_report<r>.json`` and, at model index 0, each
    run's likelihoods to ``work/options_py<r>.npz``."""
    from cnn_autoencoder_tpu_torch.parallel import distributed
    from cnn_autoencoder_tpu_torch.parallel.mesh import shard_model
    index = rank % AXIS_MODEL
    report, p_y = {}, {}
    for label, arch, mode in OPTION_RUNS:
        model = option_model(torch, work, arch)
        full = state_bytes(model)
        shard_model(model, model_group, index, AXIS_MODEL)
        x, t = option_data(torch, arch)
        rows = distributed.local_batch_slice(x.shape[0], AXIS_MODEL)
        rec, likelihoods = option_steps(
            torch, model, arch, mode, x[rows], None if t is None else t[rows],
            group, model_group)
        report[label] = dict(rec, full_bytes=full)
        p_y.update({f"{label}/{i}": a for i, a in enumerate(likelihoods)})
        del model
        torch.cuda.empty_cache()
    lat = eval_latents(torch)[distributed.local_batch_slice(EVAL_LATENTS,
                                                            AXIS_MODEL)]
    for kind in EVAL_HEADS:
        report[kind] = eval_head(torch, kind, lat, model_group, index)
        torch.cuda.empty_cache()
    if index == 0:
        np.savez(os.path.join(work, f"options_py{rank}.npz"), **p_y)
    write_json(os.path.join(work, f"options_report{rank}.json"), report)


def options_reference(torch, work):
    """(a)'s one process: each run of ``OPTION_RUNS`` on the global batch,
    and the eval heads on both latents."""
    ref = {}
    for label, arch, mode in OPTION_RUNS:
        model = option_model(torch, work, arch)
        x, t = option_data(torch, arch)
        ref[label] = option_steps(torch, model, arch, mode, x, t) + (
            x.shape[0] * x.shape[1] * x.shape[2],)
        del model
        torch.cuda.empty_cache()
    lat = eval_latents(torch)
    for kind in EVAL_HEADS:
        ref[kind] = eval_head(torch, kind, lat)
        torch.cuda.empty_cache()
    return ref


def options_check(torch, work, reports, ref, totals):
    """(a)'s checks of the ranks' reports against one process's: losses
    (without the elements at the likelihood floor in either run, as phase
    9 compares), launches, step-1 gradients, B's running statistics, the
    shards' bytes and the eval heads' logits."""
    lines = []
    for label, arch, mode in OPTION_RUNS:
        one, ref_p_y, pixels = ref[label]
        rtol = 1e-5 if mode == "float32" else 2e-2
        want = {k: n * TRAIN_STEPS
                for k, n in OPTION_LAUNCHES[(arch, mode)].items()}
        expect_launches(f"(a) {label} one process", one["launches"], want)
        plus_into(totals, one["launches"])
        check(one["grads_ok"], f"(a) {label} one process: a step-1 "
              "gradient is zero or not finite")
        # the global batch's likelihoods from the two data indices' ranks
        parts = [np.load(os.path.join(work, f"options_py{r}.npz"))
                 for r in range(0, AXIS_DATA * AXIS_MODEL, AXIS_MODEL)]
        p_y = [torch.from_numpy(np.concatenate([p[f"{label}/{i}"]
                                                for p in parts]))
               for i in range(TRAIN_STEPS)]
        worst, stats_worst, floored = 0.0, 0.0, 0
        for r in reports:
            rank = r["rank"]
            got = r["options"][label]
            tag = f"(a) {label} rank {rank}"
            expect_launches(tag, got["launches"], one["launches"])
            plus_into(totals, got["launches"])
            a, b, n = off_floor_losses(
                torch, got["losses"], {"p_y": p_y, "pixels": pixels},
                one["losses"], {"p_y": [torch.from_numpy(q) for q in ref_p_y],
                                "pixels": pixels})
            rel = max(abs(u - v) / abs(v) for u, v in zip(a, b))
            worst, floored = max(worst, rel), max(floored, n)
            check(got["grads_ok"] and rel <= rtol, f"{tag}: step-1 "
                  f"gradients finite and non-zero {got['grads_ok']}, losses "
                  f"{got['losses']} against one process's {one['losses']} "
                  f"({rel:.3e} > {rtol} without {n} floored elements)")
            check(got["param_bytes"] < got["full_bytes"][0],
                  f"{tag}: parameters of {got['param_bytes']} bytes, not "
                  "sharded")
            for k, v in one["norms"].items():
                ref_v = np.asarray(v)
                stats_worst = max(stats_worst, float(
                    np.abs(np.asarray(got["norms"][k]) - ref_v).max()
                    / max(float(np.abs(ref_v).max()), 1e-30)))
        check(stats_worst <= 1e-4, f"(a) {label}: step 1's running "
              f"statistics {stats_worst:.3e} (relative) from one process's")
        r0 = reports[0]["options"][label]
        g, s = r0["collectives"]["gather"], r0["collectives"]["sum"]
        stats_note = (f", running statistics after step 1 within "
                      f"{stats_worst:.3e} of one process's"
                      if one["norms"] else "")
        lines.append(
            f"{label}: losses within {worst:.3e} (limit {rtol}; {floored} "
            f"floored elements left out){stats_note}; launches a rank "
            f"{one['launches']}; {r0['step_ms']:.3f} ms a step on rank 0 "
            f"against one process's {one['step_ms']:.3f}; a step with its "
            f"collectives timed {r0['instrumented_ms']:.3f} ms, gathers "
            f"{g['ms']:.3f} ms ({g['calls']} calls, {g['bytes']} bytes out), "
            f"partial sums {s['ms']:.3f} ms ({s['calls']} calls, "
            f"{s['bytes']} bytes); a rank's parameters / buffers / "
            f"optimizer state {r0['param_bytes']} / {r0['buffer_bytes']} / "
            f"{r0['opt_bytes']} of one process's {one['param_bytes']} / "
            f"{one['buffer_bytes']} / {one['opt_bytes']} bytes")
    for kind in EVAL_HEADS:
        logits, aux, ms, (params, _) = ref[kind]
        ref_all = np.asarray(logits)
        scale = float(np.abs(ref_all).max())
        per = EVAL_LATENTS // AXIS_DATA
        worst = 0.0
        for r in reports:
            got = r["options"][kind]
            d = r["rank"] // AXIS_MODEL
            worst = max(worst, float(np.abs(
                np.asarray(got[0]) - ref_all[d * per:(d + 1) * per]).max())
                / scale)
            if aux is not None:
                ref_aux = np.asarray(aux)[d * per:(d + 1) * per]
                worst = max(worst, float(np.abs(np.asarray(got[1]) - ref_aux)
                                         .max()) / scale)
        check(worst <= EVAL_LIMIT, f"(a) {kind} eval: logits {worst:.3e} of "
              f"the largest from one process's (limit {EVAL_LIMIT})")
        r0 = reports[0]["options"][kind]
        lines.append(f"{kind} eval on {EVAL_LATENTS} latents: logits within "
                     f"{worst:.3e} of the largest; {r0[2]:.3f} ms on rank 0 "
                     f"(its data index's latent) against one process's "
                     f"{ms:.3f} (both); a rank's parameters {r0[3][0]} of "
                     f"{params} bytes")
    log(f"phase 18 (a) the bare step over a ({AXIS_DATA}, {AXIS_MODEL}) mesh "
        f"of gloo ranks on the one card [{CARD}], {TRAIN_STEPS} steps each "
        f"against one process ({OPTION_BATCH} x {TRAIN_PATCH}^2, ViT "
        f"{VIT_BATCH} x 32^2; host clock, steps 2-3, the ranks sharing the "
        "card): " + "; ".join(lines))


def option_cli(torch, work, totals):
    """(b) B in bf16 through the train CLI under
    ``CAE_TPU_MODEL_PARALLEL=2`` (data 1 x model 2, gloo on the one card),
    3 steps and a validation: launches a rank, both ranks' losses equal,
    only rank 0 writing, ``last_`` with one process's keys and shapes
    (``B.msgpack``'s, running statistics included), served through
    ``CAETurboCore`` with phase 10 (b)'s checks and over a (2, 2) mesh with
    frames byte-equal to one device's."""
    from cnn_autoencoder_tpu_torch.models.factory import \
        autoencoder_from_state_dict
    from cnn_autoencoder_tpu_torch.ops.kernels import (kernel_wrappers,
                                                       reset_launch_counts)
    from cnn_autoencoder_tpu_torch.parallel.mesh import create_mesh
    from cnn_autoencoder_tpu_torch.storage.turbo_codec import CAETurboCore
    from cnn_autoencoder_tpu_torch.training.checkpoint import load_checkpoint
    chk = os.path.join(work, "B.msgpack")
    os.environ["CAE_TPU_MODEL_PARALLEL"] = str(AXIS_MODEL)
    try:
        log_dir, two, wall = mesh_cli_run(
            torch, work, "B", "bf16", chk, ["cuda:0"] * AXIS_MODEL,
            "options_B_bf16")
    finally:
        del os.environ["CAE_TPU_MODEL_PARALLEL"]
    check([(r["rank"], r["ranks"]) for r in two]
          == [(i, AXIS_MODEL) for i in range(AXIS_MODEL)],
          f"(b) reports {[(r['rank'], r['ranks']) for r in two]}")
    want = arch_expected("B", "bf16", ARCH_STEPS,
                         ARCH_VALIDATIONS * VAL_BATCHES)
    losses = [[s["loss"] for s in r["on_step"]] for r in two]
    for r in two:
        tag = f"(b) B bf16 rank {r['rank']} of {r['ranks']}"
        expect_launches(tag, r["launches"], want)
        plus_into(totals, r["launches"])
        check(len(r["on_step"]) == ARCH_STEPS and r["on_step"][0]["grads_ok"]
              and all(np.isfinite(losses[r["rank"]])),
              f"{tag}: {len(r['on_step'])} steps, step-1 gradients finite "
              f"and non-zero {r['on_step'][0]['grads_ok']}, losses "
              f"{losses[r['rank']]}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(*losses))
    check(rel <= 1e-6, f"(b) the two ranks' losses {losses} ({rel:.3e})")
    with open(next(os.path.join(log_dir, f) for f in os.listdir(log_dir)
                   if f.endswith(".log"))) as f:
        logs = f.read()
    paths = cli_checkpoints(log_dir)
    check(set(paths) == {"last", "best"}
          and f"Training mesh: data=1 x model={AXIS_MODEL}" in logs
          and "Rank 0 of 2" in logs and "Rank 1" not in logs,
          f"(b) the files of the model-axis run: {sorted(os.listdir(log_dir))}")
    a, b = (dict(tree_leaves({m: load_checkpoint(p)[m] for m in
                              ("encoder", "decoder", "fact_ent")}))
            for p in (paths["last"], chk))
    stats = [k for k in b if "/batch_stats/" in k]
    check(a.keys() == b.keys() and len(stats) == 12
          and all(np.shape(a[k]) == np.shape(b[k]) for k in b),
          "(b) rank 0's last_ has other keys or shapes than one process's")
    imgs = np.stack([image(512, 512, seed) for seed in range(TILES)])
    plus_into(totals, arch_serve(torch, "B", paths["last"], imgs))
    served = autoencoder_from_state_dict(paths["last"], device="cuda")
    one = CAETurboCore(served, num_streams=1024, device="cuda")
    mesh = CAETurboCore(served, num_streams=1024, mesh=create_mesh(
        data=AXIS_DATA, model=AXIS_MODEL,
        devices=["cuda:0"] * (AXIS_DATA * AXIS_MODEL)))
    frames = one.encode_tiles(imgs)
    mesh.decode_tiles(mesh.encode_tiles(imgs))     # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    mesh_frames = mesh.encode_tiles(imgs)
    rec = mesh.decode_tiles(mesh_frames)
    torch.cuda.synchronize()
    launches = {fn.kernel_name: fn.launches for fn in kernel_wrappers()}
    plus_into(totals, launches)
    check(mesh_frames == frames and np.array_equal(rec,
                                                   one.decode_tiles(frames)),
          "(b) the (2, 2) mesh's frames or decodes differ from one device's")
    t = [s["t"] for s in two[0]["on_step"]]
    log(f"phase 18 (b) B bf16 through the train CLI under "
        f"CAE_TPU_MODEL_PARALLEL={AXIS_MODEL} [{CARD}], data 1 x model "
        f"{AXIS_MODEL} over gloo, {CLI_BATCH} x {CLI_PATCH}^2, {ARCH_STEPS} "
        f"steps and 1 validation: losses {losses[0]} on both ranks "
        f"(within {rel:.3e}), launches a rank {two[0]['launches']}; "
        f"{1e3 * (t[-1] - t[0]) / (len(t) - 1):.3f} ms a step (steps 2-3, "
        f"host clock), main() {wall:.1f} s; only rank 0 wrote; last_ with "
        f"one process's {len(b)} keys and shapes ({len(stats)} running "
        f"statistics), served as phase 10 (b) checks; over a "
        f"({AXIS_DATA}, {AXIS_MODEL}) mesh frames byte-equal to one "
        f"device's, launches {launches}")


def phase_axis_options(torch, work, procs):
    """Phase 18: residual units, batch norm, grouped convolutions and the
    heads under the model axis on the one card, in phase 17 (b)'s ranks
    (started with phase 17, their report read here) against one process,
    then B through the train CLI under the axis; returns its launches."""
    t0 = time.perf_counter()
    totals = {}
    ref = options_reference(torch, work)
    t1 = time.perf_counter()
    reports = [dict(rank=r, options=o) for r, o in enumerate(
        wait_reports(procs, work, "options_report", 600))]
    for r, p in enumerate(procs):
        p.wait(timeout=60)
        check(p.returncode == 0, f"rank {r} exited {p.returncode}: "
              f"{rank_log(work, r)}")
    t2 = time.perf_counter()
    options_check(torch, work, reports, ref, totals)
    option_cli(torch, work, totals)
    log(f"phase 18: {time.perf_counter() - t0:.1f} s (one process "
        f"{t1 - t0:.1f} s, then the ranks' end {t2 - t1:.1f} s, (b) and the "
        f"checks {time.perf_counter() - t2:.1f} s); launches {totals}")
    return totals


def phase_model_axis(torch, model, core, core16):
    """Phases 17 and 18: the model mesh axis on the one card; returns
    their launches for the ``kernels`` line.  (b)'s four ranks start
    while (c) runs, and go on to phase 18 (a) while (a)'s runs follow
    them."""
    import shutil
    t0 = time.perf_counter()
    work = os.path.join(ROOT, "build", "phase17")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    totals, procs = {}, []
    try:
        ref = axis_reference(torch)
        # phase 18's ranks are (b)'s: they read R's and B's checkpoints
        val_img = write_cli_slides(work)
        for kind in ("R", "B"):
            arch_checkpoint(torch, kind, os.path.join(work, f"{kind}.msgpack"),
                            val_img)
        procs = axis_ranks_start(work)
        t1 = time.perf_counter()
        axis_serving(torch, model, core, core16, totals)
        t2 = time.perf_counter()
        axis_ranks_check(torch, procs, work, ref, totals)
        t3 = time.perf_counter()
        lines = [axis_cli(torch, work, mode, totals)
                 for mode in ("float32", "bf16")]
        log(f"(a) the train CLI under CAE_TPU_MODEL_PARALLEL={AXIS_MODEL} "
            f"[{CARD}], data 1 x model {AXIS_MODEL} over gloo on the one "
            f"card, {CLI_BATCH} x {CLI_PATCH}^2, {ARCH_STEPS} steps and 1 "
            "validation; every rank's launches one process's, only rank 0 "
            "wrote, last_ with one process's keys and shapes: "
            + "; ".join(lines))
        log(f"phase 17: {time.perf_counter() - t0:.1f} s ((b)'s one process, "
            f"the slides and R's and B's checkpoints {t1 - t0:.1f} s, (c) "
            f"{t2 - t1:.1f} s beside (b)'s ranks, their end {t3 - t2:.1f} s, "
            f"(a) {time.perf_counter() - t3:.1f} s beside phase 18's ranks); "
            f"launches {totals}")
        plus_into(totals, phase_axis_options(torch, work, procs))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
        shutil.rmtree(work, ignore_errors=True)
    return totals


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from cnn_autoencoder_tpu_torch.models.factory import \
            autoencoder_from_state_dict
        from cnn_autoencoder_tpu_torch.storage.turbo_codec import \
            CAETurboCore
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here ({exc})",
              file=sys.stderr)
        return 2
    check(os.path.exists(CHECKPOINT), f"missing {CHECKPOINT}")

    phase_device(torch)
    model = autoencoder_from_state_dict(CHECKPOINT, device="cuda")
    core = CAETurboCore(model, num_streams=1024, device="cuda")
    records = phase_kernels(torch, model, core, TILES)
    launches, core16 = phase_end_to_end(torch, model, core, TILES)
    records.update(phase_train_kernels(torch, model))
    train_launches, step_ms = phase_training(torch)
    for name, n in train_launches.items():
        launches[name] += n
    phase_codecs(torch, model, core, core16)
    phase_slide(torch, core, core16)
    cli_launches, cli_ms = phase_train_cli(torch, step_ms)
    for name, n in cli_launches.items():
        launches[name] += n
    for name, n in phase_energy_multiscale(torch, model, core, cli_ms).items():
        launches[name] += n
    for name, n in phase_arch_options(torch, cli_ms).items():
        launches[name] += n
    for name, n in phase_eval_heads(torch, model).items():
        launches[name] += n
    for name, n in phase_pixel_transport(torch, core, core16).items():
        launches[name] += n
    for name, n in phase_mesh(torch, model, core, core16).items():
        launches[name] += n
    for name, n in phase_tools(torch, model, core).items():
        launches[name] += n
    precision_records, precision_launches = phase_precisions(torch, model,
                                                             core)
    records.update(precision_records)
    for name, n in precision_launches.items():
        launches[name] += n
    low_records, low_launches = phase_low_precision_training(torch, model,
                                                             core)
    records.update(low_records)
    for name, n in low_launches.items():
        launches[name] += n
    for name, n in phase_model_axis(torch, model, core, core16).items():
        launches[name] += n
    check(all(launches[name] > 0 for name in records),
          f"a kernel was not launched on the main paths: {launches}")

    kernels = []
    for name, rec in records.items():
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
