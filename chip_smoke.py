#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``sleap_nn_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. Device report: the card's name and power limit.
2. Build: every CUDA kernel of the port, compiled from ``csrc/`` with nvcc
   (one process per source, in parallel).
3. Kernels against their plain PyTorch versions, at the shapes of the two
   paths (UNet medium_rf, 1024x1024 frames, batch 8): the fused double conv
   at all 18 double-conv blocks of one top-down batch in bf16 (plus four
   f32 checks; the bottom-up UNet's 9 blocks have the centroid UNet's
   shapes), the peak NMS on the (8, 512, 512, 1) centroid map (k = 3 and 5)
   and on the (8, 512, 512, 15) bottom-up confmaps (k = 3), bf16 and f32,
   and the PAF line scores on the bottom-up model's own (8, 256, 256, 28)
   PAFs and peaks, bf16 and f32. Times each kernel alone (``graph_ms``:
   bare launches of its C entry into a preallocated output, pre-packed
   weights for the fused conv, in a CUDA graph) and through its wrapper,
   the plain version and, where one exists, the library call that computes
   the same function (cuDNN convolutions), and the bound of each call.
   Counts the tensor-core instructions in the fused conv's SASS
   (``cuobjdump -sass``; it must hold some).
4. Top-down end to end: ``Predictor.predict`` of the top-down pair
   (medium_rf centroid + centered-instance UNets, random weights from a
   seed, bf16) over an in-memory video of 20 synthetic 1024x1024 uint8
   frames, batch 8 (the last batch is partial). Launch counters, zeroed
   just before the run, must show both kernels ran (18 and 1 per batch);
   every output must have the JAX package's shapes, with NaN exactly on
   invalid slots. Prints frames/s and per-stage ms.
5. Bottom-up end to end (after the native grouping check: the C++ PAF
   grouping library of ``native/`` must have built, beside the kernels,
   and loaded; the host grouping of one batch is timed on it and on the
   scipy fallback): ``Predictor.predict`` of a medium_rf bottom-up
   model (confmaps at stride 2, PAFs at stride 4, 15 nodes, 14 edges,
   bf16) over the same 20 frames, with the PAF grouping on the fetch
   thread and then in 2 worker processes. Launch counters must read 9 / 1
   / 1 per batch (fused conv, NMS, PAF line scores) in each run; outputs
   must have the JAX package's keys and shapes, hold at least one
   instance, and be identical between the two runs. Prints frames/s and
   per-stage ms.
6. Agreement with the CPU on a small input: a narrow f32 top-down pair and
   a narrow f32 bottom-up model run on the card and on the CPU; maps must
   agree to 1e-4 and each post-processing stage, fed the same inputs, to
   the index (peaks and PAF scores to 1e-5, instances the same).
7. Centroid training end to end: ``ModelTrainer.train`` of a UNet medium_rf
   centroid model (confmaps at stride 2, sigma 5) on 24 synthetic
   1024x1024 uint8 frames with 1-6 instances of 15 nodes (20 train, 4
   val), batch 4, f32, Adam lr 1e-4, geometric augmentation at its
   defaults, 2 epochs of 5 steps, checkpoints in a temporary directory.
   The kernel-4 launch counter, zeroed before setup, must equal the train
   steps plus the val batches plus the setup probe (the other kernels: 0);
   every loss finite, the parameters moved, ``best.ckpt`` loads strictly
   into a fresh model, ``last.ckpt`` reproduces the trainer's outputs
   exactly, and 20 steps on one fixed batch bring the loss below its
   first value. Prints steps/s, samples/s, peak device memory and the ms
   of one step by stage. The epoch-end evaluation runs after each epoch:
   it renders the val batches again (kernel 4) and finds their centroid
   peaks on the f32 maps (kernel 2), so each adds one launch per val batch
   and epoch; every epoch's logs must hold ``val/dist.avg`` and
   ``val/detection.f1``; on one val batch the peaks through kernel 2 must
   equal those through its plain version exactly. Prints the evaluation's
   seconds per epoch.
8. Training on the card against the CPU: a narrow f32 centroid model
   (filters 8, max_stride 8, 128x128 frames), the same parameters and
   batch, augmentation off: the first loss to 1e-5 relative, every
   gradient to 1e-4 of its largest magnitude, the parameters after 3 Adam
   steps to 1e-5 absolute.
9. Single-instance end to end: ``Predictor.predict`` of a medium_rf
   single-instance model (15 nodes, confmaps at stride 2, random weights
   from a seed, bf16) over the same 20 frames, batch 8. Launch counters
   must read 9 fused-conv calls per batch and 0 for the other kernels;
   outputs must have the JAX package's keys and shapes, every node found.
   Prints frames/s and per-stage ms.
10. Bottom-up training end to end: as phase 7, with the bottom-up model
    (confmaps sigma 2.5 at stride 2, PAFs sigma 15 at stride 4, 15 nodes,
    the 14-edge tree). Kernel 4's launches must equal the train steps plus
    the val batches plus the setup probe, at (4, I, 15, 2) -> (4, 512, 512,
    15); the render is split into its confmap part (kernel 4, held against
    its plain version on the path's own points) and its PAF part.
11. Centered-instance training end to end: as phase 7, with a medium_rf
    centered-instance model (15 nodes, ``crop_size`` 256) on crops of the
    same labels, one sample per instance, and the epoch-end evaluation
    (``val/mOKS`` and ``val/dist.avg`` in every epoch's logs). No kernel
    may launch.
12. Training on the card against the CPU, as phase 8, for a narrow model
    of each of the single-instance, centered-instance and bottom-up types.
13. Predict from model directories: phases 7, 10 and 11 train into dirs
    under one temporary directory (each must hold ``initial_config.yaml``,
    ``training_config.yaml``, ``best.ckpt`` and ``training_log.csv``).
    ``run.predict`` (``load_model`` -> ``Predictor.from_model_paths`` ->
    ``Labels``) runs the top-down pair (dirs of phases 7 + 11) and the
    bottom-up model (phase 10, grouping on the fetch thread) over in-memory
    ``Labels`` of the same 20 frames, bf16, batch 8, no output file. The
    loaded weights must equal the ``state_dict`` saved in ``best.ckpt``
    bit for bit; launch counters must read 18 + 1 (top-down) and 9 + 1 + 1
    (bottom-up) per batch of that run. One ``Predictor.from_model_paths``
    then predicts the frames with ``make_labels=False`` and ``True``: its
    ``Labels``, and ``run.predict``'s, must hold exactly the instances of
    its raw outputs, on every frame. The 10-step models' maps sit near 0,
    so the peak threshold is -1e9 (every local maximum is a peak). Prints
    frames/s, a 3-batch smoke figure.
14. Model dirs on the card against the CPU: a narrow (filters 8, 128x128)
    top-down pair and bottom-up model trained 3 steps on the CPU into dirs
    (their weights then conditioned as in the CPU tests of the model dirs
    and saved by the trainer), predicted through ``run.predict`` on the
    card and on the CPU in f32: counts, validity and NaN placement exact,
    keypoints to 1e-4 px, peak values to 1e-5. ``tools/model_dir_divergence.py``
    runs the same dirs as trained and reports where the two devices part.
15. Tracked predict from model directories: ``run.predict(tracking=True)``
    from phase 13's dirs over the same 20 frames and knobs, with the
    default tracker (launch counters as in phase 13) and with the Kalman
    tracker (6 identities, single-break repair). Every instance carries a
    track, the Kalman run at most 6; each run's tracks equal those of
    ``run_tracker`` on a deep copy of the same path's untracked ``Labels``,
    and provenance holds each run's tracking knobs. Prints frames/s of the
    predict loop and tracking ms per frame, with the card's name and power
    limit.
16. Tracking and evaluation, the card against the CPU: phase 14's narrow
    dirs predict a 24-frame clip of two blob animals on straight paths 64
    px apart with tracking on (each frame's best 2 instances, centroids
    tracked by distance) on both devices: the same track for
    every instance (keypoints to 1e-4 px), and ``run_evaluation`` against
    the clip's ground truth the same (``mOKS`` to 1e-6, ``dist.avg`` to
    1e-4 px, detection counts exact); the metrics file round-trips.
17. Multi-class bottom-up training end to end: as phase 10, with an
    identity model (confmaps sigma 2.5 at stride 2, class maps sigma 5 at
    stride 2, 15 nodes) on phase 7's labels, each instance one of 6
    ``Track``s, distinct within its frame. Kernel 4's launches must equal
    the train steps plus the val batches plus the setup probe; the render
    is split into its confmap part (kernel 4, held against its plain
    version) and its class-map part (plain per-instance confmaps, then the
    max over each class's instances), with the class-map render's peak
    device memory.
18. Multi-class centered-instance training end to end: phase 11 with the
    classes: a class-vectors head (1 dense layer of 64 units on the
    globally max-pooled bottleneck) beside the confmaps, on 256x256 crops,
    with the epoch-end evaluation; ``class_accuracy`` must be in every
    epoch's logs. No kernel may launch.
19. Identity models from model directories: ``run.predict`` from phase
    17's dir (multi-class bottom-up: 9 + 1 launches per batch) and from
    phase 7's centroid dir with phase 18's (multi-class top-down: 18 + 1)
    over phase 13's 20 frames, bf16, batch 8. ``Labels`` must hold exactly
    the raw outputs' instances, each with the ``Track`` of its class, and
    no frame may hold two instances of one track. Then narrow identity
    dirs trained on the CPU predict phase 14's frames on the card and on
    the CPU in f32: validity and NaN placement exact, keypoints to 1e-4 px,
    class probabilities to 1e-5, and the class assignments equal on every
    frame whose rows all clear the bf16 step between their best and
    second-best class probability (the frames left out are counted).
20. Predict from video files: phase 4's 20 frames written into an MJPG
    ``.avi`` (OpenCV's own encoder) and a 100-frame 320x560 MJPG clip cut
    from them (the size of the reference's published ``small_robot.mp4``
    rows, predicted at that size), and, where cv2 lists FFmpeg, an
    ``mp4v`` ``.mp4`` of the 20 frames (top-down only). ``run.predict``
    reads each by name, bf16, batch 8 at 1024 and 4 at 320x560, peak
    threshold -1e9: the top-down pair of phases 7 + 11, the bottom-up dir
    of phase 10 and phase 7's centroid dir (``centroid_only``,
    ``centroid_output="both"``) on both clips, the identity dirs of phases
    17 and 7 + 18 on the 1024 clip. Launch counters per batch must read
    18 + 1 (top-down), 9 + 1 + 1 (bottom-up), 9 + 1 (centroid-only and
    multi-class bottom-up) and 18 + 1 (multi-class top-down). On each
    path's uncounted first batch, every kernel call at a shape not held
    before (the 320x560 clip's 4x320x576 centroid UNet among them) is
    held against its plain version on the same inputs, at phase 3's
    tolerances. Each path's ``Labels`` from the file must equal, bit for
    bit, those of the same dirs on the clip decoded into memory through
    the port's ``Video`` first; the centroid-only ones hold one
    ``PredictedCentroid`` per one-node instance. Prints cv2's version and whether it lists FFmpeg,
    and per path frames/s from the file beside frames/s from memory and
    the provider thread's decode ms per frame, with the card's name and
    power limit.
21. Video files, the card against the CPU: phase 14's narrow dirs on a
    24-frame MJPG clip of phase 16's animals, ``run.predict`` in f32 on
    both devices (counts, validity and NaN placement exact, keypoints to
    1e-4 px, peak values to 1e-5), each run at the lowest centroid
    threshold from 0.5 up that clears the near-ties of these weak
    models' maps, found on the card's and the CPU's maps with an f64
    witness (logged with whether the devices agree at 0.5; both f32 maps
    must lie within 1e-5 of f64): top-down with ``host_resize`` at
    ``input_scale`` 0.5 (the frames each side copies to the device equal,
    at 64x64), centroid-only, and the centroid model with its head swapped
    in (``head_ckpt_path``) from a second narrow centroid dir, the first
    trained 3 steps more from another seed on other labels; a pair given
    that one-model source raises ``ValueError`` as in the JAX package.
22. Training from a video file and the trainer options, at full width
    (UNet medium_rf, 1024x1024, batch 4, a few steps each): labels whose
    ``Video`` is an MJPG clip written as phase 20 writes its clips (the
    frames decode through ``MediaVideoBackend``) train a centroid model
    through ``run_training`` with the post-training evaluation, which
    predicts every local maximum (threshold -1e9; the models have trained
    3 steps); each ``metrics.{split}.0.npz`` must equal ``run_evaluation``
    of the same predictions, and the model dir's ``.slp`` files (the port's
    own HDF5 writer; the card machine has no h5py) must read back equal to
    the splits and to the recorded predictions. Then, on
    the card: resume for one epoch (parameters equal to ``best.ckpt`` bit
    for bit before the first step, the epoch count carried on); the
    backbone taken from phase 7's centroid dir (equal to it; the head
    not); ``save_top_k=2`` (two epoch-stamped checkpoints); bottom-up
    training with negative frames (kernel 4 renders their empty maps;
    their sample weights equal ``negative_loss_weight``); centroid
    training with frames that carry user centroids only; and AMSGrad, 3
    steps on the card against the CPU as in phase 8. Kernel 4's launches
    are counted on each of these trainings.
23. The command line at full width, in-process through
    ``sleap_nn_tpu_torch.cli.main`` (launches counted per command; every
    kernel call at each new signature recorded, kernel 4 included, and
    held against its plain version at phase 3's tolerances): ``train``
    from a YAML of phase 22's medium_rf centroid config whose
    ``train_labels_path`` / ``val_labels_path`` are ``.slp`` files the
    port wrote of phase 22's clip, with ``trainer_config.max_epochs=1`` as
    an override (the model dir's ``.slp`` files must read back equal to
    the splits and the recorded predictions); ``predict`` of phase 13's
    top-down dirs from an MJPG clip of phase 4's frames to ``.slp`` (bf16,
    batch 8) and to an analysis HDF5 file, and ``track`` of phase 10's
    bottom-up dir (kernel 3), each read back by the port's reader equal to
    ``run.predict`` in-process with the kwargs the command passed;
    ``track-only``; ``eval`` (its JSON line equal to ``run_evaluation``'s
    summary); ``info``; and ``python -m sleap_nn_tpu_torch.cli system``
    as a subprocess, which must exit 0 and name the card. Then
    ``save_slp`` and ``load_slp`` of a synthetic 10,000-frame predictions
    file (6 instances of 15 nodes a frame), timed on the host, the round
    trip equal (``slp_io`` line). The card machine has no h5py: every
    ``.slp`` and analysis file goes through the port's ``io/hdf5.py``.
24. Tiled predict at medium_rf width: 4 frames of 2048x2048 (a dark field
    with 6 animals of 15 blobs), tiles of 512 overlapping by 128 (25 a
    frame, snapped to the max stride 32), chunks of 16 (18 fused-conv
    launches a frame), bf16: a centroid model's ``TiledLayer`` in local
    mode (kernel 2 once on the merged ``(4, 1024, 1024, 1)`` canvases) and
    a 15-node single-instance model's in global mode through
    ``Predictor.predict``; every kernel call at each new signature held
    against its plain version at phase 3's tolerances; one frame's stage
    split (tiling, forward, merge, peaks, each fenced); narrow models on
    256x384 frames at tile 128, the card against the CPU.
25. Prediction on ground-truth centroids: ``run.predict`` with phase 11's
    centered-instance dir alone on a ``.slp`` the port wrote of phase 7's
    first 8 frames (an MJPG clip; user and predicted instances, mixed
    frames), bf16, batch 4, 6 crops a frame: the default centroids,
    ``anchor_part="n0"`` and ``only_labeled_frames``, each slot held to
    the source (centroid, validity, the source's score as the instance
    score) and each kernel-1 call on the ``(24, 256, 256, .)`` crops held;
    the top-down stage 2 on the same centroids equal bit for bit; ``cli
    predict --anchor_part`` and ``--only_labeled_frames`` equal to
    ``run.predict`` with the kwargs they passed; phase 14's narrow
    centered-instance dir alone, the card against the CPU.
26. Tiled training: bottom-up medium_rf on 8 noise frames of 2048x2048
    (6 / 2, 1-6 instances of 15 nodes), 4 tiles of 512 and the
    ``full_frame_pass`` slot a frame, rotation on (tiles cut 725 wide and
    cropped back after it), batch 4, 2 epochs of ``tiling.steps_per_epoch``
    5: kernel 4 launches = train steps + val batches + 1 probe, each call
    at a new signature held; steps/s and peak memory. Then a narrow tiled
    centroid training through the disk cache
    (``torch_dataset_cache_img_disk``), 3 steps on the card against the
    CPU; its ``.npy`` files are there during training and gone after it.
27-30. The other backbones and SLEAP v1 model dirs, through ``run.predict``
    from dirs written with random weights at published widths (20 frames of
    1024x1024 with 6 animals of 15 blobs, batch 8, bf16, every local peak
    counted): top-down with ConvNeXt tiny for both stages (27; kernel 2 once
    a batch, no kernel 1: the fused conv runs in UNet backbones only, as in
    JAX), bottom-up with SwinT tiny, window 7 (28; kernels 2 and 3 once a
    batch), single-instance with each pretrained built-in, ConvNeXtV2-tiny,
    ResNet-50, Swinv2-tiny and DINOv2-small, at random init since no
    snapshot is there (29; the HF import must warn; no kernel: global
    peaks), and a SLEAP v1 top-down pair at the importer's default widths,
    its ``best_model.h5`` written by the port's own HDF5 writer (30; kernel
    1 14 a batch, kernel 2 once). Every kernel call at each new signature
    is held against its plain version at phase 3's tolerances; frames/s
    and launches on the ``backbone_predict`` line. Then narrow conditioned
    dirs of each path (the CPU tests' widths, 128x128 blob frames) run on
    the card and on the CPU in f32 and must agree as phase 14's
    (``backbone_card_vs_cpu`` line).
31. Training with the other backbones at published widths
    (``run_backbone_training``, ``backbone_training`` line): ConvNeXt tiny
    centroid with the epoch-end evaluation (kernel 4 in every render,
    kernel 2 in the evaluation), SwinT tiny bottom-up (kernel 4 and the PAF
    render) and a pretrained ResNet-50 single-instance model whose encoder
    loads from a local HF snapshot the phase writes, ``freeze: true`` (the
    encoder and every ``FrozenBatchNorm`` buffer bit-identical after
    training; every other leaf moved, but SwinT's patch-embedding and
    stage-0 biases that an inf Adam second moment stopped), on 1024x1024
    frames of phase 27's animals, batch 4, f32, 2 epochs of 3 steps;
    launches counted, each new kernel signature held
    against its plain version; steps/s, peak memory and stage times of each
    model; then ``run.predict`` from each trained dir (kernels 2 and 3 on
    SwinT's).
32. Narrow ConvNeXt, SwinT and pretrained ConvNeXtV2 (frozen), Swinv2 and
    ViT trainings, 3 steps on the card and on the CPU from the same weights,
    held as phase 8 holds the UNet, but for at most 1% of the parameter
    elements, whose gradients the card misses by a tenth of their own
    (``backbone_train_card_vs_cpu`` line).
33. DDP (``check_ddp``, ``ddp`` line): phase 8's narrow centroid model, 3
    steps with a padded batch, as 2 gloo ranks on the one card in a group
    the phase makes (two processes) and as 1 NCCL rank joined through the
    launch variables, each against one process; rank 0 alone writes the
    model dir; steps/s of each (one card: correctness, not scaling).
34. Bottom-up segmentation predict (``run_segmentation_predict``,
    ``segmentation_predict`` line): ``run.predict`` from a full-width dir
    (UNet medium_rf; foreground, instance-centre and centre-offset heads
    at stride 2; random weights from a seed, the foreground and centre
    heads' biases calibrated on two frames so that about 30% of the
    pixels are foreground and about 8 centres a frame clear the
    threshold) over 20 frames of 1024x1024 animals on their noise floor,
    batch 8, bf16, ``max_instances`` 50: at ``center_nms_kernel`` 3, then
    at 5 with the fragment merge, ``distance_gate_alpha`` 2 and
    ``mask_output="both"`` (8 frames). Launches 9 (kernel 1) and 1 (kernel
    2) a batch; kernel 2 held against its plain version on the real centre
    heatmap at k = 3 and 5, and every other new kernel signature too; the
    ``Labels`` hold the first batch's raw masks; frames/s and the ms of
    each stage (preprocess, UNet, centre peaks, offset grouping, device
    total, copy to the host, host clean-up and merge).
35. Semantic segmentation predict (9 launches of kernel 1 a batch) and
    top-down segmentation predict (a medium_rf centroid model and a
    centered-instance segmentation model on crops of 256, ``max_instances``
    6: 18 + 1 a batch, kernel 1 held at the crop batch's shapes), as
    phase 34.
36. Training the three segmentation types (``run_segmentation_training``,
    ``segmentation_training`` line): ``ModelTrainer.train`` of each at
    medium_rf width on 12 frames of 1024x1024 (4 val), batch 4, f32,
    geometric augmentation, 2 epochs of 5 steps, with the epoch-end
    ``val/fg_iou``; no kernel launches. Then from each dir (top-down beside
    phase 35's centroid dir): ``run.predict`` with tracking (masks and mask
    IoU) to an ``.slp`` with masks and polygons, ``load_slp`` back (masks
    bit-identical), ``run_evaluation`` (``mask``, or ``semantic``) against
    the val frames' rendered masks. Steps/s, peak memory, step stage times,
    the predict, save, load and evaluation seconds.
37. Narrow f32 segmentation layers of the three types, the card against
    the CPU (``check_segmentation_against_cpu``,
    ``segmentation_card_vs_cpu`` line): maps to 1e-4, validity exact,
    masks under the threshold-margin rule (a pixel may differ only where
    the CPU's foreground lies within 1e-5 of the threshold, at most 0.1%
    of the mask); the host step fed the same device outputs gives the
    same masks, polygons and mask tracks on both.

38. Training with the monitors (``run_monitored_training``, line
    ``monitored_training_<type>``): phase 7's centroid and phase 10's
    bottom-up trainings with the ZMQ publisher (events received on a
    localhost SUB socket, in the JAX package's order), the ZMQ controller
    (``set_lr`` and ``stop`` sent from a localhost PUB socket: the learning
    rate from the next epoch on, the stop at its batch), the viz PNGs (the
    val sample's render through kernel 4, its peaks through kernel 2), the
    local wandb run and a ``torch.profiler`` trace whose device events name
    kernels 4 and 2 as often as they launched; steps/s beside the same
    trainings without the monitors. The ``monitor_imports`` line says which
    optional packages import here; a monitor whose package is absent is
    named there and left out (without matplotlib the viz's device half
    still runs each epoch: its render and kernel 2, no PNG). The ``wandb``
    package is blocked for the phase: the local run, no network.
39. ``run.predict`` of phase 13's top-down dirs with ``profile_dir``
    (``profiled_predict``): the trace names kernels 1 and 2 as often as
    they launched; frames/s with and without the trace.
40. Export (``run_export``, lines ``export``, ``export_kernel``): every type
    trained or built above (phases 7, 10, 11, 17, 18, 34's dirs and a
    single-instance dir) to ``model.pt2``, bf16 at batch 4 (the top-down
    and bottom-up also fp32, and bf16 at batch 8), each verified; each
    loaded program called once with the launch counters zeroed (kernels 1,
    2 and 3 launch from the loaded graph through their registered
    operators), every kernel call at a new signature held to its plain
    version; ``run.predict`` from each export dir that
    ``from_export_dir`` serves against the model dirs (counts, largest
    point distance, masks; frames/s of both).
41. The command line (``cli_export``): ``export`` of the top-down pair,
    then ``predict`` and ``track`` on the export dir from an MJPG clip, in
    process; each command's seconds.
42. Data-parallel predict (``run_data_parallel_predict``, lines
    ``data_parallel_predict``, ``data_parallel_kernel``): top-down,
    bottom-up, single-instance, multi-class bottom-up and semantic
    segmentation from the dirs above, batch 8, bf16: ``run.predict(...,
    data_parallel=True)`` over every card (one replica a card; the launch
    counts of the plain run, and its ``Labels``), then two replicas on
    ``cuda:0`` (launches doubled; bit for bit the plain predictor at batch
    4, the replica's rows; what batch 8 changes is recorded); each new
    kernel signature held to its plain version; frames/s of the three.
43. The config tooling (``run_config_tooling``, line ``config_tooling``): a
    synthetic 1024x1024 ``.slp`` (15 nodes, 1-6 instances); ``config-generate``,
    ``config --auto`` (quality and throughput presets) and ``config`` on the
    YAML written; ``train()`` without ``config_path`` from ``get_config``
    keyword arguments at the recommended widths (a centroid model, quality
    and throughput knobs, a few steps; kernel 4), its peak memory beside
    ``estimate_memory``'s total; the pipeline's centered-instance stage
    trained from each generated YAML (the throughput one at crop 128);
    ``run.predict`` of each preset's top-down pair (kernels 1 and 2, every
    call held), frames/s side by side.
44. The legacy shim (``run_legacy_shim``, line ``legacy_shim``):
    ``TopDownPredictor.from_trained_models`` on phase 7 + 11's dirs warns
    once and gives ``Predictor.from_model_paths``' ``Labels`` bit for bit.
45. SAM prompted masks (``run_sam_review``, lines ``sam_card_vs_cpu`` and
    ``sam_review``): a top-down ``run.predict`` from phase 7 + 11's dirs
    writes a pose ``.slp`` of 8 frames (kernels 1 and 2 counted, every call
    held); the script writes a random-init SAM snapshot at the published
    ViT-H widths (1280 wide, 32 layers, 16 heads, global attention at 7,
    15, 23 and 31, window 14, a 64x64 grid), runs ``sam -i poses.slp
    --mask-backend sam_jax --sam-model-id SNAPSHOT --overlay-path ...`` in
    process (float32) and ``JaxSamBackend(use_bf16=True)`` on the same
    frames; one mask a prompted instance, the poses kept, the
    ``.masks.slp`` read back equal, the overlay written, a 4-layer witness
    (the last global) card against CPU, bf16 IoU scores near float32's.
    Prints the encoder, decode and host ms a frame, the command's frames/s
    and the peak device memory.

46. Remote inputs and the top-level API (``run_remote_and_api``, line
    ``remote_and_api``): an MJPG clip of 16 smoke frames and a ``.slp`` of
    its top-down predictions, served by ``http.server`` on 127.0.0.1 in a
    thread, through ``sleap_nn_tpu_torch.predict`` of phase 7 + 11's dirs
    (bf16, batch 8) from ``http://`` with a header and from ``file://``:
    ``Labels`` bit for bit the local path's, the header seen by the
    server, the downloads removed at exit (a subprocess leaves none);
    ``load_models`` against ``Predictor.from_model_paths`` (outputs bit for
    bit); ``PAFScorer.from_config`` of phase 10's dir on one batch's
    scoring inputs, equal to the layer's own grouping. Launches 18 and 1 a
    top-down batch, kernel 3 once for ``PAFScorer.predict``; every kernel
    call held to its plain version; frames/s from each source and the
    download ms.
47. The subpackages' re-exports and masks through the geometric
    augmentation (``run_mask_augmentation``, line ``mask_augmentation``):
    every name of ``sleap_nn_tpu_torch.{config,io,ops,models,data}.__all__``
    is its port module's own object; ``apply_geometric_augmentation`` with
    6 instance masks (uint8 and f32) on a batch of 4 1024x1024 frames,
    flipped, rotated, scaled and moved half a pixel, on the card and on the
    CPU given the same drawn values: masks equal but at counted ties of the
    nearest rounding, images within 1e-5 (4 ulps of a coordinate on the
    one-pixel ramp to the zero padding), no port kernel launched. Prints
    ``warp_image``'s ms a call, nearest and bilinear.

Phase 3 also holds kernel 4 (multi-instance confmaps) against its plain
version at the centroid training shape (4, 6, 1, 2) -> (4, 512, 512, 1)
and the bottom-up one (4, 6, 15, 2) -> (4, 512, 512, 15), and at the
latter with no point and with far points, to 1e-6 with zeros placed
exactly, and reports the share of tiles and terms its cull keeps, as the
kernel counts them (held to the host model of the cull's rule); and
checks that the fused conv refuses a call under autograd. After phase 8 it
breaks the bottom-up ``paf_scoring`` stage down into its parts
(``torch.profiler`` where it sees the device), last so that the profiler
cannot slow the timed phases.

Prints one ``kernels`` JSON line and, last, ``{"ok": true, "device": ...}``.
Without a CUDA device, or without the port package beside it, it exits 1
and prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PEAK_BF16 = 989e12  # dense bf16 tensor-core FLOP/s, H100 SXM data sheet
PEAK_F32 = 67e12    # f32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3 bytes/s
IMG, BATCH, N_FRAMES, CROP, MAX_INST, N_NODES = 1024, 8, 20, 256, 6, 15
# Bottom-up skeleton: a branched tree over 15 nodes (edges whose nodes
# exist are kept when a CPU rehearsal sets fewer nodes).
TREE = ((0, 1), (1, 2), (0, 3), (3, 4), (0, 5), (5, 6), (0, 7), (7, 8), (0, 9), (9, 10),
        (2, 11), (2, 12), (4, 13), (4, 14))
MAX_PEAKS, K_PER_NODE, N_POINTS, MIN_LINE = 200, 20, 10, 0.25  # the JAX package's defaults
DEVICE = "cuda"  # a rehearsal on the CPU sets "cpu" and small sizes, then calls the phases
# Phase 7: frames (train + val), their size, batch, epochs x steps, lr.
TRAIN_FRAMES, VAL_FRAMES, TRAIN_IMG, TRAIN_BATCH, TRAIN_EPOCHS, TRAIN_STEPS = 20, 4, 1024, 4, 2, 5
N_CLASSES = 6  # identity models: one track per animal of a full frame


def sync() -> None:
    import torch

    if DEVICE != "cpu":
        torch.cuda.synchronize()


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean device ms of ``fn`` over ``reps`` calls, after one warm-up call."""
    import torch

    fn()
    if DEVICE == "cpu":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(launch, reps: int = 20) -> float:
    """Mean device ms of one ``launch`` call: ``reps`` calls captured in one
    CUDA graph, the graph replayed 5 times between two events. The host's
    per-call work (argument checks, allocation, the ctypes call) is not
    timed. ``launch`` must issue its work on the current stream."""
    import torch

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            launch()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def bound(flops: float, nbytes: float, peak_flops: float):
    """(least ms, what bounds it) for ``flops`` at ``peak_flops`` and ``nbytes`` at HBM rate."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def bf16_ulp(m: float) -> float:
    """Spacing of bf16 values at magnitude ``m`` (8 significant bits)."""
    return float(2.0 ** (np.floor(np.log2(max(m, 1e-30))) - 7))


# --------------------------------------------------------------------------
# Models of the top-down path
# --------------------------------------------------------------------------


class ArrayVideo:
    """In-memory video: ``__len__`` and ``get_frame(idx, fmt)`` for the
    predictor; ``video[idx]`` and ``.shape`` for the labels model."""

    def __init__(self, frames):
        self.frames = frames
        self.shape = frames.shape

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, idx):
        return self.frames[idx]

    def get_frame(self, idx, fmt=None):
        return self.frames[idx]


def build_models(cfg_cls, n_nodes, seed, **cfg_kw):
    """Centroid + centered-instance models with random weights from ``seed``.

    Backbone convs get He-normal weights and zero biases, so activations
    keep their scale through the UNet; the 1x1 heads get weights of gain
    0.1 and a 0.5 bias. The maps then vary by about 0.1 around 0.5: a flat
    map would round to one bf16 value and hold no strict maximum, and a
    map that swings negative breaks integral refinement's mass. Centroid
    peaks clear the 0.2 threshold and stage 2 runs on real crops.
    """
    import torch
    from types import SimpleNamespace as ns

    from sleap_nn_tpu_torch.models.model import Model

    cfg = cfg_cls(in_channels=1, output_stride=2, **cfg_kw)
    torch.manual_seed(seed)
    centroid = Model.from_config("unet", cfg, ns(confmaps=ns(
        anchor_part=None, sigma=5.0, output_stride=2, loss_weight=None)), "centroid")
    instance = Model.from_config("unet", cfg, ns(confmaps=ns(
        part_names=[f"n{i}" for i in range(n_nodes)], anchor_part=None, sigma=3.0,
        output_stride=2, loss_weight=None)), "centered_instance")
    random_init(centroid, instance)
    return cfg, centroid, instance


def random_init(*models):
    """He-normal backbone convs with zero biases; 1x1 heads of gain 0.1, bias 0.5."""
    import torch
    from torch import nn

    with torch.no_grad():
        for m in models:
            for conv in m.backbone.modules():
                if isinstance(conv, (nn.Conv2d, nn.ConvTranspose2d)):
                    nn.init.kaiming_normal_(conv.weight, nonlinearity="relu")
                    nn.init.zeros_(conv.bias)
            for layer in m.head_layers:
                for head in layer.values():
                    nn.init.normal_(head[0].weight, std=0.1 * head[0].in_channels ** -0.5)
                    head[0].bias.fill_(0.5)


def build_layer(cfg, centroid, instance, device, use_bf16, crop, max_inst):
    from sleap_nn_tpu_torch.inference.backends import TorchBackend
    from sleap_nn_tpu_torch.inference.layers import (
        CenteredInstanceLayer, CentroidLayer, PostprocessConfig, PreprocessConfig, TopDownLayer)

    pre = PreprocessConfig(ensure_grayscale=True, max_stride=cfg.max_stride)
    kw = dict(use_bf16=use_bf16, output_dtype=None, device=device)
    c_layer = CentroidLayer(TorchBackend(centroid, None, **kw), pre,
                            PostprocessConfig(peak_threshold=0.2, max_instances=max_inst),
                            output_stride=2, device=device)
    i_layer = CenteredInstanceLayer(TorchBackend(instance, None, **kw), pre,
                                    PostprocessConfig(peak_threshold=0.2),
                                    output_stride=2, device=device)
    return TopDownLayer(c_layer, i_layer, max_instances=max_inst, crop_size=crop,
                        device=device)


def bottomup_edges(n_nodes):
    return [e for e in TREE if max(e) < n_nodes]


def build_bottomup_model(cfg_cls, n_nodes, seed, frames, **cfg_kw):
    """A bottom-up model (confmaps at stride 2, PAFs at stride 4, the strides
    the JAX package's config generator writes) with random weights from
    ``seed``, initialised as in :func:`build_models`: the 0.5 head biases put
    confmap peaks above the threshold and PAF vectors at (0.5, 0.5), so
    lines that run right or down score above ``MIN_LINE``.

    Random heads give each confmap channel its own offset and spread, and
    the per-sample top-K of local peaks would then come from one or two
    channels. So the confmap head is moved per channel, on ``frames``: the
    median to 0.5 and the (max_peaks / n_nodes)-th highest local peak of a
    sample to 0.9 (mean over samples), and every node gets its share.
    """
    import torch
    from types import SimpleNamespace as ns

    from sleap_nn_tpu_torch.inference.layers import PreprocessConfig, preprocess_images
    from sleap_nn_tpu_torch.models.model import Model
    from sleap_nn_tpu_torch.ops.kernels import nms_scores

    cfg = cfg_cls(in_channels=1, output_stride=2, **cfg_kw)
    names = [f"n{i}" for i in range(n_nodes)]
    torch.manual_seed(seed)
    model = Model.from_config("unet", cfg, ns(
        confmaps=ns(part_names=names, sigma=2.5, output_stride=2, loss_weight=None),
        pafs=ns(edges=[(names[s], names[d]) for s, d in bottomup_edges(n_nodes)],
                sigma=15.0, output_stride=4, loss_weight=None)), "bottomup")
    random_init(model)
    model.to(DEVICE)
    head = model.head_layers[0]["MultiInstanceConfmapsHead"][0]
    with torch.no_grad():
        x, _ = preprocess_images(PreprocessConfig(ensure_grayscale=True, max_stride=cfg.max_stride),
                                 torch.from_numpy(frames).to(DEVICE))
        cms = model(x)["MultiInstanceConfmapsHead"].contiguous()
        peaks = nms_scores(cms, -1e9).permute(0, 3, 1, 2).flatten(2)  # (B, C, H*W)
        top = peaks.topk(MAX_PEAKS // n_nodes, dim=-1).values[..., -1].mean(dim=0)
        median = cms.flatten(0, 2).median(dim=0).values
        gain = 0.4 / (top - median)
        head.weight.mul_(gain[:, None, None, None])
        head.bias.copy_((head.bias - median) * gain + 0.5)
    return cfg, model


def build_bottomup_layer(cfg, model, device, use_bf16, max_inst):
    from sleap_nn_tpu_torch.inference.backends import TorchBackend
    from sleap_nn_tpu_torch.inference.layers import (
        BottomUpLayer, PostprocessConfig, PreprocessConfig)
    from sleap_nn_tpu_torch.inference.paf_grouping import PAFScorer

    cm_head, paf_head = model.heads
    scorer = PAFScorer(cm_head.part_names, paf_head.edges, pafs_stride=paf_head.output_stride,
                       n_points=N_POINTS, min_line_scores=MIN_LINE, k_per_node=K_PER_NODE)
    post = PostprocessConfig(peak_threshold=0.2, max_peaks=MAX_PEAKS, max_instances=max_inst,
                             k_per_node=K_PER_NODE, n_points=N_POINTS, min_line_scores=MIN_LINE)
    return BottomUpLayer(
        TorchBackend(model, None, use_bf16=use_bf16, output_dtype=None, device=device),
        PreprocessConfig(ensure_grayscale=True, max_stride=cfg.max_stride), post, scorer,
        cm_output_stride=cm_head.output_stride, device=device)


def smoke_frames():
    """The end-to-end phases' 20 synthetic uint8 frames."""
    return np.random.default_rng(0).integers(0, 256, (N_FRAMES, IMG, IMG, 1), dtype=np.uint8)


def fused_shapes(model, batch: int, size: int):
    """(name, x shape, conv0, conv1) of every fused double-conv call of one forward."""
    bb = model.backbone
    out = []
    for b, blk in enumerate(bb.encoders[0].encoder_stack):
        c0, c1 = list(blk.blocks.values())
        s = size >> b
        out.append((f"enc{b}", (batch, s, s, c0.in_channels), c0, c1))
    dec = bb.decoders[0]
    for b, blk in enumerate(dec.decoder_stack):
        c0, c1 = list(blk.blocks.values())[-2:]
        s = size // dec.strides[b]
        out.append((f"dec{b}", (batch, s, s, c0.in_channels), c0, c1))
    return out


# --------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# --------------------------------------------------------------------------


def sass_tensor_ops(kernel):
    """Counts of tensor-core instructions (HMMA, HGMMA) in a built kernel's
    SASS, from ``cuobjdump -sass``; None where the toolkit has no cuobjdump."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    sass = subprocess.run([tool, "-sass", str(kernel.library)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    return {name: len(re.findall(rf"\b{name}\.", sass)) for name in ("HMMA", "HGMMA")}


def check_fused(layer, rng):
    import torch
    import torch.nn.functional as F

    from sleap_nn_tpu_torch.models.encoder_decoder import hwio
    from sleap_nn_tpu_torch.ops.fused_conv import (
        _launch, _pack, _packed, _plain_double_conv, fused_double_conv3x3, plan_tiles)

    c_model = layer.centroid_layer.backend.model
    i_model = layer.instance_layer.backend.model
    calls = ([("centroid", *s) for s in fused_shapes(c_model, BATCH, IMG)]
             + [("instance", *s) for s in fused_shapes(i_model, BATCH * MAX_INST, CROP)])
    f32_checks = {("centroid", n) for n in ("enc0", "enc4", "dec0", "dec3")}
    rows = []
    for model_name, name, shape, c0, c1 in calls:
        for dtype in (torch.bfloat16, torch.float32):
            if dtype == torch.float32 and (model_name, name) not in f32_checks:
                continue
            # Inputs as the path sees them: an image in [0, 1), else ReLU features.
            x = rng.random(shape, dtype=np.float32) if shape[-1] == 1 else \
                np.maximum(rng.standard_normal(shape, dtype=np.float32), 0)
            x = torch.from_numpy(x).to(DEVICE, dtype)
            # Detached: the fused kernel has no backward and refuses autograd inputs.
            w1, b1 = hwio(c0.weight).detach().to(dtype), c0.bias.detach().to(dtype)
            w2, b2 = hwio(c1.weight).detach().to(dtype), c1.bias.detach().to(dtype)
            got = fused_double_conv3x3(x, w1, b1, w2, b2)
            want = _plain_double_conv(x, w1, b1, w2, b2)
            sync()
            err = (got.float() - want.float()).abs().max().item()
            top = want.float().abs().max().item()
            tol = bf16_ulp(top) if dtype == torch.bfloat16 else 1e-4 * top
            bsz, h, w, cin = shape
            cmid, cout = c0.out_channels, c1.out_channels
            itemsize = 2 if dtype == torch.bfloat16 else 4
            flops = 2.0 * bsz * h * w * 9 * (cin * cmid + cmid * cout)
            nbytes = (bsz * h * w * (cin + cout) + 9 * (cin * cmid + cmid * cout)) * itemsize \
                + 4 * (cmid + cout)
            bound_ms, bound_by = bound(flops, nbytes,
                                       PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32)
            xc = x.permute(0, 3, 1, 2)
            wc1 = c0.weight.detach().to(dtype).contiguous(memory_format=torch.channels_last)
            wc2 = c1.weight.detach().to(dtype).contiguous(memory_format=torch.channels_last)
            wrapper_ms = cuda_ms(lambda: fused_double_conv3x3(x, w1, b1, w2, b2))
            if DEVICE == "cpu":  # a rehearsal has no kernel to launch
                kernel_ms = wrapper_ms
            else:
                # The kernel alone: pre-packed weights, a preallocated output, in a graph.
                pw1, pw2 = _packed(w1, b1, dtype), _packed(w2, b2, dtype)
                out = torch.empty_like(got)
                kernel_ms = graph_ms(lambda: _launch(x, pw1, pw2, out, cmid, "relu"))
                if not torch.equal(out, got):
                    raise AssertionError(f"fused_double_conv3x3: the timed graph differs at {name}")
            plan = plan_tiles(*shape, cmid, cout) if dtype == torch.bfloat16 else None
            row = dict(
                model=model_name, block=name, dtype=str(dtype).split(".")[-1],
                x=list(shape), c_mid=cmid, c_out=cout, max_abs_err=err, tol=tol,
                err_ulps=err / bf16_ulp(top) if dtype == torch.bfloat16 else None,
                frac_diff=(got != want).float().mean().item(), ok=bool(err <= tol),
                tile=[plan.tile_h, plan.tile_w] if plan else [8, 16],
                smem_bytes=plan.smem_bytes if plan else None,
                kernel_ms=kernel_ms, wrapper_ms=wrapper_ms,
                pack_ms=cuda_ms(lambda: (_pack(w1, b1, dtype), _pack(w2, b2, dtype))),
                plain_ms=cuda_ms(lambda: _plain_double_conv(x, w1, b1, w2, b2), reps=2),
                library_ms=cuda_ms(lambda: F.relu(F.conv2d(
                    F.relu(F.conv2d(xc, wc1, b1, padding=1)), wc2, b2, padding=1))),
                bound_ms=bound_ms, bound_by=bound_by, flops=flops, bytes=nbytes,
                tflops=flops / kernel_ms / 1e9,
            )
            log("fused_double_conv3x3 " + json.dumps(row))
            rows.append(row)
            del x, got, want
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"fused_double_conv3x3 disagrees with its plain version: {bad}")
    return rows


def check_nms(rng, channels=1, ks=(3, 5)):
    import torch

    from sleap_nn_tpu_torch.ops.kernels import NMS_SCORES, _plain_nms_scores, nms_scores

    rows = []
    shape = (BATCH, IMG // 2, IMG // 2, channels)
    base = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(DEVICE)
    for dtype in (torch.bfloat16, torch.float32):
        cms = base.to(dtype)
        for k in ks:
            got = nms_scores(cms, 0.2, kernel=k)
            want = _plain_nms_scores(cms, 0.2, kernel=k)
            sync()
            same = torch.equal(got, want)
            itemsize = 2 if dtype == torch.bfloat16 else 4
            n = cms.numel()
            bound_ms, bound_by = bound(float(n * k * k), n * (itemsize + 4), PEAK_F32)
            wrapper_ms = cuda_ms(lambda: nms_scores(cms, 0.2, kernel=k), reps=20)
            if DEVICE == "cpu":  # a rehearsal has no kernel to launch
                kernel_ms = wrapper_ms
            else:
                # The kernel alone: its C entry into a preallocated output, in a graph.
                out = torch.empty_like(got)
                kernel_ms = graph_ms(lambda: NMS_SCORES.launch(
                    cms.data_ptr(), out.data_ptr(), *shape, k, 0.2,
                    int(dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream))
                if not torch.equal(out, got):
                    raise AssertionError("nms_scores: the timed graph differs")
            row = dict(dtype=str(dtype).split(".")[-1], x=list(shape), kernel=k,
                       exact=same, n_peaks=int(torch.isfinite(got).sum()),
                       max_abs_err=0.0 if same else float("inf"),
                       kernel_ms=kernel_ms, wrapper_ms=wrapper_ms,
                       plain_ms=cuda_ms(lambda: _plain_nms_scores(cms, 0.2, kernel=k), reps=5),
                       library_ms=None, bound_ms=bound_ms, bound_by=bound_by)
            log("nms_scores " + json.dumps(row))
            rows.append(row)
    if not all(r["exact"] for r in rows):
        raise AssertionError(f"nms_scores differs from its plain version: {rows}")
    return rows


def paf_inputs(layer, frames):
    """The bottom-up path's own PAFs, grouped peaks and mask for one batch."""
    import torch

    from sleap_nn_tpu_torch.inference.layers import preprocess_images
    from sleap_nn_tpu_torch.inference.paf_grouping import group_peaks_by_node
    from sleap_nn_tpu_torch.ops.peaks import find_local_peaks

    post, scorer = layer.post, layer.paf_scorer
    with torch.inference_mode():
        x, _ = preprocess_images(layer.pre, torch.from_numpy(frames).to(DEVICE))
        preds = layer.backend(x)
        pts, vals, chans, valid = find_local_peaks(
            preds[layer.cm_head], threshold=post.peak_threshold, refinement=post.refinement,
            integral_patch_size=post.integral_patch_size, max_peaks=post.max_peaks)
        gp, _, mask = group_peaks_by_node(pts * layer.cm_output_stride, vals, chans, valid,
                                          scorer.n_nodes, scorer.k_per_node)
    return preds[layer.paf_head], gp, mask


def check_paf(layer, frames):
    import torch

    from sleap_nn_tpu_torch.inference.paf_grouping import line_fractions
    from sleap_nn_tpu_torch.ops.kernels import (
        _launch_paf_line_scores, _plain_paf_line_scores, paf_line_scores, paf_line_subscripts)

    scorer = layer.paf_scorer
    pafs, gp, mask = paf_inputs(layer, frames)
    b, hp, wp, _ = pafs.shape
    edges = torch.tensor(scorer.edge_inds, dtype=torch.int32, device=DEVICE)
    t = line_fractions(scorer.n_points, DEVICE)
    max_len = scorer.max_edge_length_ratio * max(hp, wp, 2 * scorer.n_edges) * scorer.pafs_stride
    src, dst = gp[:, edges[:, 0].long()], gp[:, edges[:, 1].long()]
    ys, xs = paf_line_subscripts(src, dst, t, scorer.pafs_stride, hp, wp)
    b_idx = torch.arange(b, device=DEVICE)[:, None, None, None, None]
    e_idx = torch.arange(scorer.n_edges, device=DEVICE)[None, :, None, None, None]
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        p = pafs.to(dtype).contiguous()
        args = (p, gp, mask, edges, t, scorer.pafs_stride, max_len, scorer.dist_penalty_weight)
        got = paf_line_scores(*args)
        want = _plain_paf_line_scores(*args)
        sync()
        fin = torch.isfinite(want)
        err = (got[fin] - want[fin]).abs().max().item() if fin.any() else 0.0
        placed = bool(torch.equal(torch.isneginf(got), torch.isneginf(want))
                      and torch.equal(torch.isnan(got), torch.isnan(want)))
        # This run's data: a pair with an invalid end loads nothing.
        n_pairs = int((~torch.isneginf(want)).sum())
        itemsize = p.element_size()
        nbytes = (n_pairs * scorer.n_points * 2 * itemsize + gp.numel() * 4 + mask.numel()
                  + got.numel() * 4)
        flops = n_pairs * (10.0 * scorer.n_points + 10.0)
        bound_ms, bound_by = bound(flops, nbytes, PEAK_F32)
        wrapper_ms = cuda_ms(lambda: paf_line_scores(*args), reps=20)
        if DEVICE == "cpu":  # a rehearsal has no kernel to launch
            kernel_ms = wrapper_ms
        else:
            # The kernel alone: its C entry into a preallocated output, in a graph.
            out = torch.empty_like(got)
            kernel_ms = graph_ms(lambda: _launch_paf_line_scores(
                p, gp, mask, edges, t, out, scorer.pafs_stride, max_len,
                scorer.dist_penalty_weight))
            if not torch.equal(out.nan_to_num(), got.nan_to_num()):
                raise AssertionError("paf_line_scores: the timed graph differs")
        row = dict(
            dtype=str(dtype).split(".")[-1], pafs=list(p.shape), peaks=list(gp.shape),
            scores=list(got.shape), peaks_per_node=mask.sum(dim=-1).float().mean(dim=0).tolist(),
            valid_pairs=n_pairs, finite_scores=int(fin.sum()),
            above_min_line=int((want >= MIN_LINE).sum()), max_abs_err=err, tol=1e-5,
            inf_nan_placement_exact=placed, ok=bool(placed and err <= 1e-5),
            kernel_ms=kernel_ms, wrapper_ms=wrapper_ms,
            plain_ms=cuda_ms(lambda: _plain_paf_line_scores(*args), reps=5),
            # Covers only the sampling the TPU kernel did, not the scoring.
            gather_ms=cuda_ms(lambda: (p[b_idx, ys, xs, 2 * e_idx],
                                       p[b_idx, ys, xs, 2 * e_idx + 1]), reps=5),
            library_ms=None, bound_ms=bound_ms, bound_by=bound_by, flops=flops, bytes=nbytes,
        )
        log("paf_line_scores " + json.dumps(row))
        rows.append(row)
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"paf_line_scores disagrees with its plain version: {bad}")
    if not all(r["above_min_line"] > 0 for r in rows):
        raise AssertionError("no pair scores above min_line_scores: the smoke maps are degenerate")
    return rows


def paf_scoring_breakdown(layer, frames):
    """Where the bottom-up ``paf_scoring`` stage's time goes, on one batch:
    ms per call, each call fenced by ``synchronize()`` (the stage's own
    clock), of the stage as the path runs it (``PAFScorer.score_lines``,
    device ``t`` cached), of ``score_paf_lines_dense`` building ``t`` anew,
    and of each part alone; the wrapper's host ms per call unfenced; and,
    where ``torch.profiler`` sees the device, its per-op totals."""
    import torch

    from sleap_nn_tpu_torch.inference.paf_grouping import line_fractions, score_paf_lines_dense
    from sleap_nn_tpu_torch.ops.kernels import _launch_paf_line_scores, paf_line_scores

    scorer = layer.paf_scorer
    pafs, gp, mask = paf_inputs(layer, frames)  # the PAF head's output as the layer gets it
    hp, wp = pafs.shape[1:3]
    edges, t = scorer._edge_inds_on(pafs.device), scorer._line_fractions_on(pafs.device)
    max_len = scorer.max_edge_length_ratio * max(hp, wp, 2 * scorer.n_edges) * scorer.pafs_stride
    kw = dict(n_line_points=scorer.n_points, pafs_stride=scorer.pafs_stride,
              max_edge_length_ratio=scorer.max_edge_length_ratio,
              dist_penalty_weight=scorer.dist_penalty_weight)

    def fenced_ms(fn, reps=50):
        total = 0.0
        fn()
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            total += time.perf_counter() - t0
        return total * 1e3 / reps

    def host_ms(fn, reps=200):
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host = (time.perf_counter() - t0) * 1e3 / reps
        sync()
        return host

    wrapper = lambda: paf_line_scores(pafs, gp, mask, edges, t, scorer.pafs_stride, max_len,  # noqa: E731
                                      scorer.dist_penalty_weight)
    scores = wrapper()
    with torch.inference_mode():
        out = {
            "pafs": list(pafs.shape), "pafs_dtype": str(pafs.dtype).split(".")[-1],
            "pafs_contiguous": pafs.is_contiguous(), "pafs_strides": list(pafs.stride()),
            "stage_cached_t_ms": fenced_ms(lambda: scorer.score_lines(pafs, gp, mask)),
            "stage_new_t_ms": fenced_ms(lambda: score_paf_lines_dense(pafs, gp, mask, edges, **kw)),
            "line_fractions_ms": fenced_ms(lambda: line_fractions(scorer.n_points, pafs.device)),
            "contiguous_ms": fenced_ms(pafs.contiguous),
            "wrapper_ms": fenced_ms(wrapper),
            "fence_only_ms": fenced_ms(lambda: None),
            "wrapper_host_ms": host_ms(wrapper),
            "stage_host_ms": host_ms(lambda: scorer.score_lines(pafs, gp, mask)),
            # The wrapper's parts on the host: allocating the output, asking
            # for the stream, and the ctypes call that launches.
            "host_empty_ms": host_ms(lambda: torch.empty_like(scores)),
            "host_current_stream_ms": host_ms(lambda: torch.cuda.current_stream().cuda_stream
                                              if DEVICE != "cpu" else None),
        }
        if DEVICE != "cpu":
            out["host_launch_ms"] = host_ms(lambda: _launch_paf_line_scores(
                pafs, gp, mask, edges, t, scores, scorer.pafs_stride, max_len,
                scorer.dist_penalty_weight))
        if DEVICE != "cpu":
            try:
                from torch.profiler import ProfilerActivity, profile

                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for _ in range(20):
                        scorer.score_lines(pafs, gp, mask)
                    sync()
                ops = []
                for ev in prof.key_averages():
                    dev_us = getattr(ev, "self_device_time_total",
                                     getattr(ev, "self_cuda_time_total", 0.0))
                    ops.append({"name": ev.key[:60], "count": ev.count,
                                "cpu_us_per_call": ev.cpu_time_total / max(ev.count, 1),
                                "self_device_us_per_call": dev_us / max(ev.count, 1)})
                ops.sort(key=lambda o: -o["cpu_us_per_call"] * o["count"])
                out["profiler"] = ops[:12]
                out["profiler_device_us_per_stage"] = sum(
                    o["self_device_us_per_call"] * o["count"] for o in ops) / 20
            except Exception as exc:  # the profiler is a report, not a check
                out["profiler"] = f"failed: {exc!r}"
    log("paf_scoring_breakdown " + json.dumps(out))
    return out


def confmap_cases():
    """Kernel 4's cases: (name, nodes, sigma at output stride 2, points)."""
    return (("centroid_train", 1, 5.0, "uniform"), ("bottomup_train", N_NODES, 2.5, "uniform"),
            ("all_nan", N_NODES, 2.5, "all_nan"), ("far_points", N_NODES, 2.5, "far_points"))


def confmap_points(rng, n_nodes, case):
    """Training-target points (TRAIN_BATCH, MAX_INST, n_nodes, 2) of one case:
    uniform over the frame with NaN nodes and two padding instances;
    ``all_nan`` has no point at all, ``far_points`` puts most of them far
    outside the grid (one at x = +inf, whose non-finite bound keeps it)."""
    pts = rng.uniform(0, TRAIN_IMG, (TRAIN_BATCH, MAX_INST, n_nodes, 2)).astype(np.float32)
    pts[rng.random((TRAIN_BATCH, MAX_INST, n_nodes)) < 0.2] = np.nan  # NaN nodes
    pts[:, MAX_INST - 2:] = np.nan  # padding instances
    if case == "all_nan":
        pts[:] = np.nan
    if case == "far_points":
        pts[:, : MAX_INST - 3] += np.float32(3 * TRAIN_IMG)
        pts[0, MAX_INST - 3, 0] = [np.inf, 5.0]
    return pts


def needed_terms(pts, xv, yv, sigma):
    """(pixel, point) pairs whose Gaussian term is not exactly 0 in f32
    (d^2 / denom below 103.97): the terms this run's data needs."""
    import torch

    denom = 2 * sigma**2
    p = pts.reshape(-1, 2)
    p = p[torch.isfinite(p).all(dim=1)]
    total = 0
    for q in p:
        d2 = (xv[None, :] - q[0]) ** 2 + (yv[:, None] - q[1]) ** 2
        total += int((d2 < 103.97 * denom).sum())
    return total


def check_confmaps(rng):
    """Kernel 4 against its plain version at the training shapes (NaN
    instances and nodes included), and with no point and with far points:
    zeros placed exactly (0 wherever the plain version is 0, > 0 wherever
    it is >= 1e-30), the rest to 1e-6. Reports the share of tiles and terms
    that the kernel's cull keeps, as the kernel counts them, and holds the
    counts to the host model of the cull's rule."""
    import torch

    from sleap_nn_tpu_torch.ops.grid import make_grid_vectors
    from sleap_nn_tpu_torch.ops.kernels import (
        _launch_multi_confmaps, _plain_multi_confmaps, confmap_cull_counts, confmap_tile,
        multi_confmaps)

    rows = []
    for path, n_nodes, sigma, case in confmap_cases():
        pts = torch.from_numpy(confmap_points(rng, n_nodes, case)).to(DEVICE)
        xv, yv = make_grid_vectors(TRAIN_IMG, TRAIN_IMG, 2, device=DEVICE)
        args = (pts, xv, yv, sigma * 2)
        got = multi_confmaps(*args)
        want = _plain_multi_confmaps(*args)
        sync()
        err = (got - want).abs().max().item()
        zeros_exact = bool((got[want == 0] == 0).all() and (got[want >= 1e-30] > 0).all())
        wrapper_ms = cuda_ms(lambda: multi_confmaps(*args), reps=20)
        if DEVICE == "cpu":  # a rehearsal has no kernel to launch
            kernel_ms = wrapper_ms
        else:
            # The kernel alone: its C entry into a preallocated output, in a graph.
            out = torch.empty_like(got)
            kernel_ms = graph_ms(lambda: _launch_multi_confmaps(pts, xv, yv, out, sigma * 2))
            if not torch.equal(out, got):
                raise AssertionError(f"multi_confmaps: the timed graph did not render {path}")
        # What the cull keeps: tiles with a live point, and terms computed
        # (live points x the tile's pixels) against every term (I x N per
        # pixel). The kernel counts them; the host model must agree.
        model_tiles, model_terms, n_tiles = confmap_cull_counts(*args)
        if DEVICE == "cpu":  # a rehearsal has no kernel to count
            live_tiles, computed = model_tiles, model_terms
        else:
            stats = torch.zeros(2, dtype=torch.int64, device=DEVICE)
            _launch_multi_confmaps(pts, xv, yv, out, sigma * 2, stats)
            live_tiles, computed = stats.tolist()
            if not torch.equal(out, got):
                raise AssertionError(f"multi_confmaps: the counting launch differs on {path}")
        cull_as_modelled = (live_tiles, computed) == (model_tiles, model_terms)
        all_terms = got.numel() * pts.shape[1]
        needed = needed_terms(pts, xv, yv, sigma * 2)
        # This run's data: one Gaussian term per (pixel, point) it reaches.
        flops = 10.0 * needed
        nbytes = got.numel() * 4 + pts.numel() * 4 + (xv.numel() + yv.numel()) * 4
        bound_ms, bound_by = bound(flops, nbytes, PEAK_F32)
        row = dict(path=path, points=list(pts.shape), out=list(got.shape), sigma=sigma * 2,
                   valid_points=int(torch.isfinite(pts).all(dim=-1).sum()),
                   tile=list(confmap_tile(n_nodes)), tiles_live=live_tiles, tiles_all=n_tiles,
                   tiles_live_share=live_tiles / n_tiles, terms_computed=computed,
                   terms_all=all_terms, terms_needed=needed,
                   terms_computed_share=computed / all_terms,
                   cull_counted_by="host model" if DEVICE == "cpu" else "kernel",
                   cull_as_modelled=cull_as_modelled,
                   max_abs_err=err, tol=1e-6, zeros_exact=zeros_exact,
                   ok=bool(err <= 1e-6 and zeros_exact and cull_as_modelled),
                   max_value=got.max().item(), kernel_ms=kernel_ms, wrapper_ms=wrapper_ms,
                   plain_ms=cuda_ms(lambda: _plain_multi_confmaps(*args), reps=5),
                   library_ms=None, bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                   bytes=nbytes)
        log("multi_confmaps " + json.dumps(row))
        rows.append(row)
    bad = [r for r in rows if not r["ok"] or r["max_value"] < (0 if r["path"] == "all_nan" else 0.5)]
    if bad:
        raise AssertionError(f"multi_confmaps disagrees with its plain version: {bad}")
    return rows


def check_fused_refuses_autograd():
    """The fused conv has no backward: under autograd it must raise."""
    import torch

    from sleap_nn_tpu_torch.ops.fused_conv import fused_double_conv3x3

    x = torch.rand(1, 8, 8, 2, device=DEVICE)
    w = torch.rand(3, 3, 2, 2, device=DEVICE, requires_grad=True)
    try:
        fused_double_conv3x3(x, w, None, w, None)
    except RuntimeError as exc:
        log(f"fused_double_conv3x3 under autograd raises: {exc}")
        return
    if DEVICE != "cpu":  # the CPU takes the plain version, which has autograd
        raise AssertionError("fused_double_conv3x3 ran under autograd")


# --------------------------------------------------------------------------
# Phase 4: end to end
# --------------------------------------------------------------------------


def check_outputs(results):
    """JAX package shapes; NaN exactly on invalid slots."""
    assert len(results) == -(-N_FRAMES // BATCH), len(results)
    for i, out in enumerate(results):
        kp, vals = out["pred_keypoints"], out["pred_peak_values"]
        valid = out["instance_valid"]
        assert kp.shape == (BATCH, MAX_INST, N_NODES, 2) and kp.dtype == np.float32, kp.shape
        assert vals.shape == (BATCH, MAX_INST, N_NODES), vals.shape
        assert out["pred_centroids"].shape == (BATCH, MAX_INST, 2)
        assert out["centroid_vals"].shape == (BATCH, MAX_INST)
        assert valid.shape == (BATCH, MAX_INST) and valid.dtype == bool
        assert valid.any(), "no centroid found: stage 2 ran on empty crops only"
        assert np.isnan(kp[~valid]).all() and (vals[~valid] == 0).all()
        assert np.isfinite(out["pred_centroids"][valid]).all()
        assert np.isnan(out["pred_centroids"][~valid]).all()
        # Heads biased to 0.5 put every node above the threshold.
        assert np.isfinite(kp[valid]).all()
        assert (np.abs(kp[valid] - IMG / 2) <= IMG / 2 + CROP).all()
        n_valid = min(BATCH, N_FRAMES - i * BATCH)
        assert out["valid"].tolist() == [True] * n_valid + [False] * (BATCH - n_valid)
        assert out["frame_inds"][:n_valid].tolist() == list(range(i * BATCH, i * BATCH + n_valid))


def stage_times(layer, frames):
    """Per-stage ms of one batch, each stage fenced by synchronize()."""
    import torch

    from sleap_nn_tpu_torch.inference.layers import preprocess_images
    from sleap_nn_tpu_torch.ops.crops import crop_bboxes, make_centered_bboxes
    from sleap_nn_tpu_torch.ops.peaks import find_global_peaks, find_local_peaks

    c, inst = layer.centroid_layer, layer.instance_layer
    images = torch.from_numpy(frames).to(DEVICE)
    times = {}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        times[name] = (time.perf_counter() - t0) * 1e3
        return out

    with torch.inference_mode():
        for _ in range(2):  # the second pass is the one kept
            x, _eff = timed("preprocess", lambda: preprocess_images(c.pre, images))
            cms = timed("centroid_unet", lambda: c.backend(x)[c.head_name])
            pts = timed("centroid_peaks", lambda: find_local_peaks(
                cms, threshold=0.2, refinement="integral", max_peaks=MAX_INST)[0])
            cent = torch.nan_to_num(pts * 2, nan=-1e6).reshape(-1, 2)
            crops = timed("crop", lambda: crop_bboxes(
                x, make_centered_bboxes(cent, CROP, CROP),
                torch.arange(BATCH, device=DEVICE).repeat_interleave(MAX_INST), CROP, CROP))
            icms = timed("instance_unet", lambda: inst.backend(crops)[inst.head_name])
            timed("instance_peaks", lambda: find_global_peaks(
                icms, threshold=0.2, refinement="integral"))
    return times


def run_end_to_end(layer, kernels):
    import torch

    from sleap_nn_tpu_torch.inference.predictor import Predictor
    from sleap_nn_tpu_torch.inference.providers import VideoProvider

    frames = smoke_frames()
    video = ArrayVideo(frames)
    predictor = Predictor(layer, "topdown", batch_size=BATCH, device=DEVICE)
    predictor.predict(provider=VideoProvider(ArrayVideo(frames[:BATCH]), batch_size=BATCH),
                      make_labels=False)  # warm-up: allocator, cuDNN
    sync()
    for k in kernels.values():
        k.launches = 0
    results = predictor.predict(provider=VideoProvider(video, batch_size=BATCH),
                                make_labels=False)
    launches = {name: k.launches for name, k in kernels.items()}
    n_batches = len(results)
    want = {"fused_double_conv3x3": 18 * n_batches, "nms_scores": n_batches,
            "paf_line_scores": 0, "multi_confmaps": 0}
    if DEVICE != "cpu" and launches != want:  # a CPU rehearsal launches no kernel
        raise AssertionError(f"launch counts {launches}, expected {want}")
    check_outputs(results)
    stats = dict(predictor.last_stats)
    stats["instances"] = int(sum(r["instance_valid"][r["valid"]].sum() for r in results))
    stats["stage_ms"] = stage_times(layer, frames[:BATCH])
    stats["launches"] = launches
    stats["n_batches"] = n_batches
    log("end_to_end " + json.dumps(stats))
    return stats


# --------------------------------------------------------------------------
# Phase 5: bottom-up end to end
# --------------------------------------------------------------------------

BOTTOMUP_KEYS = {"pred_keypoints", "pred_peak_values", "pred_instance_scores",
                 "frame_inds", "video_inds", "valid"}


def check_bottomup_outputs(results, n_nodes):
    """The JAX package's keys and per-sample shapes; returns the instance count."""
    assert len(results) == -(-N_FRAMES // BATCH), len(results)
    n_inst = 0
    for i, out in enumerate(results):
        assert set(out) == BOTTOMUP_KEYS, sorted(out)
        for key in ("pred_keypoints", "pred_peak_values", "pred_instance_scores"):
            assert len(out[key]) == BATCH, (key, len(out[key]))
        for kp, vals, sc in zip(out["pred_keypoints"], out["pred_peak_values"],
                                out["pred_instance_scores"]):
            n = kp.shape[0]
            assert n <= MAX_INST, n
            assert kp.shape == (n, n_nodes, 2) and kp.dtype == np.float32, kp.shape
            assert vals.shape == (n, n_nodes) and sc.shape == (n,), (vals.shape, sc.shape)
            found = np.isfinite(kp).all(axis=-1)
            assert (found == np.isfinite(vals)).all() and (found.sum(axis=-1) >= 2).all()
            assert (np.abs(kp[found] - IMG / 2) <= IMG / 2).all()
        n_valid = min(BATCH, N_FRAMES - i * BATCH)
        assert out["valid"].tolist() == [True] * n_valid + [False] * (BATCH - n_valid)
        assert out["frame_inds"][:n_valid].tolist() == list(range(i * BATCH, i * BATCH + n_valid))
        n_inst += sum(len(kp) for kp, v in zip(out["pred_keypoints"], out["valid"]) if v)
    assert n_inst >= 1, "no instance found in any frame"
    return n_inst


def assert_same_outputs(a, b):
    """Identical per-batch outputs (NaN equal to NaN)."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for key in x:
            xs, ys = (x[key], y[key]) if isinstance(x[key], list) else ([x[key]], [y[key]])
            assert len(xs) == len(ys), key
            for u, v in zip(xs, ys):
                assert u.dtype == v.dtype and np.array_equal(u, v, equal_nan=u.dtype.kind == "f"), key


def bottomup_stage_times(layer, frames):
    """Per-stage ms of one bottom-up batch, each stage fenced by synchronize()."""
    import torch

    from sleap_nn_tpu_torch.inference.layers import preprocess_images, to_host
    from sleap_nn_tpu_torch.inference.paf_grouping import group_peaks_by_node
    from sleap_nn_tpu_torch.ops.peaks import find_local_peaks

    post, scorer = layer.post, layer.paf_scorer
    images = torch.from_numpy(frames).to(DEVICE)
    times = {}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        times[name] = (time.perf_counter() - t0) * 1e3
        return out

    with torch.inference_mode():
        for _ in range(2):  # the second pass is the one kept
            x, eff = timed("preprocess", lambda: preprocess_images(layer.pre, images))
            preds = timed("unet", lambda: layer.backend(x))
            pts, vals, chans, valid = timed("local_peaks", lambda: find_local_peaks(
                preds[layer.cm_head], threshold=post.peak_threshold, refinement=post.refinement,
                integral_patch_size=post.integral_patch_size, max_peaks=post.max_peaks))
            gp, gv, mask = timed("group_by_node", lambda: group_peaks_by_node(
                pts * layer.cm_output_stride, vals, chans, valid, scorer.n_nodes,
                scorer.k_per_node))
            scores = timed("paf_scoring", lambda: scorer.score_lines(
                preds[layer.paf_head], gp, mask))
            dev = {"grouped_peaks": gp, "grouped_vals": gv, "scores": scores, "eff_scale": eff}
            timed("host_grouping", lambda: layer.postprocess_host(to_host(dev)))
    return times


# The host grouping of a bottom-up batch of 8 on the scipy path, before the
# native grouping was ported (PERF.md section 5; NVIDIA H100 80GB HBM3,
# 700.00 W, this script's stage times): median and range of three runs.
SCIPY_GROUPING_MS = (9.697, 8.080, 10.438)


def check_native_grouping(layer, frames, reps=5):
    """Before phase 5: the C++ grouping library of ``native/`` is built and
    loaded (else this raises: the card path must not measure the scipy
    fallback), and ``group_sample`` runs in it. Times the host grouping of
    one batch (``BottomUpLayer.postprocess_host`` on its fetched scores) on
    the library and, in the same call, on the scipy fallback; both must
    find instances."""
    import os

    import torch

    from sleap_nn_tpu_torch import native
    from sleap_nn_tpu_torch.inference.layers import to_host

    lib = native.get_lib()
    if lib is None:
        raise AssertionError("the native PAF grouping library did not build or load: "
                             + native.build_log)
    with torch.inference_mode():
        host = to_host(layer.predict_async(torch.from_numpy(frames).to(DEVICE)))
    times, found = {}, {}
    for path in ("native", "scipy"):
        if path == "scipy":
            os.environ["SLEAP_NN_TPU_NO_NATIVE"] = "1"
        try:
            assert (native.get_lib() is None) == (path == "scipy")
            ms = []
            for _ in range(reps):
                t0 = time.perf_counter()
                out = layer.postprocess_host(host)
                ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            os.environ.pop("SLEAP_NN_TPU_NO_NATIVE", None)
        times[path] = ms
        found[path] = sum(len(k) for k in out["pred_keypoints"])
    assert native.get_lib() is lib
    if not found["native"] or not found["scipy"]:
        raise AssertionError(f"host grouping found no instance: {found}")
    stats = {"library": str(native.library_path().relative_to(ROOT)), "batch": len(frames),
             "native_ms": times["native"], "scipy_ms_same_call": times["scipy"],
             "native_ms_median": float(np.median(times["native"])),
             "scipy_ms_median_same_call": float(np.median(times["scipy"])),
             "scipy_ms_before_port": SCIPY_GROUPING_MS, "instances": found}
    log("native_grouping " + json.dumps(stats))
    return stats


def run_bottomup_end_to_end(layer, kernels):
    """Predict over the smoke frames with the grouping inline, then in 2 workers."""
    from sleap_nn_tpu_torch.inference.predictor import Predictor
    from sleap_nn_tpu_torch.inference.providers import VideoProvider

    frames = smoke_frames()
    n_nodes = layer.paf_scorer.n_nodes
    Predictor(layer, "bottomup", batch_size=BATCH, device=DEVICE).predict(
        provider=VideoProvider(ArrayVideo(frames[:BATCH]), batch_size=BATCH),
        make_labels=False)  # warm-up: allocator, cuDNN
    sync()
    runs, stats = {}, {}
    for workers in (0, 2):
        predictor = Predictor(layer, "bottomup", batch_size=BATCH, device=DEVICE,
                              paf_workers=workers)
        for k in kernels.values():
            k.launches = 0
        results = predictor.predict(provider=VideoProvider(ArrayVideo(frames), batch_size=BATCH),
                                    make_labels=False)
        launches = {name: k.launches for name, k in kernels.items()}
        n_batches = len(results)
        want = {"fused_double_conv3x3": 9 * n_batches, "nms_scores": n_batches,
                "paf_line_scores": n_batches, "multi_confmaps": 0}
        if DEVICE != "cpu" and launches != want:  # a CPU rehearsal launches no kernel
            raise AssertionError(f"paf_workers={workers}: launch counts {launches}, "
                                 f"expected {want}")
        runs[workers] = results
        stats[f"paf_workers_{workers}"] = dict(predictor.last_stats, launches=launches,
                                               instances=check_bottomup_outputs(results, n_nodes))
    assert_same_outputs(runs[0], runs[2])
    stats["launches"] = stats["paf_workers_0"]["launches"]
    stats["instances"] = stats["paf_workers_0"]["instances"]
    stats["fps"] = stats["paf_workers_0"]["fps"]
    stats["n_frames"] = stats["paf_workers_0"]["n_frames"]
    stats["n_batches"] = len(runs[0])
    stats["instances_per_frame"] = [len(kp) for out in runs[0]
                                    for kp, v in zip(out["pred_keypoints"], out["valid"]) if v]
    stats["stage_ms"] = bottomup_stage_times(layer, frames[:BATCH])
    log("bottomup_end_to_end " + json.dumps(stats))
    return stats


# --------------------------------------------------------------------------
# Phase 6: card against CPU on a small input
# --------------------------------------------------------------------------


def check_against_cpu():
    import torch

    from sleap_nn_tpu_torch.config.model_config import UNetConfig
    from sleap_nn_tpu_torch.inference.layers import preprocess_images
    from sleap_nn_tpu_torch.ops.peaks import find_global_peaks, find_local_peaks

    cfg, cm, im = build_models(UNetConfig, 5, seed=1, filters=8, max_stride=16)
    frames = np.random.default_rng(1).integers(0, 256, (2, 128, 128, 1), dtype=np.uint8)
    gpu = build_layer(cfg, cm, im, DEVICE, False, 32, 3)
    cpu = build_layer(cfg, cm, im, "cpu", False, 32, 3)
    report = {}
    with torch.inference_mode():
        for name, (g, c) in {"centroid": (gpu.centroid_layer, cpu.centroid_layer),
                             "instance": (gpu.instance_layer, cpu.instance_layer)}.items():
            x, _ = preprocess_images(c.pre, torch.from_numpy(frames))
            cms_g = g.backend(x.to(DEVICE))[g.head_name]
            cms_c = c.backend(x)[c.head_name]
            err = (cms_g.cpu() - cms_c).abs().max().item()
            report[f"{name}_maps_max_abs_err"] = err
            if err > 1e-4:
                raise AssertionError(f"{name} maps: card vs CPU max abs err {err}")
            if name == "centroid":
                got = find_local_peaks(cms_g, refinement="integral", max_peaks=8)
                want = find_local_peaks(cms_g.cpu(), refinement="integral", max_peaks=8)
            else:
                got = find_global_peaks(cms_g, refinement="integral")
                want = find_global_peaks(cms_g.cpu(), refinement="integral")
            for a, b in zip(got, want):
                a = a.cpu()
                if a.dtype.is_floating_point:
                    torch.testing.assert_close(a, b, rtol=0, atol=1e-5, equal_nan=True)
                else:
                    assert torch.equal(a, b)
    log("card_vs_cpu " + json.dumps(report))
    return report


def check_bottomup_against_cpu():
    """A narrow f32 bottom-up model on the card and on the CPU: maps to 1e-4;
    each later stage fed the card's inputs: peaks and scores to 1e-5 (-inf
    and NaN placement exact), grouped peaks and instances exactly."""
    import torch

    from sleap_nn_tpu_torch.config.model_config import UNetConfig
    from sleap_nn_tpu_torch.inference.layers import preprocess_images, to_host
    from sleap_nn_tpu_torch.inference.paf_grouping import group_peaks_by_node
    from sleap_nn_tpu_torch.ops.peaks import find_local_peaks

    frames = np.random.default_rng(2).integers(0, 256, (2, 128, 128, 1), dtype=np.uint8)
    cfg, model = build_bottomup_model(UNetConfig, 5, seed=2, frames=frames, filters=8,
                                      max_stride=16)
    gpu = build_bottomup_layer(cfg, model, DEVICE, False, 3)
    cpu = build_bottomup_layer(cfg, model, "cpu", False, 3)
    post, scorer = cpu.post, cpu.paf_scorer
    report = {}

    def close(name, a, b):
        a, b = a.cpu(), b.cpu()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if not a.dtype.is_floating_point:
            assert torch.equal(a, b), name
            return
        assert torch.equal(torch.isnan(a), torch.isnan(b)), name
        assert torch.equal(torch.isneginf(a), torch.isneginf(b)), name
        fin = torch.isfinite(b)
        err = (a[fin] - b[fin]).abs().max().item() if fin.any() else 0.0
        report[f"{name}_max_abs_err"] = err
        assert err <= 1e-5, (name, err)

    with torch.inference_mode():
        x, _ = preprocess_images(cpu.pre, torch.from_numpy(frames))
        preds_g, preds_c = gpu.backend(x.to(DEVICE)), cpu.backend(x)
        for head in (cpu.cm_head, cpu.paf_head):
            err = (preds_g[head].cpu() - preds_c[head]).abs().max().item()
            report[f"{head}_max_abs_err"] = err
            if err > 1e-4:
                raise AssertionError(f"{head}: card vs CPU max abs err {err}")
        cms, pafs = preds_g[cpu.cm_head], preds_g[cpu.paf_head]
        kw = dict(threshold=post.peak_threshold, refinement=post.refinement,
                  integral_patch_size=post.integral_patch_size, max_peaks=post.max_peaks)
        peaks_g = find_local_peaks(cms, **kw)
        for name, a, b in zip(("points", "vals", "channels", "valid"), peaks_g,
                              find_local_peaks(cms.cpu(), **kw)):
            close(f"peaks_{name}", a, b)
        pts, vals, chans, valid = peaks_g
        grouped_g = group_peaks_by_node(pts * 2, vals, chans, valid, scorer.n_nodes,
                                        scorer.k_per_node)
        grouped_c = group_peaks_by_node(*(a.cpu() for a in (pts * 2, vals, chans, valid)),
                                        scorer.n_nodes, scorer.k_per_node)
        for name, a, b in zip(("peaks", "vals", "mask"), grouped_g, grouped_c):
            assert torch.equal(a.cpu().nan_to_num(-1.0), b.nan_to_num(-1.0)), f"grouped_{name}"
        _, _, _, scores_g = gpu.paf_scorer.score_on_device(pafs, pts * 2, vals, chans, valid)
        _, _, _, scores_c = scorer.score_on_device(
            *(a.cpu() for a in (pafs, pts * 2, vals, chans, valid)))
        close("paf_scores", scores_g, scores_c)
        report["finite_scores"] = int(torch.isfinite(scores_c).sum())
        assert report["finite_scores"] > 0, "no pair to score: the check would hold nothing"
        inst = [layer.postprocess_host(to_host(
                    {"grouped_peaks": grouped_c[0], "grouped_vals": grouped_c[1],
                     "scores": s, "eff_scale": 1.0}))
                for layer, s in ((gpu, scores_g), (cpu, scores_c))]
    for key in ("pred_keypoints", "pred_peak_values"):
        for a, b in zip(inst[0][key], inst[1][key]):
            assert np.array_equal(a, b, equal_nan=True), key
    for a, b in zip(inst[0]["pred_instance_scores"], inst[1]["pred_instance_scores"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    report["instances"] = [len(kp) for kp in inst[1]["pred_keypoints"]]
    log("bottomup_card_vs_cpu " + json.dumps(report))
    return report


# --------------------------------------------------------------------------
# Phases 7, 10 and 11: training end to end
# --------------------------------------------------------------------------


def training_labels(n_frames, img, n_nodes, max_inst, seed):
    """Labels of ``n_frames`` synthetic uint8 frames, 1..max_inst instances of
    ``n_nodes`` nodes each (about 10% of the nodes missing), from a seed."""
    from sleap_nn_tpu_torch.io.model import Instance, LabeledFrame, Labels, Skeleton

    rng = np.random.default_rng(seed)
    video = ArrayVideo(rng.integers(0, 256, (n_frames, img, img, 1), dtype=np.uint8))
    names = [f"n{i}" for i in range(n_nodes)]
    skel = Skeleton(names, edges=bottomup_edges(n_nodes))
    frames = []
    for f in range(n_frames):
        insts = []
        for _ in range(int(rng.integers(1, max_inst + 1))):
            center = rng.uniform(0.1 * img, 0.9 * img, 2)
            pts = center + rng.normal(0, 0.03 * img, (n_nodes, 2))
            pts[rng.random(n_nodes) < 0.1] = np.nan
            insts.append(Instance(pts, skel))
        frames.append(LabeledFrame(video, f, insts))
    return Labels(frames)


TRAIN_HEADS = {
    "centroid": {"confmaps": {"sigma": 5.0, "output_stride": 2}},
    "single_instance": {"confmaps": {"sigma": 2.5, "output_stride": 2}},
    "centered_instance": {"confmaps": {"sigma": 2.5, "output_stride": 2}},
    "bottomup": {"confmaps": {"sigma": 2.5, "output_stride": 2},
                 "pafs": {"sigma": 15.0, "output_stride": 4}},
    "multi_class_bottomup": {"confmaps": {"sigma": 2.5, "output_stride": 2},
                             "class_maps": {"sigma": 5.0, "output_stride": 2}},
    "multi_class_topdown": {"confmaps": {"sigma": 2.5, "output_stride": 2},
                            "class_vectors": {"num_fc_layers": 1, "num_fc_units": 64,
                                              "global_pool": True}},
}


def with_tracks(labels, n_classes, seed):
    """``labels`` with each instance given one of ``n_classes`` tracks
    (``id0``, ``id1``, ...), distinct within its frame, from a seed of its
    own (the labels' points are untouched)."""
    from sleap_nn_tpu_torch.io.model import Track

    rng = np.random.default_rng(seed)
    tracks = [Track(name=f"id{c}") for c in range(n_classes)]
    for lf in labels.labeled_frames:
        for inst, c in zip(lf.instances, rng.permutation(n_classes)):
            inst.track = tracks[c]
    labels.tracks = tracks
    return labels


def training_config(filters, max_stride, img, batch, augment, model_type="centroid",
                    crop_size=None, backbone=None, head_stride=None, **trainer):
    """A training config: UNet (filters_rate 1.5, output stride 2) unless
    ``backbone`` (a ``backbone_config`` dict) is given, the model type's
    heads of ``TRAIN_HEADS`` (confmaps at stride 2, or ``head_stride``;
    PAFs sigma 15 at stride 4, edges from the skeleton), Adam lr 1e-4,
    f32."""
    heads = json.loads(json.dumps(TRAIN_HEADS[model_type]))
    if head_stride is not None:
        heads["confmaps"]["output_stride"] = head_stride
    from sleap_nn_tpu_torch.config import TrainingJobConfig

    return TrainingJobConfig.from_dict({
        "data_config": {
            "use_augmentations_train": augment,
            "augmentation_config": {"geometric": {}} if augment else None,
            "preprocessing": {"max_height": img, "max_width": img, "crop_size": crop_size},
        },
        "model_config": {
            "backbone_config": backbone or {"unet": {"filters": filters, "filters_rate": 1.5,
                                                     "max_stride": max_stride,
                                                     "output_stride": 2}},
            "head_configs": {model_type: heads},
        },
        "trainer_config": {
            "optimizer_name": "Adam", "optimizer": {"lr": 1e-4}, "seed": 0,
            "train_data_loader": {"batch_size": batch}, "val_data_loader": {"batch_size": batch},
            **trainer,
        },
    })


def train_stage_times(trainer, batch):
    """ms of one train step by stage, each fenced by synchronize(). For a
    bottom-up model also the render's parts (``render_parts``: preprocess
    with augmentation, the confmaps through kernel 4, the PAFs, and the
    PAF render's own peak device memory), with kernel 4 held against its
    plain version on the path's own points; for a multi-class bottom-up
    model the class maps and their render's peak memory in place of the
    PAFs."""
    import torch

    from sleap_nn_tpu_torch.data.identity import generate_class_maps
    from sleap_nn_tpu_torch.data.pipeline import preprocess_batch
    from sleap_nn_tpu_torch.data.resizing import apply_pad_to_stride
    from sleap_nn_tpu_torch.ops.confmaps import generate_multiconfmaps
    from sleap_nn_tpu_torch.ops.edge_maps import generate_pafs
    from sleap_nn_tpu_torch.ops.grid import make_grid_vectors
    from sleap_nn_tpu_torch.ops.kernels import _plain_multi_confmaps
    from sleap_nn_tpu_torch.training.losses import compute_loss
    from sleap_nn_tpu_torch.training.model_trainer import sample_weights

    times = {}

    def timed(name, fn, into=times):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        into[name] = (time.perf_counter() - t0) * 1e3
        return out

    trainer.model.train()
    for _ in range(2):  # the second pass is the one kept
        processed = timed("render", lambda: trainer.render(batch, train=True))
        trainer.optimizer.zero_grad(set_to_none=True)
        preds = timed("forward", lambda: trainer.model(processed["image"]))
        loss = timed("loss", lambda: compute_loss(
            preds, processed, trainer.model.heads, sample_weights(processed, True),
            trainer._ohkm)[0])
        timed("backward", loss.backward)
        timed("optimizer", trainer.optimizer.step)
    times["sum"] = sum(times.values())
    if trainer.model_type not in ("bottomup", "multi_class_bottomup"):
        return times

    ctx, parts = trainer.ctx, {}
    dbatch = trainer._to_device(batch)
    edges = torch.tensor(ctx.edge_inds, dtype=torch.long, device=trainer.device)
    with torch.no_grad():
        for _ in range(2):  # the second pass is the one kept
            image, inst, _eff = timed("preprocess", lambda: preprocess_batch(
                ctx, dbatch["image"], dbatch["instances"], trainer.generator, True), parts)
            hw = tuple(apply_pad_to_stride(image, ctx.max_stride).shape[1:3])
            cms = timed("confmaps_kernel4", lambda: generate_multiconfmaps(
                inst, hw, sigma=ctx.sigma, output_stride=ctx.output_stride), parts)
            if DEVICE != "cpu":
                torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated() if DEVICE != "cpu" else 0
            if trainer.model_type == "bottomup":
                name = "pafs"
                second = timed(name, lambda: generate_pafs(
                    inst, hw, edges, sigma=ctx.pafs_sigma,
                    output_stride=ctx.pafs_output_stride), parts)
            else:
                name = "class_maps"
                second = timed(name, lambda: generate_class_maps(
                    inst, hw, dbatch["track_ids"], ctx.n_classes, sigma=ctx.class_maps_sigma,
                    output_stride=ctx.class_maps_output_stride), parts)
            if DEVICE != "cpu":
                parts[f"{name}_peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2**20
        xv, yv = make_grid_vectors(*hw, ctx.output_stride, device=inst.device)
        want = _plain_multi_confmaps(inst, xv, yv, ctx.sigma * ctx.output_stride)
    parts["confmaps_max_abs_err"] = (cms - want).abs().max().item()
    if not parts["confmaps_max_abs_err"] <= 1e-6:
        raise AssertionError(f"kernel 4 on the bottom-up training path: {parts}")
    parts["points"], parts["confmaps"], parts[f"{name}_shape"] = (
        list(inst.shape), list(cms.shape), list(second.shape))
    times["render_parts"] = parts
    return times


MODEL_DIR_FILES = {"initial_config.yaml", "training_config.yaml", "best.ckpt", "training_log.csv"}

# The epoch-end evaluation of phases 7 and 11. The models train 5-10 steps
# from Xavier init, so their maps sit near 0 and their peaks lie anywhere:
# every local maximum counts as a peak (as in phase 13), and a centroid
# peak matches a ground-truth centroid at any distance, so that the
# evaluation always has pairs to score. It checks the path, not accuracy.
EVAL_PEAK_THRESHOLD, EVAL_MATCH_THRESHOLD = -1e9, 1e4
EVAL_KEYS = {"centroid": {"val/dist.avg", "val/detection.f1"},
             "centered_instance": {"val/mOKS", "val/dist.avg"},
             "multi_class_topdown": {"val/mOKS", "val/dist.avg"}}


def check_eval_peaks(cms):
    """Phase 7: the epoch-end evaluation's centroid peaks
    (``find_local_peaks(..., "integral", max_peaks=20)``) on one val batch's
    f32 maps, through kernel 2 and through its plain version: equal
    exactly (points, values, channels and validity)."""
    import torch

    from sleap_nn_tpu_torch.ops import kernels, peaks

    assert cms.dtype == torch.float32, cms.dtype
    got = peaks.find_local_peaks(cms, EVAL_PEAK_THRESHOLD, "integral", max_peaks=20)
    real = peaks.nms_scores
    peaks.nms_scores = kernels._plain_nms_scores
    try:
        want = peaks.find_local_peaks(cms, EVAL_PEAK_THRESHOLD, "integral", max_peaks=20)
    finally:
        peaks.nms_scores = real
    for g, w in zip(got, want):
        same_nan = torch.equal(torch.isnan(g), torch.isnan(w)) if g.is_floating_point() else True
        if not (same_nan and torch.equal(torch.nan_to_num(g), torch.nan_to_num(w))):
            raise AssertionError("epoch-end eval peaks: kernel 2 and its plain version differ")
    return {"maps": list(cms.shape), "dtype": "float32", "peaks": int(got[3].sum()),
            "equal_to_plain": True}


def run_training_end_to_end(kernels, root, model_type="centroid", crop_size=None,
                            evaluate=False):
    """Phases 7, 10, 11, 17 and 18: ``ModelTrainer.train`` of a medium_rf
    model of ``model_type`` on the synthetic labels (with ``N_CLASSES``
    tracks for an identity model), into the model dir
    ``root/<model_type>`` (which phases 13 and 19 predict from). Kernel 4
    renders the centroid and (multi-class) bottom-up confmaps, once per
    train step, val batch and setup probe; the crop models launch no
    kernel. With
    ``evaluate``, the epoch-end evaluation runs every epoch (``eval.enabled``,
    ``frequency`` 1, peaks and matching as ``EVAL_PEAK_THRESHOLD`` and
    ``EVAL_MATCH_THRESHOLD`` say): for a
    centroid model it renders each val batch again (kernel 4) and finds its
    peaks (kernel 2, on f32 maps); its ``val/*`` keys must be in every
    epoch's logs, and its seconds per epoch are printed."""
    import torch

    from sleap_nn_tpu_torch.models.model import Model
    from sleap_nn_tpu_torch.training import ModelTrainer
    from sleap_nn_tpu_torch.training.callbacks import EpochEndEvaluationCallback

    labels = training_labels(TRAIN_FRAMES + VAL_FRAMES, TRAIN_IMG, N_NODES, MAX_INST, seed=4)
    if model_type.startswith("multi_class"):
        labels = with_tracks(labels, N_CLASSES, seed=17)
    train = labels.extract(range(TRAIN_FRAMES))
    val = labels.extract(range(TRAIN_FRAMES, TRAIN_FRAMES + VAL_FRAMES))
    cfg = training_config(24, 32, TRAIN_IMG, TRAIN_BATCH, augment=True, model_type=model_type,
                          crop_size=crop_size, max_epochs=TRAIN_EPOCHS,
                          train_steps_per_epoch=TRAIN_STEPS, save_ckpt=True,
                          ckpt_dir=str(root), run_name=model_type,
                          model_ckpt={"save_last": True},
                          eval={"enabled": evaluate, "frequency": 1,
                                "match_threshold": EVAL_MATCH_THRESHOLD})
    trainer = ModelTrainer.get_model_trainer_from_config(cfg, [train], [val], device=DEVICE)
    if DEVICE != "cpu":
        torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    trainer.setup()
    eval_s = []
    if evaluate:
        eval_cb = next(cb for cb in trainer.callbacks
                       if isinstance(cb, EpochEndEvaluationCallback))
        eval_cb.peak_threshold = EVAL_PEAK_THRESHOLD
        inner = eval_cb._evaluate

        def timed_evaluate(tr):
            sync()
            t0 = time.perf_counter()
            out = inner(tr)
            sync()
            eval_s.append(time.perf_counter() - t0)
            return out

        eval_cb._evaluate = timed_evaluate
    start = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    history = trainer.train()
    sync()
    launches = {name: k.launches for name, k in kernels.items()}
    n_val = len(trainer.val_loader)
    n_renders = TRAIN_EPOCHS * (TRAIN_STEPS + n_val) + 1
    eval_renders = TRAIN_EPOCHS * n_val if evaluate else 0
    centroid_eval = eval_renders if model_type == "centroid" else 0
    want = {"fused_double_conv3x3": 0, "nms_scores": centroid_eval, "paf_line_scores": 0,
            "multi_confmaps": n_renders + centroid_eval
            if model_type in ("centroid", "bottomup", "multi_class_bottomup") else 0}
    if DEVICE != "cpu" and launches != want:  # a CPU rehearsal launches no kernel
        raise AssertionError(f"{model_type} training launch counts {launches}, "
                             f"expected {want}")
    peak_mem_gib = torch.cuda.max_memory_allocated() / 2**30 if DEVICE != "cpu" else None
    losses = [h[k] for h in history for k in ("train/loss", "val/loss")]
    assert len(history) == TRAIN_EPOCHS and np.isfinite(losses).all(), history
    if evaluate:
        keys = EVAL_KEYS[model_type]
        missing = [sorted(keys - set(h)) for h in history]
        if any(missing) or len(eval_s) != TRAIN_EPOCHS:
            raise AssertionError(f"{model_type} epoch-end evaluation: keys missing {missing}, "
                                 f"{len(eval_s)} evaluations in {TRAIN_EPOCHS} epochs")
        log(f"epoch_end_eval {model_type}: " + json.dumps({
            "seconds_per_epoch": eval_s, "val_batches": n_val,
            "logs": [{k: h[k] for k in sorted(keys)} for h in history]}))
    if model_type == "multi_class_topdown":
        accuracy = [{k: h.get(k) for k in ("train/class_accuracy", "val/class_accuracy")}
                    for h in history]
        if any(v is None for a in accuracy for v in a.values()):
            raise AssertionError(f"{model_type}: class_accuracy missing from the logs {accuracy}")
        log(f"class_accuracy {model_type}: " + json.dumps(accuracy))
    moved = {k: (v - start[k]).abs().max().item()
             for k, v in trainer.model.state_dict().items()}
    assert all(d > 0 for d in moved.values()), moved
    # best.ckpt loads strictly; last.ckpt gives the trainer's outputs exactly.
    ckpts = {}
    for name in ("best.ckpt", "last.ckpt"):
        fresh = Model.from_config("unet", cfg.model_config.backbone_config.unet,
                                  getattr(cfg.model_config.head_configs, model_type),
                                  model_type)
        fresh.load_state_dict(ModelTrainer.load_checkpoint_params(
            trainer.ckpt_dir / name), strict=True)
        ckpts[name] = fresh.to(DEVICE).eval()
    vbatch = next(iter(trainer.val_loader))
    trainer.model.eval()
    with torch.no_grad():
        x = trainer.render(vbatch, train=False)["image"]
        ours, theirs = trainer.model(x), ckpts["last.ckpt"](x)
    if not all(torch.equal(ours[k], theirs[k]) for k in ours):
        raise AssertionError(f"{model_type}: last.ckpt does not reproduce the trainer's outputs")
    eval_peaks = (check_eval_peaks(ours["CentroidConfmapsHead"])
                  if evaluate and model_type == "centroid" else None)
    best = torch.load(trainer.ckpt_dir / "best.ckpt", weights_only=True)
    assert best["best_val_loss"] == min(h["val/loss"] for h in history), best["best_val_loss"]
    files = {p.name for p in trainer.ckpt_dir.iterdir()}
    if not MODEL_DIR_FILES <= files:
        raise AssertionError(f"{model_type}: the model dir holds {sorted(files)}")

    batch = next(iter(trainer.train_loader))
    stages = train_stage_times(trainer, batch)
    # A steady window beside the trainer's own 5-step epochs: 20 steps on
    # one host batch (render included, no loader), fenced by synchronize().
    sync()
    t0 = time.perf_counter()
    fixed = [trainer.train_step(batch)[0] for _ in range(20)]
    sync()
    fixed_s = time.perf_counter() - t0
    fixed = [v.item() for v in fixed]
    if not fixed[-1] < fixed[0]:
        raise AssertionError(f"{model_type}: 20 steps on one batch did not lower the loss: {fixed}")
    stats = {
        "model_type": model_type, "launches": launches,
        "n_batches": {"multi_confmaps": n_renders + centroid_eval, "nms_scores": centroid_eval},
        "history": history, "steps_per_sec": history[-1]["train/steps_per_sec"],
        "samples_per_sec": history[-1]["train/samples_per_sec"],
        "steps_per_sec_by_epoch": [h["train/steps_per_sec"] for h in history],
        "fixed_batch_steps_per_sec": 20 / fixed_s,
        "fixed_batch_samples_per_sec": 20 * TRAIN_BATCH / fixed_s,
        "stage_ms": stages,
        "fixed_batch_loss_first_last": [fixed[0], fixed[-1]],
        "params": sum(v.numel() for v in start.values()), "input_shape": trainer._input_shape,
        "train_samples": len(trainer.train_ds), "val_batches": n_val,
        "peak_mem_gib": peak_mem_gib, "model_dir": str(trainer.ckpt_dir),
        "model_dir_files": sorted(files), "eval_seconds_per_epoch": eval_s,
        "eval_renders": eval_renders, "eval_peaks": eval_peaks,
    }
    log(("train_end_to_end " if model_type == "centroid" else f"train_{model_type}_end_to_end ")
        + json.dumps(stats))
    return stats


# --------------------------------------------------------------------------
# Phases 8 and 12: training on the card against the CPU
# --------------------------------------------------------------------------


def check_training_against_cpu(model_type="centroid", **trainer):
    """Phases 8 and 12 (and phase 22's AMSGrad, through ``trainer``: options
    of ``trainer_config``): a narrow f32 model of ``model_type`` trained 3
    steps on the card and on the CPU from the same parameters and batch
    (augmentation off)."""
    import torch

    from sleap_nn_tpu_torch.training import ModelTrainer

    labels = training_labels(8, 128, 5, 1 if model_type == "single_instance" else 3, seed=5)
    cfg = lambda: training_config(8, 8, 128, 4, augment=False, model_type=model_type,  # noqa: E731
                                  crop_size=64 if model_type == "centered_instance" else None,
                                  **trainer)
    train, val = labels.extract(range(6)), labels.extract(range(6, 8))
    card = ModelTrainer.get_model_trainer_from_config(cfg(), [train], [val], device=DEVICE)
    cpu = ModelTrainer.get_model_trainer_from_config(cfg(), [train], [val], device="cpu")
    card.setup()
    cpu.setup()
    card.model.load_state_dict(cpu.model.state_dict(), strict=True)
    batch = next(iter(cpu.train_loader))
    report = {"model_type": model_type, **trainer}
    for step in range(3):
        loss_card, loss_cpu = card.train_step(batch)[0].item(), cpu.train_step(batch)[0].item()
        if step == 0:
            report["loss_rel_err"] = abs(loss_card - loss_cpu) / abs(loss_cpu)
            assert report["loss_rel_err"] <= 1e-5, report
            grads = {n: (p.grad.cpu(), cpu_p.grad) for (n, p), cpu_p in zip(
                card.model.named_parameters(), cpu.model.parameters())}
            report["grad_err_over_max"] = max(
                (a - b).abs().max().item() / b.abs().max().item() for a, b in grads.values())
            assert report["grad_err_over_max"] <= 1e-4, report
    report["param_max_abs_err"] = max(
        (a.cpu() - b).abs().max().item()
        for a, b in zip(card.model.state_dict().values(), cpu.model.state_dict().values()))
    assert report["param_max_abs_err"] <= 1e-5, report
    report["losses_step3"] = [loss_card, loss_cpu]
    report["optimizer"] = type(card.optimizer).__name__
    log("train_card_vs_cpu " + json.dumps(report))
    return report


# --------------------------------------------------------------------------
# Phase 9: single-instance end to end
# --------------------------------------------------------------------------

SINGLE_KEYS = {"pred_keypoints", "pred_peak_values", "frame_inds", "video_inds", "valid"}


def build_single_instance_layer(cfg_cls, n_nodes, seed, device, use_bf16, **cfg_kw):
    """A single-instance model (confmaps at stride 2) with random weights from
    ``seed``, initialised as in :func:`build_models`, behind its layer."""
    import torch
    from types import SimpleNamespace as ns

    from sleap_nn_tpu_torch.inference.backends import TorchBackend
    from sleap_nn_tpu_torch.inference.layers import (
        PostprocessConfig, PreprocessConfig, SingleInstanceLayer)
    from sleap_nn_tpu_torch.models.model import Model

    cfg = cfg_cls(in_channels=1, output_stride=2, **cfg_kw)
    torch.manual_seed(seed)
    model = Model.from_config("unet", cfg, ns(confmaps=ns(
        part_names=[f"n{i}" for i in range(n_nodes)], sigma=2.5, output_stride=2,
        loss_weight=None)), "single_instance")
    random_init(model)
    return SingleInstanceLayer(
        TorchBackend(model, None, use_bf16=use_bf16, output_dtype=None, device=device),
        PreprocessConfig(ensure_grayscale=True, max_stride=cfg.max_stride),
        PostprocessConfig(peak_threshold=0.2), output_stride=2, device=device)


def single_instance_stage_times(layer, frames):
    """Per-stage ms of one single-instance batch, each stage fenced by synchronize()."""
    import torch

    from sleap_nn_tpu_torch.inference.layers import preprocess_images
    from sleap_nn_tpu_torch.ops.peaks import find_global_peaks

    images = torch.from_numpy(frames).to(DEVICE)
    times = {}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        times[name] = (time.perf_counter() - t0) * 1e3
        return out

    with torch.inference_mode():
        for _ in range(2):  # the second pass is the one kept
            x, _eff = timed("preprocess", lambda: preprocess_images(layer.pre, images))
            cms = timed("unet", lambda: layer.backend(x)[layer.head_name])
            timed("global_peaks", lambda: find_global_peaks(
                cms, threshold=layer.post.peak_threshold, refinement=layer.post.refinement,
                integral_patch_size=layer.post.integral_patch_size))
    times["sum"] = sum(times.values())
    return times


def run_single_instance_end_to_end(layer, kernels):
    """Phase 9: ``Predictor.predict`` of the single-instance model over the
    smoke frames: 9 fused-conv launches per batch and no other kernel; the
    JAX package's keys and shapes, every node found inside the frame."""
    from sleap_nn_tpu_torch.inference.predictor import Predictor
    from sleap_nn_tpu_torch.inference.providers import VideoProvider

    frames = smoke_frames()
    n_nodes = len(layer.backend.model.heads[0].part_names)
    predictor = Predictor(layer, "single_instance", batch_size=BATCH, device=DEVICE)
    predictor.predict(provider=VideoProvider(ArrayVideo(frames[:BATCH]), batch_size=BATCH),
                      make_labels=False)  # warm-up: allocator, cuDNN
    sync()
    for k in kernels.values():
        k.launches = 0
    results = predictor.predict(provider=VideoProvider(ArrayVideo(frames), batch_size=BATCH),
                                make_labels=False)
    launches = {name: k.launches for name, k in kernels.items()}
    n_batches = len(results)
    want = {"fused_double_conv3x3": 9 * n_batches, "nms_scores": 0, "paf_line_scores": 0,
            "multi_confmaps": 0}
    if DEVICE != "cpu" and launches != want:  # a CPU rehearsal launches no kernel
        raise AssertionError(f"single-instance launch counts {launches}, expected {want}")
    assert n_batches == -(-N_FRAMES // BATCH), n_batches
    for i, out in enumerate(results):
        assert set(out) == SINGLE_KEYS, sorted(out)
        kp, vals = out["pred_keypoints"], out["pred_peak_values"]
        assert kp.shape == (BATCH, 1, n_nodes, 2) and kp.dtype == np.float32, kp.shape
        assert vals.shape == (BATCH, 1, n_nodes), vals.shape
        # Heads biased to 0.5 put every node above the threshold.
        assert np.isfinite(kp).all() and (vals >= 0.2).all()
        assert (np.abs(kp - IMG / 2) <= IMG / 2).all()
        n_valid = min(BATCH, N_FRAMES - i * BATCH)
        assert out["valid"].tolist() == [True] * n_valid + [False] * (BATCH - n_valid)
        assert out["frame_inds"][:n_valid].tolist() == list(range(i * BATCH, i * BATCH + n_valid))
    stats = dict(predictor.last_stats, launches=launches, n_batches=n_batches,
                 stage_ms=single_instance_stage_times(layer, frames[:BATCH]))
    log("single_instance_end_to_end " + json.dumps(stats))
    return stats


# --------------------------------------------------------------------------
# Phase 13: predict from the model directories of phases 7, 10 and 11
# --------------------------------------------------------------------------

# The phase-13 models trained 10 steps from Xavier init: their maps sit near
# 0, so every local maximum counts as a peak (and, bottom-up, every scored
# line may link two peaks) for every frame to yield instances. Each
# bottom-up confmap channel keeps an offset of its own, so the top 200
# local maxima of a frame can all fall in channels that no edge joins:
# the bottom-up run keeps 2000, of which each node's best 20 are grouped.
DIR_PEAK_THRESHOLD, DIR_MIN_LINE, DIR_MAX_PEAKS = -1e9, -1e9, 2000


def frame_labels(frames):
    """In-memory ``Labels`` of empty frames over ``frames``: what
    ``run.predict`` predicts on."""
    from sleap_nn_tpu_torch.io.model import LabeledFrame, Labels

    video = ArrayVideo(frames)
    return Labels([LabeledFrame(video, i) for i in range(len(frames))], videos=[video])


def instance_classes(out, i, model_type):
    """Row ``i``'s class index of each of its instances (as ``to_labels``
    keeps them), or None for a model without classes."""
    if model_type == "multi_class_topdown":
        return out["pred_class_inds"][i][out["instance_valid"][i]]
    if model_type == "multi_class_bottomup":  # one row per class
        return np.arange(out["pred_keypoints"].shape[1])
    return None


def labels_hold_outputs(labels, results, model_type, class_names=None):
    """The ``Labels`` of a run hold exactly the instances of the raw batch
    outputs (the non-NaN, valid ones), frame by frame, and for an identity
    model each with the ``Track`` named after its class (``class_names``),
    no track twice in a frame; returns their count."""
    want = {}
    for out in results:
        for i in np.flatnonzero(out["valid"]):
            if model_type in ("topdown", "multi_class_topdown"):
                keep = out["instance_valid"][i]
                pts, vals = out["pred_keypoints"][i][keep], out["pred_peak_values"][i][keep]
            else:
                pts, vals = out["pred_keypoints"][i], out["pred_peak_values"][i]
            found = ~np.isnan(pts).all(axis=(1, 2))
            classes = instance_classes(out, i, model_type)
            names = None if classes is None else [
                class_names[c] if c >= 0 else None for c in classes[found]]
            if found.any():
                want[int(out["frame_inds"][i])] = (pts[found], vals[found], names)
    got = {lf.frame_idx: lf for lf in labels.labeled_frames}
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    for idx, (pts, vals, names) in want.items():
        insts = got[idx].instances
        assert np.array_equal(np.stack([x.points for x in insts]), pts.astype(np.float64),
                              equal_nan=True), idx
        assert np.array_equal(np.stack([x.point_scores for x in insts]),
                              np.nan_to_num(vals.astype(np.float64))), idx
        if names is not None:
            tracks = [x.track.name if x.track is not None else None for x in insts]
            if tracks != names or len(set(tracks) - {None}) != len(tracks) - tracks.count(None):
                raise AssertionError(f"frame {idx}: tracks {tracks}, classes {names}")
    return sum(len(lf) for lf in labels.labeled_frames)


# Launches per predict batch of each path: fused conv, NMS, PAF line scores.
PREDICT_LAUNCHES = {"topdown": (18, 1, 0), "bottomup": (9, 1, 1), "centroid": (9, 1, 0),
                    "multi_class_topdown": (18, 1, 0), "multi_class_bottomup": (9, 1, 0)}


def run_model_dir_predict(kernels, dirs, model_type):
    """Phases 13 and 19: ``run.predict`` over in-memory Labels of the smoke
    frames from trained model dirs (bf16, batch 8, no output file), the
    counted run; then one ``Predictor.from_model_paths`` predicts the same
    frames to raw outputs and to ``Labels``, which must hold the same
    instances (an identity model's with the tracks of their classes)."""
    import torch

    from sleap_nn_tpu_torch.inference.loaders import load_model
    from sleap_nn_tpu_torch.inference.predictor import Predictor
    from sleap_nn_tpu_torch.inference.run import predict

    for d in dirs:  # the loader's weights are the checkpoint file's, bit for bit
        loaded = load_model(d).model.state_dict()
        saved = torch.load(d / "best.ckpt", map_location="cpu", weights_only=True)["state_dict"]
        best = {k.removeprefix("model."): v for k, v in saved.items()}
        assert set(loaded) == set(best) and len(best) == len(saved)
        if not all(torch.equal(loaded[k].cpu(), best[k]) for k in best):
            raise AssertionError(f"{d}: loaded weights differ from best.ckpt")
    frames = smoke_frames()
    kw = dict(batch_size=BATCH, use_bf16=True, device=DEVICE, peak_threshold=DIR_PEAK_THRESHOLD,
              max_instances=MAX_INST)
    if model_type == "bottomup":
        kw.update(min_line_scores=DIR_MIN_LINE, max_peaks=DIR_MAX_PEAKS, paf_workers=0)
    predict(frame_labels(frames[:BATCH]), dirs, make_labels=False, **kw)  # warm-up
    sync()
    for k in kernels.values():
        k.launches = 0
    labels = predict(frame_labels(frames), dirs, output_path=None, **kw)
    sync()
    launches = {name: k.launches for name, k in kernels.items()}
    n_batches = -(-N_FRAMES // BATCH)
    per_batch = PREDICT_LAUNCHES[model_type]
    want = dict(zip(("fused_double_conv3x3", "nms_scores", "paf_line_scores"),
                    (n * n_batches for n in per_batch)), multi_confmaps=0)
    if DEVICE != "cpu" and launches != want:  # a CPU rehearsal launches no kernel
        raise AssertionError(f"{model_type} from dirs: launch counts {launches}, "
                             f"expected {want}")
    predictor = Predictor.from_model_paths(dirs, **kw)
    results = predictor.predict(frame_labels(frames), make_labels=False)
    same_labels = predictor.predict(frame_labels(frames), make_labels=True)
    names = predictor.class_names
    n_inst = labels_hold_outputs(same_labels, results, model_type, names)
    if labels_hold_outputs(labels, results, model_type, names) != n_inst:
        raise AssertionError(f"{model_type} from dirs: run.predict's Labels differ")
    per_frame = [len(lf) for lf in labels.labeled_frames]
    if len(labels.labeled_frames) != N_FRAMES:
        raise AssertionError(f"{model_type} from dirs: instances on "
                             f"{len(labels.labeled_frames)} of {N_FRAMES} frames: {per_frame}")
    stats = dict(labels.provenance["stats"], launches=launches, n_batches=n_batches,
                 instances=n_inst, instances_per_frame=per_frame,
                 peak_threshold=DIR_PEAK_THRESHOLD, backend=labels.provenance["backend"],
                 model_dirs=[str(d) for d in dirs])
    if names is not None:
        stats["tracks"] = [t.name for t in labels.tracks]
        stats["tracked_instances"] = sum(i.track is not None for lf in labels for i in lf)
    log(f"model_dir_{model_type}_predict " + json.dumps(stats))
    return stats


# --------------------------------------------------------------------------
# Phase 14: narrow model dirs trained on the CPU, predicted on the card and the CPU
# --------------------------------------------------------------------------


def blob_labels(n, img, n_nodes, max_inst, seed):
    """Black uint8 frames with bright Gaussian blobs, and labels of 1..max_inst
    instances of ``n_nodes`` nodes around them."""
    from sleap_nn_tpu_torch.io.model import Instance, LabeledFrame, Labels, Skeleton

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:img, :img]
    frames = np.zeros((n, img, img, 1), np.float32)
    centers = [rng.uniform(0.2 * img, 0.8 * img, (int(rng.integers(1, max_inst + 1)), 2))
               for _ in range(n)]
    for f, xy in enumerate(centers):
        for cx, cy in xy:
            frames[f, ..., 0] += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 4.0 ** 2))
    video = ArrayVideo((np.clip(frames, 0, 1) * 255).astype(np.uint8))
    skel = Skeleton([f"n{i}" for i in range(n_nodes)], edges=bottomup_edges(n_nodes))
    return Labels([LabeledFrame(video, f, [Instance(c + rng.normal(0, 4, (n_nodes, 2)), skel)
                                           for c in xy]) for f, xy in enumerate(centers)])


def condition_weights(model, frames):
    """Zero every bias and move each confmap head channel onto [0, 1] over
    the frames, as the CPU tests of the model dirs condition a bottom-up or
    orbax-loaded head. Away from the blobs every feature is then exactly 0
    on either device, so no float-noise tie between the card and the CPU
    decides a peak, and every refinement patch holds positive mass. As
    trained, the top-down maps reach no peak above 0.2; with every local
    maximum counted, patches whose mass nearly cancels (|mass| down to
    1.4% of the absolute mass) move refined points by up to 0.0076 px
    between f32 and f64 on the CPU alone, past this phase's 1e-4 px bound
    (``tools/model_dir_divergence.py``; PERF.md, PR 7)."""
    import torch

    heads = {"CentroidConfmapsHead", "CenteredInstanceConfmapsHead", "MultiInstanceConfmapsHead",
             "SingleInstanceConfmapsHead"}
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
        model.eval()
        out = model(torch.from_numpy(frames / np.float32(255.0)))
        for layer in model.head_layers:
            for head, conv in ((h, m[0]) for h, m in layer.items() if h in heads):
                maps = out[head].numpy()
                top, bottom = maps.max(axis=(0, 1, 2)), maps.min(axis=(0, 1, 2))
                conv.weight.div_(torch.from_numpy(top - bottom)[:, None, None, None])
                conv.bias.copy_(torch.from_numpy(-bottom / (top - bottom)))


# Phase 14's runs: name, the model types of its dirs, run.predict's knobs.
# Top-down keeps every centroid above 0.5 (max_instances 64, above any
# frame's count), so no near-tie at the cut decides which instances a
# frame holds.
NARROW_RUNS = (("topdown", ("centroid", "centered_instance"),
                {"max_instances": 64, "peak_threshold": 0.5}),
               ("bottomup", ("bottomup",), {"min_line_scores": -0.5}))


def train_narrow_dirs(root, condition=True):
    """Phase 14's labels and its narrow (filters 8, 128x128) centroid,
    centered-instance and bottom-up dirs, each trained 3 steps on the CPU
    under ``root/narrow``; with ``condition``, the weights are then
    conditioned (``condition_weights``) and saved by the trainer."""
    from sleap_nn_tpu_torch.training import ModelTrainer

    labels = blob_labels(10, 128, 5, 3, seed=14)
    dirs = {}
    for model_type in ("centroid", "centered_instance", "bottomup"):
        cfg = training_config(8, 16, 128, 4, augment=False, model_type=model_type,
                              crop_size=64 if model_type == "centered_instance" else None,
                              max_epochs=1, train_steps_per_epoch=3, save_ckpt=True,
                              ckpt_dir=str(root / "narrow"), run_name=model_type)
        trainer = ModelTrainer.get_model_trainer_from_config(
            cfg, [labels.extract(range(8))], [labels.extract(range(8, 10))], device="cpu")
        trainer.train()
        if condition:
            condition_weights(trainer.model, labels.video.frames)
            trainer.save_checkpoint("best.ckpt")
        dirs[model_type] = trainer.ckpt_dir
    return labels, dirs


def check_model_dirs_against_cpu(labels, dirs):
    """Phase 14: the narrow dirs of ``train_narrow_dirs`` (its ``labels`` and
    ``dirs``), conditioned, predicted through ``run.predict`` on the card and
    on the CPU in f32. Counts, validity and NaN placement exact; each
    frame's instances, in canonical order, with keypoints to 1e-4 px and
    peak values and instance scores to 1e-5. ``tools/model_dir_divergence.py``
    shows why the weights are conditioned (PERF.md, PR 7)."""
    from sleap_nn_tpu_torch.inference.run import predict

    frames = labels.video.frames
    report = {}
    for name, types, kw in NARROW_RUNS:
        paths = [dirs[t] for t in types]
        runs = [predict(frame_labels(frames), paths, batch_size=4, make_labels=False,
                        device=device, **kw) for device in (DEVICE, "cpu")]
        report[name] = compare_outputs(*runs)
        report[name]["most_in_a_frame"] = max(
            len(frame_instances(out, i)[0]) for out in runs[1] for i in np.flatnonzero(out["valid"]))
        if report[name]["instances"] < len(frames) or report[name]["most_in_a_frame"] >= 64:
            raise AssertionError(f"phase 14 {name}: too few instances {report[name]}")
    log("model_dirs_card_vs_cpu " + json.dumps(report))
    return report


def frame_instances(out, i):
    """Row ``i`` of a batch output as per-instance arrays, in a canonical
    order (by keypoint position): near-equal peak values may rank two
    instances either way on two devices."""
    if "instance_valid" in out:  # top-down
        keep = out["instance_valid"][i]
        arrays = [out[k][i][keep] for k in ("pred_keypoints", "pred_peak_values",
                                            "pred_centroids", "centroid_vals")]
    elif "pred_keypoints" not in out:  # centroid-only: each centroid a one-node instance
        keep = out["centroid_valid"][i]
        arrays = [out["pred_centroids"][i][keep][:, None], out["centroid_vals"][i][keep][:, None]]
    elif "pred_instance_scores" not in out:  # single instance: one instance a frame
        arrays = [np.asarray(out[k][i])[None] for k in ("pred_keypoints", "pred_peak_values")]
    else:
        arrays = [np.asarray(out[k][i]) for k in ("pred_keypoints", "pred_peak_values",
                                                   "pred_instance_scores")]
    key = [tuple(np.round(np.nan_to_num(kp, nan=-1.0), 2).ravel()) for kp in arrays[0]]
    order = sorted(range(len(key)), key=key.__getitem__)
    return [a[order] for a in arrays]


def compare_outputs(got, want):
    """Batch outputs of the card (``got``) against the CPU's: keys, frame
    indices, validity, instance counts and NaN placement exact; each frame's
    instances, in canonical order, with keypoints and centroids to 1e-4 and
    values to 1e-5. Returns the largest differences and the instance
    count."""
    assert len(got) == len(want)
    err = {"keypoints_max_abs_err": 0.0, "values_max_abs_err": 0.0, "instances": 0}
    for g_out, w_out in zip(got, want):
        assert set(g_out) == set(w_out), (sorted(g_out), sorted(w_out))
        for key in ("frame_inds", "video_inds", "valid"):
            assert np.array_equal(g_out[key], w_out[key]), key
        for i in np.flatnonzero(w_out["valid"]):
            g_arrays, w_arrays = frame_instances(g_out, i), frame_instances(w_out, i)
            err["instances"] += len(w_arrays[0])
            for j, (g, w) in enumerate(zip(g_arrays, w_arrays)):
                assert g.shape == w.shape, (int(i), j, g.shape, w.shape)
                assert np.array_equal(np.isnan(g), np.isnan(w)), (int(i), j)
                which = "keypoints" if j in (0, 2) and g.ndim >= 2 else "values"
                diff = float(np.nanmax(np.abs(g - w), initial=0.0))
                err[f"{which}_max_abs_err"] = max(err[f"{which}_max_abs_err"], diff)
    if err["keypoints_max_abs_err"] > 1e-4 or err["values_max_abs_err"] > 1e-5:
        raise AssertionError(f"card vs CPU from model dirs: {err}")
    return err


# --------------------------------------------------------------------------
# Phase 15: tracked predict from the model directories of phase 13
# --------------------------------------------------------------------------

# Phase 15's second run: the Kalman tracker at the smoke's instance count.
# ``post_connect_single_breaks`` needs ``target_instance_count``.
KALMAN_TRACKING = {"use_kalman": True, "tracking_target_instance_count": MAX_INST,
                   "target_instance_count": MAX_INST, "post_connect_single_breaks": True}


def track_rows(labels):
    """Per frame (in order): its frame index and each instance's track name."""
    return [(lf.frame_idx, [i.track.name if i.track is not None else None for i in lf.instances])
            for lf in labels.labeled_frames]


def run_tracked_predict(kernels, dirs, model_type, card):
    """Phase 15: ``run.predict`` with ``tracking=True`` over phase 13's frames
    and knobs from trained model dirs: once with the default tracker (the
    counted run) and once with ``KALMAN_TRACKING``. Every instance carries a
    track, the Kalman run holds at most ``MAX_INST`` tracks, and each run's
    tracks equal those of ``run_tracker`` applied here to a deep copy of the
    same path's untracked ``Labels`` (``tracking=False``); the launches per
    batch are phase 13's; provenance records the knobs of a tracked run.
    Prints frames/s of the predict loop and tracking ms per frame."""
    import copy

    from sleap_nn_tpu_torch.inference.run import predict
    from sleap_nn_tpu_torch.tracking import run_tracker

    frames = smoke_frames()
    kw = dict(batch_size=BATCH, use_bf16=True, device=DEVICE, peak_threshold=DIR_PEAK_THRESHOLD,
              max_instances=MAX_INST)
    if model_type == "bottomup":
        kw.update(min_line_scores=DIR_MIN_LINE, max_peaks=DIR_MAX_PEAKS, paf_workers=0)
    predict(frame_labels(frames[:BATCH]), dirs, make_labels=False, **kw)  # warm-up
    untracked = predict(frame_labels(frames), dirs, **kw)
    sync()
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    tracked = predict(frame_labels(frames), dirs, tracking=True, **kw)
    sync()
    total_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    n_batches = -(-N_FRAMES // BATCH)
    per_batch = {"topdown": (18, 1, 0), "bottomup": (9, 1, 1)}[model_type]
    want = dict(zip(("fused_double_conv3x3", "nms_scores", "paf_line_scores"),
                    (n * n_batches for n in per_batch)), multi_confmaps=0)
    if DEVICE != "cpu" and launches != want:  # a CPU rehearsal launches no kernel
        raise AssertionError(f"tracked {model_type}: launch counts {launches}, expected {want}")
    kalman = predict(frame_labels(frames), dirs, tracking=True, **KALMAN_TRACKING, **kw)

    stats = {"launches": launches, "n_batches": n_batches, "card": card}
    for name, labels, knobs in (("default", tracked, {}), ("kalman", kalman, KALMAN_TRACKING)):
        rows = track_rows(labels)
        if any(t is None for _, names in rows for t in names):
            raise AssertionError(f"tracked {model_type} ({name}): an instance has no track")
        if len(labels.labeled_frames) != N_FRAMES:
            raise AssertionError(f"tracked {model_type} ({name}): "
                                 f"{len(labels.labeled_frames)} frames")
        again = copy.deepcopy(untracked)
        t0 = time.perf_counter()
        run_tracker(again, **knobs)
        track_s = time.perf_counter() - t0
        if track_rows(again) != rows:
            raise AssertionError(f"tracked {model_type} ({name}): the tracks differ from "
                                 "run_tracker's on the untracked Labels")
        for lf, ref in zip(labels.labeled_frames, untracked.labeled_frames):
            if not all(np.array_equal(i.points, j.points, equal_nan=True)
                       for i, j in zip(lf.instances, ref.instances)):
                raise AssertionError(f"tracked {model_type} ({name}): points differ")
        if labels.provenance.get("tracking_config", {}) != knobs:
            raise AssertionError(f"tracked {model_type} ({name}): provenance "
                                 f"{labels.provenance.get('tracking_config')}")
        stats[name] = {"tracks": len(labels.tracks),
                       "instances": sum(len(lf) for lf in labels.labeled_frames),
                       "tracking_ms_per_frame": track_s * 1e3 / N_FRAMES,
                       "tracking_config": labels.provenance.get("tracking_config", {})}
    if stats["kalman"]["tracks"] > MAX_INST:
        raise AssertionError(f"tracked {model_type}: the Kalman run holds "
                             f"{stats['kalman']['tracks']} tracks")
    stats["fps"] = tracked.provenance["stats"]["fps"]
    stats["run_predict_s"] = total_s
    log(f"tracked_{model_type}_predict " + json.dumps(stats))
    log(f"tracked {model_type}: predict loop {stats['fps']:.2f} frames/s; tracking "
        f"{stats['default']['tracking_ms_per_frame']:.3f} ms/frame (default), "
        f"{stats['kalman']['tracking_ms_per_frame']:.3f} ms/frame (Kalman) | {card}")
    return stats


# --------------------------------------------------------------------------
# Phase 16: tracking and evaluation of narrow dirs, the card against the CPU
# --------------------------------------------------------------------------

TRACK_CLIP_FRAMES = 24
# The 3-step narrow models find dozens of centroids of similar value on a
# frame: phase 16 keeps each frame's best 2 instances (the gap to the
# third is about 0.03 in peak value, far above the devices' 1e-6) and
# tracks centroids by distance, which no float noise can tie.
TRACK_KNOBS = {"max_instances": 2, "tracking": True, "features": "centroids",
               "scoring_method": "euclidean_dist"}


def moving_blob_clip(n_frames, img, n_nodes, seed):
    """Phase 16's clip: two of phase 14's blob animals on straight paths
    (one from (24, 32) 2 px a frame right, one from (104, 96) 2 px a frame
    left, 64 px apart in y), the second one dimmer so that no two peaks
    tie, and their ground-truth ``Labels``: each animal's nodes at fixed
    offsets (a seeded draw) from its center."""
    from sleap_nn_tpu_torch.io.model import Instance, LabeledFrame, Labels, Skeleton

    rng = np.random.default_rng(seed)
    offsets = rng.normal(0, 4, (2, n_nodes, 2))
    yy, xx = np.mgrid[:img, :img]
    frames = np.zeros((n_frames, img, img, 1), np.float32)
    centers = np.array([[[24.0 + 2 * t, 32.0], [104.0 - 2 * t, 96.0]] for t in range(n_frames)])
    for t in range(n_frames):
        for (cx, cy), amp in zip(centers[t], (1.0, 0.8)):
            frames[t, ..., 0] += amp * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 4.0 ** 2))
    video = ArrayVideo((np.clip(frames, 0, 1) * 255).astype(np.uint8))
    skel = Skeleton([f"n{i}" for i in range(n_nodes)], edges=bottomup_edges(n_nodes))
    gt = Labels([LabeledFrame(video, t, [Instance(centers[t, k] + offsets[k], skel)
                                         for k in range(2)]) for t in range(n_frames)])
    return video, gt


def same_metric(a, b, tol):
    """``a`` and ``b`` within ``tol``, or both NaN (no matched pair)."""
    return (np.isnan(a) and np.isnan(b)) or abs(a - b) <= tol


def check_tracking_against_cpu(dirs, tmp):
    """Phase 16: phase 14's narrow dirs predict ``moving_blob_clip`` with
    ``TRACK_KNOBS`` on the card and on the CPU: every instance's track the
    same on both (instances keyed by track, keypoints to 1e-4 px);
    ``run_evaluation`` against the clip's ground truth the same on both
    (``mOKS`` to 1e-6, ``dist.avg`` to 1e-4 px, the centroid mode's
    detection counts exact); the card's metrics survive ``save_metrics_npz``
    -> ``load_metrics``."""
    from sleap_nn_tpu_torch.evaluation import load_metrics, run_evaluation, save_metrics_npz
    from sleap_nn_tpu_torch.inference.run import predict
    from sleap_nn_tpu_torch.io.model import LabeledFrame, Labels

    video, gt = moving_blob_clip(TRACK_CLIP_FRAMES, 128, 5, seed=16)
    report = {}
    for name, types, kw in NARROW_RUNS:
        paths = [dirs[t] for t in types]
        runs = {}
        for device in (DEVICE, "cpu"):
            src = Labels([LabeledFrame(video, t) for t in range(TRACK_CLIP_FRAMES)],
                         videos=[video])
            runs[device] = predict(src, paths, batch_size=4, device=device,
                                   **{**kw, **TRACK_KNOBS})
        card, cpu = runs[DEVICE], runs["cpu"]
        err, n_inst = 0.0, 0
        assert [lf.frame_idx for lf in card] == [lf.frame_idx for lf in cpu]
        for a, b in zip(card.labeled_frames, cpu.labeled_frames):
            by_track = [{i.track.name: i.points for i in lf.instances} for lf in (a, b)]
            if sorted(by_track[0]) != sorted(by_track[1]) or len(by_track[1]) != len(b):
                raise AssertionError(f"phase 16 {name}: frame {b.frame_idx} tracks "
                                     f"{sorted(by_track[0])} on the card, "
                                     f"{sorted(by_track[1])} on the CPU")
            for t, pts in by_track[1].items():
                assert np.array_equal(np.isnan(by_track[0][t]), np.isnan(pts)), (name, t)
                err = max(err, float(np.nanmax(np.abs(by_track[0][t] - pts), initial=0.0)))
            n_inst += len(b)
        if err > 1e-4 or n_inst < TRACK_CLIP_FRAMES:
            raise AssertionError(f"phase 16 {name}: keypoints {err} px apart, "
                                 f"{n_inst} instances")
        metrics = {d: (run_evaluation(gt, runs[d]), run_evaluation(gt, runs[d],
                                                                    match_method="centroid"))
                   for d in runs}
        (m_card, c_card), (m_cpu, c_cpu) = metrics[DEVICE], metrics["cpu"]
        pairs = {"mOKS": (m_card["mOKS"]["mOKS"], m_cpu["mOKS"]["mOKS"], 1e-6),
                 "dist.avg": (m_card["distance_metrics"]["avg"],
                              m_cpu["distance_metrics"]["avg"], 1e-4)}
        diffs = {k: abs(a - b) for k, (a, b, _) in pairs.items()}
        counts = [{k: c["detection_metrics"][k] for k in ("n_tp", "n_fp", "n_fn")}
                  for c in (c_card, c_cpu)]
        if not (all(same_metric(a, b, tol) for a, b, tol in pairs.values())
                and counts[0] == counts[1]):
            raise AssertionError(f"phase 16 {name}: metrics differ {diffs} {counts}")
        path = Path(tmp) / f"metrics.{name}.npz"
        save_metrics_npz(m_card, path)
        back = load_metrics(path)
        if not (same_metric(back["mOKS.mOKS"], m_card["mOKS"]["mOKS"], 0)
                and same_metric(back["distance_metrics"]["avg"],
                                m_card["distance_metrics"]["avg"], 0)):
            raise AssertionError(f"phase 16 {name}: the metrics file does not round-trip")
        report[name] = {"instances": n_inst, "tracks": len(card.tracks),
                        "keypoints_max_abs_err": err, "metric_diffs": diffs,
                        "mOKS": m_card["mOKS"]["mOKS"],
                        "dist_avg": m_card["distance_metrics"]["avg"],
                        "detection_counts": counts[0]}
    log("tracking_eval_card_vs_cpu " + json.dumps(report))
    return report


# --------------------------------------------------------------------------
# Phase 19: identity models from model dirs; narrow identity dirs, card against CPU
# --------------------------------------------------------------------------

# The narrow identity runs: name, the model types of its dirs, the
# predictor's knobs. Phase 14's centroid model finds about 45 centroids
# above 0.5 a frame, and a Hungarian match of 45 rows to 3 classes turns on
# small differences between rows: top-down keeps each frame's best 3
# centroids (the gaps between the 3rd and 4th value are 1e-4 and more,
# against the devices' 1e-6). The conditioned bottom-up maps peak near 1
# on the blobs.
NARROW_ID_RUNS = (("multi_class_topdown", ("centroid", "multi_class_topdown"),
                   {"max_instances": 3, "peak_threshold": 0.5}),
                  ("multi_class_bottomup", ("multi_class_bottomup",), {"peak_threshold": 0.5}))
NARROW_CLASSES = 3
# The 3-step class heads' outputs sit near uniform (rows of 0.29, 0.49,
# 0.21): their logits (and class-map pre-activations) are scaled by this
# much, so that most rows clear the bf16 margin the check asks for.
CLASS_HEAD_GAIN = 10.0


def train_narrow_identity_dirs(root, centroid_dir):
    """Phase 19's labels (phase 14's blob labels, each instance one of
    ``NARROW_CLASSES`` tracks) and its narrow multi-class dirs, each trained
    3 steps on the CPU under ``root/narrow_id``, conditioned as phase 14's
    and saved by the trainer, with the class heads' gain raised
    (``CLASS_HEAD_GAIN``); the top-down pair takes phase 14's centroid
    dir."""
    import torch

    from sleap_nn_tpu_torch.training import ModelTrainer

    labels = with_tracks(blob_labels(10, 128, 5, 3, seed=14), NARROW_CLASSES, seed=19)
    dirs = {"centroid": centroid_dir}
    for model_type in ("multi_class_bottomup", "multi_class_topdown"):
        cfg = training_config(8, 16, 128, 4, augment=False, model_type=model_type,
                              crop_size=64 if model_type == "multi_class_topdown" else None,
                              max_epochs=1, train_steps_per_epoch=3, save_ckpt=True,
                              ckpt_dir=str(root / "narrow_id"), run_name=model_type)
        trainer = ModelTrainer.get_model_trainer_from_config(
            cfg, [labels.extract(range(8))], [labels.extract(range(8, 10))], device="cpu")
        trainer.train()
        condition_weights(trainer.model, labels.video.frames)
        with torch.no_grad():
            for layer in trainer.model.head_layers:
                for head, module in layer.items():
                    if head == "ClassVectorsHead":
                        module.weight.mul_(CLASS_HEAD_GAIN)
                    elif head == "ClassMapsHead":
                        module[0].weight.mul_(CLASS_HEAD_GAIN)
        trainer.save_checkpoint("best.ckpt")
        dirs[model_type] = trainer.ckpt_dir
    return labels, dirs


def class_margin_ok(probs):
    """Per row of class probabilities: whether its best clears its second
    best by more than bf16's step at the best's magnitude."""
    top2 = np.sort(probs, axis=-1)[..., -2:]
    return np.array([b - a > bf16_ulp(float(b)) for a, b in top2.reshape(-1, 2)],
                    dtype=bool).reshape(top2.shape[:-1])


def _sorted_peaks(dev, i):
    """Sample ``i``'s valid peaks of a multi-class bottom-up device output,
    ordered by (channel, rough y, rough x): the same peaks, whatever order
    near-equal values gave them."""
    v = dev["valid"][i]
    rough = dev["rough"][i][v]
    order = np.lexsort((rough[:, 0], rough[:, 1], dev["channels"][i][v]))
    return {k: dev[k][i][v][order] for k in ("rough", "channels", "points", "peak_class_probs")}


def _identity_rows(fin, i):
    """Sample ``i`` of a multi-class top-down output: its valid rows in
    canonical order (by keypoints), as keypoints, class probabilities and
    class indices."""
    keep = fin["instance_valid"][i]
    kp = fin["pred_keypoints"][i][keep]
    key = [tuple(np.round(np.nan_to_num(k, nan=-1.0), 2).ravel()) for k in kp]
    order = sorted(range(len(key)), key=key.__getitem__)
    return (kp[order], fin["class_probs"][i][keep][order],
            fin["pred_class_inds"][i][keep][order])


def check_identity_dirs_against_cpu(labels, dirs):
    """Phase 19's narrow check: the dirs of ``train_narrow_identity_dirs``
    predict ``labels``' frames through their ``Predictor.from_model_paths``
    layers on the card and on the CPU, f32, batch 4. Validity, peak
    positions and NaN placement exact; keypoints to 1e-4 px, class
    probabilities to 1e-5; the class assignment equal wherever every row
    of one Hungarian match clears the bf16 step between its best and
    second-best class probability: a frame's instances (top-down), a
    (frame, node)'s peaks (bottom-up). Counts the rows under that margin
    and the matches they leave out."""
    from sleap_nn_tpu_torch.inference.layers import to_host
    from sleap_nn_tpu_torch.inference.predictor import Predictor

    frames = labels.video.frames
    report = {}
    for name, types, kw in NARROW_ID_RUNS:
        paths = [dirs[t] for t in types]
        layers = {d: Predictor.from_model_paths(paths, batch_size=4, device=d, **kw).layer
                  for d in (DEVICE, "cpu")}
        r = {"rows": 0, "rows_under_margin": 0, "matches": 0, "matches_left_out": 0,
             "keypoints_max_abs_err": 0.0, "probs_max_abs_err": 0.0}
        for start in range(0, len(frames), 4):
            chunk = frames[start:start + 4]
            dev = {d: to_host(layer.predict_async(chunk)) for d, layer in layers.items()}
            fin = {d: layers[d].postprocess_host(dict(dev[d])) for d in layers}
            g_dev, w_dev, g_fin, w_fin = dev[DEVICE], dev["cpu"], fin[DEVICE], fin["cpu"]
            for i in range(len(chunk)):
                if name == "multi_class_bottomup":
                    g, w = _sorted_peaks(g_dev, i), _sorted_peaks(w_dev, i)
                    for k in ("rough", "channels"):
                        if not np.array_equal(g[k], w[k], equal_nan=True):
                            raise AssertionError(f"phase 19 {name}: frame {start + i} peaks differ")
                    g_probs, probs = g["peak_class_probs"], w["peak_class_probs"]
                    # One match per node: its peaks, and its column of the
                    # output, whose NaN placement is the node's assignment.
                    matches = [(w["channels"] == n, (slice(None), n))
                               for n in np.unique(w["channels"])]
                    g_kp, w_kp = g_fin["pred_keypoints"][i], w_fin["pred_keypoints"][i]
                    g_cls, w_cls = np.isnan(g_kp), np.isnan(w_kp)
                else:  # one match per frame: its instances' class indices
                    g_kp, g_probs, g_cls = _identity_rows(g_fin, i)
                    w_kp, probs, w_cls = _identity_rows(w_fin, i)
                    if g_kp.shape != w_kp.shape:
                        raise AssertionError(f"phase 19 {name}: frame {start + i} holds "
                                             f"{len(g_kp)} / {len(w_kp)} instances")
                    matches = [(np.ones(len(probs), bool), slice(None))]
                ok = class_margin_ok(probs) if len(probs) else np.zeros(0, bool)
                r["rows"] += len(probs)
                r["rows_under_margin"] += int((~ok).sum())
                if len(probs):
                    r["probs_max_abs_err"] = max(r["probs_max_abs_err"],
                                                 float(np.abs(g_probs - probs).max()))
                for rows, cols in matches:
                    r["matches"] += 1
                    if not ok[rows].all():
                        r["matches_left_out"] += 1
                        continue
                    gk, wk = g_kp[cols], w_kp[cols]
                    if not (np.array_equal(g_cls[cols], w_cls[cols])
                            and np.array_equal(np.isnan(gk), np.isnan(wk))):
                        raise AssertionError(f"phase 19 {name}: frame {start + i}: the class "
                                             "assignments differ")
                    r["keypoints_max_abs_err"] = max(
                        r["keypoints_max_abs_err"], float(np.nanmax(np.abs(gk - wk), initial=0)))
        if r["keypoints_max_abs_err"] > 1e-4 or r["probs_max_abs_err"] > 1e-5:
            raise AssertionError(f"phase 19 {name}: card vs CPU {r}")
        if r["rows"] < len(frames) or r["matches_left_out"] > r["matches"] // 2:
            raise AssertionError(f"phase 19 {name}: too little compared {r}")
        report[name] = r
    log("identity_dirs_card_vs_cpu " + json.dumps(report))
    return report


# --------------------------------------------------------------------------
# Phase 20: predict from video files at full width
# --------------------------------------------------------------------------

# Phase 20's clips: phase 4's 20 frames at 1024x1024, and 100 frames of
# 320x560 (the size of the reference's small_robot.mp4) cut from them,
# predicted at that size (the dirs' sizematcher would scale them to 1024).
SMALL_CLIP, SMALL_HW, SMALL_BATCH = 100, (320, 560), 4


def cv2_report():
    """cv2's version and whether its build lists FFmpeg."""
    import cv2

    info = cv2.getBuildInformation()
    ffmpeg = any(line.strip().startswith("FFMPEG:") and "YES" in line
                 for line in info.splitlines())
    return {"cv2": cv2.__version__, "ffmpeg": ffmpeg}


def write_clip(path, frames, fourcc):
    """One-channel ``frames`` into a video file as three equal channels
    (OpenCV's own MJPG encoder mis-codes one-channel frames); MJPG through
    that encoder (no FFmpeg), other codecs through whatever cv2 picks. A
    clip cv2 cannot write raises."""
    import cv2

    h, w = frames.shape[1:3]
    args = (cv2.VideoWriter_fourcc(*fourcc), 30.0, (w, h), True)
    writer = (cv2.VideoWriter(str(path), cv2.CAP_OPENCV_MJPEG, *args) if fourcc == "MJPG"
              else cv2.VideoWriter(str(path), *args))
    if not writer.isOpened():
        raise AssertionError(f"cv2 cannot write {path} ({fourcc})")
    for f in frames:
        writer.write(np.ascontiguousarray(np.repeat(f, 3, axis=-1)))
    writer.release()
    return path


def decode_clip(path):
    """The clip's frames through the port's ``Video``, in memory."""
    from sleap_nn_tpu_torch.io.video import Video

    video = Video.from_filename(str(path))
    return np.stack([video.get_frame(i, fmt="gray") for i in range(len(video))])


def decode_ms_per_frame(path, batch):
    """ms a frame of the provider's decode thread alone: a ``VideoProvider``
    of the file (one channel, as for the smoke's models) drained with no
    consumer work."""
    from sleap_nn_tpu_torch.inference.providers import VideoProvider

    provider = VideoProvider(str(path), batch_size=batch, out_format="gray")
    t0 = time.perf_counter()
    n = sum(int(b.valid.sum()) for b in provider)
    return (time.perf_counter() - t0) * 1e3 / n


def labels_equal(a, b):
    """The same frames, instances (points and scores bit for bit) and
    centroids, in order."""
    if [lf.frame_idx for lf in a] != [lf.frame_idx for lf in b]:
        return False
    for x, y in zip(a.labeled_frames, b.labeled_frames):
        if len(x.instances) != len(y.instances) or len(x.centroids) != len(y.centroids):
            return False
        for i, j in zip(x.instances, y.instances):
            if not (np.array_equal(i.points, j.points, equal_nan=True)
                    and np.array_equal(i.point_scores, j.point_scores) and i.score == j.score):
                return False
        for c, d in zip(x.centroids, y.centroids):
            if not (np.array_equal(c.point, d.point) and c.score == d.score):
                return False
    return True


# The wrappers of kernels 1-3 as the layers call them: (name, the module
# that imports the wrapper by name).
PATH_WRAPPERS = (("fused_double_conv3x3", "sleap_nn_tpu_torch.models.encoder_decoder"),
                 ("nms_scores", "sleap_nn_tpu_torch.ops.peaks"),
                 ("paf_line_scores", "sleap_nn_tpu_torch.inference.paf_grouping"))
# Kernel 4 as the training renders call it (phase 23 records it too).
TRAIN_WRAPPERS = (("multi_confmaps", "sleap_nn_tpu_torch.ops.confmaps"),)


@contextlib.contextmanager
def recording_kernel_calls(seen, calls, wrappers=PATH_WRAPPERS):
    """Within the block, each wrapper of ``wrappers`` appends to ``calls`` a
    copy of its inputs, once for each signature (shapes, dtypes and other
    arguments) not yet in ``seen``."""
    import importlib

    import torch

    saved = []
    for name, module in wrappers:
        mod = importlib.import_module(module)
        fn = getattr(mod, name)

        def recorded(*args, _fn=fn, _name=name, **kw):
            sig = (_name, tuple((tuple(a.shape), str(a.dtype)) if torch.is_tensor(a) else a
                                for a in args), tuple(sorted(kw.items())))
            if sig not in seen:
                seen.add(sig)
                calls.append((_name, [a.clone() if torch.is_tensor(a) else a for a in args],
                              dict(kw)))
            return _fn(*args, **kw)

        setattr(mod, name, recorded)
        saved.append((mod, name, fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def timing_calls(targets, into):
    """Within the block, adds to ``into[name]`` the seconds spent in the
    callable ``getattr(owner, attribute)`` of each ``name: (owner,
    attribute)`` of ``targets`` (a call within a call of the same target
    counts once)."""
    saved = []
    for name, (owner, attr) in targets.items():
        real, depth = getattr(owner, attr), [0]
        into.setdefault(name, 0.0)

        def timed(*args, _real=real, _name=name, _depth=depth, **kw):
            _depth[0] += 1
            t0 = time.perf_counter()
            try:
                return _real(*args, **kw)
            finally:
                _depth[0] -= 1
                if not _depth[0]:
                    into[_name] += time.perf_counter() - t0

        setattr(owner, attr, timed)
        saved.append((owner, attr, real))
    try:
        yield into
    finally:
        for owner, attr, real in reversed(saved):
            setattr(owner, attr, real)


def slp_file_stages():
    """``timing_calls`` targets that split the time of ``.slp`` files:
    ``save_slp`` whole, its PNG encoding of embedded frames, the HDF5
    writer's datasets and its closing (headers, groups, superblock; a
    reader's close, an unmap, counts there too), ``load_slp`` and the PNG
    decoding of embedded frames. What ``save_slp`` spends outside the
    encoding and the writer is the frames' reads from their video and the
    row tables."""
    from sleap_nn_tpu_torch.io import hdf5, slp
    from sleap_nn_tpu_torch.io import video as pvideo

    return {"save_slp_s": (slp, "save_slp"), "encode_png_s": (slp, "encode_png"),
            "hdf5_datasets_s": (hdf5._WGroup, "create_dataset"),
            "hdf5_close_s": (hdf5.File, "close"), "load_slp_s": (slp, "load_slp"),
            "decode_png_s": (pvideo, "decode_png")}


def check_recorded_calls(calls):
    """Each recorded call of ``recording_kernel_calls`` through its wrapper
    and through its plain version on the same inputs, at phase 3's
    tolerances: the fused conv to 1 bf16 ulp of the output's largest
    magnitude (f32: 1e-4 of it), NMS exact, the PAF line scores to 1e-5 on
    finite scores, the multi-instance confmaps to 1e-6; -inf and NaN placed
    alike. Returns a row per call."""
    import torch

    from sleap_nn_tpu_torch.ops.fused_conv import _plain_double_conv, fused_double_conv3x3
    from sleap_nn_tpu_torch.ops.kernels import (
        _plain_multi_confmaps, _plain_nms_scores, _plain_paf_line_scores, multi_confmaps,
        nms_scores, paf_line_scores)

    pairs = {"fused_double_conv3x3": (fused_double_conv3x3, _plain_double_conv),
             "nms_scores": (nms_scores, _plain_nms_scores),
             "paf_line_scores": (paf_line_scores, _plain_paf_line_scores),
             "multi_confmaps": (multi_confmaps, _plain_multi_confmaps)}
    rows = []
    with torch.inference_mode():
        for name, args, kw in calls:
            kernel, plain = pairs[name]
            got, want = kernel(*args, **kw).float(), plain(*args, **kw).float()
            sync()
            fin = torch.isfinite(want)
            err = (got[fin] - want[fin]).abs().max().item() if fin.any() else 0.0
            placed = bool(torch.equal(torch.isneginf(got), torch.isneginf(want))
                          and torch.equal(torch.isnan(got), torch.isnan(want)))
            if name == "fused_double_conv3x3":
                top = want.abs().max().item()
                tol = bf16_ulp(top) if args[0].dtype == torch.bfloat16 else 1e-4 * top
            else:
                tol = {"nms_scores": 0.0, "multi_confmaps": 1e-6}.get(name, 1e-5)
            rows.append({"kernel": name, "dtype": str(args[0].dtype).split(".")[-1],
                         "shapes": [list(a.shape) for a in args if torch.is_tensor(a)],
                         "max_abs_err": err, "tol": tol, "ok": placed and err <= tol})
            del got, want
    return rows


# Phase 20's paths: name, the dirs under the phases' root, the launch row
# of PREDICT_LAUNCHES, run.predict's knobs, whether the 320x560 clip runs.
VIDEO_RUNS = (
    ("topdown", ("centroid", "centered_instance"), "topdown", {}, True),
    ("bottomup", ("bottomup",), "bottomup",
     {"min_line_scores": DIR_MIN_LINE, "max_peaks": DIR_MAX_PEAKS, "paf_workers": 0}, True),
    ("centroid_only", ("centroid", "centered_instance"), "centroid",
     {"centroid_only": True, "centroid_output": "both"}, True),
    ("multi_class_bottomup", ("multi_class_bottomup",), "multi_class_bottomup", {}, False),
    ("multi_class_topdown", ("centroid", "multi_class_topdown"), "multi_class_topdown", {},
     False),
)


def run_video_predict(kernels, root, tmp, smi):
    """Phase 20: ``run.predict`` from video files at full width, the counted
    runs. Each path's ``Labels`` from the file must equal those of the same
    dirs on the clip decoded into memory first; the centroid-only ones hold
    one ``PredictedCentroid`` per one-node instance. Returns the stats by
    path and clip."""
    from sleap_nn_tpu_torch.inference.run import predict

    report = cv2_report()
    log("video_cv2 " + json.dumps(report))
    frames = smoke_frames()
    small = np.stack([frames[i % N_FRAMES][:SMALL_HW[0], :SMALL_HW[1]]
                      for i in range(SMALL_CLIP)])
    clips = {"mjpg_1024": (write_clip(tmp / "clip1024.avi", frames, "MJPG"), BATCH, {}),
             "mjpg_320x560": (write_clip(tmp / "clip320x560.avi", small, "MJPG"), SMALL_BATCH,
                              {"max_height": SMALL_HW[0], "max_width": SMALL_HW[1]})}
    if report["ffmpeg"]:
        clips["mp4v_1024"] = (write_clip(tmp / "clip1024.mp4", frames, "mp4v"), BATCH, {})
    decoded = {name: decode_clip(path) for name, (path, _, _) in clips.items()}
    decode_ms = {name: decode_ms_per_frame(path, batch) for name, (path, batch, _) in clips.items()}
    stats, seen, held = {}, set(), []
    for name, types, launch_row, knobs, small_too in VIDEO_RUNS:
        for clip, (path, batch, size_kw) in clips.items():
            if (clip == "mjpg_320x560" and not small_too) or \
                    (clip == "mp4v_1024" and name != "topdown"):
                continue
            kw = dict(batch_size=batch, use_bf16=True, device=DEVICE, max_instances=MAX_INST,
                      peak_threshold=DIR_PEAK_THRESHOLD, **knobs, **size_kw)
            dirs = [root / t for t in types]
            # The uncounted first batch: each kernel's inputs at each new
            # shape, held against its plain version.
            calls = []
            with recording_kernel_calls(seen, calls):
                predict(str(path), dirs, frames=list(range(batch)), make_labels=False, **kw)
            sync()
            rows = check_recorded_calls(calls)
            del calls
            for r in rows:
                log(f"video_path_kernel {name} {clip} " + json.dumps(r))
            held += rows
            for k in kernels.values():
                k.launches = 0
            from_file = predict(str(path), dirs, **kw)
            sync()
            launches = {k_name: k.launches for k_name, k in kernels.items()}
            n_frames = len(decoded[clip])
            n_batches = -(-n_frames // batch)
            want = dict(zip(("fused_double_conv3x3", "nms_scores", "paf_line_scores"),
                            (n * n_batches for n in PREDICT_LAUNCHES[launch_row])),
                        multi_confmaps=0)
            if DEVICE != "cpu" and launches != want:
                raise AssertionError(f"phase 20 {name} {clip}: launch counts {launches}, "
                                     f"expected {want}")
            in_memory = predict(ArrayVideo(decoded[clip]), dirs, **kw)
            if not labels_equal(from_file, in_memory):
                raise AssertionError(f"phase 20 {name} {clip}: Labels from the file differ "
                                     "from those of the frames decoded into memory")
            n_inst = sum(len(lf) for lf in from_file)
            if n_inst == 0:
                raise AssertionError(f"phase 20 {name} {clip}: no instance")
            if launch_row == "centroid":
                for lf in from_file:
                    if len(lf.centroids) != len(lf.instances) or not all(
                            len(i.points) == 1 and np.array_equal(i.points[0], c.point)
                            for i, c in zip(lf.instances, lf.centroids)):
                        raise AssertionError(f"phase 20 {name} {clip}: frame {lf.frame_idx} "
                                             "centroids and instances differ")
            row = {"fps_file": from_file.provenance["stats"]["fps"],
                   "fps_memory": in_memory.provenance["stats"]["fps"],
                   "decode_ms_per_frame": decode_ms[clip], "n_frames": n_frames,
                   "batch": batch, "instances": n_inst, "launches": launches,
                   "n_batches": n_batches, "device": smi}
            stats[f"{name}/{clip}"] = row
            log(f"video_predict {name} {clip} " + json.dumps(row))
    log("video_containers " + json.dumps(sorted(clips)))
    bad = [r for r in held if not r["ok"]]
    if bad:
        raise AssertionError(f"phase 20: kernels disagree with their plain versions at the "
                             f"paths' shapes: {bad}")
    return stats, held


# --------------------------------------------------------------------------
# Phase 21: video files, the card against the CPU
# --------------------------------------------------------------------------


def train_second_centroid_dir(root, first_dir):
    """The source of phase 21's head swap: ``first_dir``'s centroid model
    trained 3 steps more from another seed on other labels, then
    conditioned (``condition_weights``) and saved as a dir of its own. A
    head trained over another backbone from scratch gives broad flat maps
    on this one, full of near-ties that the card and the CPU break apart."""
    import torch

    from sleap_nn_tpu_torch.inference.loaders import load_model
    from sleap_nn_tpu_torch.training import ModelTrainer

    labels = blob_labels(10, 128, 5, 3, seed=21)
    cfg = training_config(8, 16, 128, 4, augment=False, max_epochs=1, train_steps_per_epoch=3,
                          save_ckpt=True, ckpt_dir=str(root / "narrow_b"), run_name="centroid",
                          seed=21)
    trainer = ModelTrainer.get_model_trainer_from_config(
        cfg, [labels.extract(range(8))], [labels.extract(range(8, 10))], device="cpu")
    trainer.setup()
    with torch.no_grad():
        trainer.model.load_state_dict(load_model(first_dir).model.state_dict())
    trainer.train()
    condition_weights(trainer.model, labels.video.frames)
    trainer.save_checkpoint("best.ckpt")
    return trainer.ckpt_dir


# Phase 21: each f32 centroid map (card, CPU) must lie within this of the
# f64 one, else the devices part by more than float noise.
F64_BOUND = 1e-5
# Phase 21's first centroid threshold, where the search for one that
# clears every near-tie starts, and its step.
TIE_FLOOR, TIE_STEP = 0.5, 0.01


def neighbour_max(maps):
    """The largest of each cell's 8 neighbours in ``(B, H, W)`` maps
    (cells outside count -inf): a cell above it is a strict 3x3 local
    maximum, the NMS kernel's rule."""
    h, w = maps.shape[1:]
    pad = np.pad(maps, ((0, 0), (1, 1), (1, 1)), constant_values=-np.inf)
    return np.max([pad[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                   for dy in (-1, 0, 1) for dx in (-1, 0, 1) if dy or dx], axis=0)


def centroid_near_ties(paths, kw, frames):
    """The witness behind a phase-21 run's centroid threshold: the centroid
    maps of ``frames`` (the host frames both devices were sent) on the
    card and on the CPU in f32, and on the CPU in f64 (the same model and
    input). With ``d`` the largest difference between the two f32 maps,
    no cell moves by more than ``d`` from one device to the other, so a
    local maximum more than ``2 d`` above its neighbours, and more than
    ``d`` from the threshold, is a peak on both or on neither. The margin
    is ``4 d`` (at least 1e-6). A near-tie is a strict local maximum above
    ``TIE_FLOOR`` on any map within the margin of its largest neighbour
    on any map, or a peak on one f32 map and not on the other. Returns the
    near-ties (cell and, per map, the value and its largest neighbour),
    ``d``, each f32 map's largest difference from the f64 one, and the
    lowest threshold from ``TIE_FLOOR`` up in steps of ``TIE_STEP`` above
    every near-tie and away from every peak by more than the margin, with
    the card's peaks above it."""
    import copy

    import torch

    from sleap_nn_tpu_torch.inference.layers import preprocess_images
    from sleap_nn_tpu_torch.inference.predictor import Predictor

    maps = {}
    for name, device in (("card", DEVICE), ("cpu", "cpu")):
        layer = Predictor.from_model_paths(paths, device=device, **kw).layer
        c = getattr(layer, "centroid_layer", layer)
        f64 = copy.deepcopy(c.backend.model).to("cpu", torch.float64)
        parts = {name: [], "f64": []}
        with torch.no_grad():
            for i in range(0, len(frames), 4):  # the path's batches
                x, _ = preprocess_images(c.pre, torch.from_numpy(frames[i:i + 4]).to(device))
                parts[name].append(c.backend(x)[c.head_name][..., 0].float().cpu().numpy())
                if name == "cpu":
                    parts["f64"].append(f64(x.double())[c.head_name][..., 0].numpy())
        maps.update({k: np.concatenate(v) for k, v in parts.items() if v})
    d = float(np.abs(maps["card"] - maps["cpu"]).max())
    margin = max(4 * d, 1e-6)
    nbr = {k: neighbour_max(m) for k, m in maps.items()}
    local_max = {k: m > nbr[k] for k, m in maps.items()}
    peak = {k: local_max[k] & (m > TIE_FLOOR) for k, m in maps.items()}
    close = np.any([np.abs(m - nbr[k]) <= margin for k, m in maps.items()], axis=0)
    ties = ((peak["card"] | peak["cpu"] | peak["f64"]) & close) | (peak["card"] != peak["cpu"])
    tie_top = max((float(maps[k][ties].max()) for k in maps if ties.any()), default=-np.inf)
    peak_vals = np.concatenate([m[local_max[k] & (m > TIE_FLOOR - margin)]
                                for k, m in maps.items()])
    threshold = TIE_FLOOR
    while tie_top >= threshold - margin or (np.abs(peak_vals - threshold) <= margin).any():
        threshold = round(threshold + TIE_STEP, 2)
    rows = [{"frame": int(b), "cell": [int(y), int(x)],
             **{k: [float(maps[k][b, y, x]), float(nbr[k][b, y, x])] for k in maps},
             "peak_on": [k for k in maps if peak[k][b, y, x]]}
            for b, y, x in zip(*np.nonzero(ties))]
    return {"near_ties": sorted(rows, key=lambda r: -r["cpu"][0])[:20], "n_near_ties": len(rows),
            "card_vs_cpu": d, "margin": margin,
            "card_vs_f64": float(np.abs(maps["card"] - maps["f64"]).max()),
            "cpu_vs_f64": float(np.abs(maps["cpu"] - maps["f64"]).max()),
            "peaks_at_floor": {k: int(v.sum()) for k, v in peak.items()},
            "threshold": threshold,
            "card_peaks_at_threshold": int((local_max["card"] & (maps["card"] > threshold)).sum())}


def check_video_against_cpu(dirs, second_centroid, tmp):
    """Phase 21: phase 14's narrow dirs predict a 24-frame MJPG clip of
    phase 16's blob animals through ``run.predict`` on the card and on the
    CPU in f32 (``compare_outputs``: counts, validity and NaN placement
    exact, keypoints to 1e-4 px, values to 1e-5). Runs: top-down with
    ``host_resize`` at ``input_scale`` 0.5 (the frames each side copies to
    the device must be equal, at half the size), centroid-only, and the
    centroid model with its head swapped in from ``second_centroid``
    (``head_ckpt_path``; a one-model source cannot swap the heads of a
    pair, which raises as in the JAX package).

    These weak models' centroid maps hold dozens of local maxima a frame
    in the flat tails of their responses, some within float noise of a
    neighbour, which the two devices may break apart. Each run first runs
    at centroid threshold ``TIE_FLOOR`` and logs whether the devices agree
    there, then finds its near-ties (``centroid_near_ties``, on the frames
    the devices were sent), requires both f32 maps to lie within
    ``F64_BOUND`` of the f64 one, so that a disagreement there is a tie
    and not a fault, and runs again at the lowest threshold that clears
    them, where the devices must agree."""
    from sleap_nn_tpu_torch.inference.predictor import Predictor
    from sleap_nn_tpu_torch.inference.run import predict

    video, _ = moving_blob_clip(24, 128, 5, seed=16)
    path = str(write_clip(tmp / "narrow.avi", video.frames, "MJPG"))
    pair = [dirs["centroid"], dirs["centered_instance"]]
    # name, dirs, knobs, the knob that sets the centroid threshold.
    runs = (("topdown_host_resize", pair,
             {"host_resize": True, "input_scale": 0.5, "max_instances": 64,
              "peak_threshold": 0.5}, "centroid_peak_threshold"),
            ("centroid_only", pair, {"centroid_only": True}, "peak_threshold"),
            ("centroid_head_swap", pair[:1], {"head_ckpt_path": second_centroid},
             "peak_threshold"))
    sent = []
    send = Predictor._send

    def recording_send(self, frames, h2d, device):
        sent.append((frames.shape, frames.tobytes()))
        return send(self, frames, h2d, device)

    def run_both(paths, kw):
        """Both devices' batch outputs and the frames each sent."""
        outs, copies = [], []
        for device in (DEVICE, "cpu"):
            sent.clear()
            Predictor._send = recording_send
            try:
                outs.append(predict(path, paths, batch_size=4, make_labels=False,
                                    device=device, **kw))
            finally:
                Predictor._send = send
            copies.append(list(sent))
        return outs, copies

    report = {}
    for name, paths, kw, knob in runs:
        outs, copies = run_both(paths, {**kw, knob: TIE_FLOOR})
        try:
            at_floor = compare_outputs(*outs)
        except AssertionError as exc:
            at_floor = {"disagree": str(exc)[:300]}
        frames = np.concatenate([np.frombuffer(b, np.uint8).reshape(shape)
                                 for shape, b in copies[1]])
        witness = centroid_near_ties(paths, kw, frames)
        log(f"video_near_ties {name} " + json.dumps({"at_floor": at_floor, **witness}))
        if max(witness["card_vs_f64"], witness["cpu_vs_f64"]) > F64_BOUND:
            raise AssertionError(f"phase 21 {name}: a map parts from the f64 one by more than "
                                 f"{F64_BOUND:g}: {witness}")
        kw = {**kw, knob: witness["threshold"]}
        outs, copies = run_both(paths, kw)
        if copies[0] != copies[1]:
            raise AssertionError(f"phase 21 {name}: the frames sent to the devices differ")
        shapes = sorted({shape for shape, _ in copies[0]})
        if kw.get("host_resize") and shapes != [(4, 64, 64, 1)]:
            raise AssertionError(f"phase 21 {name}: host-resized frames {shapes}")
        report[name] = compare_outputs(*outs)
        report[name].update(sent=[list(x) for x in shapes], threshold=witness["threshold"],
                            n_near_ties=witness["n_near_ties"], at_floor=at_floor)
        # No frame may reach the cut, where near-equal peaks could rank
        # either way on the two devices.
        report[name]["most_in_a_frame"] = most = max(
            len(frame_instances(out, i)[0]) for out in outs[1] for i in np.flatnonzero(out["valid"]))
        if report[name]["instances"] == 0 or most >= kw.get("max_instances", MAX_PEAKS):
            raise AssertionError(f"phase 21 {name}: {report[name]}")
    try:
        Predictor.from_model_paths(pair, device="cpu", head_ckpt_path=second_centroid)
    except ValueError as exc:
        if "CenteredInstanceConfmapsHead" not in str(exc):
            raise
        report["pair_head_swap_refused"] = str(exc)
    else:
        raise AssertionError("phase 21: a centroid head swapped onto a pair did not raise")
    log("video_card_vs_cpu " + json.dumps(report))
    return report


# --------------------------------------------------------------------------
# Phase 22: training from a video file, and the trainer options
# --------------------------------------------------------------------------

# Phase 22's clip: frames (the last FILE_VAL validate), train steps per run.
FILE_FRAMES, FILE_VAL, FILE_STEPS = 12, 4, 3
# Frames of the option runs (all in the train range) that hold no instance
# (bottom-up with negatives) or only user centroids (centroid model).
FILE_NEGATIVES, FILE_USER_CENTROIDS, NEGATIVE_WEIGHT = (1, 3, 5), (0, 2, 6), 0.5


def file_labels(clip, seed, negatives=(), user_centroids=()):
    """``training_labels``' instances (``FILE_FRAMES`` frames at
    ``TRAIN_IMG``) on the frames of ``clip``, opened by name: frames in
    ``negatives`` hold no instance, frames in ``user_centroids`` one user
    centroid per instance (its nodes' mean) and no pose."""
    from sleap_nn_tpu_torch.io.model import LabeledFrame, Labels, UserCentroid
    from sleap_nn_tpu_torch.io.video import Video

    base = training_labels(FILE_FRAMES, TRAIN_IMG, N_NODES, MAX_INST, seed)
    video = Video.from_filename(str(clip))
    lfs = []
    for lf in base.labeled_frames:
        if lf.frame_idx in negatives:
            lfs.append(LabeledFrame(video, lf.frame_idx, []))
        elif lf.frame_idx in user_centroids:
            cents = [UserCentroid(np.nanmean(i.numpy(), axis=0)) for i in lf.instances]
            lfs.append(LabeledFrame(video, lf.frame_idx, [], centroids=cents))
        else:
            lfs.append(LabeledFrame(video, lf.frame_idx, lf.instances))
    return Labels(lfs, videos=[video], skeletons=base.skeletons)


def file_splits(labels):
    n_train = FILE_FRAMES - FILE_VAL
    return [labels.extract(range(n_train))], [labels.extract(range(n_train, FILE_FRAMES))]


def file_config(root, run_name, model_type="centroid", **trainer):
    """Phase 22's config: the medium_rf model of phase 7 (no augmentation,
    gray input), one epoch of ``FILE_STEPS`` steps into ``root``."""
    kw = dict(max_epochs=1, train_steps_per_epoch=FILE_STEPS, save_ckpt=True,
              ckpt_dir=str(root), run_name=run_name, model_ckpt={"save_last": True})
    cfg = training_config(24, 32, TRAIN_IMG, TRAIN_BATCH, augment=False, model_type=model_type,
                          **{**kw, **trainer})
    cfg.data_config.preprocessing.ensure_grayscale = True
    return cfg


def same_metrics(saved, direct, where):
    """Every value of ``run_evaluation``'s nested dict equal in the saved
    metrics (NaN equal to NaN)."""
    for group, values in direct.items():
        for key, v in (values.items() if isinstance(values, dict) else [(None, values)]):
            got = saved[group] if key is None else saved[group][key]
            a, b = np.asarray(got), np.asarray(v)
            same = (a.shape == b.shape and np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
                    if a.dtype.kind in "fiub" else str(got) == str(v))
            if not same:
                raise AssertionError(f"{where}: {group}.{key} saved {got!r}, computed {v!r}")


def run_counted(kernels, fn):
    """``fn()`` with every launch counter zeroed first; (result, launches)."""
    for k in kernels.values():
        k.launches = 0
    out = fn()
    sync()
    return out, {name: k.launches for name, k in kernels.items()}


def expect_launches(what, launches, phase=22, **want):
    want = {"fused_double_conv3x3": 0, "nms_scores": 0, "paf_line_scores": 0,
            "multi_confmaps": 0, **want}
    if DEVICE != "cpu" and launches != want:  # a CPU rehearsal launches no kernel
        raise AssertionError(f"phase {phase} {what}: launch counts {launches}, "
                             f"expected {want}")


def stored_labels_equal(a, b):
    """``a`` read back from a ``.slp`` file equal to ``b`` as written: the
    same frames and instances, points and point scores bit for bit (NaN
    alike), instance and tracking scores at the file's float32, the same
    track names."""
    if [lf.frame_idx for lf in a] != [lf.frame_idx for lf in b]:
        return False
    for x, y in zip(a.labeled_frames, b.labeled_frames):
        if len(x.instances) != len(y.instances):
            return False
        for i, j in zip(x.instances, y.instances):
            if not (np.array_equal(i.numpy(), j.numpy(), equal_nan=True)
                    and type(i).__name__ == type(j).__name__
                    and (i.track and i.track.name) == (j.track and j.track.name)):
                return False
            if hasattr(j, "point_scores") and not (
                    np.array_equal(i.point_scores, j.point_scores, equal_nan=True)
                    and np.float32(i.score) == np.float32(j.score)
                    and np.float32(i.tracking_score or 0) == np.float32(j.tracking_score or 0)):
                return False
    return True


def check_model_dir_slp(ckpt_dir, train, val, preds, where):
    """The model dir's ``labels_{train,val}_gt_0.slp`` read back by the
    port's reader equal to the splits (points, and the embedded frames to
    the pixel), and ``labels_pr.{train,val}_0.slp`` equal to the recorded
    post-training predictions (``preds``: (labels, predictions) in split
    order). Returns the seconds each read took."""
    from sleap_nn_tpu_torch.io.slp import load_slp

    out = {}
    for split, gt, (_, pr) in (("train", train, preds[0]), ("val", val, preds[1])):
        t0 = time.perf_counter()
        got = load_slp(ckpt_dir / f"labels_{split}_gt_0.slp")
        if [lf.frame_idx for lf in got] != [lf.frame_idx for lf in gt] or not all(
                np.array_equal(a.numpy(), b.numpy(), equal_nan=True)
                and np.array_equal(a.image, b.image) for a, b in zip(got, gt)):
            raise AssertionError(f"{where}: labels_{split}_gt_0.slp differs from the split")
        got_pr = load_slp(ckpt_dir / f"labels_pr.{split}_0.slp")
        if not stored_labels_equal(got_pr, pr) or not len(got_pr):
            raise AssertionError(f"{where}: labels_pr.{split}_0.slp differs from the "
                                 "recorded predictions")
        out[split] = time.perf_counter() - t0
    return out


def run_file_training(kernels, root, centroid_dir):
    """Phase 22: ``run_training`` from labels on an MJPG clip with the
    post-training evaluation, then resume, backbone transfer from
    ``centroid_dir`` (phase 7's), ``save_top_k``, negative frames,
    user centroids and AMSGrad, each on the card. The post-training
    predict's kernel calls are held against their plain versions at each
    shape (``recording_kernel_calls``). Returns the runs' stats by path
    name (launches and batches, for the ``kernels`` line) and the rows of
    ``check_recorded_calls``."""
    import functools

    import torch

    from sleap_nn_tpu_torch import train as ptrain
    from sleap_nn_tpu_torch.evaluation import load_metrics, run_evaluation
    from sleap_nn_tpu_torch.inference import run as prun
    from sleap_nn_tpu_torch.models.model import param_subtree
    from sleap_nn_tpu_torch.training import ModelTrainer

    t_phase = time.perf_counter()
    out_dir = root / "phase22"
    clip = write_clip(root / "phase22.avi", training_labels(
        FILE_FRAMES, TRAIN_IMG, N_NODES, MAX_INST, seed=22).labeled_frames[0].video.frames,
        "MJPG")
    labels = file_labels(clip, seed=22)
    if type(labels.videos[0].backend).__name__ != "MediaVideoBackend":
        raise AssertionError(f"phase 22: the clip opened as {labels.videos[0].backend}")
    train, val = file_splits(labels)
    stats, times = {}, {}

    # run_training with the post-training evaluation; its predictions are
    # recorded, and every local maximum counts (the model trained 3 steps).
    preds, real_predict, real_eval = [], prun.predict, ptrain._eval_split

    def recording_predict(labels_gt, *args, **kwargs):
        out = real_predict(labels_gt, *args, **kwargs)
        preds.append((labels_gt, out))
        return out

    prun.predict = recording_predict
    ptrain._eval_split = functools.partial(real_eval, peak_threshold=EVAL_PEAK_THRESHOLD)
    # The post-training predict (f32, batch 4) is the first full-width path
    # of kernel 1's f32 code at these shapes: each kernel call at each new
    # shape is recorded (a copy of its inputs; the timing includes it) and
    # held against its plain version below.
    calls = []
    t0 = time.perf_counter()
    try:
        with recording_kernel_calls(set(), calls):
            trainer, launches = run_counted(kernels, lambda: ptrain.run_training(
                file_config(out_dir, "centroid"), train, val, device=DEVICE))
    finally:
        prun.predict, ptrain._eval_split = real_predict, real_eval
    times["run_training_s"] = time.perf_counter() - t0
    held = check_recorded_calls(calls)
    del calls
    for r in held:
        log("file_train_kernel " + json.dumps(r))
    bad = [r for r in held if not r["ok"]]
    if bad or (DEVICE != "cpu" and {r["kernel"] for r in held} != {
            "fused_double_conv3x3", "nms_scores"}):
        raise AssertionError(f"phase 22 post-training predict: {len(held)} kernel calls held, "
                             f"{len(bad)} disagree with their plain versions: {bad}")
    n_val = len(trainer.val_loader)
    n_pred = sum(-(-len(gt) // 4) for gt, _ in preds)  # run.predict's batch of 4
    n_renders = FILE_STEPS + n_val + 1
    expect_launches("run_training", launches, multi_confmaps=n_renders,
                    fused_double_conv3x3=9 * n_pred, nms_scores=n_pred)
    # Renders launch kernel 4, the post-training predict's batches kernels 1 and 2.
    stats["file_train"] = {"launches": launches, "n_batches": {
                               "multi_confmaps": n_renders, "fused_double_conv3x3": n_pred,
                               "nms_scores": n_pred},
                           "predict_batches": n_pred, "shapes_held": len(held),
                           "history": trainer.history, "steps_per_sec":
                           trainer.history[-1]["train/steps_per_sec"]}
    files = {p.name for p in trainer.ckpt_dir.iterdir()}
    if len(preds) != 2:
        raise AssertionError(f"phase 22: {len(preds)} post-training predictions")
    # The model dir's .slp files, written by the port's own HDF5 writer.
    slp_read = check_model_dir_slp(trainer.ckpt_dir, train[0], val[0], preds, "phase 22")
    for split, (gt, pr) in zip(("train", "val"), preds):
        n_found = sum(len(lf.instances) for lf in pr)
        direct = run_evaluation(gt, pr, match_method="centroid")
        same_metrics(load_metrics(trainer.ckpt_dir, split=split), direct, f"metrics.{split}.0")
        stats["file_train"][f"{split}_predicted_centroids"] = n_found
    stats["file_train"]["model_dir_files"] = sorted(files)
    stats["file_train"]["model_dir_slp_read"] = slp_read

    # Resume for one epoch from best.ckpt.
    best = torch.load(trainer.ckpt_dir / "best.ckpt", weights_only=True)
    cfg = file_config(out_dir, "resume", max_epochs=best["epoch"] + 2,
                      resume_ckpt_path=str(trainer.ckpt_dir / "best.ckpt"))
    rt = ModelTrainer.get_model_trainer_from_config(cfg, train, val, device=DEVICE)
    _, launches = run_counted(kernels, rt.setup)
    restored = rt.model.state_dict()
    if not all(torch.equal(restored[k].cpu(), best["state_dict"][f"model.{k}"])
               for k in restored) or rt.current_epoch != best["epoch"] + 1:
        raise AssertionError(f"phase 22 resume: parameters or epoch {rt.current_epoch} "
                             f"not restored from {best['epoch']}")
    _, more = run_counted(kernels, rt.train)
    last = torch.load(rt.ckpt_dir / "last.ckpt", weights_only=True)
    if len(rt.history) != 1 or last["epoch"] != best["epoch"] + 1:
        raise AssertionError(f"phase 22 resume: {len(rt.history)} epochs, last epoch "
                             f"{last['epoch']}")
    launches = {k: launches[k] + more[k] for k in launches}
    expect_launches("resume", launches, multi_confmaps=FILE_STEPS + n_val + 1)
    stats["file_resume"] = {"launches": launches, "n_batches": FILE_STEPS + n_val + 1,
                            "resumed_epoch": rt.current_epoch}

    # The backbone from phase 7's centroid dir.
    cfg = file_config(out_dir, "transfer")
    cfg.model_config.pretrained_backbone_weights = str(centroid_dir)
    tt = ModelTrainer.get_model_trainer_from_config(cfg, train, val, device=DEVICE)
    _, launches = run_counted(kernels, tt.setup)
    src = ModelTrainer.load_checkpoint_params(Path(centroid_dir) / "best.ckpt")
    own = tt.model.state_dict()
    backbone = [k for k in own if param_subtree(k) == "backbone"]
    head = [k for k in own if param_subtree(k) != "backbone"]
    if not (all(torch.equal(own[k].cpu(), src[k]) for k in backbone)
            and not all(torch.equal(own[k].cpu(), src[k]) for k in head)):
        raise AssertionError("phase 22 transfer: the backbone is not the source's, or the "
                             "head is")
    expect_launches("transfer setup", launches, multi_confmaps=1)
    stats["file_transfer"] = {"launches": launches, "n_batches": 1,
                              "backbone_tensors": len(backbone), "head_tensors": len(head)}

    # save_top_k=2 over 3 epochs of one step.
    cfg = file_config(out_dir, "top_k", max_epochs=3, train_steps_per_epoch=1,
                      model_ckpt={"save_top_k": 2})
    kt = ModelTrainer.get_model_trainer_from_config(cfg, train, val, device=DEVICE)
    _, launches = run_counted(kernels, kt.train)
    kept = sorted(p.name for p in kt.ckpt_dir.glob("epoch=*.ckpt"))
    if len(kept) != 2:
        raise AssertionError(f"phase 22 save_top_k: {kept}")
    expect_launches("save_top_k", launches, multi_confmaps=3 * (1 + n_val) + 1)
    stats["file_top_k"] = {"launches": launches, "n_batches": 3 * (1 + n_val) + 1,
                           "kept": kept}

    # Bottom-up with negative frames; centroid with user centroids only.
    for path, model_type, kw, extra in (
            ("file_negatives", "bottomup", {"negatives": FILE_NEGATIVES},
             {"use_negative_frames": True, "negative_loss_weight": NEGATIVE_WEIGHT}),
            ("file_user_centroids", "centroid", {"user_centroids": FILE_USER_CENTROIDS}, {})):
        tr, va = file_splits(file_labels(clip, seed=22, **kw))
        cfg = file_config(out_dir, path, model_type)
        for k, v in extra.items():
            setattr(cfg.data_config, k, v)
        if path == "file_user_centroids":
            cfg.model_config.head_configs.centroid.confmaps.centroid_source = "user"
        ot = ModelTrainer.get_model_trainer_from_config(cfg, tr, va, device=DEVICE)
        history, launches = run_counted(kernels, ot.train)
        n_v = len(ot.val_loader)
        expect_launches(path, launches, multi_confmaps=FILE_STEPS + n_v + 1)
        frames_of = {s["frame_idx"]: s for s in ot.train_ds.samples}
        row = {"launches": launches, "n_batches": FILE_STEPS + n_v + 1,
               "train_samples": len(ot.train_ds),
               "losses": [history[-1]["train/loss"], history[-1]["val/loss"]]}
        if path == "file_negatives":
            weights = [frames_of[f]["sample_weight"] for f in FILE_NEGATIVES]
            if weights != [NEGATIVE_WEIGHT] * len(FILE_NEGATIVES) or any(
                    s["sample_weight"] != 1.0 for f, s in frames_of.items()
                    if f not in FILE_NEGATIVES):
                raise AssertionError(f"phase 22 negatives: sample weights {weights}")
            with torch.no_grad():  # their targets through kernel 4: empty
                neg = ot.render(ot.train_ds.make_batch(
                    [i for i, s in enumerate(ot.train_ds.samples)
                     if s["frame_idx"] in FILE_NEGATIVES]), train=False)
            if neg["confmaps"].any() or neg["pafs"].any():
                raise AssertionError("phase 22 negatives: a negative's targets are not empty")
            row["negative_weights"] = weights
        else:
            for f in FILE_USER_CENTROIDS:
                pts = frames_of[f]["instances"][: frames_of[f]["num_instances"]]
                if not len(pts) or np.isnan(pts).any() or not (pts == pts[:, :1]).all():
                    raise AssertionError(f"phase 22 user centroids: frame {f} samples {pts}")
            row["user_centroid_frames"] = list(FILE_USER_CENTROIDS)
        if not np.isfinite(row["losses"]).all():
            raise AssertionError(f"phase 22 {path}: losses {row['losses']}")
        stats[path] = row

    # AMSGrad: 3 steps on the card against the CPU.
    stats["amsgrad_card_vs_cpu"] = check_training_against_cpu(
        "centroid", optimizer={"lr": 1e-4, "amsgrad": True})
    if stats["amsgrad_card_vs_cpu"]["optimizer"] != "AMSGrad":
        raise AssertionError(f"phase 22 amsgrad: {stats['amsgrad_card_vs_cpu']}")
    times["phase_s"] = time.perf_counter() - t_phase
    log("file_training " + json.dumps({"times": times, **{
        k: v for k, v in stats.items() if k != "amsgrad_card_vs_cpu"}}, default=str))
    return {k: v for k, v in stats.items() if "launches" in v}, held


# --------------------------------------------------------------------------
# Phase 23: the command line at full width
# --------------------------------------------------------------------------

# Phase 23's synthetic predictions file: frames, instances a frame, nodes.
SLP_IO_FRAMES, SLP_IO_INSTANCES = 10_000, 6


def slp_io_round_trip(tmp, smi):
    """``save_slp`` then ``load_slp`` of a synthetic predictions file of
    ``SLP_IO_FRAMES`` frames with ``SLP_IO_INSTANCES`` instances of
    ``N_NODES`` nodes each, on the host: seconds each way and MB on disk;
    the labels read back must equal those written."""
    from sleap_nn_tpu_torch.io.model import LabeledFrame, Labels, PredictedInstance, Skeleton
    from sleap_nn_tpu_torch.io.slp import load_slp, save_slp
    from sleap_nn_tpu_torch.io.video import Video

    rng = np.random.default_rng(23)
    shape = (SLP_IO_FRAMES, SLP_IO_INSTANCES, N_NODES)
    pts = rng.uniform(0, IMG, shape + (2,))
    pts[rng.random(shape) < 0.05] = np.nan
    scores = rng.random(shape).astype(np.float32)
    inst_scores = rng.random(shape[:2]).astype(np.float32)
    skel = Skeleton([f"n{i}" for i in range(N_NODES)], edges=list(TREE))
    video = Video(str(tmp / "clip.avi"))
    labels = Labels([LabeledFrame(video, f, [
        PredictedInstance(pts[f, i], skel, point_scores=scores[f, i],
                          score=float(inst_scores[f, i])) for i in range(SLP_IO_INSTANCES)])
        for f in range(SLP_IO_FRAMES)], videos=[video], skeletons=[skel])
    path = tmp / "slp_io.slp"
    t0 = time.perf_counter()
    save_slp(path, labels)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = load_slp(path, open_videos=False)
    load_s = time.perf_counter() - t0
    if not stored_labels_equal(back, labels):
        raise AssertionError("phase 23 slp_io: the predictions read back differ")
    row = {"frames": SLP_IO_FRAMES, "instances": SLP_IO_FRAMES * SLP_IO_INSTANCES,
           "points": int(np.prod(shape)), "save_s": save_s, "load_s": load_s,
           "mb": path.stat().st_size / 1e6, "device": smi}
    path.unlink()
    return row


def run_cli(kernels, root, smi):
    """Phase 23: the command line (``sleap_nn_tpu_torch.cli``) at full
    width, in-process through ``cli.main`` so that launches are counted,
    each command's kernel calls recorded (``recording_kernel_calls``, a
    copy at each new signature, kernel 4 too) and held against their plain
    versions. ``train`` from ``.slp`` files the port wrote (phase 22's
    clip and labels) with the post-training evaluation; ``predict`` of
    phase 13's top-down dirs to ``.slp`` and to an analysis file, and
    ``track`` of its bottom-up dir, each equal, read back by the port's
    reader, to ``run.predict`` in-process with the kwargs the command
    passed; ``track-only``, ``eval`` (its JSON line equal to
    ``run_evaluation``'s summary) and ``info``; ``python -m
    sleap_nn_tpu_torch.cli system`` as a subprocess, naming the card.
    Returns the counted paths' stats, the held rows and the ``slp_io``
    row."""
    import functools
    import io
    import os

    from sleap_nn_tpu_torch import cli
    from sleap_nn_tpu_torch import train as ptrain
    from sleap_nn_tpu_torch.evaluation import run_evaluation
    from sleap_nn_tpu_torch.inference import run as prun
    from sleap_nn_tpu_torch.io import hdf5
    from sleap_nn_tpu_torch.io.slp import load_slp, save_slp

    t_phase = time.perf_counter()
    tmp = root / "phase23"
    tmp.mkdir()
    stats, seen, calls, times = {}, set(), [], {}
    recorded, real_predict = [], prun.predict

    def recording_predict(*args, **kwargs):
        recorded.append((args, dict(kwargs)))
        return real_predict(*args, **kwargs)

    def command(name, argv):
        """``cli.main(argv)``, counted and recorded; its stdout."""
        out = io.StringIO()
        t0 = time.perf_counter()
        with recording_kernel_calls(seen, calls, PATH_WRAPPERS + TRAIN_WRAPPERS), \
                contextlib.redirect_stdout(out):
            code, launches = run_counted(kernels, lambda: cli.main([str(a) for a in argv]))
        times[name] = time.perf_counter() - t0
        if code != 0:
            raise AssertionError(f"phase 23 {name}: exit code {code}; {out.getvalue()[-2000:]}")
        return out.getvalue(), launches

    def expect(name, launches, **want):
        want = {"fused_double_conv3x3": 0, "nms_scores": 0, "paf_line_scores": 0,
                "multi_confmaps": 0, **want}
        if DEVICE != "cpu" and launches != want:
            raise AssertionError(f"phase 23 {name}: launch counts {launches}, expected {want}")

    # train: labels on phase 22's clip, as .slp files the port writes.
    clip22 = write_clip(tmp / "train_clip.avi", training_labels(
        FILE_FRAMES, TRAIN_IMG, N_NODES, MAX_INST, seed=22).labeled_frames[0].video.frames,
        "MJPG")
    train, val = file_splits(file_labels(clip22, seed=22))
    save_slp(tmp / "train.slp", train[0])
    save_slp(tmp / "val.slp", val[0])
    cfg = file_config(tmp / "models", "centroid", max_epochs=3)
    cfg.data_config.train_labels_path = [str(tmp / "train.slp")]
    cfg.data_config.val_labels_path = [str(tmp / "val.slp")]
    if DEVICE == "cpu":
        cfg.trainer_config.trainer_accelerator = "cpu"
    cfg.save_yaml(tmp / "centroid.yaml")
    preds, real_eval = [], ptrain._eval_split

    def recording_eval_predict(labels_gt, *args, **kwargs):
        out = real_predict(labels_gt, *args, **kwargs)
        preds.append((labels_gt, out))
        return out

    prun.predict = recording_eval_predict
    ptrain._eval_split = functools.partial(real_eval, peak_threshold=EVAL_PEAK_THRESHOLD)
    try:
        _, launches = command("train", ["train", tmp / "centroid.yaml",
                                        "trainer_config.max_epochs=1"])
    finally:
        prun.predict, ptrain._eval_split = real_predict, real_eval
    model_dir = tmp / "models" / "centroid"
    n_val = -(-len(val[0]) // TRAIN_BATCH)
    n_pred = sum(-(-len(gt) // 4) for gt, _ in preds)
    n_renders = FILE_STEPS + n_val + 1
    expect("train", launches, multi_confmaps=n_renders, fused_double_conv3x3=9 * n_pred,
           nms_scores=n_pred)
    # The splits as the command read them: their videos probed (``shape``
    # finds the clip's gray content stored as RGB, as the trainer's read did).
    splits = [load_slp(tmp / "train.slp"), load_slp(tmp / "val.slp")]
    for s in splits:
        s.videos[0].shape
    slp_read = check_model_dir_slp(model_dir, *splits, preds, "phase 23 train")
    stats["cli_train"] = {"launches": launches, "n_batches": {
        "multi_confmaps": n_renders, "fused_double_conv3x3": n_pred, "nms_scores": n_pred},
        "slp_read_s": slp_read}

    # predict / track: phase 13's dirs on phase 4's frames as an MJPG clip.
    clip = write_clip(tmp / "clip.avi", smoke_frames(), "MJPG")
    n_batches = -(-N_FRAMES // BATCH)
    common = ["-i", clip, "--device", DEVICE, "-b", BATCH, "--max-instances", MAX_INST,
              "--peak-threshold", DIR_PEAK_THRESHOLD]
    if DEVICE == "cuda":
        common.append("--use-bf16")
    runs = (
        ("cli_predict_topdown", "topdown", ["predict", "-m", root / "centroid",
                                            "-m", root / "centered_instance",
                                            "-o", tmp / "td.slp"]),
        ("cli_predict_analysis", "topdown", ["predict", "-m", root / "centroid",
                                             "-m", root / "centered_instance",
                                             "-o", tmp / "td_a.slp", "--output-format",
                                             "analysis_h5"]),
        ("cli_track_bottomup", "bottomup", ["track", "-m", root / "bottomup", "-o", tmp / "bu.slp",
                                            "--min-line-scores", DIR_MIN_LINE,
                                            "--max-peaks", DIR_MAX_PEAKS, "--max-tracks",
                                            MAX_INST]),
    )
    for name, row, argv in runs:
        recorded.clear()
        prun.predict = recording_predict
        try:
            out, launches = command(name, argv[:1] + common + argv[1:])
        finally:
            prun.predict = real_predict
        want = dict(zip(("fused_double_conv3x3", "nms_scores", "paf_line_scores"),
                        (n * n_batches for n in PREDICT_LAUNCHES[row])))
        expect(name, launches, **want)
        (args, kwargs), = recorded
        ref = tmp / f"{name}.ref.slp"
        real_predict(*args, **{**kwargs, "output_path": ref})
        if "--output-format" in argv:
            got_h5, ref_h5 = tmp / "td_a.analysis.h5", tmp / f"{name}.ref.analysis.h5"
            with hdf5.File(got_h5, "r") as f, hdf5.File(ref_h5, "r") as g:
                keys = set(f.keys())
                if keys != set(g.keys()) or not all(
                        np.array_equal(f[k][()], g[k][()], equal_nan=f[k].dtype.kind == "f")
                        for k in keys - {"provenance", "labels_path"}):
                    raise AssertionError(f"phase 23 {name}: the analysis file differs from "
                                         "run.predict's")
                n_inst = int(f["track_occupancy"][()].sum())
        else:
            got, want_labels = load_slp(argv[argv.index("-o") + 1]), load_slp(ref)
            if not stored_labels_equal(got, want_labels) or set(got.provenance) != set(
                    want_labels.provenance):
                raise AssertionError(f"phase 23 {name}: the .slp differs from run.predict's")
            n_inst = sum(len(lf) for lf in got)
            if row == "bottomup" and not got.tracks:
                raise AssertionError(f"phase 23 {name}: no track")
        if not n_inst:
            raise AssertionError(f"phase 23 {name}: no instance")
        stats[name] = {"launches": launches, "n_batches": n_batches, "instances": n_inst,
                       "output": out.strip().splitlines()[-1]}

    # track-only, eval, info.
    out, launches = command("cli_track_only", ["track-only", "-i", tmp / "td.slp", "-o",
                                                tmp / "td.tracked.slp"])
    expect("track-only", launches)
    tracked = load_slp(tmp / "td.tracked.slp")
    if not tracked.tracks or tracked.provenance.get("pipeline_type") != "tracking_only":
        raise AssertionError(f"phase 23 track-only: {len(tracked.tracks)} tracks")
    pr_val = model_dir / "labels_pr.val_0.slp"
    out, launches = command("cli_eval", ["eval", "-g", tmp / "val.slp", "-p", pr_val])
    expect("eval", launches)
    want_line = cli.eval_summary(run_evaluation(  # the command's defaults
        str(tmp / "val.slp"), str(pr_val), oks_stddev=0.025, oks_scale=None,
        match_threshold=0.0, user_labels_only=True, match_method="auto", anchor_part=None))
    if json.loads(out.strip().splitlines()[-1]) != want_line:
        raise AssertionError(f"phase 23 eval: {out.strip()} against {want_line}")
    out, launches = command("cli_info", ["info", model_dir])
    expect("info", launches)
    missing = [t for t in ("Model Info", "Data", "Training", "Training Results",
                           "Evaluation Metrics (val)", "Files") if t not in out]
    if missing or "labels_pr.val_0.slp" not in out:
        raise AssertionError(f"phase 23 info: sections {missing} missing; {out[-1000:]}")

    # system, as a subprocess of its own.
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-m", "sleap_nn_tpu_torch.cli", "system"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    card = smi.split(",")[0].strip()
    if proc.returncode != 0 or (DEVICE == "cuda" and card not in proc.stdout) \
            or "device smoke test: OK" not in proc.stdout:
        raise AssertionError(f"phase 23 system: exit {proc.returncode}; {proc.stdout[-2000:]} "
                             f"{proc.stderr[-2000:]}")
    stats_system = [ln.strip() for ln in proc.stdout.splitlines()
                    if "accelerator" in ln or "cuda:" in ln or "smoke" in ln]

    held = check_recorded_calls(calls)
    del calls
    for r in held:
        log("cli_kernel " + json.dumps(r))
    bad = [r for r in held if not r["ok"]]
    want_kernels = {"fused_double_conv3x3", "nms_scores", "paf_line_scores", "multi_confmaps"}
    if bad or (DEVICE != "cpu" and {r["kernel"] for r in held} != want_kernels):
        raise AssertionError(f"phase 23: {len(held)} kernel calls held, {len(bad)} disagree "
                             f"with their plain versions: {bad}")
    slp_io = slp_io_round_trip(tmp, smi)
    times["phase_s"] = time.perf_counter() - t_phase
    log("cli " + json.dumps({"times": times, "system": stats_system, **{
        k: {kk: vv for kk, vv in v.items() if kk != "launches"} for k, v in stats.items()}},
        default=str))
    return stats, held, slp_io


# --------------------------------------------------------------------------
# Phases 24-26: tiling and ground-truth centroids
# --------------------------------------------------------------------------

# Phase 24: frames, their size, the tile geometry and the tile chunk; the
# narrow card-against-CPU frames and tile.
TILED_FRAMES, TILED_IMG, TILE, TILE_OVERLAP, TILE_BATCH = 4, 2048, 512, 128, 16
TILED_ANIMALS, TILED_NARROW_HW, TILED_NARROW_TILE = 6, (256, 384), 128
# Phase 25: the frames of phase 7's labels it predicts, and the batch.
GT_FRAMES, GT_BATCH = 8, 4
# Phase 26: frames (6 train, 2 val), tiles a frame, steps an epoch.
TILED_TRAIN_FRAMES, TILED_TRAIN_VAL, TILED_SPF, TILED_STEPS = 8, 2, 4, 5


def animal_frames(n, hw, n_animals, seed, sigma=6.0, points=None):
    """uint8 ``(n, H, W, 1)``: a dark field with ``n_animals`` bright
    animals a frame, each ``N_NODES`` Gaussian blobs of ``sigma`` px around
    its centre (drawn in a window of their own). ``points``, a list, gets
    each frame's ``(n_animals, N_NODES, 2)`` blob centres (x, y)."""
    rng = np.random.default_rng(seed)
    h, w = hw
    out = np.zeros((n, h, w), np.float32)
    r = int(4 * sigma)
    yy, xx = np.mgrid[-r:r + 1, -r:r + 1]
    blob = np.exp(-(yy ** 2 + xx ** 2) / (2 * sigma ** 2)).astype(np.float32)
    for f in range(n):
        animals = []
        for _ in range(n_animals):
            cy, cx = rng.uniform(0.1, 0.9) * h, rng.uniform(0.1, 0.9) * w
            yx = np.stack([cy + rng.normal(0, 0.02 * h, N_NODES),
                           cx + rng.normal(0, 0.02 * w, N_NODES)], axis=1)
            animals.append(yx[:, ::-1])
            for y, x in yx:
                y0, x0 = int(round(y)) - r, int(round(x)) - r
                ys, xs = slice(max(y0, 0), min(y0 + 2 * r + 1, h)), slice(max(x0, 0),
                                                                         min(x0 + 2 * r + 1, w))
                patch = blob[ys.start - y0:ys.stop - y0, xs.start - x0:xs.stop - x0]
                np.maximum(out[f, ys, xs], patch, out=out[f, ys, xs])
        if points is not None:
            points.append(np.stack(animals))
    return (out[..., None] * 255).astype(np.uint8)


def single_instance_model(cfg_cls, n_nodes, seed, **cfg_kw):
    """A single-instance model (confmaps at stride 2) with random weights
    from ``seed``, initialised as in :func:`build_models`."""
    import torch
    from types import SimpleNamespace as ns

    from sleap_nn_tpu_torch.models.model import Model

    cfg = cfg_cls(in_channels=1, output_stride=2, **cfg_kw)
    torch.manual_seed(seed)
    model = Model.from_config("unet", cfg, ns(confmaps=ns(
        part_names=[f"n{i}" for i in range(n_nodes)], sigma=2.5, output_stride=2,
        loss_weight=None)), "single_instance")
    random_init(model)
    return cfg, model


def tiled_layer(cfg, model, mode, device, use_bf16, tile, overlap=None):
    """A ``TiledLayer`` of ``model`` (its one head) in ``mode``; the overlap
    ``TILE_OVERLAP`` unless given."""
    from sleap_nn_tpu_torch.inference.backends import TorchBackend
    from sleap_nn_tpu_torch.inference.layers import (
        PostprocessConfig, PreprocessConfig, TiledLayer)

    return TiledLayer(
        TorchBackend(model, None, use_bf16=use_bf16, output_dtype=None, device=device),
        PreprocessConfig(ensure_grayscale=True, max_stride=cfg.max_stride),
        PostprocessConfig(peak_threshold=0.2), head_name=model.heads[0].name,
        output_stride=2, tile_size=tile, overlap=TILE_OVERLAP if overlap is None else overlap,
        tile_batch_size=TILE_BATCH,
        mode=mode, device=device)


def tiled_stage_times(layer, frame):
    """ms of one frame's tiled predict by stage, each fenced by
    synchronize(): cutting the tiles, the model on them (chunk by chunk),
    the merge and the peaks (local peaks on the canvas: kernel 2). The
    second of two passes is kept."""
    import torch

    from sleap_nn_tpu_torch.inference.tile_merger import merge_tiles
    from sleap_nn_tpu_torch.ops.peaks import find_local_peaks

    x = torch.from_numpy(frame[None]).to(DEVICE)
    origins = layer.tile_grid(x.shape[1:3])
    os_ = layer.output_stride
    origins_os = [(y // os_, x0 // os_) for y, x0 in origins]
    canvas = (x.shape[1] // os_, x.shape[2] // os_)
    times = {}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        times[name] = (time.perf_counter() - t0) * 1e3
        return out

    with torch.inference_mode():
        for _ in range(2):
            tiles = timed("tiling", lambda: layer.frame_tiles(layer.padded_frames(x, origins)[0],
                                                              origins))
            maps = timed("forward", lambda: layer.tile_maps(tiles))
            cms = timed("merge", lambda: merge_tiles(maps, origins_os, canvas, layer._window))
            timed("peaks", lambda: find_local_peaks(cms[None], threshold=0.2,
                                                    refinement="integral"))
    times["sum"] = sum(times.values())
    times["tiles"], times["chunks"] = len(origins), -(-len(origins) // layer.tile_batch_size)
    return times


def canonical_peaks(out, i):
    """Frame ``i``'s valid local peaks ``(channel, x, y, value)``, sorted by
    channel and position (near-equal values may rank two peaks either way
    on two devices)."""
    keep = out["peak_valid"][i]
    rows = np.concatenate([out["peak_channels"][i][keep][:, None].astype(np.float64),
                           out["pred_peaks"][i][keep], out["peak_vals"][i][keep][:, None]],
                          axis=1)
    return rows[np.lexsort((np.round(rows[:, 2], 2), np.round(rows[:, 1], 2), rows[:, 0]))]


def check_tiled_against_cpu():
    """Phase 24's narrow half: ``TiledLayer`` in both modes with narrow
    models (filters 8, max stride 16), conditioned as phase 14's, on
    ``TILED_NARROW_HW`` frames of animals at tile ``TILED_NARROW_TILE``,
    f32 on the card and on the CPU: merged maps to 1e-4 of their largest
    magnitude (the fused conv's f32 tolerance); peak counts, channels and
    NaN placement exact; points to 1e-4 px, values to 1e-5."""
    import torch

    from sleap_nn_tpu_torch.config.model_config import UNetConfig

    frames = animal_frames(2, TILED_NARROW_HW, 2, seed=240, sigma=3.0)
    report = {}
    for mode, model_type in (("local", "centroid"), ("global", "single_instance")):
        if model_type == "centroid":
            cfg, model, _ = build_models(UNetConfig, N_NODES, seed=241, filters=8,
                                         filters_rate=1.5, max_stride=16)
        else:
            cfg, model = single_instance_model(UNetConfig, N_NODES, seed=242, filters=8,
                                               filters_rate=1.5, max_stride=16)
        condition_weights(model, frames)
        outs, maps = [], []
        for device in (DEVICE, "cpu"):
            layer = tiled_layer(cfg, model, mode, device, False, TILED_NARROW_TILE, 32)
            with torch.inference_mode():
                maps.append(layer.merged_maps(torch.from_numpy(frames).to(device)).cpu())
            outs.append(layer.predict(frames))
        err = {"maps_max_abs_err": (maps[0] - maps[1]).abs().max().item(),
               "maps_max": maps[1].abs().max().item()}
        if mode == "local":
            got = [canonical_peaks(outs[0], i) for i in range(len(frames))]
            want = [canonical_peaks(outs[1], i) for i in range(len(frames))]
            err["peaks"] = sum(len(w) for w in want)
            if [len(g) for g in got] != [len(w) for w in want] or any(
                    not np.array_equal(g[:, 0], w[:, 0]) for g, w in zip(got, want)):
                raise AssertionError(f"phase 24 narrow {mode}: peaks differ {err}")
            err["points_max_abs_err"] = max((np.abs(g[:, 1:3] - w[:, 1:3]).max(initial=0.0)
                                             for g, w in zip(got, want)), default=0.0)
            err["values_max_abs_err"] = max((np.abs(g[:, 3] - w[:, 3]).max(initial=0.0)
                                             for g, w in zip(got, want)), default=0.0)
        else:
            g, w = outs[0]["pred_keypoints"], outs[1]["pred_keypoints"]
            if not np.array_equal(np.isnan(g), np.isnan(w)):
                raise AssertionError(f"phase 24 narrow {mode}: NaN placed apart")
            err["peaks"] = int(np.isfinite(w[..., 0]).sum())
            err["points_max_abs_err"] = float(np.nanmax(np.abs(g - w), initial=0.0))
            err["values_max_abs_err"] = float(np.nanmax(np.abs(
                outs[0]["pred_peak_values"] - outs[1]["pred_peak_values"]), initial=0.0))
        report[mode] = err
        if err["maps_max_abs_err"] > 1e-4 * err["maps_max"] or err["peaks"] < len(frames) \
                or err["points_max_abs_err"] > 1e-4 or err["values_max_abs_err"] > 1e-5:
            raise AssertionError(f"phase 24 narrow {mode}: card vs CPU {err}")
    log("tiled_card_vs_cpu " + json.dumps(report))
    return report


def run_tiled_predict(kernels, smi):
    """Phase 24: tiled predict at medium_rf width (bf16) on ``TILED_FRAMES``
    frames of ``TILED_IMG`` squared with animals, tiles of ``TILE``
    overlapping by ``TILE_OVERLAP`` (the grid snapped to the max stride of
    32), ``TILE_BATCH`` tiles a chunk: a centroid model in local mode
    (``layer.predict``: kernel 1 on every chunk, kernel 2 once on the
    merged canvases) and a 15-node single-instance model in global mode
    through ``Predictor.predict`` (batch 2). Every kernel call at each new
    signature is recorded and held against its plain version. Then the
    stage split of one frame and the narrow models on the card against the
    CPU. Returns the counted paths' stats and the held rows."""
    import torch

    from sleap_nn_tpu_torch.config.model_config import UNetMediumRFConfig
    from sleap_nn_tpu_torch.inference.predictor import Predictor
    from sleap_nn_tpu_torch.io.model import Skeleton

    t_phase = time.perf_counter()
    frames = animal_frames(TILED_FRAMES, (TILED_IMG, TILED_IMG), TILED_ANIMALS, seed=24)
    cfg, centroid, _ = build_models(UNetMediumRFConfig, N_NODES, seed=24)
    _, single = single_instance_model(UNetMediumRFConfig, N_NODES, seed=25)
    local = tiled_layer(cfg, centroid, "local", DEVICE, True, TILE)
    glob = tiled_layer(cfg, single, "global", DEVICE, True, TILE)
    n_tiles = len(local.tile_grid((TILED_IMG, TILED_IMG)))
    chunks = -(-n_tiles // TILE_BATCH)
    pred = Predictor(glob, "single_instance", Skeleton([f"n{i}" for i in range(N_NODES)]),
                     batch_size=2, device=DEVICE)
    video = ArrayVideo(frames)
    local.predict(frames[:1])  # warm-up
    pred.predict(ArrayVideo(frames[:2]), make_labels=False)
    seen, calls, stats = set(), [], {}
    with recording_kernel_calls(seen, calls):
        sync()
        t0 = time.perf_counter()
        out, launches = run_counted(kernels, lambda: local.predict(frames))
        local_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        results, g_launches = run_counted(kernels, lambda: pred.predict(video, make_labels=False))
        global_s = time.perf_counter() - t0
        labels = pred.predict(video)
    for name, got, want, n in (
            ("tiled_predict_local", launches, {"fused_double_conv3x3": 9 * chunks * TILED_FRAMES,
                                               "nms_scores": 1}, 1),
            ("tiled_predict_global", g_launches,
             {"fused_double_conv3x3": 9 * chunks * TILED_FRAMES}, -(-TILED_FRAMES // 2))):
        want = {"fused_double_conv3x3": 0, "nms_scores": 0, "paf_line_scores": 0,
                "multi_confmaps": 0, **want}
        if DEVICE != "cpu" and got != want:
            raise AssertionError(f"phase 24 {name}: launch counts {got}, expected {want}")
    canvas = (TILED_IMG // 2, TILED_IMG // 2)
    if out["pred_peaks"].shape[0] != TILED_FRAMES or not out["peak_valid"].any():
        raise AssertionError(f"phase 24 local: {out['peak_valid'].sum()} peaks")
    kp = np.concatenate([r["pred_keypoints"][r["valid"]] for r in results])
    if kp.shape != (TILED_FRAMES, 1, N_NODES, 2) or not np.isfinite(kp).all() \
            or not ((kp >= 0) & (kp < TILED_IMG)).all():
        raise AssertionError(f"phase 24 global: keypoints {kp.shape}")
    if [lf.frame_idx for lf in labels] != list(range(TILED_FRAMES)) or not all(
            np.array_equal(lf.instances[0].points, kp[i, 0].astype(np.float64))
            for i, lf in enumerate(labels.labeled_frames)):
        raise AssertionError("phase 24 global: the Labels do not hold the keypoints")
    held = check_recorded_calls(calls)
    del calls
    for r in held:
        log("tiled_kernel " + json.dumps(r))
    bad = [r for r in held if not r["ok"]]
    if bad or (DEVICE != "cpu" and {r["kernel"] for r in held} != {"fused_double_conv3x3",
                                                                     "nms_scores"}):
        raise AssertionError(f"phase 24: {len(held)} kernel calls held, {len(bad)} disagree "
                             f"with their plain versions: {bad}")
    stages = tiled_stage_times(local, frames[0])
    narrow = check_tiled_against_cpu()
    stats["tiled_predict_local"] = {
        "launches": launches, "n_batches": {"fused_double_conv3x3": chunks * TILED_FRAMES,
                                            "nms_scores": 1},
        "fps": TILED_FRAMES / local_s, "peaks": int(out["peak_valid"].sum()),
        "canvas": [TILED_FRAMES, *canvas, 1]}
    stats["tiled_predict_global"] = {
        "launches": g_launches, "n_batches": {"fused_double_conv3x3": chunks * TILED_FRAMES},
        "fps": TILED_FRAMES / global_s, "predictor_fps": pred.last_stats["fps"]}
    log("tiled_predict " + json.dumps({
        "frames": [TILED_FRAMES, TILED_IMG, TILED_IMG, 1], "tile": TILE,
        "overlap": TILE_OVERLAP, "tiles_per_frame": n_tiles, "chunks_per_frame": chunks,
        "stage_ms_per_frame": stages, "held": len(held), "narrow": narrow,
        "phase_s": time.perf_counter() - t_phase, "device": smi,
        **{k: {kk: vv for kk, vv in v.items() if kk != "launches"} for k, v in stats.items()}}))
    return stats, held


def gt_source(tmp):
    """Phase 25's source: the first ``GT_FRAMES`` frames of phase 7's labels
    on an MJPG clip of their frames, written by the port as a ``.slp``: the
    user instances, plus on odd frames a scored ``PredictedInstance`` beside
    them (mixed frames), and on the last frame predicted instances only."""
    from sleap_nn_tpu_torch.io.model import LabeledFrame, Labels, PredictedInstance
    from sleap_nn_tpu_torch.io.video import Video

    base = training_labels(TRAIN_FRAMES + VAL_FRAMES, TRAIN_IMG, N_NODES, MAX_INST, seed=4)
    frames = base.labeled_frames[0].video.frames[:GT_FRAMES]
    clip = write_clip(tmp / "gt_clip.avi", frames, "MJPG")
    video = Video.from_filename(str(clip))
    rng = np.random.default_rng(25)
    lfs = []
    for f in range(GT_FRAMES):
        user = list(base.labeled_frames[f].instances)
        skel = user[0].skeleton
        preds = [PredictedInstance(i.numpy() + rng.normal(0, 2, i.numpy().shape), skel,
                                   point_scores=rng.uniform(0, 1, N_NODES),
                                   score=float(rng.uniform(0.1, 0.9))) for i in user[:2]]
        insts = preds if f == GT_FRAMES - 1 else user + (preds[:1] if f % 2 else [])
        lfs.append(LabeledFrame(video, f, insts))
    labels = Labels(lfs, videos=[video], skeletons=base.skeletons)
    path = tmp / "gt.slp"
    labels.save(str(path))
    return path, labels


def expected_gt_slots(lf, anchor, user_only):
    """The centroids, validity and values a frame's slots should carry."""
    insts = lf.user_instances if user_only else lf.instances
    cents = np.full((MAX_INST, 2), np.nan)
    vals = np.full(MAX_INST, np.nan)
    for k, inst in enumerate(insts[:MAX_INST]):
        pts = inst.numpy()
        c = pts[anchor] if anchor is not None and np.isfinite(pts[anchor]).all() else \
            np.nanmean(pts, axis=0)
        cents[k] = c
        vals[k] = getattr(inst, "score", None) if hasattr(inst, "point_scores") else 1.0
    return cents, np.isfinite(cents[:, 0]), vals


def run_gt_predict(kernels, root, narrow_labels, narrow_dirs, smi):
    """Phase 25: ``run.predict`` with phase 11's centered-instance dir alone,
    on ground-truth centroids of a ``.slp`` the port wrote (``gt_source``),
    bf16, batch ``GT_BATCH``, ``MAX_INST`` crops a frame: the default
    centroids, ``anchor_part="n0"`` and ``only_labeled_frames``. Each run is
    counted (kernel 1: 9 a batch, on ``(GT_BATCH * MAX_INST, 256, 256, .)``
    crops; no other kernel), its kernel calls recorded and held, its slots
    checked against the source (centroids, validity, the source scores as
    instance scores) and its ``Labels`` against its raw outputs. The top-down
    stage 2 (phase 7's centroid dir with phase 11's) fed the same centroids
    gives the same points and values. The command line (``predict
    --anchor_part``, ``--only_labeled_frames``) gives what ``run.predict``
    gives with its kwargs. Then phase 14's narrow centered-instance dir on
    its labels, the card against the CPU."""
    import torch

    from sleap_nn_tpu_torch import cli
    from sleap_nn_tpu_torch.inference import run as prun
    from sleap_nn_tpu_torch.inference.layers import preprocess_images
    from sleap_nn_tpu_torch.inference.predictor import Predictor
    from sleap_nn_tpu_torch.inference.providers import LabelsProvider
    from sleap_nn_tpu_torch.io.slp import load_slp

    t_phase = time.perf_counter()
    tmp = root / "phase25"
    tmp.mkdir()
    path, source = gt_source(tmp)
    ci_dir = root / "centered_instance"
    kw = dict(batch_size=GT_BATCH, use_bf16=True, device=DEVICE, max_instances=MAX_INST,
              peak_threshold=DIR_PEAK_THRESHOLD)
    seen, calls, stats = set(), [], {}
    prun.predict(str(path), [ci_dir], make_labels=False, **kw)  # warm-up
    for name, extra in (("gt_default", {}), ("gt_anchor", {"anchor_part": "n0"}),
                        ("gt_only_labeled", {"only_labeled_frames": True})):
        with recording_kernel_calls(seen, calls):
            t0 = time.perf_counter()
            results, launches = run_counted(kernels, lambda: prun.predict(
                str(path), [ci_dir], make_labels=False, **kw, **extra))
            elapsed = time.perf_counter() - t0
        user_only = bool(extra.get("only_labeled_frames"))
        lfs = [lf for lf in source.labeled_frames if lf.user_instances or not user_only]
        n_batches = -(-len(lfs) // GT_BATCH)
        expect_launches(name, launches, phase=25, fused_double_conv3x3=9 * n_batches)
        anchor = 0 if "anchor_part" in extra else None
        for b, out in enumerate(results):
            for i in np.flatnonzero(out["valid"]):
                cents, valid, vals = expected_gt_slots(lfs[b * GT_BATCH + i], anchor, user_only)
                if not (np.array_equal(out["instance_valid"][i], valid)
                        and np.allclose(out["pred_centroids"][i], cents, atol=1e-3,
                                        equal_nan=True)
                        and np.array_equal(out["pred_instance_scores"][i], vals.astype(np.float32),
                                           equal_nan=True)):
                    raise AssertionError(f"phase 25 {name}: frame {lfs[b * GT_BATCH + i].frame_idx}"
                                         f" slots differ from the source")
        predictor = Predictor.from_model_paths([ci_dir], anchor_part=extra.get("anchor_part"),
                                               **kw)
        predictor.gt_user_instances_only = user_only
        labels = predictor.predict(load_slp(path))
        n_inst = labels_hold_outputs(labels, results, "topdown")
        scores = sorted({round(i.score, 6) for lf in labels for i in lf.instances})
        if not n_inst or (user_only and scores != [1.0]) or (not user_only and len(scores) < 3):
            raise AssertionError(f"phase 25 {name}: {n_inst} instances, scores {scores}")
        stats[name] = {"launches": launches, "n_batches": n_batches, "instances": n_inst,
                       "fps": len(lfs) / elapsed, "frames": len(lfs)}

    # The top-down stage 2, fed the same centroids.
    gt_pred = Predictor.from_model_paths([ci_dir], **kw)
    td_pred = Predictor.from_model_paths([root / "centroid", ci_dir], **kw)
    gt_layer, td = gt_pred.layer, td_pred.layer
    batch = next(iter(LabelsProvider(load_slp(path), batch_size=GT_BATCH, with_centroids=True,
                                      max_instances=MAX_INST)._gen()))
    dev = {k: torch.from_numpy(getattr(batch, k)).to(DEVICE) for k in (
        "frames", "gt_centroids", "gt_centroid_valid", "gt_centroid_vals")}
    got = gt_layer.finalize(gt_layer.predict_async(
        dev["frames"], dev["gt_centroids"], dev["gt_centroid_valid"], dev["gt_centroid_vals"]))
    with torch.inference_mode():
        inst = td.instance_layer
        x2, eff2 = preprocess_images(inst.pre, dev["frames"])
        s = inst.pre.scale * eff2
        peaks, vals, _ = td._stage2(x2, torch.nan_to_num(dev["gt_centroids"] * s, nan=-1e6),
                                    dev["gt_centroid_valid"])
        want_kp, want_vals = (peaks / s).float().cpu().numpy(), vals.float().cpu().numpy()
    if td.crop_size != gt_layer.crop_size or not (
            np.array_equal(got["pred_keypoints"], want_kp, equal_nan=True)
            and np.array_equal(got["pred_peak_values"], want_vals)):
        raise AssertionError("phase 25: the top-down stage 2 on the same centroids differs")

    # The command line, against run.predict with the kwargs it passed.
    recorded, real_predict = [], prun.predict

    def recording_predict(*args, **kwargs):
        recorded.append((args, dict(kwargs)))
        return real_predict(*args, **kwargs)

    common = ["predict", "-i", path, "-m", ci_dir, "--device", DEVICE, "-b", GT_BATCH,
              "--max-instances", MAX_INST, "--peak-threshold", DIR_PEAK_THRESHOLD]
    if DEVICE == "cuda":
        common.append("--use-bf16")
    for name, extra in (("cli_gt_anchor", ["--anchor_part", "n0"]),
                        ("cli_gt_only_labeled", ["--only_labeled_frames"])):
        out_path = tmp / f"{name}.slp"
        recorded.clear()
        prun.predict = recording_predict
        try:
            with recording_kernel_calls(seen, calls), \
                    contextlib.redirect_stdout(sys.stderr):
                code, launches = run_counted(kernels, lambda: cli.main(
                    [str(a) for a in common + extra + ["-o", out_path]]))
        finally:
            prun.predict = real_predict
        (args, kwargs), = recorded
        if code != 0 or kwargs.get("anchor_part", None) != ("n0" if "anchor" in name else None) \
                or bool(kwargs.get("only_labeled_frames")) != ("only" in name):
            raise AssertionError(f"phase 25 {name}: exit {code}, kwargs {kwargs}")
        ref = tmp / f"{name}.ref.slp"
        real_predict(*args, **{**kwargs, "output_path": ref})
        if not stored_labels_equal(load_slp(out_path), load_slp(ref)):
            raise AssertionError(f"phase 25 {name}: the .slp differs from run.predict's")
        n_batches = stats["gt_only_labeled" if "only" in name else "gt_anchor"]["n_batches"]
        expect_launches(name, launches, phase=25, fused_double_conv3x3=9 * n_batches)
        stats[name] = {"launches": launches, "n_batches": n_batches}

    held = check_recorded_calls(calls)
    del calls
    for r in held:
        log("gt_kernel " + json.dumps(r))
    bad = [r for r in held if not r["ok"]]
    if bad or (DEVICE != "cpu" and {r["kernel"] for r in held} != {"fused_double_conv3x3"}):
        raise AssertionError(f"phase 25: {len(held)} kernel calls held, {len(bad)} disagree "
                             f"with their plain versions: {bad}")

    # The narrow centered-instance dir alone, the card against the CPU.
    runs = [prun.predict(narrow_labels, [narrow_dirs["centered_instance"]], batch_size=4,
                         make_labels=False, device=device, peak_threshold=0.2)
            for device in (DEVICE, "cpu")]
    narrow = compare_outputs(*runs)
    if narrow["instances"] < len(narrow_labels):
        raise AssertionError(f"phase 25 narrow: too few instances {narrow}")
    log("gt_predict " + json.dumps({
        "crops": [GT_BATCH * MAX_INST, gt_layer.crop_size, gt_layer.crop_size, 1],
        "held": len(held), "narrow_card_vs_cpu": narrow,
        "phase_s": time.perf_counter() - t_phase, "device": smi,
        **{k: {kk: vv for kk, vv in v.items() if kk != "launches"} for k, v in stats.items()}}))
    return stats, held


class CacheWatch:
    """A training callback that counts the disk cache's ``.npy`` files at
    each step."""

    def __init__(self, dirs):
        from sleap_nn_tpu_torch.training.callbacks import Callback

        self.dirs, self.counts = dirs, []
        for hook in ("on_train_start", "on_train_end", "on_epoch_start", "on_epoch_end",
                     "on_batch_end"):
            setattr(self, hook, getattr(Callback(), hook))

    def on_batch_start(self, trainer, batch_idx):
        self.counts.append(sum(len(list(Path(d).glob("sample_*.npy"))) for d in self.dirs))


def tiled_config(filters, max_stride, img, tile, spf, model_type, augment, **trainer):
    """``training_config`` with tiled training: tiles of ``tile``, ``spf`` a
    frame (and a ``full_frame_pass`` slot), overlap a quarter tile."""
    cfg = training_config(filters, max_stride, img, TRAIN_BATCH, augment=augment,
                          model_type=model_type, **trainer)
    t = cfg.data_config.preprocessing.tiling
    t.enabled, t.tile_size, t.overlap, t.samples_per_frame = True, tile, tile // 4, spf
    return cfg


def run_tiled_training(kernels, smi):
    """Phase 26: bottom-up training at medium_rf width on
    ``TILED_TRAIN_FRAMES`` frames of ``TILED_IMG`` squared with 1-6 instances
    of 15 nodes, on tiles of ``TILE``: ``TILED_SPF`` tiles a frame plus the
    ``full_frame_pass`` slot, rotation on (the halo path: tiles cut
    ``ceil(TILE * sqrt(2))`` wide, cropped back after the rotation), batch
    4, 2 epochs of ``tiling.steps_per_epoch`` = ``TILED_STEPS``. Kernel 4
    renders every train step, val batch and the setup probe, each call at a
    new signature held against its plain version. Then a narrow tiled
    centroid training through the disk cache
    (``torch_dataset_cache_img_disk``), 3 steps on the card against the CPU;
    its ``.npy`` files are there during training and gone after it."""
    import torch

    from sleap_nn_tpu_torch.training import ModelTrainer

    t_phase = time.perf_counter()
    labels = training_labels(TILED_TRAIN_FRAMES, TILED_IMG, N_NODES, MAX_INST, seed=26)
    n_train = TILED_TRAIN_FRAMES - TILED_TRAIN_VAL
    cfg = tiled_config(24, 32, TILED_IMG, TILE, TILED_SPF, "bottomup", True, max_epochs=2)
    cfg.data_config.preprocessing.tiling.full_frame_pass = True
    cfg.data_config.preprocessing.tiling.steps_per_epoch = TILED_STEPS
    trainer = ModelTrainer.get_model_trainer_from_config(
        cfg, [labels.extract(range(n_train))],
        [labels.extract(range(n_train, TILED_TRAIN_FRAMES))], device=DEVICE)
    if DEVICE != "cpu":
        torch.cuda.reset_peak_memory_stats()
    seen, calls = set(), []
    with recording_kernel_calls(seen, calls, TRAIN_WRAPPERS):
        def train():
            trainer.setup()
            return trainer.train()

        history, launches = run_counted(kernels, train)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30 if DEVICE != "cpu" else None
    ds = trainer.train_ds
    n_val = len(trainer.val_loader)
    renders = 2 * (TILED_STEPS + n_val) + 1
    expect_launches("tiled training", launches, phase=26, multi_confmaps=renders)
    if not (ds.use_halo and ds.halo_size == int(np.ceil(TILE * np.sqrt(2)))
            and ds.samples_per_frame == TILED_SPF + 1 and ds.epoch == 1
            and trainer._input_shape == (1, TILE, TILE, 1) and len(history) == 2
            and np.isfinite([h["train/loss"] for h in history]).all()):
        raise AssertionError(f"phase 26: tiled training {history} (halo {ds.halo_size}, "
                             f"epoch {ds.epoch}, input {trainer._input_shape})")
    halo_batch = ds.make_batch([0, 1, 2, 3])
    rendered = trainer.render(halo_batch, train=True)
    if halo_batch["image"].shape[1] != ds.halo_size or rendered["image"].shape[1:3] != (TILE, TILE):
        raise AssertionError(f"phase 26: the halo render {halo_batch['image'].shape} -> "
                             f"{tuple(rendered['image'].shape)}")
    held = check_recorded_calls(calls)
    del calls
    for r in held:
        log("tiled_train_kernel " + json.dumps(r))
    if any(not r["ok"] for r in held) or (DEVICE != "cpu" and not held):
        raise AssertionError(f"phase 26: kernel 4 calls held {held}")

    # A narrow tiled centroid training through the disk cache, card vs CPU.
    nl = blob_labels(10, 256, 5, 3, seed=26)

    def narrow_cfg():
        c = tiled_config(8, 16, 256, 128, 2, "centroid", False, max_epochs=1,
                         train_steps_per_epoch=3)
        c.data_config.data_pipeline_fw = "torch_dataset_cache_img_disk"
        return c

    split = ([nl.extract(range(8))], [nl.extract(range(8, 10))])
    card = ModelTrainer.get_model_trainer_from_config(narrow_cfg(), *split, device=DEVICE)
    cpu = ModelTrainer.get_model_trainer_from_config(narrow_cfg(), *split, device="cpu")
    card.setup()
    cpu.setup()
    card.model.load_state_dict(cpu.model.state_dict(), strict=True)
    cache_dirs = [card.train_ds.inner.cache_dir, card.val_ds.inner.cache_dir]
    batch = next(iter(cpu.train_loader))
    report = {}
    for step in range(3):
        loss_card, loss_cpu = card.train_step(batch)[0].item(), cpu.train_step(batch)[0].item()
        if step == 0:
            report["loss_rel_err"] = abs(loss_card - loss_cpu) / abs(loss_cpu)
    report["param_max_abs_err"] = max(
        (a.cpu() - b).abs().max().item()
        for a, b in zip(card.model.state_dict().values(), cpu.model.state_dict().values()))
    if report["loss_rel_err"] > 1e-5 or report["param_max_abs_err"] > 1e-5:
        raise AssertionError(f"phase 26 narrow cached: card vs CPU {report}")
    watch = CacheWatch(cache_dirs)
    card.callbacks.append(watch)
    card.train()
    report["npy_files_during_training"] = watch.counts
    report["cache_dirs_after"] = [Path(d).exists() for d in cache_dirs]
    if not watch.counts or min(watch.counts) != len(card.train_ds.inner) + len(
            card.val_ds.inner) or any(report["cache_dirs_after"]):
        raise AssertionError(f"phase 26 narrow cached: {report}")
    cpu.delete_cache()
    stats = {"train_tiled_bottomup": {
        "launches": launches, "n_batches": {"multi_confmaps": renders},
        "steps_per_sec": history[-1]["train/steps_per_sec"],
        "samples_per_sec": history[-1]["train/samples_per_sec"],
        "steps_per_sec_by_epoch": [h["train/steps_per_sec"] for h in history],
        "peak_mem_gib": peak_gib, "train_samples": len(ds), "val_batches": n_val,
        "halo": ds.halo_size, "history": history}}
    log("tiled_training " + json.dumps({
        **{k: {kk: vv for kk, vv in v.items() if kk != "launches"} for k, v in stats.items()},
        "held": len(held), "narrow_cached_card_vs_cpu": report,
        "phase_s": time.perf_counter() - t_phase, "device": smi}))
    return stats, held


# --------------------------------------------------------------------------
# Phases 27-30: the other backbones and SLEAP v1 model dirs
# --------------------------------------------------------------------------

# Phase 27-30's full-width backbones (published widths, random weights).
CONVNEXT_TINY = {"convnext": {"model_type": "tiny", "output_stride": 2, "max_stride": 32}}
SWINT_TINY = {"swint": {"model_type": "tiny", "window_size": 7, "output_stride": 2,
                        "max_stride": 32}}
# name, the built-in id (no snapshot on the card: random init), head stride.
PRETRAINED_BUILTINS = (("convnextv2", "facebook/convnextv2-tiny-22k-224", 2),
                       ("resnet", "microsoft/resnet-50", 2),
                       ("swinv2", "microsoft/swinv2-tiny-patch4-window8-256", 2),
                       ("dinov2", "facebook/dinov2-small", 14))
# SLEAP v1 UNet at the importer's defaults.
V1_UNET = {"filters": 32, "filters_rate": 1.5, "max_stride": 16, "output_stride": 2,
           "stem_stride": None, "middle_block": True, "up_interpolate": True, "stacks": 1}
# The narrow archs of the card-against-CPU checks (the CPU tests' widths).
NARROW_BACKBONES = {
    "convnext": {"convnext": {"arch": {"depths": [1, 1, 1, 1], "channels": [8, 16, 32, 64]},
                              "output_stride": 2, "max_stride": 32}},
    "swint": {"swint": {"arch": {"embed": 8, "depths": [1, 2, 1, 1],
                                 "num_heads": [2, 2, 2, 2]},
                        "window_size": 4, "output_stride": 2, "max_stride": 32}},
}
NARROW_PRETRAINED = {
    "convnextv2": {"model_type": "convnextv2", "depths": [1, 1, 2, 1],
                   "hidden_sizes": [8, 16, 24, 32]},
    "resnet": {"model_type": "resnet", "depths": [1, 2, 1, 1], "hidden_sizes": [8, 16, 24, 32],
               "embedding_size": 8, "layer_type": "bottleneck"},
    "swinv2": {"model_type": "swinv2", "embed_dim": 16, "depths": [1, 2, 1, 1],
               "num_heads": [2, 2, 2, 2], "window_size": 4, "image_size": 64, "patch_size": 4},
    "dinov2": {"model_type": "dinov2", "hidden_size": 32, "num_hidden_layers": 2,
               "num_attention_heads": 2, "patch_size": 8, "image_size": 32},
}
# Launches per predict batch of phases 27-30's paths: fused conv, NMS, PAF.
# The fused conv runs in UNets only; a single-instance model takes global
# peaks (no NMS).
BACKBONE_LAUNCHES = {"topdown": (0, 1, 0), "bottomup": (0, 1, 1), "single_instance": (0, 0, 0),
                     "topdown_v1": (14, 1, 0)}


def skeleton_dict(n_nodes):
    return {"name": "skeleton", "nodes": [{"name": f"n{i}"} for i in range(n_nodes)],
            "edges": [{"source": {"name": f"n{a}"}, "destination": {"name": f"n{b}"}}
                      for a, b in bottomup_edges(n_nodes)], "symmetries": []}


def dir_config(backbone, model_type, n_nodes, crop=None, head_stride=2):
    """A model dir's training config (a dict) of ``backbone`` and one head set."""
    parts = [f"n{i}" for i in range(n_nodes)]
    heads = {
        "centroid": {"confmaps": {"anchor_part": None, "sigma": 5.0, "output_stride": 2}},
        "centered_instance": {"confmaps": {"part_names": parts, "anchor_part": None,
                                           "sigma": 2.5, "output_stride": 2}},
        "single_instance": {"confmaps": {"part_names": parts, "sigma": 2.5,
                                         "output_stride": head_stride}},
        "bottomup": {"confmaps": {"part_names": parts, "sigma": 2.5, "output_stride": 2},
                     "pafs": {"edges": [[f"n{a}", f"n{b}"] for a, b in bottomup_edges(n_nodes)],
                              "sigma": 15.0, "output_stride": 4}},
    }[model_type]
    return {"data_config": {"preprocessing": {"crop_size": crop},
                            "skeletons": [skeleton_dict(n_nodes)]},
            "model_config": {"backbone_config": backbone, "head_configs": {model_type: heads}},
            "trainer_config": {"run_name": model_type}}


def random_model(config, seed):
    """The port model of a dir config, with torch's init from ``seed``."""
    import torch

    from sleap_nn_tpu_torch.config import TrainingJobConfig
    from sleap_nn_tpu_torch.inference.loaders import build_model

    torch.manual_seed(seed)
    return build_model(TrainingJobConfig.from_dict(json.loads(json.dumps(config))), ROOT)[1]


def write_port_dir(d, config, model):
    """A model dir as the port's trainer writes it: ``training_config.yaml``
    and ``best.ckpt`` (the ``state_dict`` under ``model.``)."""
    import torch

    from sleap_nn_tpu_torch.config import TrainingJobConfig

    d.mkdir(parents=True, exist_ok=True)
    TrainingJobConfig.from_dict(json.loads(json.dumps(config))).save_yaml(
        d / "training_config.yaml")
    torch.save({"state_dict": {f"model.{k}": v.detach().cpu()
                               for k, v in model.state_dict().items()},
                "epoch": 0, "best_val_loss": 0.0}, d / "best.ckpt")
    return d


def v1_skeleton(n_nodes):
    """A SLEAP v1 jsonpickle skeleton: a node's first mention is its
    object, later ones ``py/id`` back-references (1-based)."""
    ids = {}

    def node(i):
        if i in ids:
            return {"py/id": ids[i]}
        ids[i] = len(ids) + 1
        return {"py/object": "sleap.skeleton.Node", "py/state": {"py/tuple": [f"n{i}", 1.0]}}

    links = [{"key": 0, "source": node(a), "target": node(b)} for a, b in bottomup_edges(n_nodes)]
    for i in range(n_nodes):
        node(i)
    return {"directed": True, "graph": {"name": "skeleton"}, "links": links, "multigraph": True,
            "nodes": [{"id": {"py/id": ids[i]}} for i in range(n_nodes)]}


def v1_config(model_type, n_nodes, unet, crop=None):
    parts = [f"n{i}" for i in range(n_nodes)]
    heads = {"centroid": {"anchor_part": None, "sigma": 5.0, "output_stride": 2},
             "centered_instance": {"part_names": parts, "anchor_part": None, "sigma": 2.5,
                                   "output_stride": 2}}
    return {"data": {"labels": {"skeletons": [v1_skeleton(n_nodes)]},
                     "preprocessing": {"ensure_grayscale": True, "input_scaling": 1.0},
                     "instance_cropping": {"crop_size": crop}},
            "model": {"backbone": {"unet": unet}, "heads": {model_type: heads[model_type]}},
            "optimization": {}, "outputs": {"run_name": model_type}}


def write_v1_dir(d, legacy, model):
    """A SLEAP v1 model dir of ``model``'s weights: ``training_config.json``
    and a Keras ``best_model.h5`` (``model_weights/<layer>/<layer>/kernel:0``,
    HWIO kernels, a transposed conv's as ``(h, w, OUT, IN)``), written with
    the port's ``io/hdf5.py`` (the card machine has no h5py)."""
    from sleap_nn_tpu_torch.io import hdf5
    from sleap_nn_tpu_torch.weights import torch_key_paths

    weights = {}
    state = model.state_dict()
    for key, (path, kind) in torch_key_paths(model).items():
        parts = key.split(".")
        layer = parts[-2] if parts[0] == "backbone" else f"{parts[2]}_0"
        value = state[key].detach().cpu().numpy()
        if kind == "conv_kernel":
            value = value.transpose(2, 3, 1, 0)
        elif kind == "trans_conv_kernel":
            value = np.swapaxes(value.transpose(2, 3, 0, 1)[::-1, ::-1], -1, -2)
        weights.setdefault(layer, {})[path[-1]] = np.ascontiguousarray(value, np.float32)
    d.mkdir(parents=True, exist_ok=True)
    (d / "training_config.json").write_text(json.dumps(legacy))
    names = sorted(weights)
    with hdf5.File(d / "best_model.h5", "w") as f:
        f.attrs["backend"] = "tensorflow"
        f.attrs["keras_version"] = "2.3.1"
        f.attrs["model_config"] = json.dumps({"class_name": "Model"})
        mw = f.create_group("model_weights")
        mw.attrs["layer_names"] = np.array([n.encode() for n in names])
        for name in names:
            g = mw.create_group(name)
            g.attrs["weight_names"] = np.array([f"{name}/{k}:0".encode()
                                                for k in sorted(weights[name])])
            inner = g.create_group(name)
            for k in sorted(weights[name]):
                inner.create_dataset(f"{k}:0", data=weights[name][k])
    return d


def backbone_dirs(root):
    """Phase 27-30's full-width dirs: (path name, dirs, run.predict knobs)."""
    runs = []
    cfg_c = dir_config(CONVNEXT_TINY, "centroid", N_NODES)
    cfg_i = dir_config(CONVNEXT_TINY, "centered_instance", N_NODES, crop=CROP)
    runs.append(("topdown_convnext", "topdown", [
        write_port_dir(root / "convnext_centroid", cfg_c, random_model(cfg_c, 27)),
        write_port_dir(root / "convnext_ci", cfg_i, random_model(cfg_i, 28))]))
    cfg_b = dir_config(SWINT_TINY, "bottomup", N_NODES)
    runs.append(("bottomup_swint", "bottomup", [
        write_port_dir(root / "swint_bottomup", cfg_b, random_model(cfg_b, 29))]))
    for i, (name, model_name, stride) in enumerate(PRETRAINED_BUILTINS):
        cfg = dir_config({"pretrained": {"model_name": model_name, "output_stride": 2}},
                         "single_instance", N_NODES, head_stride=stride)
        model = random_model(cfg, 30 + i)
        runs.append((f"single_instance_{name}", "single_instance",
                     [write_port_dir(root / f"pretrained_{name}", cfg, model)]))
    from sleap_nn_tpu_torch.legacy_models import legacy_config_mapper

    v1 = []
    for model_type, crop, seed in (("centroid", None, 40), ("centered_instance", CROP, 41)):
        legacy = v1_config(model_type, N_NODES, V1_UNET, crop)
        cfg = legacy_config_mapper(legacy)
        cfg.model_config.backbone_config.unet.in_channels = 1
        v1.append(write_v1_dir(root / f"v1_{model_type}", legacy,
                               random_model(cfg.to_dict(), seed)))
    runs.append(("topdown_v1", "topdown_v1", v1))
    return runs


def run_backbone_predict(kernels, smi):
    """Phases 27-30: ``run.predict`` from full-width model dirs of the other
    backbones and of SLEAP v1 (random weights, 20 frames of 1024x1024 with
    6 animals of 15 blobs, batch 8, bf16, every local peak counted):
    top-down ConvNeXt
    tiny for both stages (27), bottom-up SwinT tiny, window 7 (28),
    single-instance on each pretrained built-in (29: ConvNeXtV2-tiny,
    ResNet-50, Swinv2-tiny, DINOv2-small; random init, as no snapshot is
    there: ``load_hf_encoder_params`` must warn) and a SLEAP v1 top-down
    pair at the importer's default widths, its ``best_model.h5`` written
    by the port's own HDF5 writer (30). Each loads strictly; launch counts
    per batch as ``BACKBONE_LAUNCHES`` (the fused conv in the v1 UNets
    only); every kernel call at each new signature held against its plain
    version at phase 3's tolerances. Returns the runs and the held rows."""
    import warnings

    import torch

    from sleap_nn_tpu_torch.inference.loaders import load_model
    from sleap_nn_tpu_torch.inference.run import predict
    from sleap_nn_tpu_torch.models.pretrained import load_hf_encoder_params

    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    t0 = time.perf_counter()
    runs_def = backbone_dirs(root)
    write_s = time.perf_counter() - t0
    # Animals of blobs: random smooth maps (SwinT's) hold no local peak on noise.
    frames = animal_frames(N_FRAMES, (IMG, IMG), MAX_INST, seed=27)
    n_batches = -(-N_FRAMES // BATCH)
    seen, calls, runs, stats = set(), [], {}, {}
    for name, kind, dirs in runs_def:
        loaded = [load_model(d) for d in dirs]
        if name.startswith("single_instance_"):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                _, got = load_hf_encoder_params(
                    loaded[0].backbone_config.model_name, loaded[0].model.state_dict())
            if got or not any("No local snapshot" in str(w.message) for w in caught):
                raise AssertionError(f"{name}: the pretrained import did not warn")
        kw = dict(batch_size=BATCH, use_bf16=True, device=DEVICE,
                  peak_threshold=DIR_PEAK_THRESHOLD, max_instances=MAX_INST)
        if kind == "bottomup":
            kw.update(min_line_scores=DIR_MIN_LINE, max_peaks=DIR_MAX_PEAKS, paf_workers=0)
        predict(frame_labels(frames[:BATCH]), dirs, make_labels=False, **kw)  # warm-up
        sync()
        with recording_kernel_calls(seen, calls):
            labels, launches = run_counted(kernels, lambda: predict(
                frame_labels(frames), dirs, **kw))
        want = dict(zip(("fused_double_conv3x3", "nms_scores", "paf_line_scores"),
                        (n * n_batches for n in BACKBONE_LAUNCHES[kind])), multi_confmaps=0)
        if DEVICE != "cpu" and launches != want:
            raise AssertionError(f"phases 27-30 {name}: launches {launches}, expected {want}")
        # Random weights: a frame may hold no instance, the run must hold some.
        kp = [inst.numpy() for lf in labels for inst in lf.instances]
        if not kp or not all(np.isfinite(k).any() for k in kp):
            raise AssertionError(f"phases 27-30 {name}: {len(labels.labeled_frames)} frames, "
                                 f"{len(kp)} instances")
        pstats = labels.provenance["stats"]
        runs[f"backbone_{name}"] = {"launches": launches, "n_batches": n_batches,
                                    "fps": pstats["fps"]}
        stats[name] = {"fps": pstats["fps"], "launches": launches, "instances": len(kp),
                       "frames_with_instances": len(labels.labeled_frames),
                       "params_m": sum(p.numel() for lm in loaded
                                       for p in lm.model.parameters()) / 1e6,
                       "backbone": [lm.config.model_config.backbone_config.which()
                                    for lm in loaded]}
        del labels, loaded
        if DEVICE != "cpu":
            torch.cuda.empty_cache()
    held = check_recorded_calls(calls)
    del calls
    for r in held:
        log("backbone_kernel " + json.dumps(r))
    if any(not r["ok"] for r in held) or (DEVICE != "cpu" and not held):
        raise AssertionError(f"phases 27-30: kernel calls held {held}")
    log("backbone_predict " + json.dumps({"paths": stats, "held": len(held),
                                          "write_dirs_s": write_s, "frames": N_FRAMES,
                                          "batch": BATCH, "img": IMG, "device": smi}))
    tmp.cleanup()
    return runs, held


def narrow_backbone_dirs(root, labels):
    """Narrow conditioned dirs of each new path (the CPU tests' widths) on
    ``labels`` (5 nodes): name -> (dirs, run.predict knobs)."""
    frames = labels.video.frames
    out = {}

    def conditioned(config, seed):
        model = random_model(config, seed)
        condition_weights(model, frames)
        return model

    for name, backbone in NARROW_BACKBONES.items():
        if name == "convnext":
            cfgs = [dir_config(backbone, "centroid", 5),
                    dir_config(backbone, "centered_instance", 5, crop=64)]
            out["topdown_convnext"] = ([write_port_dir(root / f"narrow_cn_{i}", c,
                                                       conditioned(c, 50 + i))
                                        for i, c in enumerate(cfgs)],
                                       {"max_instances": 64, "peak_threshold": 0.5})
        else:
            c = dir_config(backbone, "bottomup", 5)
            out["bottomup_swint"] = ([write_port_dir(root / "narrow_sw", c, conditioned(c, 52))],
                                     {"min_line_scores": -0.5})
    for name, arch in NARROW_PRETRAINED.items():
        snap = root / f"snapshot_{name}"
        snap.mkdir(parents=True, exist_ok=True)
        (snap / "config.json").write_text(json.dumps(arch))
        stride = 8 if name == "dinov2" else 2
        # normalize off: black stays 0 through the encoder, as phase 14's conditioning needs.
        c = dir_config({"pretrained": {"model_name": str(snap), "output_stride": 2,
                                       "weights": False, "normalize": False}},
                       "single_instance", 5, head_stride=stride)
        out[f"single_instance_{name}"] = (
            [write_port_dir(root / f"narrow_pt_{name}", c, conditioned(c, 53))], {})
    from sleap_nn_tpu_torch.legacy_models import legacy_config_mapper

    unet = dict(V1_UNET, filters=8, max_stride=8)
    v1 = []
    for model_type, crop, seed in (("centroid", None, 54), ("centered_instance", 64, 55)):
        legacy = v1_config(model_type, 5, unet, crop)
        cfg = legacy_config_mapper(legacy)
        cfg.model_config.backbone_config.unet.in_channels = 1
        v1.append(write_v1_dir(root / f"narrow_v1_{model_type}", legacy,
                               conditioned(cfg.to_dict(), seed)))
    out["topdown_v1"] = (v1, {"max_instances": 64, "peak_threshold": 0.5})
    return out


def check_backbone_dirs_against_cpu(smi):
    """Phases 27-30 on the card against the CPU: each new path's narrow dir
    (conditioned weights, as phase 14's), predicted through ``run.predict``
    in f32 on both, held by ``compare_outputs`` (keypoints to 1e-4 px,
    values to 1e-5, counts exact)."""
    from sleap_nn_tpu_torch.inference.run import predict

    tmp = tempfile.TemporaryDirectory()
    labels = blob_labels(8, 128, 5, 3, seed=27)
    report = {}
    for name, (dirs, kw) in narrow_backbone_dirs(Path(tmp.name), labels).items():
        outs = [predict(frame_labels(labels.video.frames), dirs, batch_size=4,
                        make_labels=False, device=device, **kw) for device in (DEVICE, "cpu")]
        report[name] = compare_outputs(*outs)
        if not report[name]["instances"]:
            raise AssertionError(f"phases 27-30 narrow {name}: no instance")
    log("backbone_card_vs_cpu " + json.dumps({"paths": report, "device": smi}))
    tmp.cleanup()
    return report


# --------------------------------------------------------------------------
# Phases 31-33: training the other backbones, card against CPU, DDP
# --------------------------------------------------------------------------

# Phase 31's runs: name, backbone_config (None: the pretrained ResNet-50 of
# the snapshot the phase writes, frozen), model type, animals a frame,
# epoch-end evaluation.
BACKBONE_TRAIN_RUNS = (("convnext_centroid", CONVNEXT_TINY, "centroid", MAX_INST, True),
                       ("swint_bottomup", SWINT_TINY, "bottomup", MAX_INST, False),
                       ("resnet50_single_instance", None, "single_instance", 1, False))
BACKBONE_TRAIN_FRAMES, BACKBONE_TRAIN_VAL = 12, 4
# Steps an epoch of phase 31's trainings (fewer than the UNets' TRAIN_STEPS:
# a ConvNeXt-T step takes about 1.5 s).
BACKBONE_TRAIN_STEPS = 3
# The trained leaves of phase 31's runs that may end where they started
# (every other trained leaf must move). SwinT's patch-embedding and stage-0
# biases: a window that the rotation filled with zeros feeds each
# LayerNorm a constant token (the biases start at 0), and each such
# LayerNorm scales the gradient through it by 1 / sqrt(eps), about 316;
# compounded over the stages, the gradient of these biases passes 1e19,
# its square is inf in Adam's f32 second moment, and their updates are 0
# from then on (on the H100, 9 of SwinT's 195 trained leaves). The JAX
# package's LayerNorms have the same eps, and its biases the same zeros.
BACKBONE_TRAIN_IDLE = {"swint_bottomup": re.compile(
    r"backbone\.enc\.(patch_embed|patch_norm|stage0_block\d+\.\w+(\.\w+)?)\.bias")}
# Launches per predict batch from phase 31's dirs: fused conv, NMS, PAF.
BACKBONE_TRAIN_PREDICT = {"centroid": (0, 1, 0), "bottomup": (0, 1, 1),
                          "single_instance": (0, 0, 0)}
# Phase 32: the largest share of a model's parameter elements that its
# noise mask (noise_elements) may take out of the 1e-5 parameter check.
NOISE_FRACTION_MAX = 0.01
# Phase 32's narrow ViT (the CPU tests' arch).
NARROW_VIT = {"model_type": "vit", "hidden_size": 32, "num_hidden_layers": 2,
              "num_attention_heads": 2, "intermediate_size": 64, "patch_size": 8,
              "image_size": 32}
# Phase 33: frames (10 train: the third batch of 4 is padded; 2 val), the
# steps compared, the steps timed after them.
DDP_FRAMES, DDP_VAL, DDP_STEPS, DDP_TIMED = 12, 2, 3, 10


def animal_labels(n, img, n_animals, seed):
    """Labels over ``animal_frames`` on a noise floor (gray levels 0-15):
    each animal an instance of ``N_NODES`` nodes at its blobs' centres (the
    skeleton of ``bottomup_edges``). On an exactly black background every
    activation of a transformer backbone is 0 from Xavier's zero biases,
    and each LayerNorm there scales its gradient by ``1 / sqrt(eps)``:
    SwinT-tiny's gradients reach 1e28 at 128x128 in the JAX trainer and in
    the port, and inf (so NaN) at 1024x1024."""
    from sleap_nn_tpu_torch.io.model import Instance, LabeledFrame, Labels, Skeleton

    points = []
    frames = animal_frames(n, (img, img), n_animals, seed, points=points)
    floor = np.random.default_rng(seed + 1).integers(0, 16, frames.shape, dtype=np.uint8)
    video = ArrayVideo(np.maximum(frames, floor))
    skel = Skeleton([f"n{i}" for i in range(N_NODES)], edges=bottomup_edges(N_NODES))
    return Labels([LabeledFrame(video, f, [Instance(a, skel) for a in pts])
                   for f, pts in enumerate(points)])


def hf_resnet_key(key):
    """The HF ``ResNetModel`` key of a key of the port's ResNet encoder (the
    inverse of ``models.pretrained._map_resnet_key``)."""
    mod, leaf = key.rsplit(".", 1)
    if mod in ("stem_conv", "stem_bn"):
        return "embedder.embedder." + ("convolution" if mod == "stem_conv"
                                       else "normalization") + f".{leaf}"
    block, sub = mod.split(".")
    stage, index = block[len("stage"):].split("_block")
    base = f"encoder.stages.{stage}.layers.{index}"
    kind = "convolution" if "conv" in sub else "normalization"
    if sub.startswith("shortcut"):
        return f"{base}.shortcut.{kind}.{leaf}"
    return f"{base}.layer.{sub[-1]}.{kind}.{leaf}"


def write_safetensors(path, tensors):
    """``tensors`` (name -> array, stored f32) as a ``.safetensors`` file: an
    8-byte little-endian header length, the JSON header, the buffers."""
    header, blobs, offset = {}, [], 0
    for name, value in tensors.items():
        data = np.ascontiguousarray(value, np.float32).tobytes()
        header[name] = {"dtype": "F32", "shape": list(np.shape(value)),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as fp:
        fp.write(len(head).to_bytes(8, "little"))
        fp.write(head)
        for blob in blobs:
            fp.write(blob)


def resnet50_snapshot(root, seed):
    """A local HF snapshot of ResNet-50, what phase 31 loads at init:
    ``config.json`` (the built-in architecture) and a ``model.safetensors``
    of random values under HF's key names (He-scaled convolutions,
    BatchNorm scales near 1 and variances above 1). Returns its dir and
    ``{HF key: array}``."""
    from sleap_nn_tpu_torch.models import pretrained

    arch = dict(pretrained._BUILTIN_CONFIGS["resnet-50"])
    snap = root / "resnet50_snapshot"
    snap.mkdir(parents=True, exist_ok=True)
    (snap / "config.json").write_text(json.dumps(arch))
    rng = np.random.default_rng(seed)
    tensors = {}
    for key, v in pretrained.build_encoder(arch, 3).state_dict().items():
        leaf, shape = key.rsplit(".", 1)[1], tuple(v.shape)
        if len(shape) == 4:
            value = rng.normal(0, np.sqrt(2.0 / np.prod(shape[1:])), shape)
        elif leaf == "running_var":
            value = 1.0 + 0.1 * np.abs(rng.normal(size=shape))
        elif leaf == "weight":
            value = 1.0 + 0.1 * rng.normal(size=shape)
        else:
            value = 0.1 * rng.normal(size=shape)
        tensors[hf_resnet_key(key)] = value.astype(np.float32)
    write_safetensors(snap / "model.safetensors", tensors)
    return snap, tensors


def run_backbone_training(kernels, smi):
    """Phase 31: ``ModelTrainer.train`` with the other backbones at published
    widths on ``BACKBONE_TRAIN_FRAMES`` 1024x1024 frames of phase 27's
    animals (``BACKBONE_TRAIN_VAL`` of them val), batch 4, f32, geometric
    augmentation, 2 epochs of ``BACKBONE_TRAIN_STEPS`` steps: ConvNeXt tiny
    centroid (kernel 4 in every render, kernel 2 in the epoch-end
    evaluation), SwinT tiny, window
    7, bottom-up (kernel 4 and the PAF render) and a pretrained ResNet-50
    single-instance model, one animal a frame, whose encoder loads from a
    local snapshot the phase writes, with ``freeze: true`` (its encoder and
    every ``FrozenBatchNorm`` buffer must stay bit-identical; every other
    leaf must move, but for those ``BACKBONE_TRAIN_IDLE`` lets stop). Launch counts as phase 7's; every kernel call at a new
    signature held against its plain version. Then ``run.predict`` from
    each trained dir (bf16, batch 8): kernel 2 on the ConvNeXt centroid
    maps, kernels 2 and 3 on SwinT's. Prints steps/s, peak memory and the
    per-step stage times of each model (``backbone_training`` line).
    Returns the runs and the held rows."""
    import torch

    from sleap_nn_tpu_torch.inference.run import predict
    from sleap_nn_tpu_torch.training import ModelTrainer
    from sleap_nn_tpu_torch.training.callbacks import EpochEndEvaluationCallback
    from sleap_nn_tpu_torch.weights import torch_key_paths

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    snap, snap_tensors = resnet50_snapshot(root, seed=31)
    n_train = BACKBONE_TRAIN_FRAMES - BACKBONE_TRAIN_VAL
    seen, calls, runs, stats = set(), [], {}, {}
    for i, (name, backbone, model_type, n_animals, evaluate) in enumerate(BACKBONE_TRAIN_RUNS):
        labels = animal_labels(BACKBONE_TRAIN_FRAMES, TRAIN_IMG, n_animals, seed=310 + i)
        pretrained = backbone is None
        if pretrained:
            backbone = {"pretrained": {"model_name": str(snap), "output_stride": 2,
                                       "freeze": True}}
        cfg = training_config(0, 32, TRAIN_IMG, TRAIN_BATCH, augment=True,
                              model_type=model_type, backbone=backbone,
                              max_epochs=TRAIN_EPOCHS,
                              train_steps_per_epoch=BACKBONE_TRAIN_STEPS,
                              save_ckpt=True, ckpt_dir=str(root), run_name=name,
                              eval={"enabled": evaluate, "frequency": 1,
                                    "match_threshold": EVAL_MATCH_THRESHOLD})
        trainer = ModelTrainer.get_model_trainer_from_config(
            cfg, [labels.extract(range(n_train))],
            [labels.extract(range(n_train, BACKBONE_TRAIN_FRAMES))], device=DEVICE)
        if DEVICE != "cpu":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        start = {}

        def train():
            trainer.setup()
            if evaluate:
                next(cb for cb in trainer.callbacks if isinstance(
                    cb, EpochEndEvaluationCallback)).peak_threshold = EVAL_PEAK_THRESHOLD
            start.update({k: v.clone() for k, v in trainer.model.state_dict().items()})
            return trainer.train()

        with recording_kernel_calls(seen, calls, TRAIN_WRAPPERS + PATH_WRAPPERS[1:2]):
            history, launches = run_counted(kernels, train)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30 if DEVICE != "cpu" else None
        n_val = len(trainer.val_loader)
        renders = TRAIN_EPOCHS * (BACKBONE_TRAIN_STEPS + n_val) + 1
        eval_renders = TRAIN_EPOCHS * n_val if evaluate else 0
        renders_k4 = renders + eval_renders if model_type != "single_instance" else 0
        expect_launches(f"{name} training", launches, phase=31, multi_confmaps=renders_k4,
                        nms_scores=eval_renders)
        losses = [h[k] for h in history for k in ("train/loss", "val/loss")]
        if len(history) != TRAIN_EPOCHS or not np.isfinite(losses).all():
            raise AssertionError(f"phase 31 {name}: history {history}")
        if evaluate and any(not EVAL_KEYS[model_type] <= set(h) for h in history):
            raise AssertionError(f"phase 31 {name}: epoch-end evaluation keys {history}")
        end = trainer.model.state_dict()
        paths = torch_key_paths(trainer.model)
        stats_keys = {k for k, (p, _) in paths.items() if p[0] == "batch_stats"}
        still = set(trainer.frozen_parameters) | stats_keys
        if pretrained:
            prefix = "backbone.encoder."
            enc = [k for k in start if k.startswith(prefix)]
            loaded = all(np.array_equal(start[k].cpu().numpy(),
                                        snap_tensors[hf_resnet_key(k[len(prefix):])])
                         for k in enc)
            if not (loaded and stats_keys and set(trainer.frozen_parameters)
                    == {k for k in enc if k not in stats_keys}):
                raise AssertionError(f"phase 31 {name}: snapshot loaded {loaded}, "
                                     f"{len(trainer.frozen_parameters)} frozen of {len(enc)}")
        changed = [k for k in still if not torch.equal(end[k], start[k])]
        # A trained leaf that stayed put must be one that
        # BACKBONE_TRAIN_IDLE allows this run, stopped as it says: an inf in
        # its Adam second moment (a leaf cut off from the loss would have
        # zero gradients and moments instead).
        idle = [k for k in end if k not in still and torch.equal(end[k], start[k])]
        allowed = BACKBONE_TRAIN_IDLE.get(name)
        named = dict(trainer.model.named_parameters())
        unexplained = [k for k in idle if allowed is None or not allowed.fullmatch(k)
                       or not torch.isinf(trainer.optimizer.state[named[k]]["exp_avg_sq"]).any()]
        finite = all(torch.isfinite(v).all() for v in end.values())
        if changed or unexplained or not finite:
            raise AssertionError(f"phase 31 {name}: frozen leaves moved {changed[:5]}, "
                                 f"trained leaves idle {unexplained[:5]} unexplained "
                                 f"(of {len(idle)} idle), finite {finite}")
        batch = next(iter(trainer.train_loader))
        stages = train_stage_times(trainer, batch)

        frames = labels.video.frames
        kw = dict(batch_size=BATCH, use_bf16=True, device=DEVICE,
                  peak_threshold=DIR_PEAK_THRESHOLD, max_instances=MAX_INST)
        if model_type == "bottomup":
            kw.update(min_line_scores=DIR_MIN_LINE, max_peaks=DIR_MAX_PEAKS, paf_workers=0)
        predict(frame_labels(frames[:BATCH]), [trainer.ckpt_dir], make_labels=False,
                **kw)  # warm-up
        with recording_kernel_calls(seen, calls):
            out, dir_launches = run_counted(kernels, lambda: predict(
                frame_labels(frames), [trainer.ckpt_dir], **kw))
        n_batches = -(-len(frames) // BATCH)
        expect_launches(f"{name} predict", dir_launches, phase=31, **dict(zip(
            ("fused_double_conv3x3", "nms_scores", "paf_line_scores"),
            (n * n_batches for n in BACKBONE_TRAIN_PREDICT[model_type]))))
        kp = [inst.numpy() for lf in out for inst in lf.instances]
        if not kp or not all(np.isfinite(k).any() for k in kp):
            raise AssertionError(f"phase 31 {name} predict: {len(kp)} instances")
        runs[f"train_{name}"] = {"launches": launches, "n_batches": {
            "multi_confmaps": renders + eval_renders, "nms_scores": eval_renders},
            "steps_per_sec": history[-1]["train/steps_per_sec"]}
        runs[f"model_dir_{name}"] = {"launches": dir_launches, "n_batches": n_batches}
        stats[name] = {
            "steps_per_sec": history[-1]["train/steps_per_sec"],
            "samples_per_sec": history[-1]["train/samples_per_sec"],
            "steps_per_sec_by_epoch": [h["train/steps_per_sec"] for h in history],
            "peak_mem_gib": peak_gib, "stage_ms": stages, "launches": launches,
            "params": trainer.config.model_config.total_params,
            "frozen_params": sum(end[k].numel() for k in trainer.frozen_parameters),
            "statistics_buffers": len(stats_keys), "input_shape": trainer._input_shape,
            "idle_trained_leaves": idle, "trained_leaves": len(end) - len(still),
            "losses": losses, "predict_fps": out.provenance["stats"]["fps"],
            "predict_launches": dir_launches, "predict_instances": len(kp)}
        del trainer, out, start, end
    held = check_recorded_calls(calls)
    del calls
    for r in held:
        log("backbone_train_kernel " + json.dumps(r))
    if any(not r["ok"] for r in held) or (DEVICE != "cpu" and not held):
        raise AssertionError(f"phase 31: kernel calls held {held}")
    log("backbone_training " + json.dumps({
        "models": stats, "held": len(held), "frames": BACKBONE_TRAIN_FRAMES,
        "val_frames": BACKBONE_TRAIN_VAL, "img": TRAIN_IMG, "batch": TRAIN_BATCH,
        "phase_s": time.perf_counter() - t_phase, "device": smi}))
    tmp.cleanup()
    return runs, held


def zero_gradient_rows(name, shape):
    """The rows of a parameter whose exact gradient is 0, or None: a key
    projection's bias (SwinT's fused ``qkv``: its middle third; ViT's
    ``key``), since a shift shared by every key leaves each query's softmax
    as it is. Two devices' gradients there are rounding noise, which
    Adam's normalisation turns into steps of up to the learning rate."""
    if name.endswith("attn.qkv.bias"):
        return slice(shape[0] // 3, 2 * shape[0] // 3)
    if name.endswith("attn.key.bias"):
        return slice(0, shape[0])
    return None


def grad_err(name, got, want):
    """``max |got - want|`` over ``max |want|`` outside the rows of
    :func:`zero_gradient_rows` (0 where nothing is left)."""
    import torch

    rows = zero_gradient_rows(name, want.shape)
    if rows is not None:
        keep = torch.ones(want.shape[0], dtype=torch.bool)
        keep[rows] = False
        got, want = got[keep], want[keep]
    top = want.abs().max().item() if want.numel() else 0.0
    return (got - want).abs().max().item() / top if top > 0 else 0.0


def noise_elements(name, grads, witness):
    """The elements of a parameter whose Adam steps rounding may decide:
    those of :func:`zero_gradient_rows`, and those whose gradient
    ``grads`` (one a step) misses the f64 ``witness``'s by more than a
    tenth of the witness's at any step. Adam's step is the ratio of an
    element's gradient moments, blind to their scale, so an element whose
    gradients are held to a tenth moves as the witness's does; where the
    error is as large as the gradient itself (a gradient near 0, whose
    error is the tensor's rounding), the step can be anything up to the
    learning rate. Elsewhere the parameters are held to 1e-5."""
    import torch

    mask = torch.zeros_like(witness[0], dtype=torch.bool)
    for got, want in zip(grads, witness):
        mask |= (got - want).abs() > 0.1 * want.abs()
    rows = zero_gradient_rows(name, mask.shape)
    if rows is not None:
        mask[rows] = True
    return mask


def compare_training(a, b, start, noise):
    """The largest parameter difference of two trainers after the same
    steps outside each parameter's ``noise`` mask (:func:`noise_elements`;
    a parameter without one is compared whole), and the largest move of
    the masked elements from ``start`` in either (None without any): the
    caller holds it to Adam's bound of the learning rate a step."""
    worst, moved = 0.0, None
    sb = b.model.state_dict()
    for name, p in a.model.state_dict().items():
        p, q = p.detach().cpu().double(), sb[name].detach().cpu().double()
        mask = noise.get(name)
        if mask is not None and mask.any():
            s = start[name].double()
            move = max((t[mask] - s[mask]).abs().max().item() for t in (p, q))
            moved = max(moved or 0.0, move)
            p, q = p[~mask], q[~mask]
        if p.numel():
            worst = max(worst, (p - q).abs().max().item())
    return worst, moved


def f64_trainer(trainer):
    """``trainer`` (set up, on the CPU) in f64: its model, optimizer state
    and renders, for an f64 witness of its steps."""
    import torch

    trainer.model.double()
    render = trainer.render

    def render64(batch, train):
        return {k: v.double() if torch.is_tensor(v) and v.is_floating_point() else v
                for k, v in render(batch, train).items()}

    trainer.render = render64
    return trainer


def check_backbone_training_against_cpu(smi):
    """Phase 32: narrow ConvNeXt and SwinT (phases 27-30's narrow archs) and
    pretrained ConvNeXtV2 (``freeze`` on), Swinv2 and ViT (the CPU tests'
    archs, random init) centroid models trained 3 steps on the card, on the
    CPU and on the CPU in f64 from the same weights and batch (128x128
    frames, augmentation off), held as phase 8 holds the UNet: the first
    loss to 1e-5 relative, the first gradients to 1e-4 of their scale, the
    parameters to 1e-5 (the elements whose steps rounding decides, to
    Adam's bound: :func:`noise_elements`; they may be at most
    ``NOISE_FRACTION_MAX`` of the elements). The card is held to the f64
    witness, and the f32 CPU's distance from it is reported: the card machine's CPU build sums
    SwinT's relative-position gradient (a scatter-add over every window)
    to about 3e-3 of its scale, where the card stays within 1e-6."""
    from sleap_nn_tpu_torch.training import ModelTrainer

    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    labels = training_labels(8, 128, 5, 3, seed=32)
    train, val = labels.extract(range(6)), labels.extract(range(6, 8))
    cases = {"convnext": (NARROW_BACKBONES["convnext"], 2),
             "swint": (NARROW_BACKBONES["swint"], 2)}
    for name, arch in (("convnextv2", NARROW_PRETRAINED["convnextv2"]),
                       ("swinv2", NARROW_PRETRAINED["swinv2"]), ("vit", NARROW_VIT)):
        snap = root / name
        snap.mkdir()
        (snap / "config.json").write_text(json.dumps(arch))
        cases[name] = ({"pretrained": {"model_name": str(snap), "output_stride": 2,
                                       "weights": False, "freeze": name == "convnextv2"}},
                       8 if name == "vit" else 2)
    report = {}
    for name, (backbone, stride) in cases.items():
        def cfg():
            return training_config(0, 32, 128, 4, augment=False, backbone=backbone,
                                   head_stride=stride)

        runs = {}
        for key, device in (("card", DEVICE), ("cpu", "cpu"), ("cpu_f64", "cpu")):
            runs[key] = ModelTrainer.get_model_trainer_from_config(
                cfg(), [train], [val], device=device)
            runs[key].setup()
        start = {k: v.clone() for k, v in runs["cpu"].model.state_dict().items()}
        for key in ("card", "cpu_f64"):
            runs[key].model.load_state_dict(start, strict=True)
        f64_trainer(runs["cpu_f64"])
        batch = next(iter(runs["cpu"].train_loader))
        losses, grads = {}, {key: [] for key in runs}  # grads: one dict a step
        for step in range(3):
            for key, trainer in runs.items():
                loss = trainer.train_step(batch)[0].item()
                if step == 0:
                    losses[key] = loss
                grads[key].append({n: p.grad.detach().double().cpu()
                                   for n, p in trainer.model.named_parameters()
                                   if p.grad is not None})
        witness = runs["cpu_f64"]
        want = grads["cpu_f64"]
        row = {"frozen": len(runs["card"].frozen_parameters)}
        for key in ("card", "cpu"):
            noise = {n: noise_elements(n, [g[n] for g in grads[key]], [g[n] for g in want])
                     for n in want[0]}
            n_noise = int(sum(m.sum() for m in noise.values()))
            worst, moved = compare_training(runs[key], witness, start, noise)
            row[key] = {
                "loss_rel_err": abs(losses[key] - losses["cpu_f64"]) / abs(losses["cpu_f64"]),
                "grad_err_over_max": max(grad_err(n, g, want[0][n])
                                         for n, g in grads[key][0].items()),
                "param_max_abs_err": worst, "noise_elements": n_noise,
                "noise_fraction": n_noise / sum(m.numel() for m in noise.values()),
                "noise_max_move": moved}
        report[name] = row
        card = row["card"]
        if not (card["loss_rel_err"] <= 1e-5 and card["grad_err_over_max"] <= 1e-4
                and card["param_max_abs_err"] <= 1e-5
                and (card["noise_max_move"] or 0.0) <= 3 * 1e-4 * 1.01
                and card["noise_fraction"] <= NOISE_FRACTION_MAX
                and bool(row["frozen"]) == (name == "convnextv2")):
            raise AssertionError(f"phase 32 {name}: card vs the f64 CPU witness {row}")
    log("backbone_train_card_vs_cpu " + json.dumps({"models": report, "device": smi}))
    tmp.cleanup()
    return report


def ddp_config(root, run_name):
    """Phase 33's training config: phase 8's narrow centroid model, 3 steps
    of one epoch, the model dir under ``root``."""
    return training_config(8, 8, 128, 4, augment=False, max_epochs=1,
                           train_steps_per_epoch=DDP_STEPS, save_ckpt=True,
                           ckpt_dir=str(root), run_name=run_name)


def ddp_labels():
    labels = training_labels(DDP_FRAMES, 128, 5, 3, seed=33)
    n_train = DDP_FRAMES - DDP_VAL
    return labels.extract(range(n_train)), labels.extract(range(n_train, DDP_FRAMES))


def ddp_steps(trainer, state, kernels):
    """``trainer.setup()``, ``state`` loaded (None: its own init kept), then
    ``DDP_STEPS`` train steps on its loader's first global batches and one
    val step, each kernel-4 call at a new signature recorded: (losses,
    steps/s of ``DDP_TIMED`` more steps on the first batch, val loss, held
    rows, launches of the compared steps, its real rows of each batch, the
    parameters after them, the parameters before)."""
    import torch

    seen, calls = set(), []
    with recording_kernel_calls(seen, calls, TRAIN_WRAPPERS):
        for k in kernels.values():
            k.launches = 0
        trainer.setup()
        if state is not None:
            trainer.model.load_state_dict(state, strict=True)
        before = {k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()}
        batches = list(trainer.train_loader._gen())[:DDP_STEPS]
        losses = [trainer.train_step(b)[0].item() for b in batches]
        val = trainer.val_step(next(iter(trainer.val_loader)))[0].item()
        trainer.save_checkpoint("best.ckpt")
        after = {k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()}
        launches = {name: k.launches for name, k in kernels.items()}
        sync()
        t0 = time.perf_counter()
        for _ in range(DDP_TIMED):
            trainer.train_step(batches[0])
        sync()
        seconds = time.perf_counter() - t0
    rows = [int(np.sum(b["batch_mask"])) for b in batches]
    return (losses, DDP_TIMED / seconds, val, check_recorded_calls(calls), launches, rows,
            after, before)


def _ddp_gloo_rank(rank, addr, root, state, device):
    """A rank of phase 33's gloo run (a process of its own): join the group
    the phase makes, train as :func:`ddp_steps` and write what it saw to
    ``root/rank<r>.pt``, counting the files it writes."""
    global DEVICE
    import torch
    import torch.distributed as dist

    DEVICE = device  # a process of its own: the phase's device, not the default
    torch.backends.cudnn.allow_tf32 = False  # as main() sets it
    torch.backends.cuda.matmul.allow_tf32 = False

    sys.path.insert(0, str(ROOT))
    from sleap_nn_tpu_torch.io import model as pio
    from sleap_nn_tpu_torch.ops import _build
    from sleap_nn_tpu_torch.training import ModelTrainer

    dist.init_process_group("gloo", init_method=f"tcp://{addr}", world_size=2, rank=rank)
    real_save, real_labels_save, writes = torch.save, pio.Labels.save, []

    def counted(fn):
        def wrapped(obj, path, *args, **kw):
            writes.append(Path(str(path)).name)
            return fn(obj, path, *args, **kw)
        return wrapped

    try:
        trainer = ModelTrainer.get_model_trainer_from_config(
            ddp_config(root, "gloo"), *map(lambda L: [L], ddp_labels()), device=device)
        torch.save, pio.Labels.save = counted(real_save), counted(real_labels_save)
        out = ddp_steps(trainer, state, _build.KERNELS)
        torch.save, pio.Labels.save = real_save, real_labels_save
        real_save({"out": out, "writes": writes, "ranks": (trainer.rank, trainer.n_ranks),
                   "ckpt_dir": str(trainer.ckpt_dir)}, root / f"rank{rank}.pt")
    finally:
        torch.save, pio.Labels.save = real_save, real_labels_save
        dist.destroy_process_group()


def check_ddp(kernels, smi):
    """Phase 33: phase 8's narrow centroid model trained ``DDP_STEPS`` steps
    (the third global batch padded) three ways from the same weights: in
    one process; as 2 ranks on the one card over gloo, in a group the
    phase makes (2 processes; NCCL refuses two ranks on one device); and
    as 1 rank over NCCL joined through ``initialize_distributed``'s launch
    variables. Each run's losses (1e-5 relative) and parameters (1e-5)
    must agree with the single process, the two gloo ranks exactly with
    each other; rank 0 alone writes the model dir. Each rank renders its
    own rows through kernel 4, every new signature held against its plain
    version (``ddp`` line with each run's steps/s: one card, so this
    measures correctness, not scaling)."""
    import os
    import socket

    import torch
    import torch.multiprocessing as mp

    from sleap_nn_tpu_torch.parallel import distributed as pdist
    from sleap_nn_tpu_torch.training import ModelTrainer

    def free_addr():
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            return f"localhost:{sock.getsockname()[1]}"

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    single = ModelTrainer.get_model_trainer_from_config(
        ddp_config(root, "single"), *map(lambda L: [L], ddp_labels()), device=DEVICE)
    one = ddp_steps(single, None, kernels)
    state = one[7]
    if one[5] != [4, 4, 2]:
        raise AssertionError(f"phase 33: the single run's batches {one[5]}")

    mp.start_processes(_ddp_gloo_rank, args=(free_addr(), root, state, DEVICE), nprocs=2,
                       join=True, start_method="spawn")
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(2)]

    env = {pdist.ENV_COORDINATOR: free_addr(), pdist.ENV_NUM_PROCESSES: "1",
           pdist.ENV_PROCESS_ID: "0"}
    os.environ.update(env)
    try:
        nccl_trainer = ModelTrainer.get_model_trainer_from_config(
            ddp_config(root, "nccl"), *map(lambda L: [L], ddp_labels()), device=DEVICE)
        nccl = ddp_steps(nccl_trainer, state, kernels)
        backend = torch.distributed.get_backend()
        joined = (nccl_trainer.distributed, nccl_trainer.n_ranks, backend)
    finally:
        for k in env:
            os.environ.pop(k, None)
        pdist.destroy()

    def diff(a, b):
        return max((a[k] - b[k]).abs().max().item() for k in a)

    g0, g1 = (r["out"] for r in ranks)
    report = {
        "single": {"steps_per_sec": one[1], "losses": one[0]},
        "gloo_2_ranks": {"steps_per_sec": g0[1], "steps_per_sec_rank1": g1[1],
                         "losses": g0[0], "loss_rel_err": max(
                             abs(a - b) / abs(b) for a, b in zip(g0[0], one[0])),
                         "param_max_abs_err": diff(g0[6], one[6]),
                         "ranks_equal": diff(g0[6], g1[6]) == 0.0,
                         "rows_per_rank": [g0[5], g1[5]], "launches": [g0[4], g1[4]],
                         "writes": [r["writes"] for r in ranks]},
        "nccl_1_rank": {"steps_per_sec": nccl[1], "losses": nccl[0], "joined": joined,
                        "loss_rel_err": max(abs(a - b) / abs(b) for a, b in zip(nccl[0], one[0])),
                        "param_max_abs_err": diff(nccl[6], one[6]), "launches": nccl[4]},
        "val_loss": [one[2], g0[2], g1[2], nccl[2]],
        "start_equal": all(diff(r[7], state) == 0.0 for r in (g0, g1, nccl)),
    }
    held = one[3] + g0[3] + g1[3] + nccl[3]
    for r in held:
        log("ddp_kernel " + json.dumps(r))
    renders = DDP_STEPS + 2  # the steps, one val batch and the setup probe
    want = 0 if DEVICE == "cpu" else renders
    gl, nc = report["gloo_2_ranks"], report["nccl_1_rank"]
    ok = (gl["loss_rel_err"] <= 1e-5 and gl["param_max_abs_err"] <= 1e-5 and gl["ranks_equal"]
          and nc["loss_rel_err"] <= 1e-5 and nc["param_max_abs_err"] <= 1e-5
          and joined == (True, 1, "nccl" if DEVICE != "cpu" else "gloo")
          and [r["ranks"] for r in ranks] == [(0, 2), (1, 2)]
          and ranks[0]["ckpt_dir"] == ranks[1]["ckpt_dir"] == str(root / "gloo")
          and not ranks[1]["writes"] and "best.ckpt.tmp" in ranks[0]["writes"]
          and gl["rows_per_rank"] == [[2, 2, 2], [2, 2, 0]]
          and all(r[4]["multi_confmaps"] == want for r in (g0, g1, nccl))
          and report["start_equal"]
          and all(r["ok"] for r in held) and (DEVICE == "cpu" or held)
          and max(abs(v - one[2]) / abs(one[2]) for v in report["val_loss"]) <= 1e-5)
    log("ddp " + json.dumps({**report, "held": len(held), "phase_s":
                             time.perf_counter() - t_phase, "device": smi}))
    if not ok:
        raise AssertionError(f"phase 33: {report}")
    tmp.cleanup()
    runs = {"train_ddp_gloo": {"launches": {k: g0[4][k] + g1[4][k] for k in g0[4]},
                               "n_batches": renders},
            "train_ddp_nccl": {"launches": nccl[4], "n_batches": renders}}
    return runs, held, report


# --------------------------------------------------------------------------
# Phases 34-37: segmentation
# --------------------------------------------------------------------------

# The segmentation heads of phases 34-37 (all at stride 2).
SEG_HEADS = {
    "bottomup_segmentation": {"segmentation": {"output_stride": 2},
                              "center": {"sigma": 4.0, "output_stride": 2},
                              "offsets": {"output_stride": 2}},
    "semantic_segmentation": {"segmentation": {"output_stride": 2}},
    "centered_instance_segmentation": {"segmentation": {"output_stride": 2}},
}
TRAIN_HEADS.update(SEG_HEADS)
# Phase 34: the centres a frame may hold; the frames of the merge run (its
# host step scores every touching pair of a frame's masks); the centres
# that the random centre head's calibration puts above the threshold, on
# average, in a frame (about what a frame of animals holds: the host step
# cleans each centre's mask on the host, 10-20 ms each).
SEG_MAX_INST, SEG_MERGE_FRAMES, SEG_CENTRES = 50, 8, 8
MEDIUM_RF = {"unet": {"in_channels": 1, "filters": 24, "filters_rate": 1.5, "max_stride": 32,
                      "output_stride": 2}}
# Phases 34-36's runs: name, the model types of their dirs, run.predict's
# knobs, the launches a batch of kernels 1 and 2.
SEG_PREDICT_RUNS = (
    ("bottomup_segmentation", ("bottomup_segmentation",),
     {"max_instances": SEG_MAX_INST}, (9, 1)),
    ("bottomup_segmentation_merge", ("bottomup_segmentation",),
     {"max_instances": SEG_MAX_INST, "center_nms_kernel": 5, "merge_fragments": True,
      "distance_gate_alpha": 2.0, "mask_output": "both"}, (9, 1)),
    ("semantic_segmentation", ("semantic_segmentation",), {}, (9, 0)),
    ("topdown_segmentation", ("centroid", "centered_instance_segmentation"),
     {"max_instances": MAX_INST}, (18, 1)),
)
# Phase 36: frames (8 train, 4 val) and the evaluation of each type.
SEG_TRAIN_FRAMES, SEG_TRAIN_VAL = 12, 4
SEG_EVAL = {"bottomup_segmentation": "mask", "semantic_segmentation": "semantic",
            "centered_instance_segmentation": "mask"}
# Phase 37: the masks' threshold margin and the share of a mask it may take.
SEG_MARGIN, SEG_MARGIN_FRACTION = 1e-5, 1e-3


def seg_dir_config(model_type, n_nodes, backbone=None, crop=None):
    """A segmentation model dir's config (a dict): UNet medium_rf unless
    ``backbone`` is given."""
    cfg = dir_config(backbone or MEDIUM_RF, "centroid", n_nodes, crop=crop)
    cfg["model_config"]["head_configs"] = {model_type: json.loads(json.dumps(
        SEG_HEADS[model_type]))}
    cfg["trainer_config"]["run_name"] = model_type
    return cfg


def seg_random_init(model, frames):
    """He-normal backbone convs with zero biases and 1x1 heads of gain 0.1
    (offsets: 4 px, bias 0); then, from the maps on ``frames`` (run on
    ``DEVICE``), the foreground logits scaled to a spread of 4 with 30% of
    the pixels above 0, and the centre heatmap moved so that a frame's
    ``2 * SEG_CENTRES``-th largest local maximum sits at 0 and its
    ``SEG_CENTRES``-th at 0.25: about ``SEG_CENTRES`` centres a frame clear
    the 0.2 threshold."""
    import torch
    from torch import nn

    from sleap_nn_tpu_torch.ops.peaks import nms_max_pool

    random_init(model)
    heads = {name: head[0] for layer in model.head_layers for name, head in layer.items()}
    with torch.no_grad():
        for name, conv in heads.items():
            conv.bias.zero_()
            if name == "CenterOffsetHead":
                nn.init.normal_(conv.weight, std=4.0 * conv.in_channels ** -0.5)
        model.to(DEVICE).eval()
        out = model(torch.from_numpy(frames / np.float32(255.0)).to(DEVICE))
        p = out["SegmentationHead"].double().clamp(1e-12, 1 - 1e-12)
        z = torch.log(p / (1 - p)).flatten()
        a = 4.0 / z.std().item()
        heads["SegmentationHead"].weight.mul_(a)
        heads["SegmentationHead"].bias.fill_(-a * torch.quantile(z[::7], 0.7).item())
        if "InstanceCenterHead" in heads:
            hm = out["InstanceCenterHead"]
            peaks = (hm >= nms_max_pool(hm, 3)).flatten(1)
            kth, med = [], []
            for row, is_peak in zip(hm.flatten(1), peaks):
                v = row[is_peak].sort(descending=True).values
                kth.append(v[SEG_CENTRES - 1].item())
                med.append(v[2 * SEG_CENTRES - 1].item())
            a = 0.25 / (np.mean(kth) - np.mean(med))
            heads["InstanceCenterHead"].weight.mul_(a)
            heads["InstanceCenterHead"].bias.fill_(-a * np.mean(med))
        model.cpu()


def seg_dirs(root, frames):
    """Phase 34-35's full-width dirs with random weights: bottom-up and
    semantic segmentation, a centroid model and a centered-instance
    segmentation model (crop ``CROP``)."""
    out = {}
    for i, (mt, crop) in enumerate((("bottomup_segmentation", None),
                                    ("semantic_segmentation", None),
                                    ("centered_instance_segmentation", CROP))):
        cfg = seg_dir_config(mt, N_NODES, crop=crop)
        model = random_model(cfg, seed=340 + i)
        seg_random_init(model, frames)
        out[mt] = write_port_dir(root / mt, cfg, model)
    cfg = dir_config(MEDIUM_RF, "centroid", N_NODES)
    model = random_model(cfg, seed=343)
    random_init(model)
    out["centroid"] = write_port_dir(root / "centroid", cfg, model)
    return out


def seg_frames(n, seed):
    """Phase 27's animals on their noise floor (gray levels 0-15)."""
    frames = animal_frames(n, (IMG, IMG), MAX_INST, seed)
    floor = np.random.default_rng(seed + 1).integers(0, 16, frames.shape, dtype=np.uint8)
    return np.maximum(frames, floor)


def seg_stage_times(layer, frames):
    """ms of one batch by stage, each fenced by synchronize(): preprocess,
    the UNet(s), centre peaks (kernel 2), the offset grouping (its
    ``(B, K, H, W)`` distances in eager torch) or the crops, the copy to
    the host and the host step (clean-up, merge, pastes)."""
    import torch

    from sleap_nn_tpu_torch.inference import segmentation as seg
    from sleap_nn_tpu_torch.inference.layers import preprocess_images, to_host
    from sleap_nn_tpu_torch.ops.crops import crop_bboxes, make_centered_bboxes

    times = {}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        times[name] = (time.perf_counter() - t0) * 1e3
        return out

    images = torch.from_numpy(frames).to(layer.device)
    with torch.inference_mode():
        for _ in range(2):  # the second pass is the one kept
            if isinstance(layer, seg.TopDownSegmentationLayer):
                c = layer.centroid_layer
                x, eff = timed("preprocess", lambda: preprocess_images(c.pre, images))
                cres = timed("centroid_unet_and_peaks", lambda: c.forward_preprocessed(x, eff))
                cent = torch.nan_to_num(cres["centroids_scaled"][:, :layer.max_instances],
                                        nan=-1e6)
                b, k = cent.shape[:2]
                crops = timed("crops", lambda: crop_bboxes(
                    x, make_centered_bboxes(cent.reshape(b * k, 2), layer.crop_size,
                                            layer.crop_size),
                    torch.arange(b, device=x.device).repeat_interleave(k), layer.crop_size,
                    layer.crop_size))
                timed("instance_unet", lambda: layer.backend(crops))
            else:
                x, eff = timed("preprocess", lambda: preprocess_images(layer.pre, images))
                preds = timed("unet", lambda: layer.backend(x))
                if isinstance(layer, seg.BottomUpSegmentationLayer):
                    pts, vals, valid = timed("center_peaks", lambda: seg.find_center_peaks(
                        preds["InstanceCenterHead"], layer.post.peak_threshold,
                        layer.max_instances, layer.center_nms_kernel))
                    timed("offset_grouping", lambda: seg.group_instances_from_offsets(
                        preds["SegmentationHead"], preds["CenterOffsetHead"],
                        pts * layer.center_output_stride, valid, layer.seg_output_stride,
                        layer.max_center_dist, layer.fg_threshold,
                        layer.distance_gate_alpha))
            dev = timed("device_total", lambda: layer.forward(images))
            host = timed("to_host", lambda: to_host(dev))
    timed("host_step", lambda: layer.postprocess_host(host))
    if layer.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with torch.inference_mode():
            layer.forward(images)
        sync()
        times["device_peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
    return times


def seg_labels_hold_outputs(labels, results, mask_output):
    """The ``Labels`` of a segmentation run hold the masks of its raw
    outputs, frame by frame: each mask (bits, score, scale), and with
    ``mask_output`` ``"both"`` one polygon per mask with an outline."""
    by_frame = {lf.frame_idx: lf for lf in labels}
    n = 0
    for out in results:
        for i, f in enumerate(out["frame_inds"]):
            if not out["valid"][i]:
                continue
            want = out["pred_masks"][i]
            lf = by_frame.get(int(f))
            got = lf.masks if lf is not None else []
            if len(got) != len(want) or not all(
                    np.array_equal(a.mask, b.mask) and a.score == b.score and a.scale == b.scale
                    for a, b in zip(got, want)):
                raise AssertionError(f"frame {f}: {len(got)} masks in the Labels, "
                                     f"{len(want)} in the outputs")
            if mask_output == "both" and lf is not None and len(lf.rois) > len(got):
                raise AssertionError(f"frame {f}: {len(lf.rois)} polygons for {len(got)} masks")
            n += len(want)
    return n


def run_segmentation_predict(kernels, smi):
    """Phases 34-35: ``run.predict`` from full-width segmentation dirs
    (UNet medium_rf, random weights from a seed; 20 frames of 1024x1024
    animals on a noise floor, batch 8, bf16). Phase 34: the bottom-up
    segmentation model (``max_instances`` 50) at ``center_nms_kernel`` 3,
    then at 5 with the fragment merge, ``distance_gate_alpha`` 2 and
    ``mask_output="both"`` (on ``SEG_MERGE_FRAMES`` frames: the merge
    scores every touching pair of a frame's masks on the host). Phase 35:
    the semantic model, and the top-down pair (a centroid model and a
    centered-instance segmentation model on crops of ``CROP``,
    ``max_instances`` ``MAX_INST``). Launches a batch as
    ``SEG_PREDICT_RUNS``; every kernel call at a new signature (the centre
    heatmap at k = 3 and 5, the UNets on frames and on the crop batch) held
    against its plain version; the ``Labels`` hold the raw outputs' masks;
    frames/s and the ms of each stage (``segmentation_predict`` line).
    Returns the runs, the held rows and the dirs."""
    import torch

    from sleap_nn_tpu_torch.inference.predictor import Predictor
    from sleap_nn_tpu_torch.inference.run import predict
    from sleap_nn_tpu_torch.io.model import Labels

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    frames = seg_frames(N_FRAMES, seed=34)
    dirs = seg_dirs(Path(tmp.name), frames[:2])
    seen, calls, runs, stats = set(), [], {}, {}
    for name, types, knobs, per_batch in SEG_PREDICT_RUNS:
        paths = [dirs[t] for t in types]
        use = frames[:SEG_MERGE_FRAMES] if knobs.get("merge_fragments") else frames
        n_batches = -(-len(use) // BATCH)
        kw = dict(batch_size=BATCH, use_bf16=True, device=DEVICE, **knobs)
        predict(frame_labels(use[:BATCH]), paths, make_labels=False, **kw)  # warm-up
        sync()
        with recording_kernel_calls(seen, calls):
            labels, launches = run_counted(kernels, lambda: predict(frame_labels(use), paths,
                                                                    **kw))
        expect_launches(f"{name} predict", launches, phase=34, fused_double_conv3x3=per_batch[0]
                        * n_batches, nms_scores=per_batch[1] * n_batches)
        # The first batch again through the predictor's raw outputs: its
        # Labels, and run.predict's, hold their masks.
        pred = Predictor.from_model_paths(paths, **{k: v for k, v in kw.items()
                                                    if k != "batch_size"},
                                          batch_size=BATCH)
        first = frame_labels(use[:BATCH])
        raw = pred.predict(first, make_labels=False)
        n_masks = seg_labels_hold_outputs(pred.to_labels(raw, labels_src=first), raw,
                                          knobs.get("mask_output", "mask"))
        seg_labels_hold_outputs(Labels([lf for lf in labels if lf.frame_idx < BATCH]), raw,
                                knobs.get("mask_output", "mask"))
        total = sum(len(lf.masks) for lf in labels)
        if n_masks == 0:
            raise AssertionError(f"phase 34-35 {name}: no mask in the first batch")
        if knobs.get("mask_output") == "both" and not any(lf.rois for lf in labels):
            raise AssertionError(f"phase 34 {name}: no polygon")
        layer = pred.layer
        stages = seg_stage_times(layer, use[:BATCH])
        valid = [out["centroid_valid"][out["valid"]] for out in raw if "centroid_valid" in out]
        runs[f"seg_{name}"] = {"launches": launches, "n_batches": n_batches,
                               "fps": labels.provenance["stats"]["fps"]}
        stats[name] = {"fps": labels.provenance["stats"]["fps"], "frames": len(use),
                       "launches": launches, "masks": total,
                       "masks_per_frame": total / len(use),
                       "centres_per_frame": (float(np.mean([v.sum(axis=-1).mean()
                                                            for v in valid]))
                                             if valid else None),
                       "polygons": sum(len(lf.rois) for lf in labels),
                       "mask_scale": raw[0].get("mask_scale"), "stage_ms": stages}
        del labels, raw, pred, layer
        if DEVICE != "cpu":
            torch.cuda.empty_cache()
    held = check_recorded_calls(calls)
    del calls
    for r in held:
        log("segmentation_kernel " + json.dumps(r))
    sigs = {(r["kernel"], tuple(map(tuple, r["shapes"]))) for r in held}
    if any(not r["ok"] for r in held) or (DEVICE != "cpu" and not held):
        raise AssertionError(f"phases 34-35: kernel calls held {held}")
    log("segmentation_predict " + json.dumps({
        "paths": stats, "held": len(held), "held_signatures": len(sigs), "img": IMG,
        "batch": BATCH, "phase_s": time.perf_counter() - t_phase, "device": smi}))
    return runs, held, dirs, tmp


def seg_labels(n, seed):
    """Labels over ``seg_frames`` (``N_NODES``-node animals at their blobs'
    centres) and, per frame, the masks its instances render to (the
    training render's capsules of radius 12 around the edges)."""
    import torch

    from sleap_nn_tpu_torch.data.segmentation_maps import render_masks_from_instances
    from sleap_nn_tpu_torch.io.model import (
        Instance, LabeledFrame, Labels, SegmentationMask, Skeleton)

    points = []
    frames = animal_frames(n, (TRAIN_IMG, TRAIN_IMG), MAX_INST, seed, points=points)
    floor = np.random.default_rng(seed + 1).integers(0, 16, frames.shape, dtype=np.uint8)
    video = ArrayVideo(np.maximum(frames, floor))
    skel = Skeleton([f"n{i}" for i in range(N_NODES)], edges=bottomup_edges(N_NODES))
    edges = torch.tensor(bottomup_edges(N_NODES), dtype=torch.long)
    lfs = []
    for f, pts in enumerate(points):
        masks = render_masks_from_instances(torch.from_numpy(pts.astype(np.float32)),
                                            (TRAIN_IMG, TRAIN_IMG), edges).numpy()
        lfs.append(LabeledFrame(video, f, [Instance(a, skel) for a in pts],
                                masks=[SegmentationMask(m) for m in masks]))
    return Labels(lfs)


def run_segmentation_training(kernels, smi, dirs):
    """Phase 36: ``ModelTrainer.train`` of each segmentation type (UNet
    medium_rf, ``SEG_TRAIN_FRAMES`` 1024x1024 frames of phase 34's animals,
    ``SEG_TRAIN_VAL`` of them val, batch 4, f32, geometric augmentation, 2
    epochs of 5 steps, the epoch-end ``val/fg_iou`` in every epoch's logs);
    no kernel launches (the targets are plain torch, the trainer's convs
    cuDNN). Then from each dir (the centered-instance one beside phase
    35's centroid dir): ``run.predict`` with tracking (masks and mask IoU
    by default) to an ``.slp`` with masks and polygons, read back by
    ``load_slp`` (masks bit-identical, polygons and tracks the same),
    ``run_evaluation`` against the val frames' rendered masks (``mask`` or
    ``semantic``). Prints steps/s, peak memory, the stage times of one step
    and the predict, save, load, evaluation and tracking seconds
    (``segmentation_training`` line). Returns the runs."""
    import torch

    from sleap_nn_tpu_torch.evaluation import run_evaluation
    from sleap_nn_tpu_torch.inference.run import predict
    from sleap_nn_tpu_torch.io.slp import load_slp
    from sleap_nn_tpu_torch.training import ModelTrainer

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    labels = seg_labels(SEG_TRAIN_FRAMES, seed=36)
    n_train = SEG_TRAIN_FRAMES - SEG_TRAIN_VAL
    val = labels.extract(range(n_train, SEG_TRAIN_FRAMES))
    runs, stats = {}, {}
    for mt in SEG_HEADS:
        crop = CROP if mt == "centered_instance_segmentation" else None
        cfg = training_config(24, 32, TRAIN_IMG, TRAIN_BATCH, augment=True, model_type=mt,
                              crop_size=crop, max_epochs=TRAIN_EPOCHS, train_steps_per_epoch=TRAIN_STEPS,
                              save_ckpt=True, ckpt_dir=str(root), run_name=mt,
                              eval={"enabled": True, "frequency": 1})
        trainer = ModelTrainer.get_model_trainer_from_config(
            cfg, [labels.extract(range(n_train))], [val], device=DEVICE)
        if DEVICE != "cpu":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        history, launches = run_counted(kernels, trainer.train)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30 if DEVICE != "cpu" else None
        expect_launches(f"{mt} training", launches, phase=36)
        losses = [h[k] for h in history for k in ("train/loss", "val/loss", "val/fg_iou")]
        if len(history) != TRAIN_EPOCHS or not np.isfinite(losses).all():
            raise AssertionError(f"phase 36 {mt}: history {history}")
        stages = train_stage_times(trainer, next(iter(trainer.train_loader)))

        paths = ([dirs["centroid"]] if crop else []) + [trainer.ckpt_dir]
        out_path = root / f"{mt}.predictions.slp"
        timings = {}
        t0 = time.perf_counter()
        pred, dir_launches = run_counted(kernels, lambda: predict(
            val, paths, batch_size=BATCH, use_bf16=True, device=DEVICE, tracking=True,
            mask_output="both", max_instances=SEG_MAX_INST if not crop else MAX_INST))
        timings["predict_and_track_s"] = time.perf_counter() - t0
        per_batch = {"bottomup_segmentation": (9, 1), "semantic_segmentation": (9, 0),
                     "centered_instance_segmentation": (18, 1)}[mt]
        n_batches = -(-len(val) // BATCH)
        expect_launches(f"{mt} predict", dir_launches, phase=36,
                        fused_double_conv3x3=per_batch[0] * n_batches,
                        nms_scores=per_batch[1] * n_batches)
        masks = [m for lf in pred for m in lf.masks]
        if not masks or any(m.track is None for m in masks if m.area):
            raise AssertionError(f"phase 36 {mt}: {len(masks)} masks, tracked "
                                 f"{sum(m.track is not None for m in masks)}")
        t0 = time.perf_counter()
        pred.save(str(out_path))
        timings["save_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = load_slp(out_path)
        timings["load_s"] = time.perf_counter() - t0
        for a, b in zip(back.labeled_frames, pred.labeled_frames):
            if not (len(a.masks) == len(b.masks) and len(a.rois) == len(b.rois) and all(
                    np.array_equal(x.mask, y.mask) and x.score == y.score and x.scale == y.scale
                    and getattr(x.track, "name", None) == getattr(y.track, "name", None)
                    for x, y in zip(a.masks, b.masks)) and all(
                    np.array_equal(x.points, y.points) for x, y in zip(a.rois, b.rois))):
                raise AssertionError(f"phase 36 {mt}: frame {a.frame_idx} read back differs")
        t0 = time.perf_counter()
        metrics = run_evaluation(val, str(out_path), match_method=SEG_EVAL[mt])
        timings["evaluate_s"] = time.perf_counter() - t0
        if metrics is None:
            raise AssertionError(f"phase 36 {mt}: nothing to evaluate")
        key = "semantic_metrics" if SEG_EVAL[mt] == "semantic" else "mask_metrics"
        summary = {k: v for k, v in metrics[key].items()
                   if isinstance(v, (int, float)) and k not in ("ious",)}
        runs[f"train_{mt}"] = {"launches": launches, "n_batches": 1,
                               "steps_per_sec": history[-1]["train/steps_per_sec"]}
        runs[f"model_dir_{mt}"] = {"launches": dir_launches, "n_batches": n_batches}
        stats[mt] = {
            "steps_per_sec": history[-1]["train/steps_per_sec"],
            "samples_per_sec": history[-1]["train/samples_per_sec"],
            "peak_mem_gib": peak_gib, "stage_ms": stages, "launches": launches,
            "input_shape": trainer._input_shape, "losses": losses,
            "fg_iou": [h["val/fg_iou"] for h in history],
            "predict_launches": dir_launches, "masks": len(masks),
            "tracks": len(pred.tracks), "polygons": sum(len(lf.rois) for lf in pred),
            "eval": summary, **timings}
        del trainer, pred, back
    log("segmentation_training " + json.dumps({
        "models": stats, "frames": SEG_TRAIN_FRAMES, "val_frames": SEG_TRAIN_VAL,
        "img": TRAIN_IMG, "batch": TRAIN_BATCH, "phase_s": time.perf_counter() - t_phase,
        "device": smi}, default=str))
    tmp.cleanup()
    return runs


def seg_margin_ok(got, want, values, threshold):
    """Masks equal but for pixels where ``values`` lies within
    ``SEG_MARGIN`` of ``threshold``, at most ``SEG_MARGIN_FRACTION`` of the
    mask; returns the count of such pixels."""
    got, want = np.asarray(got, bool), np.asarray(want, bool)
    diff = got != want
    near = np.broadcast_to(np.abs(np.asarray(values, np.float64) - threshold) <= SEG_MARGIN,
                           diff.shape)
    if (diff & ~near).any() or diff.sum() > SEG_MARGIN_FRACTION * diff.size:
        raise AssertionError(f"masks differ at {int(diff.sum())} pixels, "
                             f"{int((diff & ~near).sum())} away from the threshold")
    return int(diff.sum())


def narrow_seg_layers(device, frames):
    """Narrow f32 segmentation layers (UNet filters 8, max_stride 8, heads
    at stride 2) of each type with the same weights on ``device``:
    conditioned as the CPU tests condition them (zero biases; foreground
    logits scaled to 6, the centre heatmap to 1, offsets to 4 px)."""
    import torch

    from sleap_nn_tpu_torch.inference import segmentation as seg
    from sleap_nn_tpu_torch.inference.backends import TorchBackend
    from sleap_nn_tpu_torch.inference.layers import (
        CentroidLayer, PostprocessConfig, PreprocessConfig)

    models = {}
    for i, mt in enumerate(list(SEG_HEADS) + ["centroid"]):
        unet = {"unet": {"filters": 8, "filters_rate": 1.5, "max_stride": 8,
                         "output_stride": 2, "in_channels": 1}}
        cfg = (seg_dir_config(mt, 3, backbone=unet) if mt != "centroid"
               else dir_config(unet, "centroid", 3))
        model = random_model(cfg, seed=370 + i)
        x = frames if mt != "centered_instance_segmentation" else frames[:, 32:96, 32:96]
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith("bias"):
                    p.zero_()
            model.eval()
            out = model(torch.from_numpy(x / np.float32(255.0)))
            for layer in model.head_layers:
                for head, m in layer.items():
                    y = out[head].numpy()
                    if head == "SegmentationHead":
                        y = np.clip(y, 1e-7, 1 - 1e-7)
                        scale = 6.0 / np.abs(np.log(y / (1 - y))).max(axis=(0, 1, 2))
                    elif head == "CenterOffsetHead":
                        scale = 4.0 / np.abs(y).max(axis=(0, 1, 2))
                    else:
                        top, bottom = y.max(axis=(0, 1, 2)), y.min(axis=(0, 1, 2))
                        scale = np.where(top > 0, 1 / np.maximum(top, 1e-12),
                                         1 / np.minimum(bottom, -1e-12))
                    m[0].weight.mul_(torch.from_numpy(scale.astype(np.float32))[
                        :, None, None, None])
        models[mt] = model
    pre = PreprocessConfig(ensure_grayscale=True, max_stride=8)
    post = PostprocessConfig(peak_threshold=0.2, max_instances=4)

    def backend(mt):
        return TorchBackend(models[mt], None, device=device)

    return {
        "bottomup_segmentation": seg.BottomUpSegmentationLayer(
            backend("bottomup_segmentation"), pre, post, max_instances=8,
            merge_fragments=True, device=device),
        "semantic_segmentation": seg.SemanticSegmentationLayer(
            backend("semantic_segmentation"), pre, post, device=device),
        "topdown_segmentation": seg.TopDownSegmentationLayer(
            CentroidLayer(backend("centroid"), pre, post, device=device),
            backend("centered_instance_segmentation"), pre, fg_threshold=0.6,
            max_instances=4, crop_size=64, device=device),
    }


def check_segmentation_against_cpu(smi):
    """Phase 37: narrow f32 segmentation layers of the three types on the
    card and on the CPU, same weights, 8 frames of 128x128 blobs: the maps
    to 1e-4, the centre validity and crop corners exact, the device masks
    under the threshold-margin rule (``seg_margin_ok``, against the CPU's
    foreground); the host step fed the CPU's device outputs gives the same
    masks on both layers, and their polygons and mask tracks are the same
    (``segmentation_card_vs_cpu`` line)."""
    import copy

    from sleap_nn_tpu_torch.inference.layers import to_host
    from sleap_nn_tpu_torch.inference.segmentation import mask_to_polygon
    from sleap_nn_tpu_torch.io.model import LabeledFrame, Labels
    from sleap_nn_tpu_torch.tracking.tracker import run_tracker

    labels = blob_labels(8, 128, 3, 3, seed=37)
    frames = labels.video.frames
    card, cpu = narrow_seg_layers(DEVICE, frames), narrow_seg_layers("cpu", frames)
    report = {}
    for name in card:
        got, want = to_host(card[name].predict_async(frames)), to_host(
            cpu[name].predict_async(frames))
        errs, margin = {}, 0
        for key, w in want.items():
            g = got[key]
            if not isinstance(w, np.ndarray) or key in ("instance_masks", "crop_masks"):
                continue
            if w.dtype.kind in "biu" or key == "top_left":
                if not np.array_equal(g, w):
                    raise AssertionError(f"phase 37 {name}: {key} differs")
                continue
            fin = np.isfinite(w)
            if not np.array_equal(fin, np.isfinite(g)):
                raise AssertionError(f"phase 37 {name}: {key} NaN placed apart")
            errs[key] = float(np.abs(g[fin] - w[fin]).max()) if fin.any() else 0.0
            if errs[key] > 1e-4:
                raise AssertionError(f"phase 37 {name}: {key} {errs[key]:.3e} apart")
        if name == "bottomup_segmentation":
            margin = seg_margin_ok(got["instance_masks"], want["instance_masks"],
                                   want["fg"][:, None, ..., 0], 0.5)
        elif name == "topdown_segmentation":
            if not np.array_equal(got["crop_masks"], want["crop_masks"]):
                raise AssertionError(f"phase 37 {name}: crop masks differ")
        hosts = [layer.postprocess_host(copy.deepcopy(want)) for layer in (card[name],
                                                                            cpu[name])]
        frames_out = []
        for host in hosts:
            lfs = [LabeledFrame(None, i, masks=m) for i, m in enumerate(host["pred_masks"])]
            polys = [[mask_to_polygon(m.mask, 0.01, m.scale) for m in lf.masks] for lf in lfs]
            tracked = run_tracker(Labels(lfs), features="masks", scoring_method="mask_iou")
            frames_out.append((host, polys, [[getattr(m.track, "name", None) for m in lf.masks]
                                             for lf in tracked.labeled_frames]))
        (h0, p0, t0), (h1, p1, t1) = frames_out
        same = all(len(a) == len(b) and all(np.array_equal(x.mask, y.mask) and x.score == y.score
                                            for x, y in zip(a, b))
                   for a, b in zip(h0["pred_masks"], h1["pred_masks"]))
        same_polys = all(len(a) == len(b) and all(
            (x is None and y is None) or np.array_equal(x, y) for x, y in zip(a, b))
            for a, b in zip(p0, p1))
        n_masks = sum(len(m) for m in h0["pred_masks"])
        if not (same and same_polys and t0 == t1 and n_masks):
            raise AssertionError(f"phase 37 {name}: host step apart (masks {same}, polygons "
                                 f"{same_polys}, tracks {t0 == t1}, {n_masks} masks)")
        report[name] = {"max_abs_err": errs, "margin_pixels": margin, "masks": n_masks,
                        "tracks": len({t for row in t0 for t in row if t})}
    log("segmentation_card_vs_cpu " + json.dumps({"paths": report, "device": smi}))
    return report


# --------------------------------------------------------------------------


# --------------------------------------------------------------------------
# Phases 38-41: the training monitors and traces, export, predict from an
# export dir, the command line's export
# --------------------------------------------------------------------------

# Phase 38's controller commands: (epoch, batch) -> the message sent at that
# batch's start (the controller reads it at the batch's end).
MONITOR_LR = 3e-4
MONITOR_PLAN = {(0, 1): {"command": "set_lr", "lr": MONITOR_LR}, (1, 2): {"command": "stop"}}
# The port's kernels as a torch.profiler trace names them.
TRACE_NAMES = {"fused_double_conv3x3": ("::tc::kernel<", "::f32::kernel("),
               "nms_scores": ("nms_scores_kernel",), "paf_line_scores": ("paf_line_scores_kernel",),
               "multi_confmaps": ("multi_confmaps_kernel",)}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def monitor_imports():
    """Whether each monitor's optional package imports on this machine."""
    import importlib

    out = {}
    for name in ("zmq", "matplotlib", "wandb"):
        try:
            importlib.import_module(name)
            out[name] = True
        except ImportError:
            out[name] = False
    return out


class GuiSockets:
    """The SLEAP GUI's side of the ZMQ protocol on localhost: a SUB socket
    bound for the trainer's events, a PUB socket bound for its commands."""

    def __init__(self):
        import zmq

        self.zmq = zmq
        self.ctx = zmq.Context()
        self.pub_port, self.ctl_port = free_port(), free_port()
        self.events = self.ctx.socket(zmq.SUB)
        self.events.subscribe("")
        self.events.bind(f"tcp://127.0.0.1:{self.pub_port}")
        self.commands = self.ctx.socket(zmq.PUB)
        self.commands.bind(f"tcp://127.0.0.1:{self.ctl_port}")

    def pump(self, trainer, seconds=1.0):
        """A ZMQ socket connects and subscribes only when it is used: poll
        both ends of both links before the first message."""
        ends = [self.events] + [cb.socket for cb in trainer.callbacks if hasattr(cb, "timeout")]
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for s in ends:
                s.poll(5)

    def received(self):
        out = []
        while self.events.poll(300):
            out.append(json.loads(self.events.recv_string()))
        return out

    def close(self):
        for s in (self.events, self.commands):
            s.close(linger=0)
        self.ctx.term()


class Commander:
    """A training callback that sends ``plan``'s commands at batch starts."""

    def __init__(self, sockets, plan):
        self.sockets, self.plan = sockets, plan

    def __getattr__(self, name):
        if name.startswith("on_"):
            return lambda *a, **k: None
        raise AttributeError(name)

    def on_batch_start(self, trainer, batch_idx):
        msg = self.plan.get((trainer.current_epoch, batch_idx))
        if msg is not None:
            self.sockets.commands.send_string(json.dumps(msg))


class VizDeviceHalf:
    """Where matplotlib is absent: ``VizCallback.peaks`` at each epoch end,
    the viz's render of its sample and its peaks (kernel 2), without the
    PNG."""

    def __getattr__(self, name):
        if name.startswith("on_"):
            return lambda *a, **k: None
        raise AttributeError(name)

    def on_epoch_end(self, trainer, epoch, logs):
        from sleap_nn_tpu_torch.training.viz import VizCallback

        VizCallback.peaks(trainer, epoch)


def trace_kernels(trace_dir):
    """The one trace file of ``trace_dir``: its device kernel events by port
    kernel, the device kernel events in all, the file's MB, and the kernel
    launches the trace records on the host with no device event (records
    the profiler dropped: where the GPU's and the host's clocks disagree,
    Kineto drops GPU records it times outside the trace's window, counting
    them "Out-of-range" in its log; F5 in ROADMAP section 3)."""
    from sleap_nn_tpu_torch.profiling import trace_files

    files = trace_files(trace_dir)
    if len(files) != 1:
        raise AssertionError(f"{trace_dir}: {len(files)} trace files, expected 1")
    events = json.loads(files[0].read_text())["traceEvents"]
    device = [ev for ev in events if ev.get("cat") == "kernel"]
    counts = {k: sum(any(s in ev["name"] for s in subs) for ev in device)
              for k, subs in TRACE_NAMES.items()}
    seen = {ev.get("args", {}).get("correlation") for ev in device}
    lost = sum(1 for ev in events if ev.get("cat") == "cuda_runtime" and "LaunchKernel" in
               ev.get("name", "") and ev.get("args", {}).get("correlation") not in seen)
    return counts, len(device), files[0].stat().st_size / 2**20, lost


def expected_events(steps_per_epoch):
    """JAX's event order for epochs of the given batch counts."""
    out = ["train_begin"]
    for n in steps_per_epoch:
        out += ["epoch_begin"] + ["batch_start", "batch_end"] * n + ["epoch_end"]
    return out + ["train_end"]


def run_monitored_training(kernels, smi):
    """Phase 38: phase 7's centroid and phase 10's bottom-up trainings
    (medium_rf, batch 4, f32, 2 epochs of 5) with every monitor on: the
    ZMQ events received on a localhost SUB socket, in JAX's order; the
    controller driven from a localhost PUB socket (``set_lr`` at epoch 0's
    second batch, ``stop`` at epoch 1's third); the viz PNGs (its render
    through kernel 4, its peaks through kernel 2), the local wandb run and
    a ``torch.profiler`` trace whose device events name kernel 4 and
    kernel 2. The same trainings without the monitors come first, for
    steps/s. A monitor whose package does not import here is named on
    the ``monitor_imports`` line and left out of the config (without
    matplotlib, the viz's device half, ``VizCallback.peaks``, still runs
    at each epoch end: its render and kernel 2, no PNG). The ``wandb``
    package is blocked for the phase, so the callback writes its local
    run and nothing reaches the network."""
    from sleap_nn_tpu_torch.training import ModelTrainer

    imports = monitor_imports()
    not_run = [what for what, pkg in (("zmq events and commands", "zmq"),
                                      ("viz PNGs", "matplotlib")) if not imports[pkg]]
    log("monitor_imports " + json.dumps({
        **imports, "not_run": not_run, "wandb_run": "local run directory (_LocalRun): the "
        "wandb package is blocked for this phase, which makes no network call",
        "viz_device_half": "VizCallback.peaks at each epoch end (the sample's render and "
        "its peaks, kernel 2) without matplotlib: no PNG" if not imports["matplotlib"]
        else None}))
    labels = training_labels(TRAIN_FRAMES + VAL_FRAMES, TRAIN_IMG, N_NODES, MAX_INST, seed=4)
    train = labels.extract(range(TRAIN_FRAMES))
    val = labels.extract(range(TRAIN_FRAMES, TRAIN_FRAMES + VAL_FRAMES))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for mt in ("centroid", "bottomup"):
            base = dict(max_epochs=TRAIN_EPOCHS, train_steps_per_epoch=TRAIN_STEPS, save_ckpt=True,
                        ckpt_dir=tmp)
            plain = ModelTrainer.get_model_trainer_from_config(
                training_config(24, 32, TRAIN_IMG, TRAIN_BATCH, augment=True, model_type=mt,
                                run_name=f"plain_{mt}", **base), [train], [val], device=DEVICE)
            plain_hist = plain.train()
            for attempt in (1, 2):
                sockets = GuiSockets() if imports["zmq"] else None
                monitors = dict(visualize_preds_during_training=imports["matplotlib"], keep_viz=True,
                                use_wandb=True, wandb={"wandb_mode": "offline"}, profiler="pytorch")
                if sockets is not None:
                    monitors["zmq"] = {"publish_port": sockets.pub_port,
                                       "controller_port": sockets.ctl_port}
                trainer = ModelTrainer.get_model_trainer_from_config(
                    training_config(24, 32, TRAIN_IMG, TRAIN_BATCH, augment=True, model_type=mt,
                                    run_name=f"monitored_{mt}" + "_again" * (attempt - 1),
                                    **base, **monitors),
                    [train], [val], device=DEVICE)
                blocked = sys.modules.get("wandb")
                sys.modules["wandb"] = None  # the local run: no network from this phase
                try:
                    for k in kernels.values():
                        k.launches = 0
                    trainer.setup()
                    if not imports["matplotlib"]:
                        trainer.callbacks.append(VizDeviceHalf())
                    if sockets is not None:
                        trainer.callbacks.append(Commander(sockets, MONITOR_PLAN))
                        sockets.pump(trainer)
                    history = trainer.train()
                    sync()
                    launches = {name: k.launches for name, k in kernels.items()}
                    events = sockets.received() if sockets is not None else []
                finally:
                    if blocked is None:
                        del sys.modules["wandb"]
                    else:
                        sys.modules["wandb"] = blocked
                    if sockets is not None:
                        sockets.close()
                run = trainer.ckpt_dir
                steps = [TRAIN_STEPS, 3] if sockets is not None else [TRAIN_STEPS] * TRAIN_EPOCHS
                n_val, n_viz = len(trainer.val_loader), len(steps)
                renders = sum(steps) + len(steps) * n_val + 1 + n_viz
                expect_launches(f"monitored {mt} training", launches, phase=38,
                                multi_confmaps=renders, nms_scores=n_viz)
                row = {"launches": launches, "n_batches": {"multi_confmaps": renders,
                                                           "nms_scores": max(n_viz, 1)},
                       "viz_nms_launches": launches["nms_scores"], "steps": steps}
                if sockets is not None:
                    names = [ev["event"] for ev in events]
                    want = expected_events(steps)
                    if names != want and names != want[:-1]:  # train_end may not arrive
                        raise AssertionError(f"phase 38 {mt}: events {names}, expected {want}")
                    stopped = [(ev["epoch"], ev["batch"]) for ev in events
                               if ev["event"] == "batch_end"][-1]
                    lr = trainer.optimizer.param_groups[0]["lr"]
                    if stopped != (1, 2) or history[0]["learning_rate"] != MONITOR_LR \
                            or lr != MONITOR_LR or len(history) != 2:
                        raise AssertionError(f"phase 38 {mt}: stopped at {stopped}, lr "
                                             f"{history[0]['learning_rate']} / {lr}")
                    row.update(events=len(events), event_order="jax", train_end_received=
                               names[-1] == "train_end", stopped_at=list(stopped),
                               lr_after_set_lr=lr, lr_logged=history[0]["learning_rate"])
                pngs = sorted(p.name for p in (run / "viz").iterdir()) \
                    if imports["matplotlib"] else []
                want_pngs = [f"epoch_{e:04d}{s}.png" for e in range(len(steps))
                             for s in ("",) + (("_pafs",) if mt == "bottomup" else ())]
                if imports["matplotlib"] and pngs != sorted(want_pngs):
                    raise AssertionError(f"phase 38 {mt}: viz files {pngs}")
                (local,) = (run / "wandb").glob("offline-run-*")
                wandb_files = sorted(p.name for p in local.iterdir())
                if not {"config.json", "metrics.jsonl", "summary.json"} <= set(wandb_files):
                    raise AssertionError(f"phase 38 {mt}: local wandb run {wandb_files}")
                counts, n_dev, trace_mb, lost = trace_kernels(run / "profile")
                # The trace starts with train(): setup's probe render is outside it.
                if DEVICE != "cpu" and (counts["multi_confmaps"] != launches["multi_confmaps"] - 1
                                        or counts["nms_scores"] != launches["nms_scores"]
                                        or not counts["nms_scores"]):
                    if lost and attempt == 1:  # the profiler dropped device records (F5)
                        log(f"monitored_training_{mt}_trace_lost " + json.dumps(
                            {"lost_device_records": lost, "trace_kernel_events": counts,
                             "launches": launches}))
                        continue
                    raise AssertionError(f"phase 38 {mt}: trace kernels {counts}, launches "
                                         f"{launches}, device records lost {lost}")
                break
            row.update(
                pngs=pngs, wandb_files=wandb_files, trace_kernel_events=counts,
                trace_device_kernels=n_dev, trace_mb=trace_mb, trace_attempts=attempt,
                trace_device_records_lost=lost,
                steps_per_sec_monitored=[h["train/steps_per_sec"] for h in history],
                steps_per_sec_plain=[h["train/steps_per_sec"] for h in plain_hist],
                smi=smi)
            log(f"monitored_training_{mt} " + json.dumps(row))
            out[f"monitored_train_{mt}"] = row
    return out


def run_profiled_predict(kernels, dirs, smi):
    """Phase 39: ``run.predict`` of phase 13's top-down dirs with
    ``profile_dir``, as phase 13 runs them (bf16, batch 8, threshold
    -1e9): the trace's device events must name kernels 1 and 2 as many
    times as they launched; frames/s with and without the trace."""
    from sleap_nn_tpu_torch.inference.run import predict

    kw = dict(batch_size=BATCH, use_bf16=True, device=DEVICE, peak_threshold=DIR_PEAK_THRESHOLD,
              max_instances=MAX_INST)
    frames = smoke_frames()
    predict(frame_labels(frames[:BATCH]), dirs, make_labels=False, **kw)  # warm-up
    plain = predict(frame_labels(frames), dirs, **kw)
    with tempfile.TemporaryDirectory() as tmp:
        for attempt in (1, 2):
            prof = Path(tmp) / f"prof{attempt}"
            traced, launches = run_counted(kernels, lambda: predict(
                frame_labels(frames), dirs, profile_dir=prof, **kw))
            counts, n_dev, trace_mb, lost = trace_kernels(prof)
            if not (DEVICE != "cpu" and lost and attempt == 1
                    and any(counts[k] != launches[k] for k in counts)):
                break
            # The profiler dropped device records (F5): trace the run again.
            log("profiled_predict_trace_lost " + json.dumps(
                {"lost_device_records": lost, "trace_kernel_events": counts,
                 "launches": launches}))
    n_batches = -(-N_FRAMES // BATCH)
    expect_launches("profiled top-down predict", launches, phase=39,
                    fused_double_conv3x3=18 * n_batches, nms_scores=n_batches)
    if DEVICE != "cpu" and any(counts[k] != launches[k] for k in counts):
        raise AssertionError(f"phase 39: trace kernels {counts}, launches {launches}, "
                             f"device records lost {lost}")
    if [len(lf) for lf in traced] != [len(lf) for lf in plain]:
        raise AssertionError("phase 39: the traced run's instances differ")
    row = {"launches": launches, "n_batches": n_batches, "trace_kernel_events": counts,
           "trace_device_kernels": n_dev, "trace_mb": trace_mb, "trace_attempts": attempt,
           "trace_device_records_lost": lost,
           "fps_traced": traced.provenance["stats"]["fps"],
           "fps_plain": plain.provenance["stats"]["fps"], "smi": smi}
    log("profiled_predict " + json.dumps(row))
    return {"profiled_topdown": row}


# Phase 40's exports: name, the dirs (keys of the phase's dirs), export_model's
# knobs, run.predict's knobs (for the export dir and the model dirs alike),
# the launches of kernels 1, 2 and 3 per call of the loaded program, and
# whether from_export_dir serves it (crop models run on cut crops).
EXPORT_RUNS = (
    ("single_instance", ("single_instance",), {"peak_threshold": DIR_PEAK_THRESHOLD},
     {"peak_threshold": DIR_PEAK_THRESHOLD}, (9, 0, 0), True),
    ("centroid", ("centroid",), {"peak_threshold": DIR_PEAK_THRESHOLD, "max_peaks": MAX_INST},
     {"peak_threshold": DIR_PEAK_THRESHOLD, "max_instances": MAX_INST, "max_peaks": MAX_INST},
     (9, 1, 0), True),
    ("centered_instance", ("centered_instance",), {"peak_threshold": DIR_PEAK_THRESHOLD},
     None, (9, 0, 0), False),
    ("bottomup", ("bottomup",), {"peak_threshold": DIR_PEAK_THRESHOLD, "max_peaks": DIR_MAX_PEAKS},
     {"peak_threshold": DIR_PEAK_THRESHOLD, "max_peaks": DIR_MAX_PEAKS,
      "min_line_scores": DIR_MIN_LINE, "max_instances": MAX_INST}, (9, 1, 1), True),
    ("multi_class_bottomup", ("multi_class_bottomup",), {"peak_threshold": DIR_PEAK_THRESHOLD},
     {"peak_threshold": DIR_PEAK_THRESHOLD, "max_instances": MAX_INST}, (9, 1, 0), True),
    ("topdown", ("centroid", "centered_instance"),
     {"peak_threshold": DIR_PEAK_THRESHOLD, "max_instances": MAX_INST},
     {"peak_threshold": DIR_PEAK_THRESHOLD, "max_instances": MAX_INST}, (18, 1, 0), True),
    ("multi_class_topdown", ("centroid", "multi_class_topdown"),
     {"peak_threshold": DIR_PEAK_THRESHOLD, "max_instances": MAX_INST},
     {"peak_threshold": DIR_PEAK_THRESHOLD, "max_instances": MAX_INST}, (18, 1, 0), True),
    ("semantic_segmentation", ("semantic_segmentation",), {}, {}, (9, 0, 0), True),
    ("bottomup_segmentation", ("bottomup_segmentation",), {"max_peaks": SEG_MAX_INST},
     {"max_instances": SEG_MAX_INST}, (9, 1, 0), True),
    ("centered_instance_segmentation", ("centered_instance_segmentation",), {}, None,
     (9, 0, 0), False),
)
EXPORT_BATCH, EXPORT_FRAMES = 4, 8
# Exported again at batch 8 (bf16): the paths' own batch.
EXPORT_BATCH8 = ("topdown", "bottomup")
# Also exported in fp32: the top-down composite and bottom-up (the other
# types are exported in bf16 only, for the script's time).
EXPORT_FP32 = ("bottomup", "topdown")
EXPORT_WRAPPERS = (("_fused_double_conv3x3", "sleap_nn_tpu_torch.ops.fused_conv"),
                   ("_nms_scores", "sleap_nn_tpu_torch.ops.kernels"),
                   ("paf_line_scores", "sleap_nn_tpu_torch.ops.kernels"))


def single_instance_dir(root):
    """A medium_rf single-instance model dir with random weights (phase 9's
    model type), for the export."""
    cfg = dir_config(MEDIUM_RF, "single_instance", N_NODES)
    model = random_model(cfg, seed=400)
    random_init(model)
    return write_port_dir(root / "single_instance", cfg, model)


def labels_distance(a, b):
    """(instance counts equal on every frame, largest distance of matched
    points in px, masks equal): instances and masks in order."""
    same_counts = [len(lf.instances) for lf in a] == [len(lf.instances) for lf in b] and \
        [len(lf.masks) for lf in a] == [len(lf.masks) for lf in b] and \
        [lf.frame_idx for lf in a] == [lf.frame_idx for lf in b]
    dist, masks_equal = 0.0, True
    if same_counts:
        for fa, fb in zip(a.labeled_frames, b.labeled_frames):
            for ia, ib in zip(fa.instances, fb.instances):
                if not np.array_equal(np.isnan(ia.points), np.isnan(ib.points)):
                    return same_counts, float("inf"), masks_equal
                d = np.abs(np.nan_to_num(ia.points) - np.nan_to_num(ib.points))
                dist = max(dist, float(d.max(initial=0.0)))
            masks_equal &= all(np.array_equal(ma.mask, mb.mask)
                               for ma, mb in zip(fa.masks, fb.masks))
    return same_counts, dist, masks_equal


def run_export(kernels, dirs, smi):
    """Phase 40: ``export_model`` of every type the earlier phases trained or
    built (phases 7, 10, 11, 17, 18 and 34's dirs, and a single-instance
    dir), bf16 at batch 4 (the ``EXPORT_FP32`` types also fp32, the
    ``EXPORT_BATCH8`` types bf16 also at batch 8), each verified by
    ``verify_export_numerics`` on the card;
    each export loaded and called once on real frames with the launch
    counters zeroed (every kernel call recorded at each new signature and
    held to its plain version); then ``run.predict`` from each export dir
    that ``from_export_dir`` serves, against ``run.predict`` from the
    source dirs with the same knobs and precision: instance counts,
    largest point distance, masks."""
    from sleap_nn_tpu_torch.export import export_model, load_exported_model
    from sleap_nn_tpu_torch.inference.run import predict

    frames = smoke_frames()[:EXPORT_FRAMES]
    o = (IMG - CROP) // 2
    crops = np.ascontiguousarray(frames[:EXPORT_BATCH, o:o + CROP, o:o + CROP])
    runs, seen, calls, rows = {}, set(), [], []
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        dirs = dict(dirs, single_instance=single_instance_dir(tmp))
        for name, sources, export_kw, predict_kw, per_call, loadable in EXPORT_RUNS:
            crop_model = not loadable
            for precision, batch in ([("fp32", EXPORT_BATCH)] if name in EXPORT_FP32 else []) \
                    + [("bf16", EXPORT_BATCH)] + ([("bf16", BATCH)] if name in EXPORT_BATCH8
                                                  else []):
                src = [dirs[s] for s in sources]
                out = tmp / f"{name}_{precision}_b{batch}"
                t0 = time.perf_counter()
                export_model(src if len(src) > 1 else src[0], output_dir=out, batch_size=batch,
                             precision=precision, input_height=IMG, input_width=IMG,
                             device=DEVICE, **export_kw)
                export_s = time.perf_counter() - t0
                call, meta = load_exported_model(out, device=DEVICE)
                x = crops if crop_model else frames[:EXPORT_BATCH]
                if batch != len(x):
                    x = np.concatenate([x] * (batch // len(x)))
                call(x)  # warm-up
                sync()
                with recording_kernel_calls(seen, calls, EXPORT_WRAPPERS):
                    _, launches = run_counted(kernels, lambda: call(x))
                want = dict(zip(("fused_double_conv3x3", "nms_scores", "paf_line_scores"),
                                per_call))
                expect_launches(f"the loaded {name} {precision} b{batch} program", launches,
                                phase=40, **want)
                key = f"export_{name}_{precision}_b{batch}"
                runs[key] = {"launches": launches, "n_batches": 1}
                row = {"name": name, "precision": precision, "batch": batch,
                       "export_s": export_s, "pt2_mb": (out / "model.pt2").stat().st_size / 2**20,
                       "input_shape": list(meta.input_shape), "launches_per_call": launches}
                if loadable and batch == EXPORT_BATCH:
                    kw = dict(predict_kw, batch_size=EXPORT_BATCH, device=DEVICE)
                    for paths in ([out], src):  # warm-up
                        predict(frame_labels(frames[:EXPORT_BATCH]), paths, make_labels=False,
                                use_bf16=precision == "bf16" and paths is src, **kw)
                    got, p_launches = run_counted(kernels, lambda: predict(
                        frame_labels(frames), [out], **kw))
                    want_labels = predict(frame_labels(frames), src,
                                          use_bf16=precision == "bf16", **kw)
                    same, dist, masks = labels_distance(got, want_labels)
                    n_batches = -(-EXPORT_FRAMES // EXPORT_BATCH)
                    expect_launches(f"run.predict from the {name} {precision} export dir",
                                    p_launches, phase=40,
                                    **{k: v * n_batches for k, v in want.items()})
                    runs[f"export_dir_predict_{name}_{precision}"] = {
                        "launches": p_launches, "n_batches": n_batches}
                    n = sum(len(lf.instances) + len(lf.masks) for lf in got)
                    # A CPU rehearsal's model-dir path runs plain convs, not the fused
                    # conv's plain version: in bf16 their roundings differ.
                    cpu_bf16 = DEVICE == "cpu" and precision == "bf16"
                    near = same and masks and dist <= EXPORT_MAX_DIST
                    if not ((near or cpu_bf16) and n):
                        raise AssertionError(
                            f"phase 40 {name} {precision}: from the export dir counts equal "
                            f"{same}, masks equal {masks}, {n} instances / masks, largest "
                            f"point distance {dist}")
                    row.update(counts_equal=same, masks_equal=masks, max_point_dist=dist,
                               objects=n, fps_export=got.provenance["stats"]["fps"],
                               fps_model_dir=want_labels.provenance["stats"]["fps"])
                log("export " + json.dumps(row))
                rows.append(row)
        held = check_recorded_calls([(n.lstrip("_"), a, k) for n, a, k in calls])
        bad = [r for r in held if not r["ok"]]
        log(f"export_kernel {len(held)} signatures held, "
            + json.dumps({"bad": bad, "max_abs_err": {k: max((r["max_abs_err"] for r in held
                                                              if r["kernel"] == k), default=None)
                                                      for k in TRACE_NAMES}}))
        if bad:
            raise AssertionError(f"phase 40: kernel calls off their plain versions: {bad}")
        cli_runs, cli_times = run_cli_export(kernels, dirs, tmp, frames, smi)
    log("export_summary " + json.dumps({
        "exports": len(rows), "export_s_total": sum(r["export_s"] for r in rows),
        "worst_point_dist": max(r.get("max_point_dist", 0.0) for r in rows),
        "cli_s": cli_times, "smi": smi}))
    return {**runs, **cli_runs}, held, rows


# run.predict from an export dir against the model dirs, in px: the same
# kernels on the same inputs.
EXPORT_MAX_DIST = 1e-3


def run_cli_export(kernels, dirs, tmp, frames, smi):
    """Phase 41: ``export`` of the top-down pair, then ``predict`` and
    ``track`` on the export dir, through ``cli.main`` in process (counted),
    on an MJPG clip of the frames; each command's seconds."""
    import io

    from sleap_nn_tpu_torch import cli
    from sleap_nn_tpu_torch.io.slp import load_slp

    clip = write_clip(tmp / "clip41.avi", frames, "MJPG")
    out = tmp / "cli_export"
    knobs = ["--peak-threshold", str(DIR_PEAK_THRESHOLD), "--max-instances", str(MAX_INST)]
    device = ["--device", "cpu"] if DEVICE == "cpu" else []
    times, runs = {}, {}
    n_batches = -(-len(frames) // EXPORT_BATCH)
    for name, argv, want in (
            ("export", ["export", dirs["centroid"], dirs["centered_instance"], "-o", out,
                        "--batch-size", EXPORT_BATCH, "--precision", "bf16", *knobs,
                        *device], {"fused_double_conv3x3": 36, "nms_scores": 2}),
            ("predict", ["predict", "-i", clip, "-m", out, "-o", tmp / "p41.slp", "--runtime",
                         "pt2", *knobs, *device],
             {"fused_double_conv3x3": 18 * n_batches, "nms_scores": n_batches}),
            ("track", ["track", "-i", clip, "-m", out, "-o", tmp / "t41.slp", *knobs, *device],
             {"fused_double_conv3x3": 18 * n_batches, "nms_scores": n_batches})):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            code, launches = run_counted(kernels, lambda: cli.main([str(a) for a in argv]))
        times[name] = time.perf_counter() - t0
        if code != 0:
            raise AssertionError(f"phase 41 {name}: exit code {code}")
        expect_launches(f"the command line's {name}", launches, phase=41, **want)
        runs[f"cli_export_{name}"] = {"launches": launches,
                                      "n_batches": 2 if name == "export" else n_batches}
    predicted, tracked = load_slp(tmp / "p41.slp"), load_slp(tmp / "t41.slp")
    if sum(len(lf) for lf in predicted) == 0 or \
            any(i.track is None for lf in tracked for i in lf.instances):
        raise AssertionError("phase 41: the export dir's predictions are empty or untracked")
    log("cli_export " + json.dumps({"seconds": times, "instances": sum(
        len(lf) for lf in predicted), "tracks": len(tracked.tracks), "smi": smi}))
    return runs, times


# --------------------------------------------------------------------------
# Phases 42-44: data-parallel predict, the config tooling, the legacy shim
# --------------------------------------------------------------------------


# Phase 42's paths: name, the dirs (phase 7-18 model types, or "seg:" one of
# phase 34's), run.predict's knobs, the launches a replica's batch of kernels
# 1-3, whether the frames are phase 34's animals.
DP_RUNS = (
    ("topdown", ("centroid", "centered_instance"), {}, (18, 1, 0), False),
    ("bottomup", ("bottomup",), {"min_line_scores": DIR_MIN_LINE, "max_peaks": DIR_MAX_PEAKS,
                                 "paf_workers": 0}, (9, 1, 1), False),
    ("single_instance", ("single_instance",), {}, (9, 0, 0), False),
    ("multi_class_bottomup", ("multi_class_bottomup",), {}, (9, 1, 0), False),
    ("semantic_segmentation", ("seg:semantic_segmentation",), {}, (9, 0, 0), True),
)
# Frames a frames/s figure of phase 42 runs over (8 batches).
DP_FPS_FRAMES = 64


def labels_masks_differ(a, b):
    """The largest share of pixels in which two ``Labels``' masks differ,
    masks taken in order (0 where no frame holds one)."""
    worst = 0.0
    for fa, fb in zip(a.labeled_frames, b.labeled_frames):
        for ma, mb in zip(fa.masks, fb.masks):
            worst = max(worst, float(np.mean(np.asarray(ma.mask) != np.asarray(mb.mask))))
    return worst


def run_data_parallel_predict(kernels, root, seg_dir_paths, smi):
    """Phase 42: data-parallel predict at full width (UNet medium_rf, 1024x1024
    frames, batch 8, bf16) for top-down, bottom-up, single-instance,
    multi-class bottom-up and semantic segmentation, from the dirs of phases
    7-18 and 34 (and a random-init single-instance dir).

    Per path: ``run.predict(..., data_parallel=True)`` over every card the
    process sees (one replica a card), counted, must equal the ``Labels``
    of the plain run at a replica's batch (``BATCH`` over the card count)
    bit for bit; then an explicit two-replica predictor on one card
    (``data_parallel=["cuda:0", "cuda:0"]``: each replica its own weights
    and streams, each batch split 4 + 4 and joined before the host step),
    run twice and counted (every kernel call recorded at each new signature
    and held to its plain version), must give bit for bit what a
    single-device predictor at batch 4 gives on the same frames (the same
    calls on the same rows: the tolerance is 0). Against the plain
    predictor at batch 8 the line records the difference a batch of 4
    makes (the largest point distance, masks, and the maps' largest
    difference in bf16 ulps of their magnitude): at another batch kernel 1
    plans its tiles and cuDNN picks its algorithms for another shape, and
    at peak threshold -1e9 a near-tie among random-weight peaks reorders
    the instances. Frames/s of the plain predictor, one replica a card and
    two replicas on one card, over ``DP_FPS_FRAMES`` frames."""
    import torch

    from sleap_nn_tpu_torch.inference.predictor import Predictor
    from sleap_nn_tpu_torch.inference.run import predict

    n_cards = torch.cuda.device_count() if DEVICE != "cpu" else 1
    two = [DEVICE if DEVICE == "cpu" else "cuda:0"] * 2
    n_batches = -(-N_FRAMES // BATCH)
    runs, rows, seen, calls = {}, [], set(), []
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {"single_instance": single_instance_dir(Path(tmp))}
        for name, sources, knobs, per_batch, animals in DP_RUNS:
            paths = [seg_dir_paths[s[4:]] if s.startswith("seg:") else dirs.get(s, root / s)
                     for s in sources]
            frames = seg_frames(N_FRAMES, seed=42) if animals else smoke_frames()
            kw = dict(batch_size=BATCH, use_bf16=True, device=DEVICE,
                      peak_threshold=DIR_PEAK_THRESHOLD, max_instances=MAX_INST, **knobs)
            predict(frame_labels(frames[:BATCH]), paths, make_labels=False,
                    data_parallel=True, **kw)  # warm-up
            sync()
            got, launches = run_counted(kernels, lambda: predict(
                frame_labels(frames), paths, data_parallel=True, **kw))
            want = dict(zip(("fused_double_conv3x3", "nms_scores", "paf_line_scores"),
                            (n * n_batches for n in per_batch)))
            expect_launches(f"{name} run.predict(data_parallel=True) on one card", launches,
                            phase=42, **{k: v * n_cards if n_cards > 1 else v
                                         for k, v in want.items()})
            runs[f"dp_{name}_run_predict"] = {"launches": launches, "n_batches": n_batches}
            # A card's replica predicts BATCH / n_cards rows of each batch.
            plain = predict(frame_labels(frames), paths, **dict(kw, batch_size=BATCH // n_cards))
            same, dist, masks = labels_distance(got, plain)
            if not (same and dist == 0.0 and masks):
                raise AssertionError(f"phase 42 {name}: one replica a card differs from the "
                                     f"plain run at batch {BATCH // n_cards}: counts {same}, "
                                     f"{dist} px, masks {masks}")
            pred_kw = {k: v for k, v in kw.items() if k not in ("paf_workers",)}
            two_rep = Predictor.from_model_paths(paths, data_parallel=two, **pred_kw)
            assert len(two_rep.replicas) == 2 and two_rep.replicas[0] is not two_rep.replicas[1]
            two_rep.predict(frame_labels(frames[:BATCH]), make_labels=False)  # warm-up
            sync()
            twice = []
            for _ in range(2):
                with recording_kernel_calls(seen, calls):
                    labels2, l2 = run_counted(kernels, lambda: two_rep.predict(
                        frame_labels(frames)))
                expect_launches(f"{name} two replicas on one card", l2, phase=42,
                                **{k: 2 * v for k, v in want.items()})
                twice.append(labels2)
            runs[f"dp_{name}_two_replicas"] = {"launches": l2, "n_batches": n_batches}
            half = Predictor.from_model_paths(paths, **dict(pred_kw, batch_size=BATCH // 2))
            at_half = half.predict(frame_labels(frames))
            full = Predictor.from_model_paths(paths, **pred_kw)
            at_full = full.predict(frame_labels(frames))
            exact = [labels_distance(t, at_half) for t in twice]
            if not all(s and d == 0.0 and m for s, d, m in exact):
                raise AssertionError(f"phase 42 {name}: two replicas differ from the plain "
                                     f"predictor at batch {BATCH // 2}: {exact}")
            # Against the plain predictor at batch 8 (a record): what a batch
            # of 4 changes, the maps' largest difference where the layer
            # returns them.
            same8, dist8, masks8 = labels_distance(twice[0], at_full)
            mask_frac = labels_masks_differ(twice[0], at_full)
            maps = {}
            for label, p in (("b4", half), ("b8", full)):
                outs = p.predict(frame_labels(frames[:BATCH]), make_labels=False,
                                 return_confmaps=True)
                maps[label] = {k: np.concatenate([o[k] for o in outs]) for k in ("confmaps",
                                                                                  "pafs")
                               if k in outs[0]}
            map_err = {k: float(np.abs(maps["b4"][k] - maps["b8"][k]).max())
                       for k in maps["b8"]}
            map_top = {k: float(np.abs(maps["b8"][k]).max()) for k in maps["b8"]}
            many = frame_labels(np.concatenate([frames] * (-(-DP_FPS_FRAMES // len(frames))))
                                [:DP_FPS_FRAMES])
            fps, fps_runs = {}, {}
            for label, p in (("plain", full), ("one_replica_a_card", Predictor.from_model_paths(
                    paths, data_parallel=True, **pred_kw)), ("two_replicas_one_card", two_rep)):
                fps_runs[label] = []
                for _ in range(2):
                    p.predict(many, make_labels=False)
                    fps_runs[label].append(p.last_stats["fps"])
                fps[label] = max(fps_runs[label])
            n_obj = sum(len(lf.instances) + len(lf.masks) for lf in twice[0])
            row = {"name": name, "launches_run_predict": launches, "launches_two_replicas": l2,
                   "objects": n_obj, "two_replicas_equal_batch4": True,
                   "vs_batch8": {"counts_equal": same8, "max_point_dist": dist8,
                                 "masks_equal": masks8, "mask_pixels_differ": mask_frac,
                                 "map_max_abs_diff": map_err, "map_max_abs": map_top,
                                 "map_diff_bf16_ulps": {k: map_err[k] / bf16_ulp(map_top[k])
                                                        for k in map_err if map_top[k] > 0}},
                   "fps": fps, "fps_runs": fps_runs, "cards": n_cards, "smi": smi}
            log("data_parallel_predict " + json.dumps(row))
            rows.append(row)
    held = check_recorded_calls(calls)
    bad = [r for r in held if not r["ok"]]
    log(f"data_parallel_kernel {len(held)} signatures held, " + json.dumps(
        {"bad": bad, "shapes": sorted({json.dumps(r['shapes']) for r in held})}))
    if bad:
        raise AssertionError(f"phase 42: kernel calls off their plain versions: {bad}")
    return runs, held, rows


# Phase 43: the synthetic dataset (15 nodes, 1-6 instances a 1024x1024
# frame) and the trainings from get_config keyword arguments.
CFG_FRAMES, CFG_STEPS = 12, 5


@contextlib.contextmanager
def peak_of(owner, attr, into):
    """Within the block, each call of ``getattr(owner, attr)`` starts the
    card's peak memory count anew and appends its peak in GiB to ``into``
    (nothing on the CPU)."""
    import torch

    real = getattr(owner, attr)

    def measured(*args, **kw):
        if DEVICE == "cpu":
            return real(*args, **kw)
        torch.cuda.reset_peak_memory_stats()
        try:
            return real(*args, **kw)
        finally:
            into.append(torch.cuda.max_memory_allocated() / 2**30)

    setattr(owner, attr, measured)
    try:
        yield into
    finally:
        setattr(owner, attr, real)


def run_config_tooling(kernels, smi):
    """Phase 43: the config tooling on the card. A synthetic ``.slp``
    (``CFG_FRAMES`` frames of 1024x1024, 15 nodes, 1-6 instances, embedded,
    from a seed); ``config-generate`` and ``config --auto`` with the quality
    and the throughput presets, and ``config`` on the YAML written (each
    exit 0, the YAMLs equal to ``generate_config``'s); then ``train()``
    without ``config_path``, from ``get_config`` keyword arguments at the
    recommended widths (UNet filters 32, the recommended max stride, sigma,
    scale and batch), a centroid model (the generated top-down pipeline's
    first stage) for ``CFG_STEPS`` steps on the card, once with the quality
    knobs and once with the throughput preset's (heads at output stride 4,
    frames scaled to 384 px); kernel 4 renders its targets (every call held
    to its plain version), and ``estimate_memory``'s total is printed beside
    ``torch.cuda.max_memory_allocated`` of the whole ``train()`` call and
    of its training loop alone (a record, not a gate); then the pipeline's
    second stage, the centered-instance model of the generated top-down
    YAML of each preset (the throughput one at crop 128), trained from that
    YAML for ``CFG_STEPS`` steps (no kernel launches in its training, and
    ``run_training`` evaluates no lone centered-instance model); then
    ``run.predict`` of each preset's top-down pair, counted (kernels 1 and
    2, every call held), with the two configs' frames/s side by side."""
    import torch
    import yaml

    from sleap_nn_tpu_torch import cli
    from sleap_nn_tpu_torch.config import TrainingJobConfig
    from sleap_nn_tpu_torch.config_generator import (
        analyze_slp, estimate_memory, generate_config, recommend_config)
    from sleap_nn_tpu_torch.inference.run import predict
    from sleap_nn_tpu_torch.io.slp import save_slp
    from sleap_nn_tpu_torch.train import train
    from sleap_nn_tpu_torch.training import ModelTrainer

    runs, rows, seen, calls = {}, {}, set(), []
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        slp = str(tmp / "animals.pkg.slp")
        save_slp(slp, training_labels(CFG_FRAMES, IMG, N_NODES, MAX_INST, seed=43), embed=True)
        stats = analyze_slp(slp)
        rec = recommend_config(stats)
        t0, printed = time.perf_counter(), {}
        for preset in ("quality", "throughput"):
            for argv in (["config-generate", slp, "-o", str(tmp / f"gen_{preset}.yaml"),
                          "--preset", preset],
                         ["config", slp, "--auto", "-o", str(tmp / f"auto_{preset}.yaml"),
                          "--preset", preset],
                         ["config", str(tmp / f"auto_{preset}.yaml")]):
                out = io.StringIO()
                with contextlib.redirect_stdout(out):
                    code = cli.main(argv)
                if code != 0:
                    raise AssertionError(f"phase 43: {' '.join(argv[:1] + argv[2:])} failed")
                printed[argv[0] + (" --auto" if "--auto" in argv else "")
                        + f" {preset}"] = out.getvalue()
            want = generate_config(slp, preset=preset).to_dict()
            for f in (f"gen_{preset}.yaml", f"auto_{preset}.yaml"):
                got = TrainingJobConfig.load_yaml(tmp / f).to_dict()
                if dict(got, filename="") != dict(want, filename=""):
                    raise AssertionError(f"phase 43: {f} is not generate_config's YAML")
        cli_s = time.perf_counter() - t0
        generated = json.loads(printed["config-generate quality"])
        if generated["pipeline"] != rec.pipeline.pipeline or yaml.safe_load(
                printed["config quality"])["filename"] != str(tmp / "auto_quality.yaml"):
            raise AssertionError("phase 43: config-generate or config printed another config")
        quality = yaml.safe_load((tmp / "auto_quality.yaml").read_text())
        fast = rec.throughput_preset
        trained = {}
        for preset, scale, stride in (("quality", rec.scale, 2),
                                      ("throughput", min(rec.scale, fast["scale"]),
                                       fast["output_stride"])):
            kwargs = dict(train_labels_path=slp, backbone_config="unet",
                          filters=32, filters_rate=1.5, max_stride=rec.max_stride,
                          output_stride=stride,
                          head_configs={"centroid": {"confmaps": {"sigma": rec.sigma}}},
                          scale=scale, ensure_grayscale=True, batch_size=rec.batch_size,
                          max_epochs=1, train_steps_per_epoch=CFG_STEPS, save_ckpt=True,
                          ckpt_dir=str(tmp), run_name=f"centroid_{preset}",
                          trainer_accelerator="cpu" if DEVICE == "cpu" else "auto")
            if DEVICE != "cpu":
                torch.cuda.reset_peak_memory_stats()
            t0, train_peak = time.perf_counter(), []
            with recording_kernel_calls(seen, calls, PATH_WRAPPERS + TRAIN_WRAPPERS), \
                    peak_of(ModelTrainer, "train", train_peak):
                trainer, t_launches = run_counted(kernels, lambda: train(**kwargs))
            train_s = time.perf_counter() - t0
            if t_launches["multi_confmaps"] < CFG_STEPS and DEVICE != "cpu":
                raise AssertionError(f"phase 43 {preset}: kernel 4 launched "
                                     f"{t_launches['multi_confmaps']} times in {CFG_STEPS} steps")
            peak = torch.cuda.max_memory_allocated() / 2**30 if DEVICE != "cpu" else None
            est = estimate_memory(IMG, IMG, channels=1, batch_size=rec.batch_size, filters=32,
                                  filters_rate=1.5, max_stride=rec.max_stride,
                                  output_stride=stride, scale=scale, n_heads_channels=1)
            cfg = trainer.config
            assert cfg.model_config.backbone_config.unet.output_stride == stride
            assert cfg.model_config.head_configs.centroid.confmaps.output_stride == stride
            # One "batch": the whole train() call (training, then the
            # post-training predict and evaluation of each split).
            runs[f"config_train_{preset}"] = {"launches": t_launches, "n_batches": 1}
            trained[preset] = Path(trainer.ckpt_dir)
            rows[preset] = {"scale": scale, "output_stride": stride, "train_s": train_s,
                            "steps_per_sec": trainer.history[-1]["train/steps_per_sec"],
                            "train_launches": t_launches, "peak_gib": peak,
                            "train_loop_peak_gib": train_peak[0] if train_peak else None,
                            "estimate_total_gib": est.total_device_gb * 1e9 / 2**30,
                            "estimate": str(est)}
        stage = {}
        for preset in trained:
            t0 = time.perf_counter()
            with recording_kernel_calls(seen, calls, PATH_WRAPPERS + TRAIN_WRAPPERS):
                trainer, t_launches = run_counted(kernels, lambda: train(
                    config_path=str(tmp / f"auto_{preset}.yaml"), max_epochs=1,
                    train_steps_per_epoch=CFG_STEPS, save_ckpt=True, ckpt_dir=str(tmp),
                    run_name=f"centered_instance_{preset}",
                    trainer_accelerator="cpu" if DEVICE == "cpu" else "auto"))
            train_s = time.perf_counter() - t0
            pre = trainer.config.data_config.preprocessing
            if trainer.model_type != "centered_instance" or (
                    preset == "throughput" and pre.crop_size != fast["crop_size"]):
                raise AssertionError(f"phase 43 {preset}: the generated YAML trained a "
                                     f"{trainer.model_type} at crop {pre.crop_size}")
            expect_launches(f"the {preset} centered-instance stage's training", t_launches,
                            phase=43)
            runs[f"config_train_centered_instance_{preset}"] = {"launches": t_launches,
                                                                 "n_batches": 1}
            stage[preset] = Path(trainer.ckpt_dir)
            rows[preset].update(instance_crop=pre.crop_size, instance_scale=pre.scale,
                                instance_train_s=train_s, instance_train_launches=t_launches,
                                instance_steps_per_sec=trainer.history[-1][
                                    "train/steps_per_sec"])
        frames = smoke_frames()
        kw = dict(batch_size=BATCH, use_bf16=True, device=DEVICE,
                  peak_threshold=DIR_PEAK_THRESHOLD, max_instances=MAX_INST)
        n_batches = -(-N_FRAMES // BATCH)
        for preset, d in trained.items():
            pair = [d, stage[preset]]
            predict(frame_labels(frames[:BATCH]), pair, make_labels=False, **kw)  # warm-up
            sync()
            with recording_kernel_calls(seen, calls):
                labels, launches = run_counted(kernels, lambda: predict(
                    frame_labels(frames), pair, **kw))
            if DEVICE != "cpu" and (launches["nms_scores"] != n_batches
                                    or launches["fused_double_conv3x3"] % n_batches
                                    or not launches["fused_double_conv3x3"]
                                    or launches["paf_line_scores"] + launches["multi_confmaps"]):
                raise AssertionError(f"phase 43 {preset}: predict launches {launches}")
            if len(labels.labeled_frames) != N_FRAMES:
                raise AssertionError(f"phase 43 {preset}: predictions on "
                                     f"{len(labels.labeled_frames)} of {N_FRAMES} frames")
            runs[f"config_predict_{preset}"] = {"launches": launches, "n_batches": n_batches}
            rows[preset].update(predict_launches=launches,
                                fps=labels.provenance["stats"]["fps"],
                                instances=sum(len(lf) for lf in labels.labeled_frames))
    held = check_recorded_calls(calls)
    bad = [r for r in held if not r["ok"]]
    log("config_tooling " + json.dumps({
        "recommendation": {k: v for k, v in rec.summary().items() if k != "throughput_preset"},
        "throughput_preset": {k: v for k, v in fast.items() if k != "note"},
        "quality_yaml_heads": [k for k, v in quality["model_config"]["head_configs"].items()
                               if v],
        "cli_s": cli_s, "runs": rows, "signatures_held": len(held), "bad": bad, "smi": smi}))
    if bad:
        raise AssertionError(f"phase 43: kernel calls off their plain versions: {bad}")
    return runs, held, rows


def run_legacy_shim(kernels, root, smi):
    """Phase 44: ``TopDownPredictor.from_trained_models`` on phase 7 + 11's
    dirs (f32: the legacy keywords hold no precision) warns once with a
    ``DeprecationWarning`` and gives the ``Labels`` that
    ``Predictor.from_model_paths`` gives with the same knobs, bit for bit;
    counted (kernels 1 and 2, every call held to its plain version)."""
    import warnings

    from sleap_nn_tpu_torch.inference.predictor import Predictor
    from sleap_nn_tpu_torch.inference.predictors import TopDownPredictor

    frames = smoke_frames()
    kw = dict(batch_size=BATCH, peak_threshold=DIR_PEAK_THRESHOLD, max_instances=MAX_INST,
              device=DEVICE)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        legacy = TopDownPredictor.from_trained_models(
            centroid_ckpt_path=str(root / "centroid"),
            confmap_ckpt_path=str(root / "centered_instance"), **kw)
    deps = [str(w.message) for w in caught if issubclass(w.category, DeprecationWarning)]
    if len(deps) != 1 or "TopDownPredictor.from_trained_models is deprecated" not in deps[0]:
        raise AssertionError(f"phase 44: deprecation warnings {deps}")
    legacy.predict(frame_labels(frames[:BATCH]), make_labels=False)  # warm-up
    sync()
    seen, calls = set(), []
    with recording_kernel_calls(seen, calls):
        got, launches = run_counted(kernels, lambda: legacy.predict(frame_labels(frames)))
    n_batches = -(-N_FRAMES // BATCH)
    expect_launches("the legacy TopDownPredictor", launches, phase=44,
                    fused_double_conv3x3=18 * n_batches, nms_scores=n_batches)
    want = Predictor.from_model_paths([root / "centroid", root / "centered_instance"],
                                      **kw).predict(frame_labels(frames))
    same, dist, masks = labels_distance(got, want)
    if not (same and dist == 0.0):
        raise AssertionError(f"phase 44: the shim's Labels differ: counts {same}, {dist} px")
    held = check_recorded_calls(calls)
    bad = [r for r in held if not r["ok"]]
    log("legacy_shim " + json.dumps({
        "warning": deps[0], "launches": launches, "instances": sum(len(lf) for lf in got),
        "fps": got.provenance["stats"]["fps"], "signatures_held": len(held), "bad": bad,
        "smi": smi}))
    if bad:
        raise AssertionError(f"phase 44: kernel calls off their plain versions: {bad}")
    return {"shim_topdown": {"launches": launches, "n_batches": n_batches}}, held


# --------------------------------------------------------------------------
# Phase 45: SAM prompted masks (the mask-review workflow)
# --------------------------------------------------------------------------

# The published facebook/sam-vit-huge architecture (its config.json's widths):
# ViT-H image encoder, 1024x1024 input, patches of 16 (a 64x64 grid).
SAM_CONFIG = {
    "model_type": "sam",
    "vision_config": {"hidden_size": 1280, "num_hidden_layers": 32, "num_attention_heads": 16,
                      "mlp_dim": 5120, "global_attn_indexes": [7, 15, 23, 31],
                      "image_size": 1024, "patch_size": 16, "window_size": 14,
                      "output_channels": 256, "num_pos_feats": 128, "num_channels": 3,
                      "layer_norm_eps": 1e-6, "use_rel_pos": True, "use_abs_pos": True},
    "prompt_encoder_config": {"hidden_size": 256, "image_size": 1024, "patch_size": 16,
                              "mask_input_channels": 16, "num_point_embeddings": 4},
    "mask_decoder_config": {"hidden_size": 256, "num_hidden_layers": 2,
                            "num_attention_heads": 8, "mlp_dim": 2048, "iou_head_depth": 3,
                            "iou_head_hidden_dim": 256, "num_multimask_outputs": 3,
                            "attention_downsample_rate": 2},
}
SAM_FRAMES = 8
# The card-against-CPU witness: the published widths with the depth cut to
# 4 layers, the last one global, so that the CPU run stays short.
SAM_WITNESS_LAYERS = 4
# float32 logits and IoU scores, card against CPU: 1e-4 of the largest
# magnitude (the CPU tests' 1e-4 absolute, at this width's scale); a mask
# pixel may differ only where the card's upscaled logit is that close to 0.
SAM_F32_REL_TOL = 1e-4
# bfloat16 against float32 IoU scores (the same frames and prompts): within
# 0.1 of the float32 scores' largest magnitude.
SAM_BF16_IOU_REL_TOL = 0.1


def sam_config(num_layers=None):
    """``SAM_CONFIG``, or its depth cut to ``num_layers`` with the last global."""
    cfg = json.loads(json.dumps(SAM_CONFIG))
    if num_layers is not None:
        cfg["vision_config"].update(num_hidden_layers=num_layers,
                                    global_attn_indexes=[num_layers - 1])
    return cfg


# The tables of embeddings and tokens among SAM's weights (std 1); every
# other weight of 2 or more dimensions is a linear or conv kernel.
SAM_EMBEDDINGS = ("point_embed.", "no_mask_embed.", "iou_token.", "mask_tokens.",
                  "positional_embedding")


def sam_state(arch, seed):
    """Random upstream-keyed float32 weights of a ``SamArch`` from an explicit
    seeded generator: linear and conv weights of std fan_in^-0.5, norms near 1,
    biases of 0.1, the relative-position tables and ``pos_embed`` of std 0.5
    (upstream initialises those to zero, which would leave them unused),
    embeddings and tokens of std 1."""
    import torch

    from sleap_nn_tpu_torch.models.sam_jax import TIED_KEYS, SamModel

    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in SamModel(arch).state_dict().items()}
    rng = np.random.default_rng(seed)
    out = {}
    for key, shape in shapes.items():
        if key in TIED_KEYS:
            continue
        v = rng.standard_normal(shape, dtype=np.float32)
        if "layer_norm" in key and key.endswith(".weight"):
            v = 1.0 + 0.1 * v
        elif key.endswith(".bias"):
            v *= 0.1
        elif "rel_pos" in key or key.endswith("pos_embed"):
            v *= 0.5
        elif len(shape) >= 2 and not any(m in key for m in SAM_EMBEDDINGS):
            v *= (shape[0] if "upscale" in key else int(np.prod(shape[1:]))) ** -0.5
        out[key] = v
    return out


def sam_encoder_flops(arch):
    """Multiply-adds x 2 of one frame through the image encoder: the linears
    (windowed layers on their zero-padded tokens), the attention products,
    the patch embedding and the neck."""
    g, c, ws = arch.grid, arch.hidden_size, arch.window_size
    padded = -(-g // ws) * ws
    total = 2 * g * g * 3 * arch.patch_size ** 2 * c
    for i in range(arch.num_hidden_layers):
        glob = i in arch.global_attn_indexes
        tokens = g * g if glob else padded * padded
        total += 2 * tokens * 4 * c * c + 2 * g * g * 2 * c * arch.mlp_dim
        total += 4 * g ** 4 * c if glob else 4 * (padded // ws) ** 2 * ws ** 4 * c
    o = arch.output_channels
    return total + 2 * g * g * (c * o + 9 * o * o)


@contextlib.contextmanager
def sam_stage_times(into):
    """Within the block, ``JaxSamBackend`` appends to ``into`` per frame the
    seconds of its encoder (synchronised), its batched decode (which ends in
    the copy to the host) and all of ``masks``, with the decode's outputs,
    and counts under ``"empty"`` the chosen masks that hold no pixel (the
    layer drops those, as in JAX)."""
    from sleap_nn_tpu_torch.inference.sam.backends import JaxSamBackend

    real = {name: getattr(JaxSamBackend, name) for name in ("_encode", "_decode", "masks")}

    def timed(name):
        def wrapper(self, *args, **kw):
            t0 = time.perf_counter()
            out = real[name](self, *args, **kw)
            if name == "_encode":
                sync()
            into.setdefault(name, []).append(time.perf_counter() - t0)
            if name == "_decode":
                into.setdefault("decoded", []).append(out)
            if name == "masks":
                into["empty"] = into.get("empty", 0) + sum(not m.any() for m in out[0])
            return out
        return wrapper

    for name in real:
        setattr(JaxSamBackend, name, timed(name))
    try:
        yield into
    finally:
        for name, fn in real.items():
            setattr(JaxSamBackend, name, fn)


def sam_per_frame_ms(times):
    """Median ms a frame of the encoder, the decode and the host's share of
    ``masks`` (CLAHE, the resizes, the pick), from ``sam_stage_times``."""
    enc, dec, tot = (np.array(times[k]) * 1e3 for k in ("_encode", "_decode", "masks"))
    return {"encoder_ms": float(np.median(enc)), "decode_ms": float(np.median(dec)),
            "host_ms": float(np.median(tot - enc - dec)),
            "encoder_ms_first": float(enc[0]), "frames": len(tot)}


def sam_logits_agree(got, want, rel_tol):
    """(largest abs error, tolerance, ok) of two arrays, the tolerance
    ``rel_tol`` of ``want``'s largest magnitude."""
    err = float(np.abs(got - want).max())
    tol = rel_tol * max(float(np.abs(want).max()), 1.0)
    return err, tol, err <= tol


def check_sam_against_cpu(frame, prompts, seed):
    """Phase 45's witness: one frame and its prompts through ``JaxSamBackend``
    in float32 at the published widths, depth cut to ``SAM_WITNESS_LAYERS``,
    on the card and on the host's CPU. Low-res logits and IoU scores
    within ``SAM_F32_REL_TOL``; masks equal except where the card's upscaled
    logit lies within that tolerance of 0."""
    import cv2

    from sleap_nn_tpu_torch.inference.sam.backends import JaxSamBackend
    from sleap_nn_tpu_torch.models.sam_jax import SamArch

    arch = SamArch.from_hf_config(sam_config(SAM_WITNESS_LAYERS))
    state = sam_state(arch, seed)
    out = {}
    for device in (DEVICE, "cpu"):
        backend = JaxSamBackend(state, arch, device=device)
        times = {}
        with sam_stage_times(times):
            masks, scores = backend.masks(frame, prompts)
        out[device] = (masks, scores, times["decoded"][0])
        del backend
    (cm, cs, (cl, ci)), (hm, hs, (hl, hi)) = out[DEVICE], out["cpu"]
    logit_err, logit_tol, logit_ok = sam_logits_agree(cl, hl, SAM_F32_REL_TOL)
    iou_err, iou_tol, iou_ok = sam_logits_agree(ci, hi, SAM_F32_REL_TOL)
    h, w = frame.shape[:2]
    scale = arch.image_size / max(h, w)
    nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
    off_pixels, off_far = 0, 0
    for i, (a, b) in enumerate(zip(cm, hm)):
        pick = int(np.flatnonzero(ci[i] == cs[i])[0])
        up = cv2.resize(cl[i, pick], (arch.image_size, arch.image_size),
                        interpolation=cv2.INTER_LINEAR)[:nh, :nw]
        full = cv2.resize(up, (w, h), interpolation=cv2.INTER_LINEAR)
        off_pixels += int((a != b).sum())
        off_far += int((np.abs(full[a != b]) > logit_tol).sum())
    row = {"layers": SAM_WITNESS_LAYERS, "global_attn_indexes": list(arch.global_attn_indexes),
           "prompts": len(prompts), "logits_max_abs_err": logit_err, "logits_tol": logit_tol,
           "iou_max_abs_err": iou_err, "iou_tol": iou_tol, "mask_pixels_off": off_pixels,
           "mask_pixels_off_beyond_tol": off_far}
    log("sam_card_vs_cpu " + json.dumps(row))
    if not (logit_ok and iou_ok and off_far == 0):
        raise AssertionError(f"phase 45: the card's SAM differs from the CPU's: {row}")
    return row


def run_sam_review(kernels, root, smi):
    """Phase 45: the mask-review workflow on the card. A top-down
    ``run.predict`` from phase 7 + 11's dirs writes a pose ``.slp`` of
    ``SAM_FRAMES`` 1024x1024 frames (kernels 1 and 2 counted, every call held
    to its plain version); a random-init SAM snapshot at ViT-H widths
    (``config.json`` and a ``model.safetensors`` this script writes) serves
    ``sam -i poses.slp --mask-backend sam_jax --sam-model-id SNAPSHOT
    --overlay-path ...`` in process, in float32; ``JaxSamBackend(use_bf16=True)``
    runs the same frames through ``run_sam_segmentation``. Checks: exit code
    0, one mask per prompted instance with the poses kept, the ``.masks.slp``
    read back equal, the overlay written, the witness card against CPU
    (``check_sam_against_cpu``), bf16 IoU scores within
    ``SAM_BF16_IOU_REL_TOL`` of float32's. Prints the encoder, decode and host
    ms a frame, the command's frames/s and the peak device memory."""
    import torch

    from sleap_nn_tpu_torch import cli
    from sleap_nn_tpu_torch.inference import sam as sam_pkg
    from sleap_nn_tpu_torch.inference.run import predict
    from sleap_nn_tpu_torch.inference.sam.backends import JaxSamBackend
    from sleap_nn_tpu_torch.inference.sam.prompts import visible_keypoints
    from sleap_nn_tpu_torch.io.slp import load_slp
    from sleap_nn_tpu_torch.models.sam_jax import SamArch

    tmp = tempfile.TemporaryDirectory()
    d = Path(tmp.name)
    frames = smoke_frames()[:SAM_FRAMES]
    dirs = [root / "centroid", root / "centered_instance"]
    kw = dict(batch_size=BATCH, use_bf16=True, device=DEVICE, peak_threshold=DIR_PEAK_THRESHOLD,
              max_instances=MAX_INST)

    # 1. The pose predictions, counted.
    seen, calls = set(), []
    with recording_kernel_calls(seen, calls):
        poses, launches = run_counted(kernels, lambda: predict(
            frame_labels(frames), dirs, output_path=d / "poses.slp", embed=True, **kw))
    n_batches = -(-SAM_FRAMES // BATCH)
    expect_launches("the pose predict", launches, phase=45,
                    fused_double_conv3x3=18 * n_batches, nms_scores=n_batches)
    held = check_recorded_calls(calls)
    bad = [r for r in held if not r["ok"]]
    if bad:
        raise AssertionError(f"phase 45: kernel calls off their plain versions: {bad}")
    n_prompted = sum(len(visible_keypoints(i.numpy()[:, :2])) > 0 for lf in poses for i in lf)

    # 2. The snapshot.
    t0 = time.perf_counter()
    snap = d / "sam-vit-huge-random"
    snap.mkdir()
    (snap / "config.json").write_text(json.dumps(sam_config()))
    arch = SamArch.from_hf_config(sam_config())
    write_safetensors(snap / "model.safetensors", sam_state(arch, seed=45))
    snapshot_s = time.perf_counter() - t0

    # 3. The sam command, float32, its Labels kept as run_sam_segmentation
    # returned them.
    returned, f32_times = [], {}
    real_run = sam_pkg.run_sam_segmentation

    def keep(*a, **k):
        returned.append(real_run(*a, **k))
        return returned[-1]

    argv = ["sam", "-i", str(d / "poses.slp"), "--mask-backend", "sam_jax", "--sam-model-id",
            str(snap), "--overlay-path", str(d / "overlay.png")]
    real_get = sam_pkg.get_mask_backend
    if DEVICE != "cuda":  # a CPU rehearsal: the command's backend on the CPU
        sam_pkg.get_mask_backend = lambda name, **k: real_get(name, **{**k, "device": DEVICE})
    sam_pkg.run_sam_segmentation = keep
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    stdout = io.StringIO()
    try:
        t0 = time.perf_counter()
        with sam_stage_times(f32_times), contextlib.redirect_stdout(stdout):
            code = cli.main(argv)
        command_s = time.perf_counter() - t0
    finally:
        sam_pkg.run_sam_segmentation, sam_pkg.get_mask_backend = real_run, real_get
    peak_f32 = torch.cuda.max_memory_allocated() / 2 ** 30 if DEVICE == "cuda" else None
    out_path = d / "poses.masks.slp"
    if code != 0 or not out_path.exists():
        raise AssertionError(f"phase 45: sam exited {code}: {stdout.getvalue()}")
    masked = returned[0]
    n_masks = sum(len(lf.masks) for lf in masked)
    if stdout.getvalue().strip() != f"Masked {len(masked)} frames, {n_masks} masks -> {out_path}":
        raise AssertionError(f"phase 45: the command printed {stdout.getvalue()!r}")
    # One mask a prompted instance; a chosen mask with no pixel is dropped.
    if n_masks + f32_times.get("empty", 0) != n_prompted or n_masks == 0:
        raise AssertionError(f"phase 45: {n_masks} masks (and {f32_times.get('empty', 0)} "
                             f"empty) for {n_prompted} prompted instances")
    if [(lf.frame_idx, len(lf)) for lf in masked] != [(lf.frame_idx, len(lf)) for lf in poses] \
            or not all(np.array_equal(a.points, b.points, equal_nan=True)
                       for fa, fb in zip(masked, poses) for a, b in zip(fa, fb)):
        raise AssertionError("phase 45: the poses were not kept")
    back = load_slp(out_path)
    same, dist, masks_equal = labels_distance(back, masked)
    scores_equal = all(np.float32(a.score) == np.float32(b.score) for fa, fb in zip(back, masked)
                       for a, b in zip(fa.masks, fb.masks))
    if not (same and dist == 0.0 and masks_equal and scores_equal):
        raise AssertionError(f"phase 45: the .masks.slp reads back different: counts {same}, "
                             f"{dist} px, masks {masks_equal}, scores {scores_equal}")
    import cv2

    overlay = cv2.imread(str(d / "overlay.png"))
    if overlay is None or overlay.shape != (IMG, IMG, 3):
        raise AssertionError("phase 45: no overlay PNG")

    # bf16 on the same frames.
    bf16_times = {}
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bf16 = JaxSamBackend.from_pretrained(str(snap), device=DEVICE, use_bf16=True)
    load_bf16_s = time.perf_counter() - t0
    with sam_stage_times(bf16_times):
        masked_bf16 = sam_pkg.run_sam_segmentation(str(d / "poses.slp"), "sam_jax", backend=bf16)
    peak_bf16 = torch.cuda.max_memory_allocated() / 2 ** 30 if DEVICE == "cuda" else None
    del bf16
    iou32 = np.concatenate([iou.ravel() for _, iou in f32_times["decoded"]])
    iou16 = np.concatenate([iou.ravel() for _, iou in bf16_times["decoded"]])
    bf16_err, bf16_tol, bf16_ok = sam_logits_agree(iou16, iou32, SAM_BF16_IOU_REL_TOL)
    bf16_masks = sum(len(lf.masks) for lf in masked_bf16)

    # 4. The witness, card against CPU, on the first frame's prompts (as the
    # layer builds them).
    from sleap_nn_tpu_torch.inference.sam.backends import MaskBackend
    from sleap_nn_tpu_torch.inference.sam.mask_layer import SamSegmentationLayer

    class PromptRecorder(MaskBackend):
        def masks(self, image, prompts):
            self.prompts = prompts
            return [], []

    recorder = PromptRecorder()
    SamSegmentationLayer(recorder).masks_for_frame(frames[0], poses.labeled_frames[0].instances)
    witness = check_sam_against_cpu(frames[0][..., 0], recorder.prompts, seed=46)

    flops = sam_encoder_flops(arch)
    f32_ms, bf16_ms = sam_per_frame_ms(f32_times), sam_per_frame_ms(bf16_times)
    row = {
        "frames": SAM_FRAMES, "instances": int(sum(len(lf) for lf in poses)),
        "prompted": int(n_prompted), "masks_f32": n_masks, "masks_bf16": bf16_masks,
        "empty_f32": f32_times.get("empty", 0), "empty_bf16": bf16_times.get("empty", 0),
        "mask_area_fraction_median": float(np.median([m.mask.mean() for lf in masked
                                                      for m in lf.masks])),
        "arch": {"hidden": arch.hidden_size, "layers": arch.num_hidden_layers,
                 "heads": arch.num_attention_heads, "global": list(arch.global_attn_indexes),
                 "grid": arch.grid},
        "encoder_gflop_per_frame": flops / 1e9,
        "f32": {**f32_ms, "tflops": flops / f32_ms["encoder_ms"] / 1e9,
                "floor_ms": flops / PEAK_F32 * 1e3, "peak_gib": peak_f32},
        "bf16": {**bf16_ms, "tflops": flops / bf16_ms["encoder_ms"] / 1e9,
                 "floor_ms": flops / PEAK_BF16 * 1e3, "peak_gib": peak_bf16,
                 "load_s": load_bf16_s},
        "command_s": command_s, "command_fps": SAM_FRAMES / command_s,
        "masks_fps_f32": SAM_FRAMES / float(np.sum(f32_times["masks"])),
        "masks_fps_bf16": SAM_FRAMES / float(np.sum(bf16_times["masks"])),
        "snapshot_write_s": snapshot_s,
        "bf16_iou_max_abs_err": bf16_err, "bf16_iou_tol": bf16_tol,
        "pose_launches": launches, "signatures_held": len(held), "witness": witness, "smi": smi}
    log("sam_review " + json.dumps(row))
    if not bf16_ok:
        raise AssertionError(f"phase 45: bf16 IoU scores off float32's by {bf16_err} > {bf16_tol}")
    tmp.cleanup()
    return {"sam_pose_predict": {"launches": launches, "n_batches": n_batches}}, held, row


# --------------------------------------------------------------------------
# Phase 46: remote inputs and the top-level API
# --------------------------------------------------------------------------
REMOTE_FRAMES = 16  # two batches of 8 from a clip of the smoke frames
REMOTE_HEADERS = {"X-Smoke": "46"}
PROXY_VARS = ("http_proxy", "https_proxy", "all_proxy", "HTTP_PROXY", "HTTPS_PROXY",
              "ALL_PROXY", "no_proxy", "NO_PROXY")


@contextlib.contextmanager
def loopback_server(directory):
    """``directory`` served by a ``ThreadingHTTPServer`` on 127.0.0.1 from a
    daemon thread, with proxies bypassed for the block (a request to the
    loopback address goes straight to it). Yields the base URL and the list
    of each GET's ``(path, headers)``, header names in lower case."""
    import http.server
    import os

    seen = []

    class Handler(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, directory=str(directory), **kwargs)

        def do_GET(self):
            seen.append((self.path, {k.lower(): v for k, v in self.headers.items()}))
            super().do_GET()

        def log_message(self, *args):
            pass

    saved = {k: os.environ.pop(k) for k in PROXY_VARS if k in os.environ}
    os.environ["no_proxy"] = os.environ["NO_PROXY"] = "*"
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_port}", seen
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
        for k in ("no_proxy", "NO_PROXY"):
            os.environ.pop(k, None)
        os.environ.update(saved)


def run_remote_and_api(kernels, root, smi):
    """Phase 46: remote inputs and the top-level API on the card. An MJPG
    clip of ``REMOTE_FRAMES`` smoke frames and a ``.slp`` of its top-down
    predictions, served by ``loopback_server``, go through
    ``sleap_nn_tpu_torch.predict`` of phase 7 + 11's dirs (bf16, batch 8)
    from ``http://127.0.0.1`` with ``REMOTE_HEADERS`` and from ``file://``:
    each run's ``Labels`` equal the local path's bit for bit, the server saw
    the headers, the downloads wait for the interpreter's exit (a subprocess
    shows none is left behind). ``load_models`` builds
    ``Predictor.from_model_paths``' predictor (outputs bit for bit), and
    ``PAFScorer.from_config`` of phase 10's dir, fed the inputs of one
    bottom-up batch's scoring, groups exactly as the layer does. Launches
    counted (kernel 1 18 and kernel 2 1 a top-down batch, kernel 3 once for
    ``PAFScorer.predict``), every kernel call of the phase held to its plain
    version."""
    import os
    from urllib.parse import quote

    import sleap_nn_tpu_torch
    from sleap_nn_tpu_torch.config import TrainingJobConfig, get_head_config
    from sleap_nn_tpu_torch.inference import run as prun
    from sleap_nn_tpu_torch.inference.layers import to_host
    from sleap_nn_tpu_torch.inference.paf_grouping import PAFScorer
    from sleap_nn_tpu_torch.inference.predictor import Predictor

    tmp = tempfile.TemporaryDirectory()
    d = Path(tmp.name)
    frames = smoke_frames()[:REMOTE_FRAMES]
    n_frames = len(frames)
    clip = write_clip(d / "clip.avi", frames, "MJPG")
    dirs = [root / "centroid", root / "centered_instance"]
    # The top-level API runs on the card unless asked (a CPU rehearsal asks).
    kw = dict(batch_size=BATCH, use_bf16=True, peak_threshold=DIR_PEAK_THRESHOLD,
              max_instances=MAX_INST, **({} if DEVICE == "cuda" else {"device": DEVICE}))
    # No warm-up: phase 45 has just predicted from the same dirs.
    n_batches = -(-n_frames // BATCH)
    pending = lambda: set(Path(tempfile.gettempdir()).glob("sleap_nn_tpu_torch_remote_*"))  # noqa: E731
    before = pending()
    seen, calls, runs, fetch_s, steps_s = set(), [], {}, {}, {}

    def counted(name, source, **extra):
        t0 = time.perf_counter()
        with recording_kernel_calls(seen, calls), \
                timing_calls({"fetch_s": (prun, "fetch_remote_data")}, fetch_s):
            fetch_s["fetch_s"] = 0.0
            labels, launches = run_counted(kernels, lambda: sleap_nn_tpu_torch.predict(
                data_path=source, model_paths=dirs, **kw, **extra))
        expect_launches(f"predict from {name}", launches, phase=46,
                        fused_double_conv3x3=18 * n_batches, nms_scores=n_batches)
        if labels.provenance.get("backend") != DEVICE:
            raise AssertionError(f"phase 46 {name}: predicted on "
                                 f"{labels.provenance.get('backend')}, not {DEVICE}")
        runs[f"remote_{name}"] = {"launches": launches, "n_batches": n_batches,
                                  "fps": labels.provenance["stats"]["fps"],
                                  "fetch_ms": fetch_s["fetch_s"] * 1e3}
        steps_s[name] = time.perf_counter() - t0
        return labels

    # 1. The local clip and a .slp of its predictions (the clip named by
    # its path), then both from the loopback server and from file:// URLs.
    # Meanwhile a fresh process fetches both from the server and exits:
    # its downloads must be gone from its temp directory.
    sub = d / "subprocess_tmp"
    sub.mkdir()
    code = ("import sys; from pathlib import Path; "
            "from sleap_nn_tpu_torch.inference.run import fetch_remote_data; "
            "print([Path(fetch_remote_data(u, headers={'X-Smoke': '46'})).stat().st_size "
            "for u in sys.argv[1:]])")
    local_clip = counted("local_clip", str(clip))
    local_clip.save(str(d / "clip.slp"))
    with loopback_server(d) as (url, requests):
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-c", code, f"{url}/clip.avi", f"{url}/clip.slp"],
            env={**os.environ, "TMPDIR": str(sub), "PYTHONPATH": str(ROOT)},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            local_slp = counted("local_slp", str(d / "clip.slp"))
            got = {"http_clip": counted("http_clip", f"{url}/clip.avi", headers=REMOTE_HEADERS),
                   "http_slp": counted("http_slp", f"{url}/clip.slp", headers=REMOTE_HEADERS)}
            for scheme in ("clip", "slp"):
                path = clip if scheme == "clip" else d / "clip.slp"
                got[f"file_{scheme}"] = counted(f"file_{scheme}", "file://" + quote(str(path)))
            sizes, errors = proc.communicate(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        subprocess_s = time.perf_counter() - t0
    left_behind = sorted(p.name for p in sub.iterdir())
    downloads = sorted(p.name for p in pending() - before)
    sizes = sizes.strip()
    if proc.returncode or sizes != str([clip.stat().st_size, (d / "clip.slp").stat().st_size]) \
            or left_behind:
        raise AssertionError(f"phase 46: the subprocess exited {proc.returncode}, downloaded "
                             f"{sizes}, left behind {left_behind}: {errors[-2000:]}")
    if len(downloads) != 2:
        raise AssertionError(f"phase 46: {len(downloads)} downloads pending, expected 2")
    headers_seen = sorted((path, h.get("x-smoke")) for path, h in requests)
    if headers_seen != [("/clip.avi", "46")] * 2 + [("/clip.slp", "46")] * 2:
        raise AssertionError(f"phase 46: the server saw {headers_seen}")
    for name, labels in got.items():
        want = local_clip if name.endswith("clip") else local_slp
        if not labels_equal(labels, want) or len(labels.labeled_frames) != n_frames:
            raise AssertionError(f"phase 46 {name}: the Labels differ from the local path's")

    # 2. load_models against Predictor.from_model_paths.
    t0 = time.perf_counter()
    batch = frame_labels(frames[:BATCH])
    by_api = sleap_nn_tpu_torch.load_models(dirs, **kw)
    plain = Predictor.from_model_paths(dirs, **kw)
    with recording_kernel_calls(seen, calls):
        api_out, api_launches = run_counted(
            kernels, lambda: by_api.predict(batch, make_labels=False))
    expect_launches("load_models' predictor", api_launches, phase=46,
                    fused_double_conv3x3=18, nms_scores=1)
    runs["remote_load_models"] = {"launches": api_launches, "n_batches": 1}
    if type(by_api.layer) is not type(plain.layer) or str(by_api.device) != str(plain.device):
        raise AssertionError("phase 46: load_models' predictor differs from from_model_paths'")
    assert_same_outputs(api_out, plain.predict(batch, make_labels=False))
    steps_s["load_models"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # 3. PAFScorer.from_config on one bottom-up batch's scoring inputs.
    bu = Predictor.from_model_paths([root / "bottomup"], batch_size=BATCH, use_bf16=True,
                                    peak_threshold=DIR_PEAK_THRESHOLD,
                                    min_line_scores=DIR_MIN_LINE, max_peaks=DIR_MAX_PEAKS,
                                    **({} if DEVICE == "cuda" else {"device": DEVICE}))
    layer = bu.layer
    head = get_head_config(TrainingJobConfig.load_yaml(root / "bottomup" / "training_config.yaml"))
    leaf = {"part_names": head.confmaps.part_names, "edges": head.pafs.edges,
            "output_stride": head.pafs.output_stride}
    scorer = PAFScorer.from_config(leaf, min_line_scores=DIR_MIN_LINE,
                                   k_per_node=layer.paf_scorer.k_per_node)
    fields = ("edge_inds", "sorted_edge_inds", "pafs_stride", "n_points",
              "max_edge_length_ratio", "dist_penalty_weight", "min_instance_peaks",
              "min_line_scores", "k_per_node")
    if any(getattr(scorer, f) != getattr(layer.paf_scorer, f) for f in fields):
        raise AssertionError("phase 46: from_config's scorer differs from the layer's")
    inputs = []
    real = layer.paf_scorer.score_on_device
    layer.paf_scorer.score_on_device = lambda *a: inputs.append(a) or real(*a)
    try:
        dev = layer.predict_async(frames[:BATCH])
    finally:
        del layer.paf_scorer.score_on_device
    host = to_host(dev)
    own = layer.postprocess_host(host)
    lift = layer.host_payload(host)["lift"]
    with recording_kernel_calls(seen, calls):
        grouped, paf_launches = run_counted(kernels, lambda: scorer.predict(*inputs[0]))
    expect_launches("PAFScorer.predict", paf_launches, phase=46, paf_line_scores=1)
    runs["remote_paf_scorer"] = {"launches": paf_launches,
                                 "n_batches": {"paf_line_scores": 1}}
    n_inst = sum(len(g[0]) for g in grouped)
    same = len(grouped) == BATCH and n_inst > 0 and all(
        np.array_equal(pts * lift, own["pred_keypoints"][i], equal_nan=True)
        and np.array_equal(vals, own["pred_peak_values"][i], equal_nan=True)
        and np.array_equal(scores, own["pred_instance_scores"][i])
        for i, (pts, vals, scores) in enumerate(grouped))
    if not same:
        raise AssertionError(f"phase 46: PAFScorer.predict differs from the layer's grouping "
                             f"({n_inst} instances)")
    steps_s["paf_scorer"] = time.perf_counter() - t0

    held = check_recorded_calls(calls)
    bad = [r for r in held if not r["ok"]]
    row = {"fps": {k.removeprefix("remote_"): v["fps"] for k, v in runs.items() if "fps" in v},
           "download_ms": {k.removeprefix("remote_"): v["fetch_ms"] for k, v in runs.items()
                           if k.startswith("remote_http")},
           "launches": {k.removeprefix("remote_"): v["launches"] for k, v in runs.items()},
           "headers_seen": headers_seen, "downloads_pending_until_exit": len(downloads),
           "subprocess_left_behind": len(left_behind), "subprocess_s": subprocess_s,
           "steps_s": steps_s,
           "clip_bytes": clip.stat().st_size, "slp_bytes": (d / "clip.slp").stat().st_size,
           "paf_scorer_instances": n_inst, "signatures_held": len(held), "bad": bad,
           "smi": smi}
    log("remote_and_api " + json.dumps(row))
    if bad:
        raise AssertionError(f"phase 46: kernel calls off their plain versions: {bad}")
    tmp.cleanup()
    return runs, held, row


# --------------------------------------------------------------------------
# Phase 47: the subpackages' re-exports, and masks through the geometric
# augmentation
# --------------------------------------------------------------------------

REEXPORT_PACKAGES = ("config", "io", "ops", "models", "data")
# A mask pixel whose source coordinate (in f64, from the CPU's matrices)
# lies within this many pixels of a half-integer is a tie that the card's
# and the CPU's f32 coordinates may round apart (a few ulps at 1024 px).
MASK_TIE_PX = 1e-3
# Image tolerance card against CPU: 1e-5 inside; where the source lies
# within a pixel outside the frame, bilinear ramps from the edge pixel to
# the zero padding over one pixel, so a coordinate's ulps (1.2e-4 px between
# 1024 and 2048) show at full strength: 4 of them there.
IMAGE_TOL, IMAGE_RAMP_TOL = 1e-5, 4 * 2.0 ** -13


def check_reexports():
    """Every name of the five subpackages' ``__all__`` is the object of the
    port module that defines it (not a wrapper). Returns the names held."""
    import importlib

    held = 0
    for sub in REEXPORT_PACKAGES:
        pkg = importlib.import_module(f"sleap_nn_tpu_torch.{sub}")
        for name in pkg.__all__:
            obj = getattr(pkg, name)
            homes = [m for k, m in list(sys.modules.items())
                     if k.startswith(pkg.__name__ + ".") and getattr(m, name, None) is obj]
            home = getattr(obj, "__module__", None)
            if not homes or (home and home.startswith("sleap_nn_tpu_torch")
                             and getattr(sys.modules[home], name, None) is not obj):
                raise AssertionError(f"phase 47: {pkg.__name__}.{name} is not a port "
                                     f"module's own object")
            held += 1
    return held


@contextlib.contextmanager
def drawn_values(aug, flip, affine):
    """The augmentation chain's flip and affine samplers return ``flip``
    and ``affine`` (moved to the generator's device) in place of a draw."""
    saved = aug.sample_flip, aug.sample_affine
    aug.sample_flip = lambda generator, batch, p: flip.to(generator.device)
    aug.sample_affine = lambda generator, batch, *args: {
        k: v.to(generator.device) for k, v in affine.items()}
    try:
        yield
    finally:
        aug.sample_flip, aug.sample_affine = saved


def source_coords(mats, h, w):
    """``(sx, sy)``, each ``(B, H, W)`` f64: each output pixel's source
    coordinate under the inverse of ``mats``."""
    inv = np.linalg.inv(mats.astype(np.float64))
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float64), np.arange(w, dtype=np.float64),
                         indexing="ij")
    return tuple(inv[:, r, 0, None, None] * xx + inv[:, r, 1, None, None] * yy
                 + inv[:, r, 2, None, None] for r in range(2))


def run_mask_augmentation(kernels, smi):
    """Phase 47: the five subpackages' re-exports are the port modules'
    own objects (``check_reexports``), then ``apply_geometric_augmentation``
    with masks at the training smoke's shape (batch ``TRAIN_BATCH``,
    ``TRAIN_IMG``^2, ``MAX_INST`` instance masks, uint8 and f32) on the card
    and on the CPU, given the same drawn values (``drawn_values``): row 0
    flipped and moved half a pixel right, row 1 rotated 30 degrees and
    scaled 1.1, row 2 flipped and scaled 0.5 (every source coordinate a
    tie), row 3 rotated -12.5 degrees, scaled 0.9 and moved (3.25, 0.5).
    Masks equal the CPU's exactly on rows 0 and 2 and elsewhere but at
    pixels within ``MASK_TIE_PX`` of a tie (counted and printed); images
    within ``IMAGE_TOL`` (``IMAGE_RAMP_TOL`` on the one-pixel ramp to the
    zero padding), points within 1e-3 px; the chain without masks gives the
    same image and points bit for bit. No kernel of the port launches.
    Times ``warp_image`` a call: nearest (``order=0``) on the uint8 and f32
    masks, bilinear (``order=1``) on the f32 masks and on the image, and
    the chain with masks."""
    import torch

    from sleap_nn_tpu_torch.data import augmentation as aug

    reexports_held = check_reexports()
    b, h, w, m = TRAIN_BATCH, TRAIN_IMG, TRAIN_IMG, MAX_INST
    rng = np.random.default_rng(47)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    # A smooth image (broad blobs), so that an ulp between the card's and
    # the CPU's matrices moves a bilinear tap by far less than 1e-5.
    image = np.zeros((b, h, w, 1), np.float32)
    for k in range(b):
        for cx, cy, s in zip(*rng.uniform(0, w, (2, 6)), rng.uniform(0.1, 0.3, 6) * w):
            image[k, :, :, 0] += np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s))
    image = np.clip(image / image.max(), 0, 1)
    points = rng.uniform(0, w, (b, m, N_NODES, 2)).astype(np.float32)
    centres, radii = rng.uniform(0.1 * w, 0.9 * w, (b, m, 2)), rng.uniform(0.03, 0.15, (b, m)) * w
    masks = ((xx[None, :, :, None] - centres[:, None, None, :, 0]) ** 2
             + (yy[None, :, :, None] - centres[:, None, None, :, 1]) ** 2
             <= radii[:, None, None, :] ** 2).astype(np.uint8)  # (B, H, W, M)
    flip = torch.tensor([True, False, True, False])
    affine = {"angle": torch.tensor([0.0, 30.0, 0.0, -12.5]) * (np.pi / 180.0),
              "scale": torch.tensor([1.0, 1.1, 0.5, 0.9]),
              "tx": torch.tensor([0.5, 0.0, 0.0, 3.25]), "ty": torch.tensor([0.0, 0.0, 0.0, 0.5])}
    kw = dict(flip_p=0.5, rotation_p=1.0, scale_p=1.0, translate_p=1.0)
    exact_rows = [0, 2]

    def chain(device, mask_dtype, with_masks=True):
        gen = torch.Generator(device=device).manual_seed(47)
        mk = torch.from_numpy(masks).to(device, mask_dtype) if with_masks else None
        with drawn_values(aug, flip, affine):
            out = aug.apply_geometric_augmentation(
                gen, torch.from_numpy(image).to(device), torch.from_numpy(points).to(device),
                masks=mk, **kw)
        return [t.cpu() for t in out]

    for k in kernels.values():
        k.launches = 0
    mats = aug.affine_matrices(**affine, height=h, width=w)
    sx, sy = source_coords(mats.numpy(), h, w)
    ties = np.zeros(sx.shape, bool)
    for src in (sx, sy):
        ties |= np.abs(src - np.floor(src) - 0.5) < MASK_TIE_PX
    ramp = ((sx > -1) & (sx < 0)) | ((sx > w - 1) & (sx < w)) | ((sy > -1) & (sy < 0)) \
        | ((sy > h - 1) & (sy < h))
    row = {"shape": [b, h, w, m], "reexports_held": reexports_held, "masks": {}}
    for dtype_name, dtype in (("uint8", torch.uint8), ("float32", torch.float32)):
        card, cpu = chain(DEVICE, dtype), chain("cpu", dtype)
        if card[2].dtype != dtype or cpu[2].dtype != dtype:
            raise AssertionError(f"phase 47 {dtype_name}: masks came back "
                                 f"{card[2].dtype} / {cpu[2].dtype}")
        img_diff = (card[0] - cpu[0]).abs().amax(-1).numpy()
        img_err = float(img_diff[~ramp].max(initial=0.0))
        ramp_err = float(img_diff[ramp].max(initial=0.0))
        pts_err = float((card[1] - cpu[1]).nan_to_num().abs().max())
        differ = (card[2] != cpu[2]).any(-1).numpy()
        row["masks"][dtype_name] = {
            "image_max_abs_err": img_err, "image_max_abs_err_edge_ramp": ramp_err,
            "edge_ramp_pixels": int(ramp.sum()), "points_max_abs_err": pts_err,
            "pixels_differing": int(differ.sum()),
            "pixels_differing_off_ties": int((differ & ~ties).sum()),
            "pixels_differing_exact_rows": int(differ[exact_rows].sum()),
            "tie_pixels": int(ties.sum()), "mask_pixels_on": int(cpu[2].sum())}
        if img_err > IMAGE_TOL or ramp_err > IMAGE_RAMP_TOL or pts_err > 1e-3 \
                or (differ & ~ties).any() \
                or differ[exact_rows].any():
            raise AssertionError(f"phase 47 {dtype_name}: the card's augmentation differs from "
                                 f"the CPU's: {row['masks'][dtype_name]}")
        plain = chain(DEVICE, dtype, with_masks=False)
        if len(plain) != 2 or not (torch.equal(plain[0], card[0])
                                   and torch.equal(plain[1].nan_to_num(), card[1].nan_to_num())):
            raise AssertionError(f"phase 47 {dtype_name}: masks changed the image or the points")
    launches = {name: k.launches for name, k in kernels.items()}
    if any(launches.values()):
        raise AssertionError(f"phase 47: the augmentation launched port kernels: {launches}")

    dev_mats = mats.to(DEVICE)
    dev_image = torch.from_numpy(image).to(DEVICE)
    dev_masks = {n: torch.from_numpy(masks).to(DEVICE, t)
                 for n, t in (("uint8", torch.uint8), ("float32", torch.float32))}
    gen = torch.Generator(device=DEVICE).manual_seed(47)
    row["ms"] = {
        "order0_uint8": cuda_ms(lambda: aug.warp_image(dev_masks["uint8"], dev_mats, order=0), 20),
        "order0_float32": cuda_ms(lambda: aug.warp_image(dev_masks["float32"], dev_mats,
                                                         order=0), 20),
        "order1_float32_masks": cuda_ms(lambda: aug.warp_image(dev_masks["float32"], dev_mats),
                                        20),
        "order1_image": cuda_ms(lambda: aug.warp_image(dev_image, dev_mats), 20),
        "chain_with_uint8_masks": cuda_ms(lambda: aug.apply_geometric_augmentation(
            gen, dev_image, torch.from_numpy(points).to(DEVICE), masks=dev_masks["uint8"],
            **kw), 20)}
    row["launches"], row["smi"] = launches, smi
    log("mask_augmentation " + json.dumps(row))
    return row



def kernel_summary(fused_rows, nms_rows, nms_bu_rows, paf_rows, paf_breakdown, cm_rows, runs,
                   held):
    """The ``kernels`` line: one entry per kernel, launches from the paths'
    runs (``runs``: path name -> the phase's stats, with its ``launches``
    and ``n_batches``, one count or a count per kernel that launched), and
    the checks at the shapes of other paths (``held``: name -> the rows of
    ``check_recorded_calls``; phase 20's ``video_path``, phase 22's
    ``file_train``, phase 23's ``cli``, phases 24-26's ``tiled``, ``gt`` and
    ``tiled_train``, phases 27-30's ``backbone``)."""
    main_path = [r for r in fused_rows if r["dtype"] == "bfloat16"]
    nms_main = next(r for r in nms_rows if r["dtype"] == "bfloat16" and r["kernel"] == 3)
    nms_bu = next(r for r in nms_bu_rows if r["dtype"] == "bfloat16")
    paf_main = next(r for r in paf_rows if r["dtype"] == "bfloat16")
    t_ops = sum(r["flops"] / PEAK_BF16 for r in main_path)
    t_bytes = sum(r["bytes"] / PEAK_BYTES for r in main_path)

    cm_main = next(r for r in cm_rows if r["path"] == "bottomup_train")

    def batches(path, kernel):
        n = runs[path]["n_batches"]
        return n.get(kernel, 0) if isinstance(n, dict) else n

    def launches(kernel):
        by_path = {path: run["launches"][kernel] for path, run in runs.items()}
        out = {"launches": sum(by_path.values()), "launches_by_path": by_path,
               "launches_per_batch": {path: n // batches(path, kernel) if n else 0
                                      for path, n in by_path.items()}}
        # The calls made by loaded .pt2 programs (phases 40-41).
        out["launches_from_pt2"] = sum(n for path, n in by_path.items() if path.startswith(
            ("export_", "cli_export_predict", "cli_export_track")))
        for what, held_rows in held.items():
            rows = [r for r in held_rows if r["kernel"] == kernel]
            out[f"{what}_shapes_held"] = len(rows)
            out[f"{what}_max_abs_err"] = max((r["max_abs_err"] for r in rows), default=None)
        return out

    return {"kernels": [
        {
            "name": "fused_double_conv3x3", "route": "cuda",
            "source": "sleap_nn_tpu_torch/csrc/fused_double_conv3x3.cu",
            "replaces": "sleap_nn_tpu/ops/fused_conv.py:112",
            **launches("fused_double_conv3x3"),
            "max_abs_err": max(r["max_abs_err"] for r in fused_rows),
            "max_err": max(r["max_abs_err"] / r["tol"] for r in fused_rows),
            "tol": "bf16: 1 bf16 ulp at the output's largest magnitude; f32: 1e-4 x that magnitude",
            "max_err_ulps": max(r["err_ulps"] for r in main_path),
            "timing": "kernel_ms: graph_ms of bare launches with pre-packed weights; "
                      "wrapper_ms: calls of fused_double_conv3x3 (weights packed once, cached); "
                      "pack_ms: packing both weights of every call anew",
            "ms": sum(r["kernel_ms"] for r in main_path),
            "kernel_ms": sum(r["kernel_ms"] for r in main_path),
            "wrapper_ms": sum(r["wrapper_ms"] for r in main_path),
            "pack_ms": sum(r["pack_ms"] for r in main_path),
            "tflops": sum(r["flops"] for r in main_path) / sum(r["kernel_ms"] for r in main_path)
            / 1e9,
            "plain_ms": sum(r["plain_ms"] for r in main_path),
            "bound_ms": sum(r["bound_ms"] for r in main_path),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": sum(r["library_ms"] for r in main_path),
            "shapes": "the 18 bf16 calls of one top-down batch (9 centroid UNet @ 8x1024^2, "
                      "9 instance UNet @ 48x256^2); times summed. The bottom-up and "
                      "single-instance UNets' 9 calls have the centroid UNet's shapes",
        },
        {
            "name": "nms_scores", "route": "cuda",
            "source": "sleap_nn_tpu_torch/csrc/nms_scores.cu",
            "replaces": "sleap_nn_tpu/ops/pallas_kernels.py:116",
            **launches("nms_scores"),
            "max_abs_err": max(r["max_abs_err"] for r in nms_rows + nms_bu_rows),
            "max_err": max(r["max_abs_err"] for r in nms_rows + nms_bu_rows),
            "tol": "exact",
            "ms": nms_main["kernel_ms"], "kernel_ms": nms_main["kernel_ms"],
            "wrapper_ms": nms_main["wrapper_ms"],
            "plain_ms": nms_main["plain_ms"], "bound_ms": nms_main["bound_ms"],
            "bound_by": nms_main["bound_by"], "library_ms": None,
            "shapes": "(8, 512, 512, 1) bf16, k=3",
            "bottomup": {k: nms_bu[k] for k in ("x", "kernel_ms", "wrapper_ms", "plain_ms",
                                                 "bound_ms", "bound_by", "n_peaks")},
            "centroid_eval": {"launches": runs["train"]["eval_renders"],
                              **runs["train"]["eval_peaks"]},
        },
        {
            "name": "paf_line_scores", "route": "cuda",
            "source": "sleap_nn_tpu_torch/csrc/paf_line_scores.cu",
            "replaces": "sleap_nn_tpu/ops/pallas_kernels.py:204",
            **launches("paf_line_scores"),
            "max_abs_err": max(r["max_abs_err"] for r in paf_rows),
            "tol": "1e-5 absolute on finite scores; -inf and NaN placement exact",
            "ms": paf_main["kernel_ms"], "kernel_ms": paf_main["kernel_ms"],
            "wrapper_ms": paf_main["wrapper_ms"],
            "plain_ms": paf_main["plain_ms"], "bound_ms": paf_main["bound_ms"],
            "bound_by": paf_main["bound_by"], "library_ms": None,
            "gather_ms": paf_main["gather_ms"],
            "gather_note": "advanced-index gather of the x and y samples only (what the TPU "
                           "kernel computed), not the scoring",
            "paf_scoring_breakdown": {k: v for k, v in paf_breakdown.items() if k != "profiler"},
            "shapes": f"PAFs {paf_main['pafs']} bf16, peaks {paf_main['peaks']}, "
                      f"{N_POINTS} line points, {paf_main['valid_pairs']} valid pairs",
        },
        {
            "name": "multi_confmaps", "route": "cuda",
            "source": "sleap_nn_tpu_torch/csrc/multi_confmaps.cu",
            "replaces": "sleap_nn_tpu/ops/pallas_kernels.py:35",
            **launches("multi_confmaps"),
            "max_abs_err": max(r["max_abs_err"] for r in cm_rows),
            "tol": "1e-6 absolute",
            "ms": cm_main["kernel_ms"], "kernel_ms": cm_main["kernel_ms"],
            "wrapper_ms": cm_main["wrapper_ms"],
            "plain_ms": cm_main["plain_ms"], "bound_ms": cm_main["bound_ms"],
            "bound_by": cm_main["bound_by"], "library_ms": None,
            "timing": "kernel_ms: 20 launches of the C entry captured in a CUDA graph; "
                      "wrapper_ms: 20 calls of multi_confmaps between events",
            "shapes": f"points {cm_main['points']} -> {cm_main['out']} f32 (bottom-up training "
                      "targets; launches_per_batch counts renders: train steps, val batches "
                      "and the setup probe)",
            "zeros_exact": all(r["zeros_exact"] for r in cm_rows),
            "train_bottomup_path_max_abs_err":
                runs["train_bottomup"]["stage_ms"]["render_parts"]["confmaps_max_abs_err"],
            "other_cases": {r["path"]: {k: r[k] for k in ("points", "out", "kernel_ms",
                                                          "wrapper_ms", "plain_ms", "bound_ms",
                                                          "bound_by", "max_abs_err")}
                            for r in cm_rows if r is not cm_main},
        },
    ]}


# --------------------------------------------------------------------------


def main() -> int:
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        from sleap_nn_tpu_torch.config.model_config import UNetMediumRFConfig
        from sleap_nn_tpu_torch.ops import _build, fused_conv, kernels  # noqa: F401
    except ImportError as exc:
        print(f"the port package is not beside this script: {exc}", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 1. Device report.
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"device: {name} | torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")

    # 2. Build: the kernels (nvcc, in parallel) and, beside them, the native
    # PAF grouping (g++).
    from sleap_nn_tpu_torch import native

    native_s, t_build = [], time.perf_counter()
    native_build = threading.Thread(target=lambda: native_s.append(
        (native.get_lib(), time.perf_counter() - t_build)))
    native_build.start()
    build_s = _build.build()
    native_build.join()
    log(f"build: {build_s:.2f} s for {len(_build.KERNELS)} kernels; native PAF grouping "
        f"{'loaded' if native_s[0][0] is not None else 'FAILED'} after {native_s[0][1]:.2f} s "
        f"({native.library_path().name})")
    for k in _build.KERNELS.values():
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {k.name}: {line.strip()}")

    sass = sass_tensor_ops(fused_conv.KERNEL)
    log(f"sass fused_double_conv3x3: {json.dumps(sass)}")
    if sass is not None and not sass["HMMA"] + sass["HGMMA"]:
        raise AssertionError("fused_double_conv3x3's SASS holds no tensor-core instruction")

    # 3. Kernels against their plain versions, at the paths' shapes.
    cfg, centroid, instance = build_models(UNetMediumRFConfig, N_NODES, seed=0)
    layer = build_layer(cfg, centroid, instance, DEVICE, True, CROP, MAX_INST)
    bu_cfg, bu_model = build_bottomup_model(UNetMediumRFConfig, N_NODES, seed=3,
                                            frames=smoke_frames()[:2])
    bu_layer = build_bottomup_layer(bu_cfg, bu_model, DEVICE, True, MAX_INST)
    rng = np.random.default_rng(0)
    fused_rows = check_fused(layer, rng)
    nms_rows = check_nms(rng)
    nms_bu_rows = check_nms(rng, channels=N_NODES, ks=(3,))
    paf_rows = check_paf(bu_layer, smoke_frames()[:BATCH])
    cm_rows = check_confmaps(rng)
    check_fused_refuses_autograd()

    # 4. Top-down end to end through Predictor.predict.
    e2e = run_end_to_end(layer, _build.KERNELS)

    # 5. Bottom-up end to end through Predictor.predict, grouping natively.
    native_grouping = check_native_grouping(bu_layer, smoke_frames()[:BATCH])
    bu = run_bottomup_end_to_end(bu_layer, _build.KERNELS)

    # 6. Card against CPU on a small input.
    check_against_cpu()
    check_bottomup_against_cpu()

    # 7. Centroid training end to end, into a model dir that phase 13 loads,
    # with the epoch-end evaluation.
    runs_dir = tempfile.TemporaryDirectory()
    root = Path(runs_dir.name)
    tr = run_training_end_to_end(_build.KERNELS, root, evaluate=True)

    # 8. Training on the card against the CPU.
    check_training_against_cpu()

    # 9. Single-instance end to end through Predictor.predict.
    si_layer = build_single_instance_layer(UNetMediumRFConfig, N_NODES, seed=6, device=DEVICE,
                                           use_bf16=True)
    si = run_single_instance_end_to_end(si_layer, _build.KERNELS)

    # 10. Bottom-up training end to end (kernel 4 at 15 nodes).
    tr_bu = run_training_end_to_end(_build.KERNELS, root, "bottomup")

    # 11. Centered-instance training end to end.
    tr_ci = run_training_end_to_end(_build.KERNELS, root, "centered_instance", crop_size=CROP,
                                    evaluate=True)

    # 12. Training of the other model types on the card against the CPU.
    for model_type in ("single_instance", "centered_instance", "bottomup"):
        check_training_against_cpu(model_type)

    # 13. run.predict from the model dirs of phases 7 + 11 and of phase 10.
    dir_td = run_model_dir_predict(_build.KERNELS, [root / "centroid", root / "centered_instance"],
                                   "topdown")
    dir_bu = run_model_dir_predict(_build.KERNELS, [root / "bottomup"], "bottomup")

    # 14. Narrow model dirs trained on the CPU, predicted on the card and the CPU.
    narrow_labels, narrow_dirs = train_narrow_dirs(root)
    check_model_dirs_against_cpu(narrow_labels, narrow_dirs)

    # 15. Tracked run.predict from the model dirs of phase 13.
    t_phase = time.perf_counter()
    tracked_td = run_tracked_predict(_build.KERNELS, [root / "centroid",
                                                      root / "centered_instance"],
                                     "topdown", smi)
    tracked_bu = run_tracked_predict(_build.KERNELS, [root / "bottomup"], "bottomup", smi)
    log(f"phase 15: {time.perf_counter() - t_phase:.1f} s")

    # 16. Tracking and evaluation of the narrow dirs, the card against the CPU.
    t_phase = time.perf_counter()
    check_tracking_against_cpu(narrow_dirs, root)
    log(f"phase 16: {time.perf_counter() - t_phase:.1f} s")

    # 17. Multi-class bottom-up training end to end (kernel 4, class maps).
    t_phase = time.perf_counter()
    tr_mbu = run_training_end_to_end(_build.KERNELS, root, "multi_class_bottomup")
    log(f"phase 17: {time.perf_counter() - t_phase:.1f} s")

    # 18. Multi-class centered-instance training end to end (class vectors).
    t_phase = time.perf_counter()
    tr_mtd = run_training_end_to_end(_build.KERNELS, root, "multi_class_topdown",
                                     crop_size=CROP, evaluate=True)
    log(f"phase 18: {time.perf_counter() - t_phase:.1f} s")

    # 19. run.predict of the identity models from their dirs; narrow
    # identity dirs on the card against the CPU.
    t_phase = time.perf_counter()
    dir_mbu = run_model_dir_predict(_build.KERNELS, [root / "multi_class_bottomup"],
                                    "multi_class_bottomup")
    dir_mtd = run_model_dir_predict(_build.KERNELS, [root / "centroid",
                                                     root / "multi_class_topdown"],
                                    "multi_class_topdown")
    id_labels, id_dirs = train_narrow_identity_dirs(root, narrow_dirs["centroid"])
    check_identity_dirs_against_cpu(id_labels, id_dirs)
    log(f"phase 19: {time.perf_counter() - t_phase:.1f} s")

    # 20. run.predict from video files at full width.
    t_phase = time.perf_counter()
    video, video_held = run_video_predict(_build.KERNELS, root, root, smi)
    log(f"phase 20: {time.perf_counter() - t_phase:.1f} s")

    # 21. Video files, the card against the CPU: host_resize, centroid-only,
    # a head swap.
    t_phase = time.perf_counter()
    check_video_against_cpu(narrow_dirs, train_second_centroid_dir(root, narrow_dirs["centroid"]),
                            root)
    log(f"phase 21: {time.perf_counter() - t_phase:.1f} s")

    # 22. Training from a video file with the post-training evaluation, and
    # the trainer options (resume, transfer, save_top_k, negative frames,
    # user centroids, AMSGrad).
    t_phase = time.perf_counter()
    with timing_calls(slp_file_stages(), {}) as slp_split:
        file_runs, file_held = run_file_training(_build.KERNELS, root, root / "centroid")
    phase22_s = time.perf_counter() - t_phase
    log(f"phase 22: {phase22_s:.1f} s")
    log("file_training_slp_split " + json.dumps({"phase_s": phase22_s, **slp_split}))

    # 23. The command line at full width: train from .slp files, predict and
    # track to .slp and analysis files, track-only, eval, info, system.
    t_phase = time.perf_counter()
    cli_runs, cli_held, slp_io = run_cli(_build.KERNELS, root, smi)
    phase23_s = time.perf_counter() - t_phase
    log(f"phase 23: {phase23_s:.1f} s")

    # 24. Tiled predict: a centroid model in local mode and a single-instance
    # model in global mode on 2048x2048 frames, tiles of 512.
    t_phase = time.perf_counter()
    tiled_runs, tiled_held = run_tiled_predict(_build.KERNELS, smi)
    phase24_s = time.perf_counter() - t_phase
    log(f"phase 24: {phase24_s:.1f} s")

    # 25. Predict from ground-truth centroids: phase 11's centered-instance
    # dir alone on a .slp, through run.predict and the command line.
    t_phase = time.perf_counter()
    gt_runs, gt_held = run_gt_predict(_build.KERNELS, root, narrow_labels, narrow_dirs, smi)
    phase25_s = time.perf_counter() - t_phase
    log(f"phase 25: {phase25_s:.1f} s")

    # 26. Tiled training (bottom-up, the halo, full_frame_pass) and the disk cache.
    t_phase = time.perf_counter()
    tiled_train_runs, tiled_train_held = run_tiled_training(_build.KERNELS, smi)
    phase26_s = time.perf_counter() - t_phase
    log(f"phase 26: {phase26_s:.1f} s")

    # 27-30. The other backbones and SLEAP v1 dirs from model dirs at full
    # width (ConvNeXt top-down, SwinT bottom-up, the pretrained built-ins,
    # a v1 top-down pair), then their narrow dirs on the card against the CPU.
    t_phase = time.perf_counter()
    backbone_runs, backbone_held = run_backbone_predict(_build.KERNELS, smi)
    backbone_vs_cpu = check_backbone_dirs_against_cpu(smi)
    phase27_s = time.perf_counter() - t_phase
    log(f"phases 27-30: {phase27_s:.1f} s")

    # 31. Training with ConvNeXt, SwinT and a frozen pretrained ResNet-50 at
    # published widths, then run.predict from their dirs.
    t_phase = time.perf_counter()
    bb_train_runs, bb_train_held = run_backbone_training(_build.KERNELS, smi)
    phase31_s = time.perf_counter() - t_phase
    log(f"phase 31: {phase31_s:.1f} s")

    # 32. Narrow trainings of the other backbones on the card against the CPU.
    t_phase = time.perf_counter()
    bb_train_vs_cpu = check_backbone_training_against_cpu(smi)
    phase32_s = time.perf_counter() - t_phase
    log(f"phase 32: {phase32_s:.1f} s")

    # 33. DDP: 2 gloo ranks on the one card, 1 NCCL rank, against one process.
    t_phase = time.perf_counter()
    ddp_runs, ddp_held, ddp = check_ddp(_build.KERNELS, smi)
    phase33_s = time.perf_counter() - t_phase
    log(f"phase 33: {phase33_s:.1f} s")

    # 34-35. Segmentation predict from full-width dirs: bottom-up (k = 3;
    # k = 5 with the merge), semantic, top-down.
    t_phase = time.perf_counter()
    seg_runs, seg_held, seg_dir_paths, seg_tmp = run_segmentation_predict(_build.KERNELS, smi)
    phase34_s = time.perf_counter() - t_phase
    log(f"phases 34-35: {phase34_s:.1f} s")

    # 36. Training the three segmentation types, then predict, save, load,
    # evaluate and track from their dirs.
    t_phase = time.perf_counter()
    seg_train_runs = run_segmentation_training(_build.KERNELS, smi, seg_dir_paths)
    phase36_s = time.perf_counter() - t_phase
    log(f"phase 36: {phase36_s:.1f} s")

    # 37. Narrow segmentation layers, the card against the CPU.
    t_phase = time.perf_counter()
    check_segmentation_against_cpu(smi)
    phase37_s = time.perf_counter() - t_phase
    log(f"phase 37: {phase37_s:.1f} s")

    # 38. The centroid and bottom-up trainings with the monitors: ZMQ events
    # and commands, viz, the local wandb run, a torch.profiler trace.
    t_phase = time.perf_counter()
    monitored = run_monitored_training(_build.KERNELS, smi)
    phase38_s = time.perf_counter() - t_phase
    log(f"phase 38: {phase38_s:.1f} s")

    # 39. run.predict of phase 13's top-down dirs with profile_dir.
    t_phase = time.perf_counter()
    profiled = run_profiled_predict(_build.KERNELS, [root / "centroid", root / "centered_instance"],
                                    smi)
    phase39_s = time.perf_counter() - t_phase
    log(f"phase 39: {phase39_s:.1f} s")

    # 40-41. Export of every type trained or built above, predict from the
    # export dirs; export, predict and track on the command line.
    t_phase = time.perf_counter()
    export_dirs = {mt: root / mt for mt in ("centroid", "centered_instance", "bottomup",
                                            "multi_class_bottomup", "multi_class_topdown")}
    export_dirs.update({mt: seg_dir_paths[mt] for mt in (
        "semantic_segmentation", "bottomup_segmentation", "centered_instance_segmentation")})
    export_runs, export_held, export_rows = run_export(_build.KERNELS, export_dirs, smi)
    phase40_s = time.perf_counter() - t_phase
    log(f"phases 40-41: {phase40_s:.1f} s")

    # 42. Data-parallel predict from the dirs above: one replica a card, and
    # two replicas on one card, against the plain predictor.
    t_phase = time.perf_counter()
    dp_runs, dp_held, dp_rows = run_data_parallel_predict(_build.KERNELS, root, seg_dir_paths,
                                                          smi)
    phase42_s = time.perf_counter() - t_phase
    log(f"phase 42: {phase42_s:.1f} s")
    seg_tmp.cleanup()

    # 43. The config tooling: config-generate, config --auto, config, then
    # train() from get_config keyword arguments and predict from its dirs.
    t_phase = time.perf_counter()
    cfg_runs, cfg_held, cfg_rows = run_config_tooling(_build.KERNELS, smi)
    phase43_s = time.perf_counter() - t_phase
    log(f"phase 43: {phase43_s:.1f} s")

    # 44. The legacy TopDownPredictor on phase 7 + 11's dirs.
    t_phase = time.perf_counter()
    shim_runs, shim_held = run_legacy_shim(_build.KERNELS, root, smi)
    phase44_s = time.perf_counter() - t_phase
    log(f"phase 44: {phase44_s:.1f} s")

    # 45. SAM prompted masks: a pose .slp from phase 7 + 11's dirs, then the
    # sam command from a random-init ViT-H snapshot (f32), bf16, and a
    # 4-layer witness card against CPU.
    t_phase = time.perf_counter()
    sam_runs, sam_held, sam_row = run_sam_review(_build.KERNELS, root, smi)
    phase45_s = time.perf_counter() - t_phase
    log(f"phase 45: {phase45_s:.1f} s")

    # 46. Remote inputs and the top-level API: predict from http:// and
    # file:// URLs of a clip and a .slp, load_models, PAFScorer.from_config.
    t_phase = time.perf_counter()
    remote_runs, remote_held, remote_row = run_remote_and_api(_build.KERNELS, root, smi)
    phase46_s = time.perf_counter() - t_phase
    log(f"phase 46: {phase46_s:.1f} s")
    runs_dir.cleanup()

    # 47. The subpackages' re-exports, then masks through the geometric
    # augmentation, card against CPU on the same drawn values.
    t_phase = time.perf_counter()
    mask_row = run_mask_augmentation(_build.KERNELS, smi)
    phase47_s = time.perf_counter() - t_phase
    log(f"phase 47: {phase47_s:.1f} s")

    # Phase 3's breakdown of the paf_scoring stage runs last: it opens a
    # torch.profiler window, which must not slow the timed phases above.
    paf_breakdown = paf_scoring_breakdown(bu_layer, smoke_frames()[:BATCH])

    runs = {"topdown": e2e, "bottomup": bu, "single_instance": si, "train": tr,
            "train_bottomup": tr_bu, "train_centered_instance": tr_ci,
            "model_dir_topdown": dir_td, "model_dir_bottomup": dir_bu,
            "tracked_topdown": tracked_td, "tracked_bottomup": tracked_bu,
            "train_multi_class_bottomup": tr_mbu, "train_multi_class_topdown": tr_mtd,
            "model_dir_multi_class_bottomup": dir_mbu, "model_dir_multi_class_topdown": dir_mtd,
            **{f"video_{path}": row for path, row in video.items()}, **file_runs, **cli_runs,
            **tiled_runs, **gt_runs, **tiled_train_runs, **backbone_runs, **bb_train_runs,
            **ddp_runs, **seg_runs, **seg_train_runs, **monitored, **profiled, **export_runs,
            **dp_runs, **cfg_runs, **shim_runs, **sam_runs, **remote_runs}
    summary = kernel_summary(fused_rows, nms_rows, nms_bu_rows, paf_rows, paf_breakdown, cm_rows,
                             runs, {"video_path": video_held, "file_train": file_held,
                                    "cli": cli_held, "tiled": tiled_held, "gt": gt_held,
                                    "tiled_train": tiled_train_held,
                                    "backbone": backbone_held,
                                    "backbone_train": bb_train_held, "ddp": ddp_held,
                                    "segmentation": seg_held, "export": export_held,
                                    "data_parallel": dp_held, "config_tooling": cfg_held,
                                    "legacy_shim": shim_held, "sam_review": sam_held,
                                    "remote_and_api": remote_held})
    summary["kernels"][0]["sass_tensor_ops"] = sass
    training = "; ".join(
        f"{name} {run['steps_per_sec']:.2f} steps/s, {run['samples_per_sec']:.2f} samples/s "
        f"(last 5-step epoch), {run['fixed_batch_steps_per_sec']:.2f} steps/s over 20 steps on "
        f"one batch" for name, run in (("centroid", tr), ("bottom-up", tr_bu),
                                       ("centered-instance", tr_ci),
                                       ("multi-class bottom-up", tr_mbu),
                                       ("multi-class centered-instance", tr_mtd)))
    log(f"e2e: top-down {e2e['fps']:.2f} frames/s over {e2e['n_frames']} frames "
        f"({e2e['instances']} instances); bottom-up {bu['fps']:.2f} frames/s "
        f"({bu['instances']} instances; {bu['paf_workers_2']['fps']:.2f} frames/s with 2 "
        f"grouping workers); single-instance {si['fps']:.2f} frames/s; from model dirs "
        f"(run.predict, bf16, peak_threshold {DIR_PEAK_THRESHOLD:g}, a 3-batch smoke figure): "
        f"top-down {dir_td['fps']:.2f} frames/s ({dir_td['instances']} instances), bottom-up "
        f"{dir_bu['fps']:.2f} frames/s ({dir_bu['instances']} instances), multi-class bottom-up "
        f"{dir_mbu['fps']:.2f} frames/s ({dir_mbu['instances']} instances), multi-class "
        f"top-down {dir_mtd['fps']:.2f} frames/s ({dir_mtd['instances']} instances); "
        f"from video files (frames/s from the file / from memory, decode ms a frame): "
        + "; ".join(f"{path} {row['fps_file']:.2f} / {row['fps_memory']:.2f}, "
                    f"{row['decode_ms_per_frame']:.3f}" for path, row in video.items())
        + f"; training: {training}; host PAF grouping of a batch of {BATCH}: native "
        f"{native_grouping['native_ms_median']:.3f} ms, scipy "
        f"{native_grouping['scipy_ms_median_same_call']:.3f} ms in this call (scipy before the "
        f"port: {SCIPY_GROUPING_MS[0]} ms); phase 22 {phase22_s:.1f} s; "
        f"phase 23 {phase23_s:.1f} s; tiled predict (2048x2048, tiles of {TILE}) "
        f"{tiled_runs['tiled_predict_local']['fps']:.2f} frames/s local, "
        f"{tiled_runs['tiled_predict_global']['fps']:.2f} global; ground-truth centroids "
        f"{gt_runs['gt_default']['fps']:.2f} frames/s; tiled bottom-up training "
        f"{tiled_train_runs['train_tiled_bottomup']['steps_per_sec']:.2f} steps/s; phase 24 "
        f"{phase24_s:.1f} s; phase 25 {phase25_s:.1f} s; phase 26 {phase26_s:.1f} s; "
        f"phases 27-30 {phase27_s:.1f} s; from the other backbones' and v1 dirs "
        f"(frames/s, bf16, batch {BATCH}): "
        + ", ".join(f"{k.removeprefix('backbone_')} {v['fps']:.2f}"
                    for k, v in backbone_runs.items())
        + f"; narrow card vs CPU worst keypoint "
        f"{max(r['keypoints_max_abs_err'] for r in backbone_vs_cpu.values()):.2e} px; "
        f"phase 31 {phase31_s:.1f} s, training (steps/s, batch {TRAIN_BATCH}, 1024^2, f32): "
        + ", ".join(f"{k.removeprefix('train_')} {v['steps_per_sec']:.2f}"
                    for k, v in bb_train_runs.items() if k.startswith("train_"))
        + f"; phase 32 {phase32_s:.1f} s, worst parameter card vs CPU f64 "
        f"{max(r['card']['param_max_abs_err'] for r in bb_train_vs_cpu.values()):.2e}; phase 33 "
        f"{phase33_s:.1f} s, steps/s one process {ddp['single']['steps_per_sec']:.2f}, "
        f"2 gloo ranks {ddp['gloo_2_ranks']['steps_per_sec']:.2f}, 1 NCCL rank "
        f"{ddp['nccl_1_rank']['steps_per_sec']:.2f}; phases 34-35 {phase34_s:.1f} s, "
        f"segmentation predict (frames/s, bf16, batch {BATCH}): "
        + ", ".join(f"{k.removeprefix('seg_')} {v['fps']:.2f}" for k, v in seg_runs.items())
        + f"; phase 36 {phase36_s:.1f} s, segmentation training (steps/s): "
        + ", ".join(f"{k.removeprefix('train_')} {v['steps_per_sec']:.2f}"
                    for k, v in seg_train_runs.items() if k.startswith("train_"))
        + f"; phase 37 {phase37_s:.1f} s; phase 38 {phase38_s:.1f} s, steps/s with the "
        f"monitors / without (epoch 0): "
        + ", ".join(f"{k.removeprefix('monitored_train_')} "
                    f"{v['steps_per_sec_monitored'][0]:.2f} / {v['steps_per_sec_plain'][0]:.2f}"
                    for k, v in monitored.items())
        + f"; phase 39 {phase39_s:.1f} s, top-down frames/s traced "
        f"{profiled['profiled_topdown']['fps_traced']:.2f} / plain "
        f"{profiled['profiled_topdown']['fps_plain']:.2f}; phases 40-41 {phase40_s:.1f} s, "
        f"{len(export_rows)} exports, from the export dir / the model dirs (frames/s, batch "
        f"{EXPORT_BATCH}): "
        + ", ".join(f"{r['name']} {r['precision']} {r['fps_export']:.2f} / "
                    f"{r['fps_model_dir']:.2f}" for r in export_rows if "fps_export" in r)
        + f"; phase 42 {phase42_s:.1f} s, data-parallel frames/s (plain / one replica a card / "
        f"two replicas on one card): "
        + ", ".join(f"{r['name']} {r['fps']['plain']:.2f} / {r['fps']['one_replica_a_card']:.2f}"
                    f" / {r['fps']['two_replicas_one_card']:.2f}" for r in dp_rows)
        + f"; phase 43 {phase43_s:.1f} s, centroid from get_config keywords (quality / "
        f"throughput): {cfg_rows['quality']['steps_per_sec']:.2f} / "
        f"{cfg_rows['throughput']['steps_per_sec']:.2f} steps/s, peak "
        f"{cfg_rows['quality']['peak_gib'] or 0:.2f} / {cfg_rows['throughput']['peak_gib'] or 0:.2f}"
        f" GiB against an estimate of {cfg_rows['quality']['estimate_total_gib']:.2f} / "
        f"{cfg_rows['throughput']['estimate_total_gib']:.2f} GiB, centered-instance stage "
        f"(crop {cfg_rows['quality']['instance_crop']} / {cfg_rows['throughput']['instance_crop']})"
        f" {cfg_rows['quality']['instance_steps_per_sec']:.2f} / "
        f"{cfg_rows['throughput']['instance_steps_per_sec']:.2f} steps/s, top-down predict "
        f"{cfg_rows['quality']['fps']:.2f} / {cfg_rows['throughput']['fps']:.2f} frames/s; "
        f"phase 44 {phase44_s:.1f} s; phase 45 {phase45_s:.1f} s, SAM ViT-H ms a frame "
        f"(encoder f32 / bf16, decode, host): {sam_row['f32']['encoder_ms']:.2f} / "
        f"{sam_row['bf16']['encoder_ms']:.2f}, {sam_row['f32']['decode_ms']:.2f}, "
        f"{sam_row['f32']['host_ms']:.2f}; sam command {sam_row['command_fps']:.3f} frames/s "
        f"({sam_row['masks_fps_f32']:.2f} frames/s masking), peak {sam_row['f32']['peak_gib'] or 0:.2f}"
        f" GiB f32 / {sam_row['bf16']['peak_gib'] or 0:.2f} GiB bf16; phase 46 "
        f"{phase46_s:.1f} s, top-down frames/s from http / file:// / the local path (clip; "
        f".slp): {remote_row['fps']['http_clip']:.2f} / {remote_row['fps']['file_clip']:.2f} / "
        f"{remote_row['fps']['local_clip']:.2f}; {remote_row['fps']['http_slp']:.2f} / "
        f"{remote_row['fps']['file_slp']:.2f} / {remote_row['fps']['local_slp']:.2f}, download "
        f"ms {remote_row['download_ms']['http_clip']:.2f} (clip) / "
        f"{remote_row['download_ms']['http_slp']:.2f} (.slp); phase 47 {phase47_s:.1f} s, "
        f"warp_image ms a call at {mask_row['shape']} (nearest uint8 / f32 masks, bilinear f32 "
        f"masks / image): {mask_row['ms']['order0_uint8']:.3f} / "
        f"{mask_row['ms']['order0_float32']:.3f}, {mask_row['ms']['order1_float32_masks']:.3f} / "
        f"{mask_row['ms']['order1_image']:.3f}, chain with masks "
        f"{mask_row['ms']['chain_with_uint8_masks']:.3f}; {smi}"
        + f"; total script {time.perf_counter() - t_start:.1f} s")
    log("slp_io " + json.dumps(slp_io))
    log(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
