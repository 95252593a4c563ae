"""Frames/s of data-parallel ``Predictor.predict`` from one checkout, on the cards.

    python3 tools/data_parallel_fps.py TREE [RUN,...]

``TREE`` is a checkout's root (``.`` for this one): its ``chip_smoke.py``
writes random-init medium_rf model dirs (weights from a seed) for the
top-down pair, bottom-up and single-instance, and its port predicts 160
synthetic 1024x1024 frames (bf16, batch 8) with each, three runs after a
warm-up, as the plain predictor on ``cuda:0`` (``plain``), with
``data_parallel=True``, one replica on each card the process sees
(``one_replica_a_card``), and with two replicas on ``cuda:0``
(``two_replicas_cuda0``); ``RUN`` picks some of these. One ``dp`` JSON
line of frames/s and of the median host ms the predict loop's thread
spends in ``_Replicas.enqueue`` a batch (null where a tree's path does
not go through it), with the card count and the cards' name and power
limit. To compare two commits on one machine, unpack the other with ``git
archive`` into ``_work/`` (gitignored) and run other, this, this, other in
one call.
"""

if __name__ == "__main__":
    import json
    import subprocess
    import sys
    import tempfile
    import time
    from pathlib import Path

    root = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import chip_smoke as cs
    from sleap_nn_tpu_torch.inference import predictor as ppred
    from sleap_nn_tpu_torch.inference.predictor import Predictor
    from sleap_nn_tpu_torch.inference.providers import VideoProvider
    from sleap_nn_tpu_torch.ops import _build, fused_conv, kernels  # noqa: F401

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    enqueue_ms = []
    replicas = getattr(ppred, "_Replicas", None)
    if replicas is not None:
        real_enqueue = replicas.enqueue

        def timed_enqueue(self, *args, **kw):
            t0 = time.perf_counter()
            try:
                return real_enqueue(self, *args, **kw)
            finally:
                enqueue_ms.append((time.perf_counter() - t0) * 1e3)

        replicas.enqueue = timed_enqueue
    _build.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    frames = np.concatenate([cs.smoke_frames()] * 8)  # 160 frames
    tmp = Path(tempfile.mkdtemp())
    for i, (mt, crop) in enumerate((("centroid", None), ("centered_instance", cs.CROP),
                                    ("bottomup", None))):
        cfg = cs.dir_config(cs.MEDIUM_RF, mt, cs.N_NODES, crop=crop)
        model = cs.random_model(cfg, seed=420 + i)
        cs.random_init(model)
        cs.write_port_dir(tmp / mt, cfg, model)
    cs.single_instance_dir(tmp)
    kw = dict(batch_size=cs.BATCH, use_bf16=True, device="cuda",
              peak_threshold=cs.DIR_PEAK_THRESHOLD, max_instances=cs.MAX_INST)
    out = {"tree": root.name, "cards": torch.cuda.device_count(), "smi": smi,
           "frames": len(frames)}
    for name, sources, knobs, _, _ in cs.DP_RUNS[:3]:
        paths = [tmp / s for s in sources]
        knobs = {k: v for k, v in knobs.items() if k != "paf_workers"}
        out[name] = {}
        for label, dp in (("plain", False), ("one_replica_a_card", True),
                          ("two_replicas_cuda0", ["cuda:0", "cuda:0"])):
            if len(sys.argv) > 2 and label not in sys.argv[2].split(","):
                continue
            p = Predictor.from_model_paths(paths, data_parallel=dp, **kw, **knobs)
            p.predict(provider=VideoProvider(cs.ArrayVideo(frames[:16]), batch_size=cs.BATCH),
                      make_labels=False)
            fps = []
            enqueue_ms.clear()
            for _ in range(3):
                p.predict(provider=VideoProvider(cs.ArrayVideo(frames), batch_size=cs.BATCH),
                          make_labels=False)
                fps.append(p.last_stats["fps"])
            out[name][label] = fps
            out[name][label + "_enqueue_ms"] = (float(np.median(enqueue_ms)) if enqueue_ms
                                                else None)
    print("dp " + json.dumps(out), flush=True)
