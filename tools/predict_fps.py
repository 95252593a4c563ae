"""Frames/s of the live ``Predictor.predict`` from one checkout, on the card.

    python3 tools/predict_fps.py TREE

``TREE`` is a checkout's root (``.`` for this one): its ``chip_smoke.py``
builds the medium_rf top-down, bottom-up and single-instance layers
(random weights from a seed, bf16, batch 8) and its port predicts 160
synthetic 1024x1024 frames with each, three runs after a warm-up. One
``ab`` JSON line of frames/s. To compare two commits on one card, unpack
the other with ``git archive`` into ``_work/`` (gitignored) and run
other, this, this, other in one call.
"""

if __name__ == "__main__":
    import json, sys, time
    from pathlib import Path
    root = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    import chip_smoke as cs
    from sleap_nn_tpu_torch.config.model_config import UNetMediumRFConfig
    from sleap_nn_tpu_torch.inference.predictor import Predictor
    from sleap_nn_tpu_torch.inference.providers import VideoProvider
    from sleap_nn_tpu_torch.ops import _build, fused_conv, kernels  # noqa: F401
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    frames = np.concatenate([cs.smoke_frames()] * 8)  # 160 frames
    cfg, centroid, instance = cs.build_models(UNetMediumRFConfig, cs.N_NODES, seed=0)
    td = cs.build_layer(cfg, centroid, instance, cs.DEVICE, True, cs.CROP, cs.MAX_INST)
    bu_cfg, bu_model = cs.build_bottomup_model(UNetMediumRFConfig, cs.N_NODES, seed=3,
                                               frames=cs.smoke_frames()[:2])
    bu = cs.build_bottomup_layer(bu_cfg, bu_model, cs.DEVICE, True, cs.MAX_INST)
    si = cs.build_single_instance_layer(UNetMediumRFConfig, cs.N_NODES, seed=6,
                                        device=cs.DEVICE, use_bf16=True)
    out = {"tree": str(root.name)}
    for name, layer in (("topdown", td), ("bottomup", bu), ("single_instance", si)):
        p = Predictor(layer, name, batch_size=cs.BATCH, device=cs.DEVICE)
        p.predict(provider=VideoProvider(cs.ArrayVideo(frames[:16]), batch_size=cs.BATCH),
                  make_labels=False)
        fps = []
        for _ in range(3):
            p.predict(provider=VideoProvider(cs.ArrayVideo(frames), batch_size=cs.BATCH),
                      make_labels=False)
            fps.append(p.last_stats["fps"])
        out[name] = fps
    print("ab " + json.dumps(out), flush=True)
