"""Where the time of the SAM image encoder goes on the card.

    python3 tools/sam_encoder_profile.py [LAYERS]

Builds the port's SAM graph (``sleap_nn_tpu_torch/models/sam_jax.py``) at
the published ViT-H widths of ``chip_smoke.SAM_CONFIG``, its depth cut to
``LAYERS`` (default 32, the whole model; a cut keeps the last layer
global), with random weights from ``chip_smoke.sam_state``, and encodes
one 1024x1024 frame in float32 (TF32 off) and in bfloat16:

- ``eager_ms``: the mean wall ms of 5 encodes after 2 warm-ups, each
  ended by a synchronize (what ``JaxSamBackend`` spends a frame);
- ``graph_ms``: the same encode captured once in a CUDA graph and
  replayed (the device's work without the host's launches);
- one eager encode under ``torch.profiler``: its wall ms, the ms of device
  kernels in it and the device's idle share of that window, the kernel
  count, and the 8 kernel names that take the most device time.

Prints one ``sam_encoder_profile`` JSON line per dtype, with the card's
name and power limit, and the encoder's GFLOP a frame
(``chip_smoke.sam_encoder_flops``).
"""

if __name__ == "__main__":
    import json
    import subprocess
    import sys
    import tempfile
    import time
    from collections import defaultdict
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from sleap_nn_tpu_torch.models.sam_jax import SamArch, SamModel, sam_image_encoder

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: torch.cuda.is_available() is False")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    layers = int(sys.argv[1]) if len(sys.argv) > 1 else None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    arch = SamArch.from_hf_config(cs.sam_config(layers))
    state = cs.sam_state(arch, seed=45)
    frame = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, arch.image_size, arch.image_size, 3)).astype(np.float32)).cuda()
    for dtype in (torch.float32, torch.bfloat16):
        model = SamModel.from_state_dict(arch, state).to("cuda", dtype)
        x = frame.to(dtype)

        def encode():
            with torch.inference_mode():
                return sam_image_encoder(model, arch, x)

        for _ in range(2):
            encode()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            encode()
            torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) * 1e3 / 5

        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            encode()  # warm-up on the capture stream
        torch.cuda.current_stream().wait_stream(stream)
        with torch.cuda.graph(graph):
            encode()
        graph.replay()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            graph.replay()
        torch.cuda.synchronize()
        graph_ms = (time.perf_counter() - t0) * 1e3 / 5
        del graph

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            encode()
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3
        with tempfile.TemporaryDirectory() as tmp:
            prof.export_chrome_trace(f"{tmp}/trace.json")
            events = json.loads(Path(f"{tmp}/trace.json").read_text())["traceEvents"]
        kernels = [ev for ev in events if ev.get("cat") == "kernel"]
        by_name = defaultdict(float)
        for ev in kernels:
            by_name[ev["name"][:90]] += ev["dur"] / 1e3
        busy_ms = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        print("sam_encoder_profile " + json.dumps({
            "dtype": str(dtype).split(".")[-1], "layers": arch.num_hidden_layers,
            "global": list(arch.global_attn_indexes),
            "gflop": cs.sam_encoder_flops(arch) / 1e9, "eager_ms": eager_ms,
            "graph_ms": graph_ms, "traced_ms": traced_ms, "kernel_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / traced_ms, "kernels": len(kernels),
            "top_kernels_ms": top, "smi": smi}), flush=True)
        del model
        torch.cuda.empty_cache()
