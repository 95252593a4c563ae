#!/usr/bin/env python3
"""Convert a JAX trainer's model directory into one the port loads.

    python3 tools/orbax_to_torch.py JAX_MODEL_DIR OUT_DIR

The JAX package's trainer saves ``best.ckpt`` (and ``last.ckpt``) as orbax
checkpoint directories. The port reads torch checkpoints only: orbax
imports JAX, which the port never does. This tool restores each orbax
checkpoint of ``JAX_MODEL_DIR``, maps its flax variables (the params and,
for a ResNet encoder, the BatchNorm ``batch_stats``) onto the port model
that the dir's ``training_config.yaml`` describes, of any backbone the
port builds (``sleap_nn_tpu_torch.weights.flax_to_torch_state``), and writes
``OUT_DIR`` with the dir's config and log files and a torch checkpoint of
the same name (the model's ``state_dict`` under ``model.``, as the port's
trainer saves it). It then loads ``OUT_DIR`` back through the port's
``load_model`` (strict) and checks every weight. It needs orbax, and so
JAX, on the machine that runs it.
"""

from __future__ import annotations

import argparse
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
COPIED = ("training_config.yaml", "initial_config.yaml", "training_log.csv")
CHECKPOINTS = ("best.ckpt", "last.ckpt")


def convert(jax_dir, out_dir) -> Path:
    """Write the port's form of the model dir ``jax_dir`` into ``out_dir``;
    returns ``out_dir``."""
    import orbax.checkpoint as ocp
    import torch

    from sleap_nn_tpu_torch.config import TrainingJobConfig
    from sleap_nn_tpu_torch.inference.loaders import build_model, load_model
    from sleap_nn_tpu_torch.weights import flax_to_torch_state

    jax_dir, out_dir = Path(jax_dir), Path(out_dir)
    if jax_dir.resolve() == out_dir.resolve():
        raise ValueError("OUT_DIR must differ from JAX_MODEL_DIR (its checkpoints are "
                         "orbax directories of the same names)")
    ckpts = [jax_dir / name for name in CHECKPOINTS if (jax_dir / name).is_dir()]
    if not ckpts:
        raise FileNotFoundError(f"no orbax best.ckpt or last.ckpt directory under {jax_dir}")
    config = TrainingJobConfig.load_yaml(jax_dir / "training_config.yaml")
    _, model = build_model(config, jax_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for name in COPIED:
        if (jax_dir / name).exists():
            shutil.copy2(jax_dir / name, out_dir / name)
    states = {}
    for ckpt in ckpts:
        params = ocp.PyTreeCheckpointer().restore(str(ckpt.absolute()))["params"]
        states[ckpt.name] = flax_to_torch_state(params, model)
        torch.save({"state_dict": {f"model.{k}": v for k, v in states[ckpt.name].items()}},
                   out_dir / ckpt.name)
    for name, state in states.items():
        loaded = load_model(out_dir / name).model.state_dict()
        if not all(torch.equal(loaded[k], v) for k, v in state.items()):
            raise AssertionError(f"{out_dir / name}: the port loads other weights")
    return out_dir


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("jax_model_dir", help="a JAX trainer's model dir (orbax checkpoints)")
    parser.add_argument("out_dir", help="where the port's form of the dir is written")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    out = convert(args.jax_model_dir, args.out_dir)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
