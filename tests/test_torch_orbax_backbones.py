"""``tools/orbax_to_torch.py`` on JAX-trained dirs of the ConvNeXt, SwinT and
pretrained (ResNet, whose BatchNorm statistics live in the ``batch_stats``
collection) backbones.

The JAX package's trainer trains each tiny model one step on 64x64 frames
and saves its orbax ``best.ckpt``; the port refuses that dir by name, the
tool converts it, and the port loads the result strictly with every weight
equal to the orbax params converted by ``weights.flax_to_torch_state``.
"""

import json

import jax
import numpy as np
import pytest
import torch

from sleap_nn_tpu.config import TrainingJobConfig as JConfig
from sleap_nn_tpu.io import model as jio
from sleap_nn_tpu.training import ModelTrainer as JTrainer
from sleap_nn_tpu_torch.inference.loaders import load_model
from sleap_nn_tpu_torch.training import ModelTrainer
from sleap_nn_tpu_torch.weights import flax_to_torch_state
from tests.test_torch_backbone_dirs import CONVNEXT, SWINT
from tests.test_torch_model_dir import _orbax_to_torch, config_dict, frames_and_labels
from tests.test_torch_pretrained import CONFIGS as PRETRAINED_CONFIGS
from tests.test_torch_pipeline import torch_threads  # noqa: F401 (autouse)


def _backbones(tmp_path):
    snap = tmp_path / "resnet_snapshot"
    snap.mkdir()
    (snap / "config.json").write_text(json.dumps(PRETRAINED_CONFIGS["resnet_basic"]))
    return {"convnext": CONVNEXT, "swint": SWINT,
            "pretrained": {"pretrained": {"model_name": str(snap), "output_stride": 2,
                                          "weights": False}}}


@pytest.mark.parametrize("backbone", ["convnext", "swint", "pretrained"])
def test_jax_trained_dir_of_each_backbone_converts(tmp_path, backbone):
    pytest.importorskip("orbax.checkpoint")
    _, labels = frames_and_labels(jio, 1, n=4)
    d = config_dict("single_instance", tmp_path)
    d["model_config"]["backbone_config"] = json.loads(json.dumps(
        _backbones(tmp_path)[backbone]))
    d["trainer_config"]["model_ckpt"] = {"save_last": False}
    jt = JTrainer.get_model_trainer_from_config(JConfig.from_dict(d), [labels])
    jt.train()
    run = jt.ckpt_dir
    assert (run / "best.ckpt").is_dir()
    with pytest.raises(ValueError, match="tools/orbax_to_torch.py"):
        load_model(run)
    converted = _orbax_to_torch().convert(run, tmp_path / "converted")
    loaded = load_model(converted)
    want = flax_to_torch_state(jax.device_get(jt.params), loaded.model)
    state = ModelTrainer.load_checkpoint_params(converted / "best.ckpt")
    assert set(state) == set(want) == set(loaded.model.state_dict())
    for k, v in want.items():
        torch.testing.assert_close(loaded.model.state_dict()[k], v, rtol=0, atol=0, msg=k)
    if backbone == "pretrained":
        assert any(k.endswith("running_var") for k in state)
        assert not np.allclose(state["backbone.encoder.stem_bn.running_var"].numpy(), 0)
