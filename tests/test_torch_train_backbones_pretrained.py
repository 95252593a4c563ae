"""Port parity: training with the pretrained backbones (ConvNeXtV2, ResNet,
Swinv2, ViT) against the JAX trainer.

The pretrained cases of ``tests/test_torch_train_backbones.py``: its tests
and fixtures, parametrised over this module's ``CASES``, in a file of
their own so that the two halves run on two workers. The encoders load the
synthetic HF snapshots of ``tests/test_torch_pretrained.py``'s
``snapshots`` fixture, with ``freeze`` on for ConvNeXtV2 and ViT. With
``freeze`` the encoder, and always the BatchNorm statistics, stay
bit-identical in both trainers; a ResNet dir also resumes (its statistics
restored) and seeds a transfer init (the statistics kept, as the JAX
trainer swaps ``params`` only).
"""

import pytest
import torch

from sleap_nn_tpu_torch.config import TrainingJobConfig as PConfig
from sleap_nn_tpu_torch.io import model as pio
from sleap_nn_tpu_torch.training import ModelTrainer
from sleap_nn_tpu_torch.training.model_trainer import frozen_encoder_parameters
from sleap_nn_tpu_torch.weights import flax_to_torch_state
from tests.test_torch_pipeline import make_labels
from tests.test_torch_pretrained import snapshots  # noqa: F401 (a fixture)
from tests.test_torch_train_backbones import (  # noqa: F401 (the fixtures and the tests)
    PRETRAINED,
    _native_cpu_convs,
    config,
    pytest_generate_tests,
    test_init_draws_what_the_jax_trainer_draws,
    test_the_written_dir_loads_and_maps_to_the_jax_tree,
    test_three_steps_match_the_jax_trainer,
    trained,
)
from tests.test_torch_pipeline import torch_threads  # noqa: F401 (autouse)

CASES = list(PRETRAINED)


@pytest.mark.parametrize("case", ["convnextv2", "resnet", "vit"])
def test_frozen_encoder_and_statistics_stay_bit_identical(trained, case):
    got = trained(case)
    pt, start = got["pt"], got["start"]
    end_port = pt.model.state_dict()
    end_jax = flax_to_torch_state(got["jax_end"], pt.model)
    begin_jax = flax_to_torch_state(got["jax_start"], pt.model)
    frozen = set(frozen_encoder_parameters(pt.model)) if PRETRAINED[case][1] else set()
    stats = {k for k, (path, _) in got["paths"].items() if path[0] == "batch_stats"}
    assert bool(stats) == (case == "resnet")
    moved = 0
    for key in end_port:
        if key in frozen or key in stats:
            assert torch.equal(end_port[key], start[key]), key
            assert torch.equal(end_jax[key], begin_jax[key]), key
        else:
            moved += not torch.equal(end_port[key], start[key])
    assert moved > 0
    assert all(not p.requires_grad for n, p in pt.model.named_parameters() if n in frozen)


def test_resnet_dir_resumes_and_seeds_a_transfer(trained, snapshots, tmp_path):  # noqa: F811
    got = trained("resnet")
    src = got["pt"]
    stats = [k for k, (path, _) in got["paths"].items() if path[0] == "batch_stats"]
    ckpt = src.ckpt_dir / "best.ckpt"
    # Marked statistics in the checkpoint show which values each path keeps.
    state = torch.load(ckpt, weights_only=True)
    for k in stats:
        state["state_dict"][f"model.{k}"] = state["state_dict"][f"model.{k}"] + 0.5
    torch.save(state, ckpt)

    resumed = ModelTrainer.get_model_trainer_from_config(
        PConfig.from_dict(config("resnet", snapshots, resume_ckpt_path=str(ckpt))),
        [make_labels(pio)], device="cpu")
    resumed.setup()
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, state["state_dict"][f"model.{k}"]), k
    d = config("resnet", snapshots)
    d["model_config"]["pretrained_backbone_weights"] = str(ckpt)
    moved = ModelTrainer.get_model_trainer_from_config(PConfig.from_dict(d),
                                                       [make_labels(pio)], device="cpu")
    moved.setup()
    own = got["port_init"]
    for k, v in moved.model.state_dict().items():
        if k in stats:  # JAX swaps the params collection only
            assert torch.equal(v, own[k]), k
        elif k.startswith("backbone."):
            assert torch.equal(v, state["state_dict"][f"model.{k}"]), k
    moved.train_step(next(iter(moved.train_loader)))  # trains from there
