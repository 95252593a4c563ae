"""Port parity: training with the ConvNeXt, SwinT and pretrained backbones
(ConvNeXtV2, ResNet, Swinv2, ViT) against the JAX trainer.

Each case builds the JAX trainer and the port's from one config (a centroid
model, the tiny archs of ``tests/test_torch_backbones.py`` and
``tests/test_torch_pretrained.py``, 64x64 frames, augmentation off); the
pretrained encoders load the synthetic HF snapshots of that module's
``snapshots`` fixture (``weights: true``), with ``freeze`` on for
ConvNeXtV2 and ViT.

- Initialisation: each package's own draws. The leaves Xavier redraws are
  the same set (every conv, transposed-conv and dense kernel, JAX's
  ``kernel`` leaves), within ``sqrt(6 / (fan_in + fan_out))`` and filling
  it; SwinT's relative position tables within flax's +-2 standard
  deviations; every constant leaf (LayerNorm, BatchNorm, layer scale, GRN,
  ``logit_scale``, biases) equal; the HF encoder equal leaf for leaf;
  ``total_params`` equal.
- Three steps from the JAX trainer's params on the same batches (the
  third padded): losses 1e-5 relative, step-0 gradients 1e-4 of each
  tensor's largest magnitude (the frozen encoder has none in the port),
  parameters 1e-5 absolute; with ``freeze`` the encoder, and always the
  BatchNorm statistics, bit-identical in both; the val loss 1e-5.
- The dir the port writes loads strictly through ``load_model``; every key
  of its ``state_dict`` maps to the JAX trainer's leaf of the same shape
  (``weights.flax_to_torch_state``, the reverse of
  ``tools/orbax_to_torch.py``'s key rules).

The pretrained cases run from ``tests/test_torch_train_backbones_pretrained.py``
(these tests, parametrised over its ``CASES``), so that the two halves run
on two workers; there a ResNet dir also resumes (its statistics restored)
and seeds a transfer init (the statistics kept, as the JAX trainer swaps
``params`` only).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleap_nn_tpu.config import TrainingJobConfig as JConfig
from sleap_nn_tpu.io import model as jio
from sleap_nn_tpu.models.model import Model as FlaxModel
from sleap_nn_tpu.training import model_trainer as jmt
from sleap_nn_tpu.training import ModelTrainer as JTrainer
from sleap_nn_tpu_torch.config import TrainingJobConfig as PConfig
from sleap_nn_tpu_torch.inference.loaders import load_model
from sleap_nn_tpu_torch.io import model as pio
from sleap_nn_tpu_torch.training import ModelTrainer
from sleap_nn_tpu_torch.training.model_trainer import (
    flax_random_leaves_init,
    frozen_encoder_parameters,
    xavier_init_params,
)
from sleap_nn_tpu_torch.weights import flax_to_torch_state, torch_key_paths
from tests.test_torch_pipeline import cfg_dict, make_labels
from tests.test_torch_training import _jax_grads
from tests.test_torch_pipeline import torch_threads  # noqa: F401 (autouse)

NARROW = {
    "convnext": {"convnext": {"arch": {"depths": [1, 1, 1, 1], "channels": [8, 16, 32, 64]},
                              "output_stride": 2, "max_stride": 32}},
    "swint": {"swint": {"arch": {"embed": 8, "depths": [1, 2, 1, 1],
                                 "num_heads": [2, 2, 2, 2]},
                        "window_size": 4, "output_stride": 2, "max_stride": 32}},
}
# family of the snapshot, freeze, head stride
PRETRAINED = {"convnextv2": ("convnextv2", True, 2), "resnet": ("resnet_bottleneck", False, 2),
              "swinv2": ("swinv2", False, 2), "vit": ("vit", True, 8)}
# The cases of this module's tests (``pytest_generate_tests``): the narrow
# backbones here, the pretrained ones in the ``_pretrained`` module.
CASES = list(NARROW)
KERNELS = ("conv_kernel", "trans_conv_kernel", "dense_kernel")
LR = 1e-4  # the learning rate of both configs (the default)


# The cases whose port side keeps oneDNN: torch's native grouped convolution
# (ConvNeXt's 7x7 depthwise) is about ten times slower on the CPU. Their
# three steps sit as far inside the tolerances with oneDNN as without.
ONEDNN_CASES = ("convnext", "convnextv2")


def pytest_generate_tests(metafunc):
    if "case" in metafunc.fixturenames and \
            metafunc.definition.get_closest_marker("parametrize") is None:
        metafunc.parametrize("case", metafunc.module.CASES)


@pytest.fixture(scope="module")
def snapshots():
    """The narrow cases load no HF snapshot (the ``_pretrained`` module
    takes ``tests/test_torch_pretrained.py``'s)."""
    return None


@pytest.fixture(autouse=True)
def _native_cpu_convs(request):
    """The port's side runs torch's native CPU convolutions (but in
    ``ONEDNN_CASES``): this torch's oneDNN backward of a strided 1x1 conv on
    channels-last tensors (the ResNet bottleneck's ``conv0``) crashes with
    more than one thread."""
    case = getattr(request.node, "callspec", None) and request.node.callspec.params.get("case")
    with torch.backends.mkldnn.flags(enabled=case in ONEDNN_CASES):
        yield


def config(case, snapshots, **trainer):
    d = cfg_dict(batch=4, **trainer)
    if case in NARROW:
        d["model_config"]["backbone_config"] = NARROW[case]
    else:
        family, freeze, stride = PRETRAINED[case]
        d["model_config"]["backbone_config"] = {"pretrained": {
            "model_name": str(snapshots[family][0]), "output_stride": 2, "freeze": freeze}}
        d["model_config"]["head_configs"]["centroid"]["confmaps"]["output_stride"] = stride
    return d


def _leaves(tree):
    """``{flax path: array}`` of a variables tree; a ``batch_stats`` leaf's
    path starts with its collection, as ``weights.torch_key_paths`` names it."""
    out = {}
    for path, v in jax.tree_util.tree_leaves_with_path(jax.device_get(tree)):
        names = tuple(str(getattr(k, "key", k)) for k in path)
        out[names[1:] if names[0] == "params" else names] = np.asarray(v)
    return out


def _is_encoder(path):
    return any(p in ("enc", "encoder") for p in path)


@pytest.fixture(scope="module")
def trained(snapshots, tmp_path_factory):  # noqa: F811
    """Per case, built on first use: the JAX trainer after setup and 3
    steps, and the port's, each with what the tests read."""
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = _train_both(case, snapshots, tmp_path_factory.mktemp(case))
        return cache[case]

    return get


def _train_both(case, snapshots, tmp):  # noqa: F811
    jt = JTrainer.get_model_trainer_from_config(JConfig.from_dict(config(case, snapshots)),
                                                [make_labels(jio)])
    with pytest.MonkeyPatch.context() as mp:
        # The JAX trainer's own init and Xavier draw, jitted: the same values
        # (the same keys), without flax's slow eager init at these sizes.
        init = FlaxModel.init
        mp.setattr(FlaxModel, "init",
                   lambda self, key, x: jax.jit(functools.partial(init, self))(key, x))
        mp.setattr(jmt, "xavier_init_params", jax.jit(jmt.xavier_init_params))
        jt.setup()
    pt = ModelTrainer.get_model_trainer_from_config(
        PConfig.from_dict(config(case, snapshots, save_ckpt=True, ckpt_dir=str(tmp),
                                 run_name=case)), [make_labels(pio)], device="cpu")
    pt.setup()
    out = {"jt": jt, "pt": pt, "port_init": {k: v.clone() for k, v in
                                             pt.model.state_dict().items()},
           "jax_init": _leaves(jt.params), "paths": torch_key_paths(pt.model)}
    pt.model.load_state_dict(flax_to_torch_state(jax.device_get(jt.params), pt.model),
                             strict=True)
    start = {k: v.clone() for k, v in pt.model.state_dict().items()}
    batches = list(jt.train_loader._gen())[:3]
    assert not batches[-1]["batch_mask"].all()
    params, opt_state = jt.params, jt.tx.init(jt.params)
    copy = lambda t: jax.tree_util.tree_map(lambda x: x.copy(), t)  # noqa: E731 (donated)
    losses = []
    for step, batch in enumerate(batches):
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        if step == 0:
            out["want_grads"] = flax_to_torch_state(jax.device_get(_jax_grads(jt, jbatch)),
                                                    pt.model)
        params, opt_state, want_loss, _ = jt._train_step(copy(params), copy(opt_state), jbatch,
                                                         jax.random.PRNGKey(step))
        got_loss, _ = pt.train_step(batch)
        losses.append((got_loss.item(), float(want_loss)))
        if step == 0:
            out["grads"] = {n: None if p.grad is None else p.grad.clone()
                            for n, p in pt.model.named_parameters()}
    vbatch = next(iter(jt.val_loader))
    want_val = float(jt._val_step(params, {k: jnp.asarray(v) for k, v in vbatch.items()})[0])
    out.update(losses=losses, val=(pt.val_step(vbatch)[0].item(), want_val), start=start,
               jax_start=jax.device_get(jt.params), jax_end=jax.device_get(params))
    pt.save_checkpoint("best.ckpt")
    return out


def test_init_draws_what_the_jax_trainer_draws(trained, case):
    got = trained(case)
    pt, port, jax_init, paths = got["pt"], got["port_init"], got["jax_init"], got["paths"]
    weights = case in PRETRAINED
    assert pt.config.model_config.total_params == got["jt"].config.model_config.total_params \
        == sum(v.size for v in jax_init.values())
    redrawn = {k for k, (_, kind) in paths.items() if kind in KERNELS}
    assert redrawn == {k for k, (path, _) in paths.items()
                       if path[-1] == "kernel" and jax_init[path].ndim >= 2}
    jstate = flax_to_torch_state(got["jax_start"], pt.model)
    n_random = 0
    for key, (path, kind) in paths.items():
        mine, theirs = port[key], jax_init[path]
        if weights and _is_encoder(path):  # both from the snapshot
            assert torch.equal(mine, jstate[key]), key
        elif key in redrawn:
            limit = math.sqrt(6.0 / (np.prod(theirs.shape[:-1]) + theirs.shape[-1]))
            assert mine.abs().max().item() <= limit and np.abs(theirs).max() <= limit, key
            if mine.numel() >= 500:  # the draws fill [-limit, limit] uniformly
                assert mine.abs().max().item() > 0.9 * limit, key
                assert abs(mine.std().item() - limit / math.sqrt(3)) < 0.15 * limit, key
        elif path[-1] == "rel_pos_bias":  # flax's truncated_normal(0.02): |x| <= 0.04
            n_random += 1
            assert mine.abs().max().item() <= 0.04 and np.abs(theirs).max() <= 0.04, key
            assert 0.01 < mine.std().item() < 0.025, key
        elif path[-1] in ("cls_token", "position_embeddings", "register_tokens"):
            n_random += 1
        else:  # a constant of flax's initialisers (zeros, ones, layer scales, log 10)
            assert torch.equal(mine, jstate[key]), key
    assert bool(n_random) == (case == "swint")  # ViT's tokens come from its snapshot


def test_random_leaves_follow_flax_and_the_generator():
    """SwinT's tables and ViT's tokens come from the trainer's generator
    (not torch's global RNG) with flax's spreads."""
    from sleap_nn_tpu_torch.models import swint, transformer_encoders

    enc = transformer_encoders.ViTEncoder(1, hidden_size=64, num_layers=1, num_heads=2,
                                          intermediate_size=64, patch_size=8, image_size=256)
    attn = swint.WindowAttention(16, 8, 16)
    holder = torch.nn.ModuleDict({"vit": enc, "attn": attn})
    draws = []
    for _ in range(2):
        torch.manual_seed(len(draws))  # the global RNG differs between the draws
        flax_random_leaves_init(holder, torch.Generator().manual_seed(3))
        draws.append({k: v.clone() for k, v in holder.state_dict().items()})
    for k in ("vit.cls_token", "vit.position_embeddings", "attn.rel_pos_bias"):
        assert torch.equal(draws[0][k], draws[1][k]), k
    pos = draws[0]["vit.position_embeddings"]
    assert abs(pos.std().item() - 1.0) < 0.02 and abs(pos.mean().item()) < 0.02
    table = draws[0]["attn.rel_pos_bias"]
    assert table.abs().max().item() <= 0.04 and table.abs().max().item() > 0.039
    # A normal cut at +-2 standard deviations keeps 0.87962566 of its spread.
    assert abs(table.std().item() - 0.02 * 0.87962566) < 0.0005
    fresh = swint.WindowAttention(16, 8, 16).rel_pos_bias  # the module's own draw: cut too
    assert fresh.abs().max().item() <= 0.04
    xavier_init_params(holder, torch.Generator().manual_seed(0))
    assert torch.equal(holder.state_dict()["attn.rel_pos_bias"], table)  # not a kernel


def test_three_steps_match_the_jax_trainer(trained, case):
    got = trained(case)
    pt = got["pt"]
    for mine, theirs in got["losses"]:
        np.testing.assert_allclose(mine, theirs, rtol=1e-5)
    frozen = set(pt.frozen_parameters)
    assert bool(frozen) == (case in PRETRAINED and PRETRAINED[case][1])
    for name, g in got["grads"].items():
        if name in frozen:
            assert g is None, name
            continue
        scale = got["want_grads"][name].abs().max().item()
        assert (g - got["want_grads"][name]).abs().max().item() <= 1e-4 * scale, name
    want = flax_to_torch_state(got["jax_end"], pt.model)
    n_noise = 0
    for name, p in pt.model.state_dict().items():
        noise = _zero_gradient_rows(name, p)
        if noise is not None:  # rounding noise that Adam scales to steps of up to lr
            n_noise += 1
            scale = got["want_grads"][name].abs().max().item()
            for g in (got["grads"][name], got["want_grads"][name]):
                assert g[noise].abs().max().item() <= 1e-6 * scale, name
            for end in (p, want[name]):
                moved = (end[noise] - got["start"][name][noise]).abs().max().item()
                assert moved <= 3 * LR * 1.01, (name, moved)
            keep = torch.ones(p.shape[0], dtype=torch.bool)
            keep[noise] = False
            p, want[name] = p[keep], want[name][keep]
        torch.testing.assert_close(p, want[name], rtol=0, atol=1e-5, msg=name)
    assert bool(n_noise) == (case == "swint")
    np.testing.assert_allclose(*got["val"], rtol=1e-5)


def _zero_gradient_rows(name, p):
    """The rows of a parameter whose exact gradient is 0: the key third of
    SwinT's fused ``qkv`` bias (a shift shared by every key leaves each
    query's softmax as it is). Both trainers' gradients there are rounding
    noise (about 1e-9), which Adam's normalisation turns into steps of up
    to the learning rate, of either sign; those rows are held to that
    bound instead of to each other."""
    if name.endswith("attn.qkv.bias"):
        c = p.shape[0] // 3
        return slice(c, 2 * c)
    return None


def test_the_written_dir_loads_and_maps_to_the_jax_tree(trained, case):
    got = trained(case)
    pt = got["pt"]
    loaded = load_model(pt.ckpt_dir)
    mine = pt.model.state_dict()
    assert set(loaded.model.state_dict()) == set(mine)
    for k, v in loaded.model.state_dict().items():
        assert torch.equal(v, mine[k].cpu()), k
    # Every key is a leaf of the JAX trainer's tree, of the same shape.
    want = flax_to_torch_state(got["jax_end"], loaded.model)
    assert {k: tuple(v.shape) for k, v in want.items()} == \
        {k: tuple(v.shape) for k, v in mine.items()}
