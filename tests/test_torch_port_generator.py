"""The port's Generator and weight bridge against the JAX Generator.

A JAX ``Generator(ngf=4)`` is initialised from a key, carried across by
``vfd_gan_tpu_torch.utils.weights`` and compared in eval mode on the same
numpy clips.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfd_gan_tpu.models.mygan import Generator as JaxGenerator
from vfd_gan_tpu.utils import torch_export
from vfd_gan_tpu_torch.models.layers import GenConvBlock
from vfd_gan_tpu_torch.models.mygan import Generator
from vfd_gan_tpu_torch.ops.image import to_channel_first, to_channel_last
from vfd_gan_tpu_torch.utils.checkpoint import load_state_dict
from vfd_gan_tpu_torch.utils.weights import generator_state_dict
from test_torch_port_threads import one_torch_thread  # noqa: F401

NGF = 4
SHAPE = (2, 16, 16, 16, 3)
# float32 through ~25 convs and 10 BNs, summed in a different order by XLA
# and by PyTorch's CPU convolutions: measured ~1e-7 on the sigmoid mask.
MASK_ATOL = 2e-5


@functools.lru_cache(maxsize=None)
def _jax_generator():
    model = JaxGenerator(ngf=NGF)
    x = jnp.zeros(SHAPE, jnp.float32)
    variables = jax.jit(model.init, static_argnums=2)(jax.random.key(0), x,
                                                      False)
    apply = jax.jit(lambda v, x: model.apply(v, x, False))
    return jax.tree_util.tree_map(np.asarray, variables), apply


def _with_random_stats(variables, seed):
    """Replace every BN running mean/var with random values (var > 0), so the
    eval path's use of the running statistics is really exercised."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "mean":
            return rng.uniform(-0.5, 0.5, leaf.shape).astype(np.float32)
        return rng.uniform(0.2, 2.0, leaf.shape).astype(np.float32)

    stats = jax.tree_util.tree_map_with_path(draw, variables["batch_stats"])
    return {"params": variables["params"], "batch_stats": stats}


def _port_generator(variables):
    model = Generator(ngf=NGF)
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in generator_state_dict(variables).items()}
    model.load_state_dict(sd, strict=True)
    return model.eval()


def test_weight_bridge_equals_torch_export():
    variables, _ = _jax_generator()
    variables = _with_random_stats(variables, 1)
    got = generator_state_dict(variables)
    want = torch_export.mygan_generator_to_torch(variables)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def test_exported_pth_loads_strict(tmp_path):
    variables, _ = _jax_generator()
    path = str(tmp_path / "run_netG.pth")
    torch_export.save_pth(path, variables, "mygan_generator", epoch=3)
    model = Generator(ngf=NGF)
    model.load_state_dict(load_state_dict(path), strict=True)
    for k, v in load_state_dict(path).items():
        assert torch.equal(model.state_dict()[k], v), k


def test_module_prefix_is_stripped(tmp_path):
    model = Generator(ngf=NGF, generator=torch.Generator().manual_seed(3))
    path = str(tmp_path / "dp_netG.pth")
    torch.save({"state_dict": {f"module.{k}": v
                               for k, v in model.state_dict().items()}}, path)
    loaded = Generator(ngf=NGF)
    loaded.load_state_dict(load_state_dict(path), strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


@pytest.mark.parametrize("stats", ["init", "random"])
def test_generator_eval_forward_matches_jax(stats):
    variables, apply = _jax_generator()
    if stats == "random":
        variables = _with_random_stats(variables, 2)
    x = np.random.default_rng(3).uniform(-1, 1, SHAPE).astype(np.float32)
    want = np.asarray(apply(variables, jnp.asarray(x)))
    model = _port_generator(variables)
    with torch.inference_mode():
        got = to_channel_last(model(to_channel_first(torch.from_numpy(x))))
    assert got.shape == want.shape == SHAPE[:4] + (1,)
    np.testing.assert_allclose(got.numpy(), want, atol=MASK_ATOL, rtol=0)


def test_gen_conv_block_matches_jax_in_eval():
    """One GenConvBlock (STConv -> BN -> LeakyReLU 0.2) with random running
    statistics, at a width where the mid channels differ from cin/cout."""
    from vfd_gan_tpu.models.layers import GenConvBlock as JaxBlock

    x = np.random.default_rng(4).uniform(-1, 1, (2, 4, 6, 6, 5)).astype(
        np.float32)
    jblock = JaxBlock(7)
    v = jblock.init(jax.random.key(1), jnp.asarray(x), False)
    v = _with_random_stats(jax.tree_util.tree_map(np.asarray, v), 5)
    want = np.asarray(jblock.apply(v, jnp.asarray(x), False))

    out: dict = {}
    torch_export._gen_block(out, "blk", v["params"], v["batch_stats"])
    block = GenConvBlock(5, 7)
    block.load_state_dict({k[4:]: torch.from_numpy(np.array(a))
                           for k, a in out.items()}, strict=True)
    with torch.inference_mode():
        got = to_channel_last(block.eval()(to_channel_first(
            torch.from_numpy(x))))
    # float32 conv + BN + activation: a few ulps of O(1) values
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_seeded_init_is_reproducible_and_follows_the_reference():
    a = Generator(ngf=8, generator=torch.Generator().manual_seed(7))
    b = Generator(ngf=8, generator=torch.Generator().manual_seed(7))
    c = Generator(ngf=8, generator=torch.Generator().manual_seed(8))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["conv_last.weight"], sc["conv_last.weight"])

    w = sa["uconv1.conv.spatial_conv.weight"]                 # N(0, 0.02)
    assert abs(w.mean().item()) < 0.002 and abs(w.std().item() - 0.02) < 0.002
    bn = sa["dconv5.bn.weight"]                                # N(1, 0.02)
    assert abs(bn.mean().item() - 1.0) < 0.01 and bn.std().item() < 0.04
    assert torch.equal(sa["dconv5.bn.bias"], torch.zeros_like(bn))
    bias = sa["uconv1.conv.temporal_conv.bias"]             # U(+-1/sqrt(fan))
    mid = sa["uconv1.conv.temporal_conv.weight"].shape[1]
    assert bias.abs().max().item() <= 1.0 / (mid * 3) ** 0.5
    assert "conv_last.bias" not in sa
