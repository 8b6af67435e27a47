"""``--int8_disc``: the port's int8 straight-through convs (``quant/
qdisc.py``) against the JAX package's and the float convs, and the
invariance of G's update, on the CPU.

* ``qspatial_conv`` (3x3, stride 1 and 2, symmetric padding) and
  ``qtemporal_conv`` (3 taps, padding 1): the forward within 5% of the
  float conv's largest magnitude (``tests/test_int8_disc.py``'s bound),
  and within 1e-6 relative of JAX's ``qspatial_conv`` / ``qtemporal_conv``
  (the same dynamic scales and int8 operands, int32 sums; only the
  float32 dequantisation rounds); the straight-through VJP equals the
  float conv's VJP **exactly** at the same cotangent.
* ``--int8_disc`` in a MyGAN run makes every discriminator conv int8
  (``QConv3d``) and no generator conv; two steps from the same seed with
  and without the flag leave G's parameters and buffers **bit-equal**
  (G's loss has no D term), while D's parameters differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vfd_gan_tpu.quant import qdisc as jqdisc
from vfd_gan_tpu_torch.cli import trainer
from vfd_gan_tpu_torch.models.layers import QConv3d
from vfd_gan_tpu_torch.ops.image import to_channel_first, to_channel_last
from vfd_gan_tpu_torch.quant.qdisc import qspatial_conv, qtemporal_conv

# case -> (x shape channel-last, JAX kernel shape, port function, JAX
# function, the float conv's stride and padding)
CASES = {
    "spatial_s1": ((2, 3, 12, 12, 8), (3, 3, 8, 16),
                   lambda x, w: qspatial_conv(x, w, 1, 1),
                   lambda x, k: jqdisc.qspatial_conv(x, k, 1, 1),
                   (1, 1, 1), (0, 1, 1)),
    "spatial_s2": ((2, 2, 13, 12, 3), (3, 3, 3, 8),
                   lambda x, w: qspatial_conv(x, w, 2, 1),
                   lambda x, k: jqdisc.qspatial_conv(x, k, 2, 1),
                   (1, 2, 2), (0, 1, 1)),
    "temporal": ((2, 6, 8, 8, 12), (3, 12, 10),
                 lambda x, w: qtemporal_conv(x, w, 1),
                 lambda x, k: jqdisc.qtemporal_conv(x, k, 1),
                 (1, 1, 1), (1, 0, 0)),
}


def _torch_weight(k: np.ndarray) -> torch.Tensor:
    """A JAX spatial ``(kh, kw, I, O)`` or temporal ``(kt, I, O)`` kernel
    in torch's ``(O, I, kt, kh, kw)`` layout."""
    if k.ndim == 4:
        return torch.from_numpy(k.transpose(3, 2, 0, 1)[:, :, None].copy())
    return torch.from_numpy(k.transpose(2, 1, 0)[:, :, :, None, None].copy())


@pytest.mark.parametrize("case", list(CASES))
def test_qconv_forward_and_straight_through_vjp(case):
    xshape, kshape, port, jax_fn, stride, padding = CASES[case]
    rng = np.random.default_rng(len(case))
    x = rng.normal(size=xshape).astype(np.float32)
    k = (rng.normal(size=kshape) * 0.1).astype(np.float32)
    xt = to_channel_first(torch.from_numpy(x)).contiguous().requires_grad_()
    wt = _torch_weight(k).requires_grad_()

    y_q = port(xt, wt)
    y_f = F.conv3d(xt, wt, None, stride, padding)
    assert y_q.shape == y_f.shape and y_q.dtype == torch.float32
    err = (y_q - y_f).abs().max().item()
    assert err < 0.05 * y_f.abs().max().item(), err
    want = np.asarray(jax_fn(jnp.asarray(x), jnp.asarray(k)))
    np.testing.assert_allclose(to_channel_last(y_q.detach()).numpy(), want,
                               rtol=1e-6, atol=1e-6)

    # straight-through: exactly the float conv's VJP at the same cotangent
    g = torch.from_numpy(rng.normal(size=tuple(y_f.shape)).astype(
        np.float32))
    got = torch.autograd.grad(y_q, (xt, wt), g)
    ref = torch.autograd.grad(y_f, (xt, wt), g)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def _run(tmp_path, flag: bool):
    extra = ["--int8_disc"] if flag else []
    return trainer.main([
        "--model", "mygan", "--batchsize", "1", "--isize", "64", "--nfr",
        "16", "--ngf", "4", "--ndf", "4", "--compute_dtype", "float32",
        "--synthetic_data", "2", "--synthetic_test_batches", "1", "--ep",
        "1", "--freq", "100", "--max_steps", "2", "--seed", "7",
        "--no-tensorboard", "--device", "cpu", "--result_root",
        str(tmp_path / str(flag)), *extra])


def test_g_update_bit_invariant_to_int8_disc(tmp_path):
    plain, quant = _run(tmp_path, False), _run(tmp_path, True)
    assert plain.global_step == quant.global_step == 2
    qconvs = [m for m in quant.netd.modules() if isinstance(m, QConv3d)]
    # every conv of the 9 discriminator blocks, spatial and temporal
    assert len(qconvs) == 18
    assert not any(isinstance(m, QConv3d) for m in plain.netd.modules())
    assert not any(isinstance(m, QConv3d) for m in quant.netg.modules())
    for (k, a), b in zip(plain.netg.state_dict().items(),
                         quant.netg.state_dict().values()):
        assert torch.equal(a, b), k
    d_diff = max((a - b).abs().max().item() for a, b in zip(
        plain.netd.parameters(), quant.netd.parameters()))
    assert d_diff > 0
    assert all(torch.isfinite(p).all() for p in quant.netd.parameters())
