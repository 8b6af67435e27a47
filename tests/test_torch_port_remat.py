"""``--remat`` / ``--remat_blocks``: the port's rematerialized Generator
against its plain one and against JAX's ``nn.remat`` Generator, and one
``--remat`` trainer step.

``torch.utils.checkpoint`` runs a block's forward a second time in the
backward pass; a train-mode BatchNorm would then move its running
statistics and ``num_batches_tracked`` again, which JAX's remat does not
do.  The port's remat Generator must leave every buffer as the plain one
does: on the CPU the two are held bit for bit (outputs, gradients,
buffers), and a plain ``checkpoint`` of a block is shown to double-count.

Against JAX (dropout at rate 0, the CPU): outputs and running statistics
within 1e-5, as the port's train-mode Generator is held in
``tests/test_torch_port_train.py``; gradients by relative L2 distance
(``train/state.relative_distances``), the median tensor's and the whole
set's, within 1e-3.  That bound is JAX's float32 error, not the port's:
measured, JAX's remat gradients are 3.8e-4 (median) and 1.4e-4 (whole)
from the port's, exactly as far as JAX's plain ones from the port's plain
ones, while the port's float32 gradients are 9e-6 and 4e-6 from its own
float64 run (held here within 5e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from vfd_gan_tpu.models.mygan import Generator as JaxGenerator
from vfd_gan_tpu_torch.cli import trainer
from vfd_gan_tpu_torch.models.mygan import Generator
from vfd_gan_tpu_torch.ops.image import to_channel_last
from vfd_gan_tpu_torch.train.state import relative_distances
from vfd_gan_tpu_torch.utils.weights import generator_state_dict
from test_torch_port_threads import one_torch_thread  # noqa: F401

NGF, B, T, S = 4, 2, 16, 16
SELECTIONS = {"all": (), "dconv1,uconv1": ("dconv1", "uconv1"),
              "uconv1,no_such_block": ("uconv1", "no_such_block")}


def _clip(seed: int) -> torch.Tensor:
    x = np.random.default_rng(seed).uniform(-1, 1, (B, 3, T, S, S))
    return torch.from_numpy(x.astype(np.float32))


def _run(model: Generator, steps: int = 2):
    """Two train-mode forwards with dropout on (masks from one seeded
    generator) and their backward; returns the outputs, the gradients and
    the buffers."""
    drop = torch.Generator().manual_seed(7)
    outs = []
    for i in range(steps):
        y = model(_clip(i), drop)
        (y * y).mean().backward()
        outs.append(y.detach())
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    return outs, grads, {k: v.clone() for k, v in model.state_dict().items()}


def _generator(**kw) -> Generator:
    return Generator(NGF, generator=torch.Generator().manual_seed(0),
                     **kw).train()


@pytest.mark.parametrize("blocks", list(SELECTIONS))
def test_remat_generator_equals_plain_buffers_included(blocks):
    remat = _generator(remat=True, remat_blocks=SELECTIONS[blocks])
    want = set(Generator.BLOCKS) & set(SELECTIONS[blocks] or
                                       Generator.BLOCKS)
    assert remat.remat == want
    plain_out, plain_grads, plain_bufs = _run(_generator())
    out, grads, bufs = _run(remat)
    for a, b in zip(out, plain_out):
        assert torch.equal(a, b)
    for k in plain_grads:
        assert torch.equal(grads[k], plain_grads[k]), k
    for k in plain_bufs:
        assert torch.equal(bufs[k], plain_bufs[k]), k
    assert int(bufs["dconv1.bn.num_batches_tracked"]) == 2
    assert int(bufs["uconv1.conv.bn.num_batches_tracked"]) == 2


def test_plain_checkpoint_moves_the_statistics_twice():
    """The trap the port's remat avoids: a block checkpointed as is runs
    its train-mode BatchNorms again in the backward pass."""
    block = _generator().dconv1
    before = block.bn.running_mean.clone()
    y = checkpoint(block, _clip(0), use_reentrant=False)
    assert int(block.bn.num_batches_tracked) == 1
    once = block.bn.running_mean.clone()
    y.square().mean().backward()
    assert int(block.bn.num_batches_tracked) == 2
    assert not torch.equal(block.bn.running_mean, once)
    assert not torch.equal(once, before)


def test_eval_and_no_grad_forwards_do_not_checkpoint():
    remat = _generator(remat=True).eval()
    plain = _generator().eval()
    with torch.no_grad():
        assert torch.equal(remat(_clip(0)), plain(_clip(0)))


@pytest.fixture(scope="module")
def jax_variables():
    x = jnp.zeros((B, T, S, S, 3), jnp.float32)
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: JaxGenerator(ngf=NGF, drop_rate=0.0).init(k, x, False))(
            jax.random.key(0)))


@pytest.mark.parametrize("blocks", ["all", "dconv1,uconv1"])
def test_remat_gradients_match_jax_remat(jax_variables, blocks):
    variables = jax_variables
    x = _clip(3)
    gt = (np.random.default_rng(4).uniform(size=(B, T, S, S, 1)) > 0.8
          ).astype(np.float32)
    jg = JaxGenerator(ngf=NGF, drop_rate=0.0, remat=True,
                      remat_blocks=SELECTIONS[blocks])

    def loss(params):
        pred, mut = jg.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(to_channel_last(x).numpy()), True,
            mutable=["batch_stats"], rngs={"dropout": jax.random.key(1)})
        return jnp.mean((pred - gt) ** 2), (pred, mut["batch_stats"])

    (_, (want_pred, want_stats)), want_grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(variables["params"])

    def port(remat, dtype):
        model = Generator(NGF, drop_rate=0.0, remat=remat,
                          remat_blocks=SELECTIONS[blocks]).train()
        model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                               generator_state_dict(variables).items()})
        model.to(dtype)
        pred = to_channel_last(model(x.to(dtype)))
        ((pred - torch.from_numpy(gt).to(dtype)) ** 2).mean().backward()
        return model, pred.detach()

    model, pred = port(True, torch.float32)
    np.testing.assert_allclose(pred.numpy(), np.asarray(want_pred), rtol=0,
                               atol=1e-5)
    grads = {k: p.grad for k, p in model.named_parameters()}
    # the JAX gradients and statistics in the port's state_dict names
    as_sd = generator_state_dict({
        "params": jax.tree_util.tree_map(np.asarray, want_grads),
        "batch_stats": jax.tree_util.tree_map(np.asarray, want_stats)})
    median, whole = relative_distances(
        grads, {k: torch.from_numpy(np.array(as_sd[k])) for k in grads})
    assert median <= 1e-3 and whole <= 1e-3, (median, whole)
    model64, _ = port(False, torch.float64)
    median, whole = relative_distances(
        grads, {k: p.grad for k, p in model64.named_parameters()})
    assert median <= 5e-5 and whole <= 5e-5, (median, whole)
    got_sd = model.state_dict()
    for k, want in as_sd.items():
        if "running" in k:
            np.testing.assert_allclose(got_sd[k].numpy(), want, rtol=0,
                                       atol=1e-5, err_msg=k)
        elif k.endswith("num_batches_tracked"):
            assert int(got_sd[k]) == 1, k


_ARGS = ["--model", "mygan", "--batchsize", "2", "--nfr", "16", "--isize",
         "64", "--ngf", "2", "--ndf", "2", "--compute_dtype", "float32",
         "--synthetic_data", "1", "--synthetic_test_batches", "1", "--ep",
         "1", "--freq", "1", "--no-tensorboard", "--device", "cpu"]


def test_remat_trainer_step_equals_plain(tmp_path):
    """One ``--remat`` trainer step and a sweep from the seed of a plain
    one: the same losses, scores, parameters, buffers and Adam state, bit
    for bit on the CPU."""
    engines = [trainer.main(_ARGS + extra + ["--result_root",
                                             str(tmp_path / name)])
               for name, extra in (("plain", []), ("remat", ["--remat"]))]
    plain, remat = engines
    assert remat.netg.remat == set(Generator.BLOCKS) and not plain.netg.remat
    assert remat.errors == {**plain.errors, "perf/steps_per_sec":
                            remat.errors["perf/steps_per_sec"]}
    assert remat.scores == plain.scores
    for a, b in ((remat.g, plain.g), (remat.d, plain.d)):
        sa, sb = a.module.state_dict(), b.module.state_dict()
        for k in sb:
            assert torch.equal(sa[k], sb[k]), k
        for p, q in zip(a.module.parameters(), b.module.parameters()):
            assert torch.equal(a.optimizer.state[p]["exp_avg"],
                               b.optimizer.state[q]["exp_avg"])


def test_remat_leaves_the_ae_autoencoder_alone(tmp_path):
    """JAX wires ``--remat`` into the Generator only: an ``--ae`` run's
    AutoEncoder trains as without it."""
    engine = trainer.build_engine(_ARGS + ["--ae", "--remat",
                                           "--result_root", str(tmp_path)])
    assert type(engine.netg).__name__ == "AutoEncoder"
    assert not hasattr(engine.netg, "remat")
    engine.close()
