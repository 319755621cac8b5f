"""A TPU-written run resumed in PyTorch: for each model family, the JAX
harness's own pieces (``tpuframe.train.make_loss_fn``, its optimizer, the
train step with no mesh) train two steps and write the TrainState with
the JAX package's checkpoint writer (``tpuframe.ckpt.save``, as its
trainer's ``CheckpointManager`` does with ``ckpt_dir``).  The port reads
that checkpoint (``tpuframe_torch.ckpt.restore``), maps it with
``models.convert.train_state_from_jax`` into its model and optimizer, and
trains step 3 on the batch the JAX run takes third.  Its loss, parameters,
buffers and optimizer moments must be the JAX run's own step 3.

The families, at the tiny sizes of the port's step-parity tests, f32 and
with no dropout (the two packages draw masks from different generators):
the LM (``test_torch_train.py``'s tiny LM, einsum attention), the ResNet
(``test_torch_image_train.py``'s tiny Bottleneck ResNet, ``bn="fused"``,
nesterov SGD with decay), BERT (``test_torch_glue_train.py``'s 4-layer
BERT, adamw) and the MNIST ConvNet (``test_torch_mnist_cifar_train.py``'s
``mnist_single``, sgd without clip).  Tolerances are those files': the
two differ in summation order only, so the loss within 1e-5 and every
tensor within 1e-5 absolute.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpuframe import ckpt as jax_ckpt  # noqa: E402
from tpuframe import models as jax_models  # noqa: E402
from tpuframe import train as jax_train  # noqa: E402
from tpuframe.models import resnet as jax_resnet  # noqa: E402
from tpuframe.parallel import step as jax_step  # noqa: E402
from tpuframe.utils import build_optimizer as jax_build_optimizer  # noqa: E402
from tpuframe.utils.config import TrainConfig as JaxTrainConfig  # noqa: E402
from tpuframe.utils.config import get_config as jax_get_config  # noqa: E402
from tpuframe_torch import ckpt  # noqa: E402
from tpuframe_torch import models as port_models  # noqa: E402
from tpuframe_torch import train as port_train  # noqa: E402
from tpuframe_torch.data import datasets  # noqa: E402
from tpuframe_torch.models import resnet as port_resnet  # noqa: E402
from tpuframe_torch.models import transformer_lm as torch_lm  # noqa: E402
from tpuframe_torch.models.convert import train_state_from_jax  # noqa: E402
from tpuframe_torch.parallel import step as port_step  # noqa: E402
from tpuframe_torch.utils.config import TrainConfig  # noqa: E402
from tpuframe_torch.utils.config import get_config  # noqa: E402
from tpuframe_torch.utils.optim import build_optimizer  # noqa: E402

ATOL = 1e-5


def _rows(ds, batch, i):
    return ds[np.arange(batch * i, batch * (i + 1))]


def _lm():
    common = dict(name="interop", model="transformer-lm",
                  model_kwargs={"tiny": True, "vocab_size": 64,
                                "attn_impl": "xla"},
                  dataset="lm_text",
                  dataset_kwargs={"seq_len": 64, "vocab_size": 64,
                                  "synthetic_size": 64},
                  optimizer="adamw", base_lr=3e-3, scale_lr_by_batch=False,
                  warmup_steps=1, schedule="cosine", weight_decay=0.1,
                  grad_clip_norm=1.0, global_batch=4, total_steps=10,
                  compute_dtype="float32", fused_xent=True)
    jcfg, cfg = JaxTrainConfig(**common), TrainConfig(**common)
    model = jax_models.get_model("transformer-lm", dtype=jnp.float32,
                                 **jcfg.model_kwargs)
    v = model.init(jax.random.key(0), jnp.zeros((1, 64), jnp.int32))
    train_ds, _ = datasets.lm_text(None, **cfg.dataset_kwargs)

    def port_model():
        return torch_lm.TransformerLM(torch_lm.LMConfig.tiny(
            vocab_size=64, attn_impl="xla"), device="cpu")

    return (jcfg, model, v, cfg, port_model,
            [_rows(train_ds, 4, i) for i in range(3)])


def _resnet():
    common = dict(name="interop", model="resnet50",
                  model_kwargs={"bn": "fused"}, dataset="imagenet",
                  dataset_kwargs={"image_size": 32, "synthetic_size": 64,
                                  "num_classes": 4},
                  optimizer="sgd", base_lr=0.4, warmup_steps=1,
                  schedule="cosine", weight_decay=1e-4, label_smoothing=0.1,
                  global_batch=8, total_steps=10, augment="none")
    jcfg, cfg = JaxTrainConfig(**common), TrainConfig(**common)
    model = jax_resnet.ResNet(stage_sizes=(1, 1),
                              block_cls=jax_resnet.Bottleneck, num_classes=4,
                              width=8, bn="fused")
    v = model.init(jax.random.key(0), jnp.zeros((2, 32, 32, 3)), train=True)
    train_ds, _ = datasets.imagenet(None, **cfg.dataset_kwargs)

    def port_model():
        return port_resnet.ResNet((1, 1), port_resnet.Bottleneck,
                                  num_classes=4, width=8, bn="fused",
                                  device="cpu")

    return (jcfg, model, v, cfg, port_model,
            [_rows(train_ds, 8, i) for i in range(3)])


def _bert():
    over = dict(model_kwargs={"vocab_size": 1024, "hidden_size": 128,
                              "num_layers": 4, "num_heads": 4,
                              "intermediate_size": 256, "max_position": 128,
                              "dropout": 0.0, "num_classes": 2},
                dataset_kwargs={"seq_len": 32, "vocab_size": 1024,
                                "synthetic_size": 64},
                global_batch=8, total_steps=10, warmup_steps=1)
    jcfg = jax_get_config("glue_bert").with_overrides(**over)
    cfg = get_config("glue_bert").with_overrides(**over)
    model = jax_models.get_model("bert-base", dtype=jnp.float32,
                                 **jcfg.model_kwargs)
    v = model.init(jax.random.key(0), jnp.zeros((1, 32), jnp.int32))
    train_ds, _ = datasets.build(cfg.dataset, None, **cfg.dataset_kwargs)

    def port_model():
        return port_models.get_model("bert-base", dtype="float32",
                                     device="cpu", **cfg.model_kwargs)

    return (jcfg, model, v, cfg, port_model,
            [_rows(train_ds, 8, i) for i in range(3)])


def _convnet():
    over = dict(global_batch=16, model_kwargs={"dropout": 0.0},
                dataset_kwargs={"synthetic_size": 64})
    jcfg = jax_get_config("mnist_single").with_overrides(**over)
    cfg = get_config("mnist_single").with_overrides(**over)
    model = jax_models.get_model(jcfg.model, dtype=jnp.float32,
                                 **jcfg.model_kwargs)
    train_ds, _ = datasets.build(cfg.dataset, None, **cfg.dataset_kwargs)
    batches = [_rows(train_ds, 16, i) for i in range(3)]
    v = model.init(jax.random.key(cfg.seed),
                   jnp.asarray(batches[0]["image"][:2]))

    def port_model():
        return port_models.get_model("convnet", dtype="float32",
                                     device="cpu", **cfg.model_kwargs)

    return jcfg, model, v, cfg, port_model, batches


FAMILIES = {"transformer-lm": _lm, "resnet50": _resnet, "bert-base": _bert,
            "convnet": _convnet}


@pytest.fixture(scope="module", params=list(FAMILIES))
def runs(request, tmp_path_factory):
    """The JAX run's steps 1-2, its checkpoint at step 2, its step 3 and
    the state after it (through the same checkpoint path, at step 3); the
    port's step 3 from the step-2 checkpoint."""
    family = request.param
    jcfg, model, v, cfg, port_model, batches = FAMILIES[family]()
    v = jax.tree.map(np.asarray, v)
    stats = v.get("batch_stats")
    tx = jax_build_optimizer(jcfg, v["params"])
    state = jax_step.TrainState.create(
        v["params"], tx,
        model_state={"batch_stats": stats} if stats is not None else None)
    step = jax_step.make_train_step(jax_train.make_loss_fn(jcfg, model), tx,
                                    None, donate=False)
    directory = str(tmp_path_factory.mktemp(family))
    losses = []
    for i, b in enumerate(batches):
        state, m = step(state, {k: jnp.asarray(x) for k, x in b.items()})
        losses.append(float(m["loss"]))
        if i >= 1:
            jax_ckpt.save(directory, i + 1, state)
    want = train_state_from_jax(jax_ckpt.restore(directory, 3), family)

    model_sd, opt_sd, start = train_state_from_jax(
        ckpt.restore(directory, 2), family)
    port = port_model()
    port.load_state_dict(model_sd)
    pstate = port_step.TrainState(port, build_optimizer(cfg, port),
                                  step=start)
    pstate.opt.load_state_dict(opt_sd)
    train_step = port_step.make_train_step(port_train.make_loss_fn(cfg),
                                           distributed=cfg.distributed)
    got = float(train_step(pstate, {k: torch.from_numpy(x)
                                    for k, x in batches[2].items()})["loss"])
    return family, losses, got, want, pstate, opt_sd


def test_the_port_continues_the_jax_run_at_its_step(runs):
    family, losses, got, (_, _, want_step), pstate, opt_sd = runs
    assert opt_sd["count"] == 2 and want_step == 3 == pstate.step
    assert pstate.opt.count == 3
    np.testing.assert_allclose(got, losses[2], atol=ATOL, rtol=0)


def test_parameters_and_buffers_match_the_jax_step(runs):
    _, _, _, (want, _, _), pstate, _ = runs
    got = pstate.model.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=ATOL,
                                   rtol=0, err_msg=k)


def test_optimizer_moments_match_the_jax_step(runs):
    family, _, _, (_, want_opt, _), pstate, _ = runs
    got = pstate.opt.state_dict()
    assert set(got) == set(want_opt)
    assert set(got) == ({"count", "mu", "nu"}
                        if family in ("transformer-lm", "bert-base")
                        else {"count", "trace"})
    assert got["count"] == want_opt["count"] == 3
    for key in set(got) - {"count"}:
        for k, w in want_opt[key].items():
            np.testing.assert_allclose(got[key][k].numpy(), w.numpy(),
                                       atol=ATOL, rtol=0,
                                       err_msg=f"{key} {k}")


@pytest.mark.parametrize("bad,match", [
    ({"extra_leaf": np.zeros(2)}, "unmapped JAX TrainState"),
    ({"opt_state": {"0": {"weird": np.zeros(2)}}}, "unmapped JAX optimizer"),
    ({"opt_state": {"0": {"count": 1}, "1": {"count": 2}}}, "counts"),
    ({"model_state": {"batch_stats": {}}}, "batch_stats"),
])
def test_train_state_from_jax_refuses_what_it_cannot_map(bad, match):
    tree = {"step": np.int32(1), "params": {}, "opt_state": {}, **bad}
    with pytest.raises(ValueError, match=match):
        train_state_from_jax(tree, "bert-base")
    with pytest.raises(ValueError, match="no JAX TrainState map"):
        train_state_from_jax({"step": 0, "params": {}, "opt_state": {}},
                             "vit")
