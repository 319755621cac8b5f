"""tpuframe_torch's GLUE training against the JAX package's.

Step parity: each package's own ``glue_bert*`` config, cut to a tiny BERT
(4 layers, 128 wide, dropout 0) and a small synthetic batch, trains five
steps from one flax init (``bert_params_from_jax``) on the same batches:
the JAX harness's ``make_loss_fn`` through its train step, the port's
through its own.  SST-2 and CoLA (2-way cross-entropy), MNLI (3-way, pair
inputs) and STS-B (MSE on one output).  Then both evaluate the trained
JAX parameters on the same eval batches through their metric functions
and ``_finalize_eval``.

The steps run at the configs' own learning rate, 2e-5 after a linear
warmup (step 0 at lr 0).

Tolerances.  f32: losses within 1e-5, the eval metrics within 1e-5; the
two differ in summation order only.  bf16: training and eval losses
within 5e-3, as ``tests/test_torch_train.py`` states for the LM, scaled
by the loss where it exceeds 1 (STS-B's MSE is ~10): the frameworks round
the bf16 activations at different places, ~1e-3 of the loss at step 0,
and Adam carries that into sign-like updates of the smallest gradients,
which at step 4 measured up to 3.0e-3 of the loss (MNLI) on this CPU.
Accuracy, MCC and Pearson are compared in f32 only, since such a
rounding difference may flip a prediction near the boundary.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpuframe import models as jax_models  # noqa: E402
from tpuframe import train as jax_train  # noqa: E402
from tpuframe.parallel import step as jax_step  # noqa: E402
from tpuframe.utils import build_optimizer as jax_build_optimizer  # noqa: E402
from tpuframe.utils.config import get_config as jax_get_config  # noqa: E402
from tpuframe_torch import models as port_models  # noqa: E402
from tpuframe_torch import train as port_train  # noqa: E402
from tpuframe_torch.data import datasets  # noqa: E402
from tpuframe_torch.models.convert import bert_params_from_jax  # noqa: E402
from tpuframe_torch.parallel import step as port_step  # noqa: E402
from tpuframe_torch.utils.config import get_config  # noqa: E402
from tpuframe_torch.utils.optim import build_optimizer  # noqa: E402

STEPS, BATCH, SEQ = 5, 8, 32
TINY = {"vocab_size": 1024, "hidden_size": 128, "num_layers": 4,
        "num_heads": 4, "intermediate_size": 256, "max_position": 128,
        "dropout": 0.0}
CLASSES = {"glue_bert": 2, "glue_bert_mnli": 3, "glue_bert_stsb": 1,
           "glue_bert_cola": 2}


def _overrides(name, dtype):
    return dict(model_kwargs=dict(TINY, num_classes=CLASSES[name]),
                dataset_kwargs={"seq_len": SEQ, "vocab_size": 1024,
                                "synthetic_size": 64},
                global_batch=BATCH, total_steps=10, warmup_steps=2,
                compute_dtype=dtype)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=[
    (name, dtype) for dtype in ("float32", "bfloat16") for name in CLASSES],
    ids=lambda p: f"{p[0]}-{p[1]}")
def runs(request):
    """Five steps of each package from one init, then both metric
    functions on the trained JAX params: (cfg, jax, port) dicts."""
    name, dtype = request.param
    over = _overrides(name, dtype)
    jcfg = jax_get_config(name).with_overrides(**over)
    cfg = get_config(name).with_overrides(**over)
    model = jax_models.get_model("bert-base", dtype=jnp.dtype(dtype),
                                 **jcfg.model_kwargs)
    params = model.init(jax.random.key(0),
                        jnp.zeros((1, SEQ), jnp.int32))["params"]
    tx = jax_build_optimizer(jcfg, params)
    state = jax_step.TrainState.create(params, tx)
    step = jax_step.make_train_step(jax_train.make_loss_fn(jcfg, model), tx,
                                    None, donate=False)
    train_ds, eval_ds = datasets.build(cfg.dataset, None,
                                       **cfg.dataset_kwargs)
    batches = [train_ds[np.arange(BATCH * i, BATCH * (i + 1))]
               for i in range(STEPS)]
    jax_losses = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        jax_losses.append(float(m["loss"]))

    port = port_models.get_model("bert-base", dtype=dtype, device="cpu",
                                 **cfg.model_kwargs)
    port.load_state_dict(bert_params_from_jax(_np(params)))
    pstate = port_step.TrainState(port, build_optimizer(cfg, port))
    train_step = port_step.make_train_step(port_train.make_loss_fn(cfg))
    port_losses = [float(train_step(pstate, {k: torch.from_numpy(v)
                                             for k, v in b.items()})["loss"])
                   for b in batches]

    evals = [eval_ds[np.arange(BATCH * i, BATCH * (i + 1))]
             for i in range(3)]
    jmetric = jax.jit(jax_train.make_metric_fn(jcfg, model))
    jm = [_np(jmetric(state.params, {}, {k: jnp.asarray(v)
                                         for k, v in b.items()}))
          for b in evals]
    jax_eval = jax_train._finalize_eval(
        {k: float(np.mean([m[k] for m in jm])) for k in jm[0]})
    port.load_state_dict(bert_params_from_jax(_np(state.params)))
    metric_fn = port_train.make_metric_fn(cfg)
    with torch.no_grad():
        pm = [metric_fn(port, {k: torch.from_numpy(v) for k, v in b.items()})
              for b in evals]
    port_eval = port_train._finalize_eval(
        {k: float(np.mean([float(m[k]) for m in pm])) for k in pm[0]})
    return cfg, {"losses": np.array(jax_losses), "eval": jax_eval}, {
        "losses": np.array(port_losses), "eval": port_eval,
        "dtypes": {p.dtype for p in port.parameters()}}


def test_losses_match_jax(runs):
    cfg, want, got = runs
    if cfg.compute_dtype == "float32":
        np.testing.assert_allclose(got["losses"], want["losses"], atol=1e-5,
                                   rtol=0)
    else:
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                                   atol=5e-3 * max(1.0, want["losses"].max()))
    assert np.isfinite(got["losses"]).all()
    assert got["dtypes"] == {torch.float32}


def test_eval_metrics_match_jax(runs):
    cfg, want, got = runs
    assert set(got["eval"]) == set(want["eval"])
    assert not any(k.startswith("_m_") for k in got["eval"])
    if cfg.dataset == "glue_stsb":
        assert "pearson" in got["eval"] and "accuracy" not in got["eval"]
    else:
        assert "accuracy" in got["eval"]
    if cfg.compute_dtype == "float32":
        for k, w in want["eval"].items():
            assert abs(got["eval"][k] - w) <= 1e-5, (k, got["eval"][k], w)
    else:
        # bf16: a rounding difference may flip a prediction near the
        # boundary, so only the (continuous) loss is held.
        w = want["eval"]["loss"]
        assert abs(got["eval"]["loss"] - w) <= 5e-3 * max(1.0, w)


@pytest.mark.parametrize("moments", [
    {"_m_tp": 0.3, "_m_fp": 0.1, "_m_tn": 0.4, "_m_fn": 0.2,
     "accuracy": 0.7, "loss": 0.6},
    {"_m_tp": 0.0, "_m_fp": 0.0, "_m_tn": 0.7, "_m_fn": 0.3,
     "accuracy": 0.7, "loss": 0.6},          # one class never predicted
    {"_m_pred": 2.1, "_m_y": 2.5, "_m_pred2": 5.0, "_m_y2": 7.5,
     "_m_py": 5.6, "mse": 0.4, "loss": 0.4},
    {"_m_pred": 2.0, "_m_y": 2.5, "_m_pred2": 4.0, "_m_y2": 7.5,
     "_m_py": 5.0, "mse": 0.4, "loss": 0.4},  # constant prediction
], ids=["mcc", "mcc-degenerate", "pearson", "pearson-degenerate"])
def test_finalize_eval_matches_jax(moments):
    got = port_train._finalize_eval(dict(moments))
    want = jax_train._finalize_eval(dict(moments))
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k] == pytest.approx(w, abs=1e-12), k


def test_text_task_predicates_follow_the_config():
    for name, n_cls in CLASSES.items():
        cfg = get_config(name)
        assert port_train._is_text_task(cfg)
        assert port_train._is_regression_task(cfg) == (n_cls == 1)
    assert not port_train._is_text_task(get_config("lm_long"))
