"""The port's ensemble step against ``make_ensemble_eval_step`` on the CPU.

Three members with different numpy-seeded weights (BatchNorm running stats
perturbed) run through the JAX package's vmapped step on stacked trees and
through the port's step on the converted state dicts; the mean predictions
agree at rtol = atol = 1e-4.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_fusion_fpn_tpu.config import make_config
from multimodal_fusion_fpn_tpu.models.zoo import build_model as jbuild
from multimodal_fusion_fpn_tpu.train.step import make_ensemble_eval_step \
    as jax_ensemble_step

from multimodal_fusion_fpn_torch.eval.ensemble import make_ensemble_eval_step
from multimodal_fusion_fpn_torch.models.zoo import build_model
from multimodal_fusion_fpn_torch.weights import state_dict_from_jax

from test_torch_model import (_batch, compile_ref, jax_template,
                              random_trees)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N_MEMBERS = 3


@pytest.fixture(scope="module")
def ensemble_case():
    """The config, batch, the members' state dicts, the JAX ensemble
    prediction, a future (the step is traced here and compiled in a thread
    while the tests that do not read it run), and the port's fp32 step on
    the batch, which two tests read.  The JAX trees' template comes from
    the JAX package's name table (``jax_template``), not from a trace of
    the model's init."""
    cfg = make_config(model="FPNHybridFusion", crop="relative_2d_max",
                      fusion_modality="slo")
    batch = _batch(4)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = jbuild(cfg, remat=False)
    model = build_model(cfg, device="cpu")
    template = jax_template(model.state_dict())
    members = [random_trees(template, seed=20 + i) for i in range(N_MEMBERS)]
    stack = lambda trees: jax.tree.map(lambda *a: np.stack(a), *trees)
    args = (stack([p for p, _ in members]), stack([s for _, s in members]),
            jb)
    lowered = jax_ensemble_step(jmodel).lower(*args)
    sds = [state_dict_from_jax(p, s) for p, s in members]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref = pool.submit(
            lambda: np.asarray(compile_ref(lowered)(*args)["prediction"]))
        port = make_ensemble_eval_step(model, sds, device="cpu")(batch)
        yield cfg, batch, sds, ref, model, port["prediction"]


def test_ensemble_is_the_mean_of_members(ensemble_case):
    _, batch, sds, _, model, got = ensemble_case
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    preds = []
    for sd in sds:
        model.load_state_dict(sd, strict=True)
        with torch.no_grad():
            preds.append(model(tb)["prediction"])
    torch.testing.assert_close(got, torch.stack(preds).mean(0),
                               rtol=1e-6, atol=1e-6)


def test_ensemble_step_defaults_to_cuda(ensemble_case):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    cfg, _, sds, _, _, _ = ensemble_case
    with pytest.raises((AssertionError, RuntimeError)):
        make_ensemble_eval_step(build_model(cfg, device="cpu"), sds)


def test_ensemble_matches_jax(ensemble_case):
    _, _, _, ref, _, got = ensemble_case
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref.result(), rtol=1e-4,
                               atol=1e-4)


def test_ensemble_bf16_returns_compute_dtype(ensemble_case):
    cfg, batch, sds, ref, _, _ = ensemble_case
    step = make_ensemble_eval_step(
        build_model(cfg, dtype=torch.bfloat16, device="cpu"), sds,
        device="cpu")
    got = step(batch)["prediction"]
    ref = ref.result()
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    a, b = got.float().numpy().ravel() - 0.5, ref.ravel() - 0.5
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    assert cos >= 0.999 and abs(np.linalg.norm(a) / np.linalg.norm(b)
                                - 1) <= 0.01
