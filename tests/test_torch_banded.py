"""The port's narrow-entry conv (``ops/banded_conv.py``, K10) against the
JAX package, on the CPU, and its routing in the model.

Same numpy inputs through both, fp32, rtol = atol = 1e-5 (the tolerance of
``tests/test_pallas_interpret.py``'s K10 test):

* the plain forward against the TPU kernel itself
  (``banded_conv_blocked_pallas(..., interpret=True)``, its band and wrap
  matrices built as that test builds them) and against the XLA body
  ``banded._banded_conv_blocked_impl``: the 3D entry conv (lead taps (1, 3),
  kz 3), the 1x1x1 downsample, the 2D entry conv on the singleton-X view
  and the data gradient's instance (ci 16 -> co 1);
* the extents twin against ``mask_valid`` + ``_banded_conv_blocked_impl``,
  on inputs random beyond the extents;
* ``BandedConv``'s backward (dw and dx) against
  ``jax.vjp(banded.banded_conv_blocked)``;
* the argument checks of the CUDA path (run here directly), the routing
  (4 K10 forwards per member, 4 forwards + 4 weight gradients and no data
  gradient per train step at the ini widths) and the dropout guard.

The JAX package's ``_PALLAS_MODE`` stays "off"; the Pallas kernel is called
directly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_fusion_fpn_tpu.ops import banded
from multimodal_fusion_fpn_tpu.ops import dynamic_extent as jdyn
from multimodal_fusion_fpn_tpu.ops.pallas.banded_conv import (
    banded_conv_blocked_pallas, w2_band, w2_wrap)

from multimodal_fusion_fpn_torch import losses as tlosses
from multimodal_fusion_fpn_torch.models import blocks as tblocks
from multimodal_fusion_fpn_torch.models.arch_config import ArchSpec
from multimodal_fusion_fpn_torch.models.zoo import build_model
from multimodal_fusion_fpn_torch.ops import banded_conv as tbc
from multimodal_fusion_fpn_torch.train.optim import sgd
from multimodal_fusion_fpn_torch.train.state import create_train_state
from multimodal_fusion_fpn_torch.train.step import make_train_step

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, Y, X, NB, BS = 1, 2, 3, 2, 8
Z = NB * BS
# name -> (port kernel (kY, kX, kz), ci, co); "2d" runs on the singleton-X
# view (B, H, 1, W, C) of a 2D map, as the port's 2D stages do
CASES = {"3d": ((1, 3, 3), 1, 16), "ds": ((1, 1, 1), 1, 16),
         "2d": ((1, 1, 3), 1, 16), "dgrad": ((1, 3, 3), 16, 1)}
EXT = {"3d": (1, 2, 11), "2d": (2, 1, 13)}


def _inputs(name, seed=0):
    """numpy x (B, Y', X', Z, ci), w (kY, kX, kz, ci, co)."""
    taps, ci, co = CASES[name]
    rng = np.random.default_rng(seed)
    shape = (B, 3, 1, Z, ci) if name == "2d" else (B, Y, X, Z, ci)
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=taps + (ci, co)) * 0.3).astype(np.float32)
    return x, w


def _to_jax(name, x, w):
    """The JAX package's blocked form: x6 (B, lead.., nb, bs, ci) and w
    (k_lead.., kz, ci, co); the 2D map has one lead axis."""
    if name == "2d":
        return (jnp.asarray(x[:, :, 0].reshape(B, x.shape[1], NB, BS, -1)),
                jnp.asarray(w[:, 0]))
    return (jnp.asarray(x.reshape(x.shape[:3] + (NB, BS, x.shape[-1]))),
            jnp.asarray(w))


def _from_jax(name, y, shape):
    return np.asarray(y).reshape(shape)


def _pallas(x6, wj):
    """``banded_conv_blocked_pallas`` in interpret mode, with the band and
    wrap matrices of ``_dispatch_blocked``."""
    k_lead, kz = wj.shape[:-3], wj.shape[-3]
    taps = [wj[t] for t in np.ndindex(*k_lead)]
    band = jnp.stack([w2_band(t, BS) for t in taps])
    wrap = (jnp.stack([w2_wrap(t, BS) for t in taps]) if kz == 3
            else jnp.zeros_like(band))
    return banded_conv_blocked_pallas(x6, band, wrap, k_lead, kz,
                                      preferred_element_type=jnp.float32,
                                      interpret=True)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_the_tpu_kernel_and_the_xla_body(name):
    x, w = _inputs(name)
    got = tbc.banded_conv_plain(torch.from_numpy(x), torch.from_numpy(w))
    out_shape = x.shape[:4] + (w.shape[-1],)
    assert got.shape == out_shape
    x6, wj = _to_jax(name, x, w)
    _close(got, _from_jax(name, _pallas(x6, wj), out_shape))
    _close(got, _from_jax(name, banded._banded_conv_blocked_impl(
        x6, wj, jnp.float32), out_shape))
    # the wrapper on a CPU tensor is the plain version
    torch.testing.assert_close(
        tbc.banded_conv(torch.from_numpy(x), torch.from_numpy(w)), got,
        rtol=0, atol=0)


@pytest.mark.parametrize("name", list(EXT))
def test_extents_twin_matches_the_masked_xla_body(name):
    """x random everywhere: what lies at or beyond the extents must not
    reach the output (the JAX side masks it first)."""
    x, w = _inputs(name, seed=1)
    ext = EXT[name]
    got = tbc.banded_conv_plain(torch.from_numpy(x), torch.from_numpy(w),
                                ext)
    xm = jdyn.mask_valid(jnp.asarray(x), dict(zip((1, 2, 3), ext)))
    x6, wj = _to_jax(name, np.asarray(xm), w)
    want = _from_jax(name, banded._banded_conv_blocked_impl(
        x6, wj, jnp.float32), got.shape)
    _close(got, want)
    unmasked = tbc.banded_conv_plain(torch.from_numpy(x),
                                     torch.from_numpy(w))
    assert not np.allclose(unmasked.numpy(), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        tbc.banded_conv(torch.from_numpy(x), torch.from_numpy(w),
                        dyn_extents=ext), got, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["3d", "ds", "2d"])
def test_backward_matches_jax_vjp(name):
    """dx (the flipped conv) and dw of ``BandedConv`` against the JAX
    package's custom VJP of ``banded_conv_blocked``."""
    x, w = _inputs(name, seed=2)
    g = np.random.default_rng(3).normal(
        size=x.shape[:4] + (w.shape[-1],)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    tbc.banded_conv(xt, wt).backward(torch.from_numpy(g))
    x6, wj = _to_jax(name, x, w)
    g6 = _to_jax(name, g, w)[0]
    _, vjp = jax.vjp(lambda a, b: banded.banded_conv_blocked(a, b), x6, wj)
    dx6, dwj = vjp(g6)
    _close(xt.grad, np.asarray(dx6).reshape(x.shape))
    _close(wt.grad, np.asarray(dwj).reshape(w.shape))
    # the plain halves, called directly
    _close(tbc.banded_conv_dgrad(torch.from_numpy(g), torch.from_numpy(w)),
           xt.grad)
    _close(tbc.banded_conv_wgrad(torch.from_numpy(x), torch.from_numpy(g),
                                 w.shape), wt.grad)


def test_checks_refuse_what_the_kernels_do_not_take():
    """The CUDA path's checks (run here directly) and the wrapper's own."""
    x, w = torch.zeros(1, 2, 3, 16, 1), torch.zeros(1, 3, 3, 1, 16)
    tbc._check(x, w.shape, [("w", w, None)])   # the main path's call
    bad = [
        (x.double(), w.shape, [], "dtype"),
        (x, (1, 3, 3, 2, 16), [], "mismatch"),
        (x, (1, 2, 3, 1, 16), [], "taps"),
        (torch.zeros(1, 2, 3, 16, 65), (1, 1, 1, 65, 16), [], "ci"),
        (x, (1, 3, 3, 1, 8), [], "co"),
        (x, w.shape, [("w", w.bfloat16(), None)], "float32"),
        (x, w.shape, [("g", torch.zeros(1, 2, 3, 16, 8), (1, 2, 3, 16, 16))],
         "shape"),
        (torch.zeros(1, 2, 16, 3, 1).transpose(2, 3), w.shape, [],
         "contiguous"),
    ]
    for xb, kshape, others, match in bad:
        with pytest.raises(ValueError, match=match):
            tbc._check(xb, kshape, others)
    with pytest.raises(ValueError, match="extents"):
        tbc.banded_conv(x, w, dyn_extents=(3, 3, 16))
    with pytest.raises(ValueError, match="eval-only"):
        tbc.banded_conv(x.requires_grad_(), w, dyn_extents=(1, 1, 1))


# --- the model --------------------------------------------------------------

def _cfg():
    from multimodal_fusion_fpn_tpu.config import make_config
    return make_config(model="FPNHybridFusion", crop="relative_2d_max",
                       fusion_modality="slo")


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(size=(1, 1, 8, 64, 32)).astype(np.float32),
            "slo": rng.normal(size=(1, 1, 80, 1, 32)).astype(np.float32),
            "mask": (rng.random((1, 1, 8, 1, 32)) > 0.7).astype(np.float32)}


@pytest.fixture
def spies(monkeypatch):
    """Counts of the K10 wrapper calls from the blocks and of its two
    gradients from ``BandedConv``."""
    seen = {"fwd": 0, "wgrad": 0, "dgrad": 0}
    for key, mod, name in (("fwd", tblocks, "banded_conv"),
                           ("wgrad", tbc, "banded_conv_wgrad"),
                           ("dgrad", tbc, "banded_conv_dgrad")):
        real = getattr(mod, name)

        def spy(*args, _real=real, _key=key, **kw):
            seen[_key] += 1
            return _real(*args, **kw)
        monkeypatch.setattr(mod, name, spy)
    return seen


@pytest.fixture(scope="module")
def full_model():
    """One model at the ini widths for both routing tests."""
    return build_model(_cfg(), device="cpu")


def test_routing_per_member_forward(spies, full_model):
    """At the ini widths the narrow convs are the first conv and the 1x1x1
    downsample of the 3D and the 2D stage 1: 4 K10 calls per member."""
    model = full_model.eval()
    with torch.no_grad():
        model({k: torch.from_numpy(v) for k, v in _batch().items()})
    assert spies == {"fwd": 4, "wgrad": 0, "dgrad": 0}
    with torch.no_grad():   # the plain path does not call the wrapper
        model({k: torch.from_numpy(v) for k, v in _batch().items()},
              kernels=False)
    assert spies["fwd"] == 4


def test_routing_per_train_step(spies, full_model):
    """One train step: the 4 forwards through ``BandedConv``, a weight
    gradient each, and no data gradient (their input is the data)."""
    model = full_model
    opt = sgd(model.parameters(), 0.1)
    state = create_train_state(model, opt)
    crit = tlosses.Mix({"Dice Loss": tlosses.dice_loss_joint(),
                        "BCE loss": tlosses.bce_loss()})
    make_train_step(model, opt, crit, device="cpu")(state, _batch())
    assert spies == {"fwd": 4, "wgrad": 4, "dgrad": 0}


@pytest.mark.parametrize("slot,where", [(0, "encoder level 1"),
                                        (4, "encoder level 5"),
                                        (5, "up_concat4"), (8, "up_concat1")])
def test_dropout_refused_in_training_only(slot, where):
    """ROADMAP Queue 3 item 1: a spec with dropout > 0 in any slot cannot
    train (the port has no dropout yet); eval, where dropout is the
    identity, runs."""
    drop = tuple(0.25 if i == slot else 0.0 for i in range(9))
    spec = ArchSpec(channels=(2, 4, 8, 16, 32), dropout=drop)
    model = build_model(_cfg(), spec=spec, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(1).items()}
    with torch.no_grad():
        assert model(batch)["prediction"].shape == (1, 1, 8, 1, 32)
    model.train()
    with pytest.raises(NotImplementedError,
                       match=f"dropout slot {slot} .*{where}.*ROADMAP M8"):
        model(batch)
