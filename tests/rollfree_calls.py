"""Counting the JAX package's roll-free kernel bodies (K9) while the port's
CPU tests trace their references.

``MMF_ROLLFREE=1`` makes the JAX fused conv take ``_rf_kernel`` (the
forward, with or without stats and extents) and ``_rf_dx_kernel`` (the
merged backward) for its kY == 1, kX == 3 convs; the flag is read while a
function is traced.  The launchers build their ``pallas_call`` from
``functools.partial(_rf_kernel, ...)``, which looks the module global up at
that moment, so a counting wrapper set with ``monkeypatch.setattr`` sees
every trace of a body, with no edit to the JAX package.  A body runs once
per trace of its call.
"""

import contextlib
import functools

import pytest

from multimodal_fusion_fpn_tpu.ops.pallas import fused_conv as jfc

BODIES = ("_rf_kernel", "_rf_dx_kernel")


class RollfreeCalls:
    """``by_case[key]``: how often each roll-free body ran while case
    ``key`` was traced (inside :meth:`trace`)."""

    def __init__(self, mp: pytest.MonkeyPatch):
        self.total = dict.fromkeys(BODIES, 0)
        self.by_case = {}
        for name in BODIES:
            mp.setattr(jfc, name, self._counting(name, getattr(jfc, name)))

    def _counting(self, name, body):
        @functools.wraps(body)
        def run(*args, **kwargs):
            self.total[name] += 1
            return body(*args, **kwargs)
        return run

    @contextlib.contextmanager
    def trace(self, key, rollfree: bool):
        """Trace case ``key`` inside, with ``MMF_ROLLFREE=1`` if
        ``rollfree`` (else without the flag)."""
        before = dict(self.total)
        with pytest.MonkeyPatch.context() as mp:
            if rollfree:
                mp.setenv("MMF_ROLLFREE", "1")
            else:
                mp.delenv("MMF_ROLLFREE", raising=False)
            yield
        self.by_case[key] = {n: self.total[n] - before[n] for n in BODIES}

    def check(self):
        """Every roll-free case ran ``_rf_kernel`` (and, where it was
        differentiated, ``_rf_dx_kernel``); no other case ran either."""
        for key, calls in self.by_case.items():
            if "rollfree" in key:
                assert calls["_rf_kernel"] > 0, (key, calls)
            else:
                assert not any(calls.values()), (key, calls)


@pytest.fixture(scope="module")
def rollfree_calls():
    with pytest.MonkeyPatch.context() as mp:
        yield RollfreeCalls(mp)
