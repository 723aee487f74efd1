"""The port's MXNet frontend (``horovod_tpu_torch/interop/mxnet.py``) held
against the reference's (``horovod_tpu/interop/mxnet.py``): the 6 cases of
``tests/test_mxnet_interop.py``.

MXNet is not installed, so both frontends run against the duck-typed
stand-in that the reference's test injects (``install_fake_mxnet``,
imported from it).  The single-process cases run each call through both
frontends on the same NDArrays and hold the port's values equal to the
reference's (a world of one: exact).  The two-process case runs the
reference test's sequence in a gloo world of two through ``python -m
horovod_tpu_torch.run -np 2`` and holds each rank's values to the ones the
reference's two-process test asserts.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import types as types_mod
from pathlib import Path

import numpy as np
import pytest

import horovod_tpu as jhvd
from test_mxnet_interop import FakeNDArray, install_fake_mxnet

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _worlds():
    import horovod_tpu_torch as hvd

    jhvd.init()
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


@pytest.fixture(autouse=True)
def frontends():
    had = {k: sys.modules.get(k) for k in list(sys.modules)
           if k == "mxnet" or k.startswith("mxnet.")}
    install_fake_mxnet()
    import horovod_tpu.interop.mxnet as jmx
    import horovod_tpu_torch.interop.mxnet as pmx

    yield pmx, jmx
    for k in list(sys.modules):
        if k == "mxnet" or k.startswith("mxnet."):
            del sys.modules[k]
    sys.modules.update({k: v for k, v in had.items() if v is not None})


def test_allreduce_identity_and_inplace(frontends):
    pmx, jmx = frontends
    value = np.arange(6, dtype=np.float32).reshape(2, 3)
    outs = [m.allreduce(FakeNDArray(value, ctx="fake_gpu(1)"))
            for m in (pmx, jmx)]
    assert isinstance(outs[0], FakeNDArray)
    np.testing.assert_array_equal(outs[0].asnumpy(), outs[1].asnumpy())
    np.testing.assert_allclose(outs[0].asnumpy(), value)
    # out-of-place results keep the source's context
    assert outs[0].context == "fake_gpu(1)" == outs[1].context
    ys = [FakeNDArray(np.ones(4, np.float32)) for _ in range(2)]
    rets = [m.allreduce_(y, average=False) for m, y in zip((pmx, jmx), ys)]
    assert rets[0] is ys[0]
    np.testing.assert_array_equal(ys[0].asnumpy(), ys[1].asnumpy())
    np.testing.assert_allclose(ys[0].asnumpy(), np.ones(4))


def test_broadcast_and_allgather_single(frontends):
    pmx, jmx = frontends
    x = FakeNDArray(np.full((2, 2), 3.0, np.float32))
    for op in (lambda m: m.broadcast(x, root_rank=0),
               lambda m: m.allgather(x)):
        got, want = op(pmx), op(jmx)
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
        np.testing.assert_allclose(got.asnumpy(), x.asnumpy())


def _sgd(mx):
    class SGD(mx.optimizer.Optimizer):
        def __init__(self):
            self.rescale_grad = 1.0
            self.updates = []

        def update(self, index, weight, grad, state):
            self.updates.append((index, weight, grad, state))

        def update_multi_precision(self, index, weight, grad, state):
            self.update(index, weight, grad, state)

        def create_state_multi_precision(self, index, weight):
            return None

        def set_learning_rate(self, lr):
            self.lr = lr

    return SGD()


def test_distributed_optimizer_rescales_and_updates(frontends):
    seen = []
    for m in frontends:
        base = _sgd(sys.modules["mxnet"])
        opt = m.DistributedOptimizer(base)
        # the average folded into rescale_grad
        assert base.rescale_grad == pytest.approx(1.0 / m.size())
        g = FakeNDArray(np.ones(3, np.float32))
        w = FakeNDArray(np.zeros(3, np.float32))
        opt.update(0, w, g, None)
        opt.update_multi_precision([1, 2], [w, w], [g, g], [None, None])
        opt.set_learning_rate(0.5)  # delegation
        seen.append((len(base.updates), base.lr, base.rescale_grad,
                     type(opt).__name__))
    assert seen[0] == seen[1] == (2, 0.5, 1.0, "_DistributedOptimizer")


def test_distributed_trainer_scale_and_unwrap(frontends):
    for m in frontends:
        base = _sgd(sys.modules["mxnet"])
        wrapped = m.DistributedOptimizer(base)
        with pytest.warns(UserWarning, match="unwrapped"):
            trainer = m.DistributedTrainer({}, wrapped)
        assert trainer._optimizer is base
        assert trainer._scale == pytest.approx(1.0 / m.size())


def test_deferred_init_hook_broadcasts_after_init(frontends):
    """``_append_broadcast_init`` wraps a gluon parameter's
    ``_init_impl`` so the value after initialization is broadcast."""
    values = []
    for m in frontends:
        calls = []

        class Param:
            name = "w1"

            def __init__(self):
                self._value = None

            def data(self):
                return self._value

            def _init_impl(self, *a, **kw):
                calls.append("init")
                self._value = FakeNDArray(np.arange(2, dtype=np.float32))

        p = Param()
        p._init_impl = types_mod.MethodType(
            m._append_broadcast_init(p, root_rank=0), p)
        p._init_impl()
        assert calls == ["init"]
        values.append(p.data().asnumpy())
    np.testing.assert_array_equal(values[0], values[1])
    np.testing.assert_allclose(values[0], [0.0, 1.0])


WORKER = textwrap.dedent("""
    import json, sys, types
    import numpy as np
    sys.path.insert(0, {tests!r})
    from test_mxnet_interop import FakeNDArray, install_fake_mxnet

    install_fake_mxnet()
    import horovod_tpu_torch.interop.mxnet as hmx

    hmx.init()
    r = hmx.rank()
    out = {{}}
    x = FakeNDArray(np.full(3, float(r + 1), np.float32))
    hmx.allreduce_(x, average=False, name="ar")
    out["allreduce_"] = x.asnumpy().tolist()
    b = FakeNDArray(np.full(2, float(r), np.float32))
    hmx.broadcast_(b, root_rank=1, name="bc")
    out["broadcast_"] = b.asnumpy().tolist()

    class SGD(sys.modules["mxnet"].optimizer.Optimizer):
        def __init__(self):
            self.rescale_grad = 1.0
            self.seen = None

        def update(self, index, weight, grad, state):
            self.seen = grad.asnumpy() * self.rescale_grad

    base = SGD()
    opt = hmx.DistributedOptimizer(base)
    opt.update(7, FakeNDArray(np.zeros(2, np.float32)),
               FakeNDArray(np.full(2, float(r + 1), np.float32)), None)
    out["effective_grad"] = base.seen.tolist()

    params = {{"w": FakeNDArray(np.full(2, float(10 * (r + 1)),
                                        np.float32))}}
    hmx.broadcast_parameters(params, root_rank=0)
    out["param_after_bcast"] = params["w"].asnumpy().tolist()

    deferred_error = sys.modules[
        "mxnet"].gluon.parameter.DeferredInitializationError

    class Param:
        def __init__(self, name, value=None):
            self.name = name
            self._value = value

        def data(self):
            if self._value is None:
                raise deferred_error()
            return self._value

        def _init_impl(self, *a, **kw):
            self._value = FakeNDArray(
                np.full(2, float(100 * (hmx.rank() + 1)), np.float32))

    class ParamDict:
        def __init__(self, p):
            self._p = p

        def items(self):
            return self._p.items()

    ready = Param("p0", FakeNDArray(np.full(2, float(r), np.float32)))
    deferred = Param("p1")
    hmx.broadcast_parameters(ParamDict({{"p0": ready, "p1": deferred}}))
    out["ready_after_bcast"] = ready.data().asnumpy().tolist()
    deferred._init_impl()
    out["deferred_after_init"] = deferred.data().asnumpy().tolist()
    hmx.shutdown()
    print(json.dumps(out), flush=True)
""")


def test_mxnet_frontend_two_process(tmp_path):
    """The reference's two-process sequence in a gloo world of two
    launched by ``python -m horovod_tpu_torch.run -np 2``: every rank
    ends with the values the reference's test asserts."""
    worker = tmp_path / "mx_worker.py"
    worker.write_text(WORKER.format(tests=str(REPO / "tests")))
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               HVDTPU_CYCLE_TIME="2", JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2",
         sys.executable, str(worker)],
        capture_output=True, text=True, env=env, timeout=180,
        cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    for rank in (0, 1):
        tag = f"[{rank}]"
        res = [json.loads(ln[len(tag):]) for ln in proc.stdout.splitlines()
               if ln.startswith(tag + "{")]
        assert len(res) == 1, proc.stdout[-2000:]
        res = res[0]
        assert res["allreduce_"] == [3.0, 3.0, 3.0]      # 1 + 2
        assert res["broadcast_"] == [1.0, 1.0]           # root 1's value
        assert res["effective_grad"] == [1.5, 1.5]       # (1 + 2) / 2
        assert res["param_after_bcast"] == [10.0, 10.0]
        assert res["ready_after_bcast"] == [0.0, 0.0]    # root 0's value
        assert res["deferred_after_init"] == [100.0, 100.0]
