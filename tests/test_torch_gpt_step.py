"""The port's GPT training step, as a whole, held against the JAX
package's on the CPU.

``train.build_gpt_step("nano", "fp32", 4, 32)`` (flash attention, whose
CPU route is the plain versions the CUDA kernels are held to on the card)
against the root ``bench.build_gpt_step("nano", "fp32", 4, 32)`` (the
Pallas kernels in interpret mode), both in a world of one: the port in one
gloo process, the reference on a 1-device mesh.  Both start from the
reference's ``PRNGKey(0)`` weights (mapped by ``models/convert.py``) and
take their tokens from the same ``RandomState(0)``; three AdamW steps.

Tolerances (fp32 sums in other orders through three steps): losses within
2e-5 absolute and relative, measured 4.3e-6 (6.1e-7 relative); parameters
within 2 x steps x lr = 6e-4 absolute everywhere (AdamW moves an element
whose gradient is at fp32 rounding level by up to lr = 1e-4 a step in a
direction rounding decides, as in tests/test_torch_optim.py; measured
9.5e-5), and within 1e-6 on all but 0.1% of the elements, measured 0.043%.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import _torch_world
import bench as root_bench
import horovod_tpu as jhvd
from horovod_tpu_torch.models import params_from_jax

STEPS, BATCH, SEQ, BLOCK = 3, 4, 32, 16
LOSS_TOL = 2e-5
PARAM_TOL = 2 * STEPS * 1e-4
CLOSE_TOL, CLOSE_SHARE = 1e-6, 1e-3


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


@pytest.fixture(scope="module")
def reference(monkeypatch_module):
    """The root bench's GPT step on one device: initial weights (port
    names), losses, tokens and the parameters after."""
    device = jax.devices()[:1]
    monkeypatch_module.setattr(jhvd, "num_devices", lambda: 1)
    monkeypatch_module.setattr(
        jhvd, "mesh", lambda shape="flat": Mesh(np.asarray(device),
                                                (jhvd.DP_AXIS,)))
    step, state, static = root_bench.build_gpt_step(
        "nano", "fp32", BATCH, SEQ, flash_block_q=BLOCK,
        flash_block_k=BLOCK)
    assert static == {"n_chips": 1, "global_batch": BATCH, "carry_len": 2}
    to_port = lambda params: {
        k: v.numpy() for k, v in params_from_jax(
            jax.tree_util.tree_map(np.asarray, params)).items()}
    init = to_port(state[0])
    tokens = np.asarray(state[2])
    losses = []
    for _ in range(STEPS):
        state = step(*state)
        losses.append(float(state[2]))
        state = (state[0], state[1], tokens)
    return {"init": init, "losses": losses, "tokens": tokens,
            "params": to_port(state[0])}


@pytest.fixture(scope="module")
def port(reference):
    (res,) = _torch_world.run_world(
        _torch_world.gpt_step_worker,
        (reference["init"], STEPS, BATCH, SEQ, BLOCK), world=1, timeout=120)
    return res


def test_same_tokens_and_batch(reference, port):
    np.testing.assert_array_equal(port["tokens"], reference["tokens"])
    assert port["static"] == {"n_chips": 1, "global_batch": BATCH,
                              "carry_len": 2}


def test_losses_match_jax(reference, port):
    np.testing.assert_allclose(port["losses"], reference["losses"],
                               atol=LOSS_TOL, rtol=LOSS_TOL)


def test_params_match_jax_after_adamw_steps(reference, port):
    want = reference["params"]
    assert set(port["params"]) == set(want)
    far = total = 0
    for name, got in port["params"].items():
        np.testing.assert_allclose(got, want[name], atol=PARAM_TOL, rtol=0,
                                   err_msg=name)
        far += int((np.abs(got - want[name]) > CLOSE_TOL).sum())
        total += got.size
    assert far <= CLOSE_SHARE * total, (far, total)
