"""The port's entry contracts (``k210_yolo_framework_tpu_torch/entry.py``)
against the root ``__graft_entry__.py`` (the JAX package's): ``entry()``'s
forward on the JAX entry's weights, bridged, against the JAX entry's
forward (fp32, 1e-5, ``test_torch_model.py``'s tolerance), on the
contract's zero images and on random ones; the mesh rule; and
``dryrun_multichip(n, device="cpu")`` as a world of gloo processes on the
CPU (4 here, 8 marked slow as the root's own dryrun tests are;
``chip_smoke.py`` runs 8 ranks sharing the card and 1 over NCCL).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from k210_yolo_framework_tpu.training.checkpoint import _flatten
from k210_yolo_framework_tpu_torch import entry as TE
from k210_yolo_framework_tpu_torch.training import checkpoint as TC

torch.set_num_threads(1)


def test_entry_matches_the_jax_entry():
    jax_forward, (variables, jax_images) = graft.entry()
    forward, (net, images) = TE.entry("cpu")
    assert tuple(images.shape) == jax_images.shape == (8, 224, 320, 3)
    assert images.dtype == torch.float32 and not images.any()
    assert not net.training
    flat = {f"{g}/{k}": np.asarray(v) for g in ("params", "batch_stats")
            for k, v in _flatten(variables[g]).items()}
    net.load_state_dict(TC.state_dict_from_flat(flat, net))
    rng = np.random.default_rng(0)
    noise = rng.uniform(0, 1, (8, 224, 320, 3)).astype(np.float32)
    jitted = jax.jit(jax_forward)    # one compile for both batches
    for x_t, x_j in ((images, jax_images),
                     (torch.from_numpy(noise), jnp.asarray(noise))):
        with torch.no_grad():
            got = forward(net, x_t)
        want = jitted(variables, x_j)
        assert isinstance(got, tuple) and len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-5)


def test_entry_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("the refusal is that of a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.entry()


def test_dryrun_refuses_a_missing_card():
    """The dryrun runs on the card unless asked for the CPU: with none it
    raises before it spawns a rank."""
    if torch.cuda.is_available():
        pytest.skip("the refusal is that of a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.dryrun_multichip(4)


@pytest.mark.parametrize("n,dims", [(1, (1, 1, 1)), (2, (1, 2, 1)),
                                    (4, (2, 2, 1)), (6, (3, 2, 1)),
                                    (8, (2, 2, 2)), (16, (4, 2, 2))])
def test_mesh_rule_is_the_roots(n, dims):
    """``__graft_entry__.dryrun_multichip``'s rule: sp 2 where n divides by
    4 and n >= 8, mp 2 where n is even, the rest data."""
    assert TE.mesh_dims(n) == dims


def _dryrun(n, capsys):
    TE.dryrun_multichip(n, device="cpu")
    out = capsys.readouterr().out
    dp, mp, sp = TE.mesh_dims(n)
    assert (f"dryrun_multichip({n}) OK: mesh {{'data': {dp}, 'model': {mp}, "
            f"'space': {sp}}}, loss ") in out
    assert "sharded serving matches single-device (" in out
    assert f"{n} gloo processes on the CPU" in out


def test_dryrun_multichip_4(capsys):
    _dryrun(4, capsys)


@pytest.mark.slow
def test_dryrun_multichip_8(capsys):
    _dryrun(8, capsys)
