"""The port's checkpoints against the JAX package's
(``training/checkpoint.py`` and ``port.py``): the train state resumed bit
for bit, the native ``.h5`` and its ``.npz`` twin both ways, reference
Keras ``.h5`` files of all four builders, and the guards.
"""

import h5py
import numpy as np
import pytest
import torch

from k210_yolo_framework_tpu import port as JPort
from k210_yolo_framework_tpu.training import checkpoint as JCK
from k210_yolo_framework_tpu.training.checkpoint import _flatten
from k210_yolo_framework_tpu_torch import config as TConfig
from k210_yolo_framework_tpu_torch import port as TPort
from k210_yolo_framework_tpu_torch.training import checkpoint as TC
from k210_yolo_framework_tpu_torch.training import train as TT

from test_torch_model import SMALL, jax_net_and_flat, torch_net
from test_torch_predictor import TSPEC
from test_torch_pruning import PCFG, _jax_state
from test_torch_train import _batch, _t
from torch_parity import jax_weights, port_net

torch.set_num_threads(1)


def _flat_of(variables):
    return {f"{g}/{k}": np.asarray(v) for g in ("params", "batch_stats")
            for k, v in _flatten(variables[g]).items()}


def _assert_sd_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


# ---- the train state -----------------------------------------------------

@pytest.mark.parametrize("prune", [False, True])
def test_state_resumes_bit_for_bit(tmp_path, prune):
    """Two steps, save; the saved run and a restored fresh state each take
    a third step: weights, BN statistics, Adam's moments, masks, P/R
    counters and logs equal bit for bit."""
    _, _, flat = jax_net_and_flat()
    cfg = TConfig.TrainConfig(**{**PCFG, "is_prune": prune})
    step = TT.make_train_step(TSPEC, cfg, train_epoch_step=3)
    a = TT.create_train_state(torch_net(flat), cfg, "cpu")
    for seed in (50, 51):
        images, labels = _batch(seed)
        a, _ = step(a, _t(images), [_t(l) for l in labels])
    TC.save_state(str(tmp_path / "ckpt"), a)

    b = TT.create_train_state(torch_net(), cfg, "cpu")   # other weights
    assert b.step == 0
    assert TC.restore_state(str(tmp_path / "ckpt"), b) is b
    assert b.step == a.step == 2
    images, labels = _batch(52)
    a, logs_a = step(a, _t(images), [_t(l) for l in labels])
    b, logs_b = step(b, _t(images), [_t(l) for l in labels])
    assert sorted(logs_a) == sorted(logs_b)
    for k in logs_a:
        assert float(logs_a[k]) == float(logs_b[k]), k
    _assert_sd_equal(b.net.state_dict(), a.net.state_dict())
    pa, pb = dict(a.net.named_parameters()), dict(b.net.named_parameters())
    for n in pa:
        sa, sb = a.optimizer.state[pa[n]], b.optimizer.state[pb[n]]
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[k], sb[k]), (n, k)
    assert sorted(a.masks) == sorted(b.masks) and bool(a.masks) == prune
    for n in a.masks:
        assert torch.equal(a.masks[n], b.masks[n]), n
    for k in a.pr:
        assert torch.equal(a.pr[k], b.pr[k]), k
    # the directory also loads as weights
    _assert_sd_equal(TC.load_variables(str(tmp_path / "ckpt"),
                                       "yolo_mobilev1", torch_net()),
                     {k: v for k, v in torch.load(
                         tmp_path / "ckpt" / TC.STATE_FILE,
                         weights_only=True)["net"].items()})


def test_restore_into_a_pruning_state_from_an_unpruned_run(tmp_path):
    """An unpruned run saved no masks: a pruning state restored from it
    keeps all-ones masks (as JAX's unpruned state carries them)."""
    _, _, flat = jax_net_and_flat()
    plain = TT.create_train_state(torch_net(flat), TConfig.TrainConfig(),
                                  "cpu")
    TC.save_state(str(tmp_path / "ckpt"), plain)
    pruning = TT.create_train_state(torch_net(), TConfig.TrainConfig(
        **PCFG), "cpu")
    TC.restore_state(str(tmp_path / "ckpt"), pruning)
    assert pruning.masks and all(bool((m == 1).all())
                                 for m in pruning.masks.values())
    assert float(pruning.sparsity) == 0.0


# ---- the native .h5 and .npz ---------------------------------------------

def test_port_h5_and_npz_read_by_jax_bit_for_bit(tmp_path):
    jnet, variables, flat = jax_net_and_flat()
    net = torch_net(flat)
    TC.save_h5(str(tmp_path / "w.h5"), net)
    TC.save_npz(str(tmp_path / "w.npz"), net)
    template = {"params": variables["params"],
                "batch_stats": variables["batch_stats"]}
    got = _flat_of(JCK.load_h5(str(tmp_path / "w.h5"), template))
    assert sorted(got) == sorted(flat)
    for k in flat:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], flat[k], err_msg=k)
    with np.load(tmp_path / "w.npz") as z, \
            h5py.File(tmp_path / "w.h5", "r") as f:
        assert sorted(z.files) == sorted(flat)
        for k in z.files:
            np.testing.assert_array_equal(z[k], f[k][()], err_msg=k)


def test_jax_h5_read_by_the_port_bit_for_bit(tmp_path):
    _, variables, flat = jax_net_and_flat()
    JCK.save_h5(str(tmp_path / "j.h5"), variables)
    want = TC.state_dict_from_flat(flat, torch_net())
    _assert_sd_equal(TC.load_variables(str(tmp_path / "j.h5"),
                                       "yolo_mobilev1", torch_net()), want)
    # and back out through the port's npz: the same keys and values
    net = torch_net()
    net.load_state_dict(TC.load_variables(str(tmp_path / "j.h5"),
                                          "yolo_mobilev1", net))
    TC.save_npz(str(tmp_path / "p.npz"), net)
    _assert_sd_equal(TC.load_variables(str(tmp_path / "p.npz"),
                                       "yolo_mobilev1", torch_net()), want)


# ---- reference Keras .h5 --------------------------------------------------

_BUILDERS = [("yolo_mobilev1", 0.5), ("yolo_mobilev2", 0.5),
             ("tiny_yolo", 1.0), ("yolo", 1.0)]


@pytest.mark.parametrize("name,alpha", _BUILDERS,
                         ids=[b[0] for b in _BUILDERS])
def test_reference_h5_loads_like_jax(tmp_path, name, alpha):
    """JAX's ``save_reference_h5`` writes a Keras-layout file; the port's
    ``load_variables`` reads it into the state dict JAX's
    ``port_reference_h5`` gives, bridged.  The port's own
    ``save_reference_h5`` writes the same datasets and layer order."""
    in_hw = (96, 96) if name != "yolo" else (64, 64)
    _, variables, flat = jax_weights(name, in_hw, 3, 4, alpha=alpha)
    path = str(tmp_path / "ref.h5")
    JPort.save_reference_h5(path, variables, name)
    template = {"params": variables["params"],
                "batch_stats": variables["batch_stats"]}
    ported, missing = JPort.port_reference_h5(path, name, template)
    assert missing == []
    net = port_net(name, in_hw, 3, 4, alpha=alpha)
    want = TC.state_dict_from_flat(_flat_of(ported), net)
    _assert_sd_equal(TC.load_variables(path, name, net), want)

    mine = str(tmp_path / "mine.h5")
    TPort.save_reference_h5(mine, flat, name)
    with h5py.File(path, "r") as a, h5py.File(mine, "r") as b:
        assert list(a.attrs["layer_names"]) == list(b.attrs["layer_names"])
        names = []
        a.visititems(lambda n, o: names.append(n)
                     if isinstance(o, h5py.Dataset) else None)
        for n in names:
            np.testing.assert_array_equal(a[n][()], b[n][()], err_msg=n)


def test_reference_h5_missing_layers_are_named(tmp_path, capsys):
    """A backbone-only file: the head stays as the net had it."""
    _, variables, flat = jax_net_and_flat()
    path = str(tmp_path / "ref.h5")
    JPort.save_reference_h5(path, variables, "yolo_mobilev1")
    with h5py.File(path, "a") as f:
        for layer in [k for k in f if k.startswith(("conv2d",
                                                    "batch_normalization"))]:
            del f[layer]
    net = torch_net()
    before = net.state_dict()
    got = TC.load_variables(path, "yolo_mobilev1", net)
    assert "8 layers absent" in capsys.readouterr().out
    want = TC.state_dict_from_flat(flat)
    for k in got:
        ref = before[k] if k.startswith("head.") else want[k]
        assert torch.equal(got[k], ref), k


# ---- guards ---------------------------------------------------------------

def test_shape_mismatch_and_foreign_layouts_raise(tmp_path):
    _, _, flat = jax_net_and_flat()
    TC.save_npz(str(tmp_path / "w.npz"), torch_net(flat))
    wider = port_net("yolo_mobilev1", SMALL["in_hw"], 3, 3, alpha=0.5)
    with pytest.raises(ValueError, match="shape"):
        TC.load_variables(str(tmp_path / "w.npz"), "yolo_mobilev1", wider)
    TC.save_h5(str(tmp_path / "w.h5"), torch_net(flat))
    with pytest.raises(ValueError, match="shape"):
        TC.load_variables(str(tmp_path / "w.h5"), "yolo_mobilev1", wider)
    np.savez(tmp_path / "foreign.npz", **{"weights/conv1": np.zeros(3)})
    with pytest.raises(KeyError, match="not a native checkpoint leaf"):
        TC.load_variables(str(tmp_path / "foreign.npz"), "yolo_mobilev1",
                          torch_net())
    with h5py.File(tmp_path / "foreign.h5", "w") as f:
        f.create_dataset("something/else", data=np.zeros(3))
    with pytest.raises(ValueError, match="no layer of the yolo_mobilev1"):
        TC.load_variables(str(tmp_path / "foreign.h5"), "yolo_mobilev1",
                          torch_net())
    (tmp_path / "w.pt").write_bytes(b"")
    with pytest.raises(ValueError, match="not a checkpoint"):
        TC.load_variables(str(tmp_path / "w.pt"), "yolo_mobilev1",
                          torch_net())
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="not a train-state directory"):
        TC.load_variables(str(tmp_path / "empty"), "yolo_mobilev1",
                          torch_net())


def test_orbax_directory_raises_the_way_across(tmp_path):
    _, variables, _ = jax_net_and_flat()
    JCK.save_state(str(tmp_path / "orbax"), _jax_state(variables))
    for fn in (lambda: TC.load_variables(str(tmp_path / "orbax"),
                                         "yolo_mobilev1", torch_net()),
               lambda: TC.restore_state(str(tmp_path / "orbax"),
                                        TT.create_train_state(
                                            torch_net(),
                                            TConfig.TrainConfig(), "cpu"))):
        with pytest.raises(ValueError, match="orbax") as e:
            fn()
        assert "save_h5" in str(e.value) and "load_variables" in str(e.value)


def test_write_args_txt_is_jax_byte_for_byte(tmp_path):
    args = {"train_set": "voc", "image_size": (224, 320), "pre_ckpt": "None",
            "depth_multiplier": 0.75, "batch_size": 16, "mesh": "",
            "output_size": [7, 10, 14, 20], "init_learning_rate": 0.001}
    JCK.write_args_txt(args, str(tmp_path / "j.txt"))
    TC.write_args_txt(args, str(tmp_path / "p.txt"))
    assert (tmp_path / "p.txt").read_bytes() == \
        (tmp_path / "j.txt").read_bytes()


def test_train_state_fields_default_for_an_unpruned_run():
    state = TT.create_train_state(torch_net(), TConfig.TrainConfig(), "cpu")
    assert state.masks == {} and state.sparsity is None
