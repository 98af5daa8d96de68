"""The port's row split (parallel/mesh.py, backend.TorchModelBackend with
several slots), its dry run (parallel/dryrun.py) and entry point, on the
CPU, against unsplit runs and against the JAX package.

Bars: a split run equals the unsplit run bit for bit (the model has no
cross-row data flow).  Against JAX (the 8 virtual CPU devices of
tests/conftest.py, x64): tests/test_torch_model.py's bars, float leaves
within rtol 1e-12, int leaves within 1 in at most 0.01% of a leaf's
entries.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_model import assert_leaf_parity
from uvc_tpu import calling as jcalling
from uvc_tpu.parallel import mesh as jmesh
from uvc_tpu_torch.backend import TorchModelBackend
from uvc_tpu_torch.kernels.layout import OUT_NAMES, WireLayout
from uvc_tpu_torch import calling as tcalling
from uvc_tpu_torch.model.example import (example_model_payload,
                                         example_rescued_payload,
                                         packed_request)
from uvc_tpu_torch.parallel import dryrun, mesh

CPU = torch.device("cpu")


def test_factor_mesh_is_the_jax_function():
    for n in range(1, 65):
        assert mesh.factor_mesh(n) == jmesh.factor_mesh(n)


def test_make_mesh_and_plane_split():
    """The grid is (dp, sp) in the order given; the split pads to the
    slot count and gives each slot one contiguous block, row-major."""
    devs = [torch.device("cpu")] * 6
    m = mesh.make_mesh(devs)
    assert (len(m), len(m[0])) == (2, 3)
    Rp, blocks = mesh.plane_split(131, m)
    assert Rp == 132 and [(lo, hi) for _, lo, hi in blocks] == [
        (i * 22, (i + 1) * 22) for i in range(6)]
    assert mesh.plane_split(0, m)[0] == 6      # every slot gets a row
    assert mesh.plane_split(128, mesh.make_mesh(devs[:1]))[1] == [
        (CPU, 0, 128)]


@pytest.fixture(scope="module")
def requests():
    """f64 packed requests: 512 rows, its first 131 rows, and a real
    rescued normal-run request; with their cfgs."""
    arrays, cand, cfg = example_model_payload(n_pos=512, seed=4, pad_to=512)
    whole = packed_request(arrays, cand, "f64")
    odd = (whole[0][:131],) + whole[1:]
    ra, rc, td, tq, rcfg = example_rescued_payload(n_pos=512, seed=5)
    resc = packed_request(ra, rc, "f64", td, tq, is_tumor_only=False)
    return {"512": (whole, cfg), "131": (odd, cfg), "rescued": (resc, rcfg)}


@pytest.mark.parametrize("slots", [8, 3, 1])
@pytest.mark.parametrize("req", ["512", "131", "rescued"])
def test_split_is_bitwise_the_unsplit_run(requests, req, slots):
    packed, cfg = requests[req]
    assert packed[4] == (req == "rescued")
    want = TorchModelBackend("cpu", "f64").eval(packed, cfg)
    be = TorchModelBackend("cpu", "f64", devices=[CPU] * slots)
    got = be.eval(packed, cfg)
    assert got[0].shape[0] == packed[0].shape[0]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert be.split_requests == (slots > 1)
    assert be.padded_requests == (packed[0].shape[0] % slots != 0)


def test_split_refuses_a_slot_without_rows(requests, monkeypatch):
    """A split whose blocks leave a slot empty raises instead of running
    on fewer slots."""
    from uvc_tpu_torch import backend
    packed, cfg = requests["131"]
    be = TorchModelBackend("cpu", "f64", devices=[CPU] * 2)
    monkeypatch.setattr(backend.mesh_mod, "plane_split", lambda R, m: (
        R + 1, [(CPU, 0, R + 1), (CPU, R + 1, R + 1)]))
    with pytest.raises(AssertionError, match="received no rows"):
        be.eval(packed, cfg)


@pytest.mark.parametrize("req", ["512", "131"])
def test_split_against_jax_sharded(requests, req):
    """The port's 8-slot split against the JAX package's model_eval_packed,
    which shards the rows over the 8 CPU devices."""
    assert jax.local_device_count() == 8
    packed, cfg = requests[req]
    joi, jof, jspec = jcalling.model_eval_packed(packed, cfg)
    oi, of, spec = TorchModelBackend(
        "cpu", "f64", devices=[CPU] * 8).eval(packed, cfg)
    assert spec == tuple(jspec)
    lay = WireLayout(packed[2], spec)
    assert_leaf_parity(lay, (joi, jof), (oi, of), OUT_NAMES, 1e-12, 1e-4)


def test_entry_against_jax_model_core():
    """entry("cpu") (f64, the kernels' plain versions) against JAX's
    _model_core on its own 2,048-row example payload, as
    __graft_entry__.entry runs it."""
    from uvc_tpu.model.example import example_model_payload as jpayload
    arrays, cand, cfg = jpayload(n_pos=2048, seed=0)

    @jax.jit
    def jfn(arrays, cand):
        out = jcalling._model_core(arrays, cand, None, None, cfg, True)
        return tuple(out[n] for n in dryrun.ENTRY_OUTPUTS)

    want = [np.asarray(x) for x in jfn(arrays, cand)]
    fn, args = dryrun.entry("cpu")
    got = [x.numpy() for x in fn(*args)]
    for name, w, g in zip(dryrun.ENTRY_OUTPUTS, want, got):
        assert g.shape == w.shape, name
        if name == "cVQ1":
            d = g != w
            assert np.abs(g - w).max() <= 1 and d.sum() <= 1e-4 * d.size
        else:
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0,
                                       err_msg=name)
    plain = [x.numpy() for x in fn(*args, plain=True)]
    for g, p in zip(got, plain):
        np.testing.assert_array_equal(g, p)


def test_dryrun_multidevice_on_four_cpu_slots(capsys, monkeypatch):
    """The dry run over 4 CPU slots at a quarter of its contig length:
    every assertion of the JAX dry run, with the row and record
    thresholds a quarter as high; it leaves the model hooks as it found
    them (unset here, whatever CLI run this process made before)."""
    monkeypatch.setattr(tcalling, "_MODEL_EVAL", None)
    monkeypatch.setattr(tcalling, "_MODEL_CAST_F32", False)
    counts = dryrun.dryrun_multidevice([CPU] * 4, scale=0.25)
    assert counts["mesh"] == (2, 2) and counts["padded_shards"] >= 1
    assert counts["equality_checks"] == 2
    assert counts["tn_equality_checks"] == 1
    assert "dryrun_multidevice: mesh=(2x2) devices=4" in \
        capsys.readouterr().out
    assert tcalling._MODEL_EVAL is None and not tcalling._MODEL_CAST_F32
