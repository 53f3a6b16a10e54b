"""The port's roofline (``launch/roofline.py``) on the CPU.

The terms and the bottleneck with the H100 constants (the twin of
``tests/test_sharding_dryrun.py``'s roofline test), ``_shape_bytes``, the
constants that ``chip_smoke.py`` reads, the traced analysis against
``FlopCounterMode`` and against the reference's ``analyze_hlo`` of the same
reduced llama3-8b forward on one CPU device (FLOPs equal; the traffic
models, which count different ops, within 5%), the kernel roofline of an
elementwise body, ``TorchPlane.roofline_report``, and that the port's
relational dispatch does not read ``is_bandwidth_bound``.  No process group:
these traces run on plain and meta tensors.  The JAX comparison skips where
JAX is missing (the card's machine).
"""

import inspect
import pathlib

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_arch as ref_get_arch
from repro.launch import roofline as REF
from repro_torch.configs import get_arch
from repro_torch.engine.plane import torch_plane
from repro_torch.kernels import relational
from repro_torch.launch import roofline as RL
from repro_torch.models import build_model

ROOT = pathlib.Path(__file__).resolve().parent.parent
TRAFFIC_TOL = 0.05  # relative: the two traffic models count different op sets


def test_roofline_terms_and_bottleneck():
    r = RL.Roofline(flops=1e14, hbm_bytes=1e12, collective_bytes=1e11, model_flops=2e16, n_chips=256)
    assert r.t_compute == pytest.approx(1e14 / 989e12)
    assert r.t_memory == pytest.approx(1e12 / 3.35e12)
    assert r.t_collective == pytest.approx(1e11 / (400e9 / 8))
    assert r.bottleneck == "collective"
    assert 0 < r.roofline_fraction < 1
    # a compute-heavy cell on the H100's terms
    r = RL.Roofline(flops=1e15, hbm_bytes=1e12, collective_bytes=1e10, model_flops=2e17, n_chips=256)
    assert r.bottleneck == "compute"
    assert r.useful_flops_ratio == pytest.approx(2e17 / (1e15 * 256))


def test_roofline_record_keys_match_reference():
    kw = dict(flops=1e14, hbm_bytes=1e12, collective_bytes=1e11, model_flops=2e16, n_chips=256)
    assert list(RL.Roofline(**kw).as_dict()) == list(REF.Roofline(**kw).as_dict())


def test_model_flops_match_reference():
    assert RL.train_model_flops(8e9, 4096) == REF.train_model_flops(8e9, 4096)
    assert RL.decode_model_flops(8e9, 128) == REF.decode_model_flops(8e9, 128)


def test_shape_bytes():
    assert RL._shape_bytes((2048, 4096), torch.bfloat16) == 2048 * 4096 * 2
    assert RL._shape_bytes((8,), torch.float32) == 32
    assert RL._shape_bytes((2, 2), torch.bool) == 4
    assert RL._shape_bytes((), torch.int32) == 4
    # the reference's HLO names, and the reference's own parse of the same shapes
    for dims, name in (((2048, 4096), "bf16"), ((8,), "f32"), ((2, 2), "pred"), ((3, 5), "s64")):
        assert RL._shape_bytes(dims, name) == REF._shape_bytes(f"{name}[{','.join(map(str, dims))}]")


def test_h100_constants_are_chip_smokes():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_for_constants", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # defines the phases; runs none
    assert mod.HBM_BYTES_PER_S == RL.HBM_BW == 3.35e12
    assert mod.BF16_TENSOR_FLOP_PER_S == RL.PEAK_FLOPS == 989e12
    assert mod.FP32_FLOP_PER_S == RL.FP32_FLOP_PER_S == 67e12
    assert mod.FP64_FLOP_PER_S == RL.FP64_FLOP_PER_S == 34e12
    # no TPU v5e constant in the port
    assert (RL.PEAK_FLOPS, RL.HBM_BW) != (REF.PEAK_FLOPS, REF.HBM_BW)


def _reduced_llama(attn_impl="reference"):
    return build_model(get_arch("llama3-8b").with_reduced(), attn_impl=attn_impl)


def test_analysis_counts_what_flop_counter_counts():
    model = _reduced_llama()
    params = model.init(0, device="cpu")
    tokens = torch.randint(0, 256, (2, 32), generator=torch.Generator().manual_seed(0), dtype=torch.int32)
    with FlopCounterMode(display=False) as fcm:
        want = model.forward(params, tokens)
    got, an = RL.analyze(model.forward, params, tokens)
    assert torch.equal(got, want)
    assert an.flops == fcm.get_total_flops() > 0
    assert an.total_collective_bytes == 0 and an.n_ops > 0
    assert 0 < an.traffic_bytes < an.raw_bytes
    # meta tensors trace the same ops without storage
    _, meta = RL.analyze(model.forward, model.abstract_params(),
                         torch.empty(2, 32, dtype=torch.int32, device="meta"))
    assert (meta.flops, meta.traffic_bytes, meta.n_ops) == (an.flops, an.traffic_bytes, an.n_ops)


def test_forward_flops_match_reference_hlo():
    jax = pytest.importorskip("jax")  # the card's machine has none
    import jax.numpy as jnp

    from repro.models import build_model as ref_build

    ref = ref_build(ref_get_arch("llama3-8b").with_reduced())
    tokens = np.random.default_rng(0).integers(0, 256, (2, 64)).astype(np.int32)
    want = REF.analyze_jitted(lambda p, t: ref.forward(p, t), ref.init(jax.random.PRNGKey(0)),
                              jnp.asarray(tokens))
    model = _reduced_llama()
    _, got = RL.analyze(model.forward, model.abstract_params(),
                        torch.empty(tokens.shape, dtype=torch.int32, device="meta"))
    assert got.flops == want.flops
    assert got.traffic_bytes == pytest.approx(want.traffic_bytes, rel=TRAFFIC_TOL)


def test_kernel_roofline_of_an_elementwise_body():
    x = torch.empty(1_000_000, dtype=torch.float64, device="meta")
    r = RL.kernel_roofline(lambda a, b: 2.5 * a - b, x, x)
    assert r.flops == 0 and r.hbm_bytes == 3 * 8e6  # two reads, one write: the floor
    assert r.bottleneck == "memory" and r.useful_flops_ratio == 0.0
    assert RL.is_bandwidth_bound(lambda a, b: 2.5 * a - b, x, x)
    m = torch.empty(4096, 4096, dtype=torch.bfloat16, device="meta")
    assert not RL.is_bandwidth_bound(lambda a, b: a @ b, m, m)


def test_plane_roofline_report():
    report = torch_plane.TorchPlane(device="cpu").roofline_report(1_000_000)
    assert [r["kernel"] for r in report] == ["filter", "project", "join_probe"]
    for r in report:
        assert set(r) == {"kernel", "rows", "flops", "hbm_bytes", "t_compute_s", "t_memory_s",
                          "bottleneck", "bandwidth_bound"}
        assert r["rows"] == 1_000_000 and r["hbm_bytes"] >= 8e6 and r["bandwidth_bound"]
    # the filter reads three float64 columns and writes a bool mask
    assert report[0]["hbm_bytes"] == 3 * 8e6 + 1e6


def test_relational_dispatch_does_not_read_the_roofline():
    for src in (inspect.getsource(relational), inspect.getsource(torch_plane.TorchPlane.lowers),
                inspect.getsource(torch_plane.TorchPlane.execute_op)):
        assert "is_bandwidth_bound" not in src and "roofline" not in src
