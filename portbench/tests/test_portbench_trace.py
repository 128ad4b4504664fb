"""The trace reduction on made-up events, and the port's kernel names."""

from __future__ import annotations

import pathlib

import pytest

from portbench import tracing

CSRC = pathlib.Path(__file__).resolve().parents[2] / "mina_bridge_tpu_torch" / "csrc"


def test_port_kernel_names_are_read_from_the_sources():
    names = tracing.port_kernel_names(CSRC)
    assert {"transcript_kernel", "pow_group_kernel", "padd_kernel", "pdouble_kernel", "padd_fixup_kernel",
            "padd_weight_sum_kernel", "padd_select_scan_kernel", "padd_mixed_select2_scan_kernel"} <= names


def _events():
    ev = tracing.Events()
    ev.spans = [("window", 0, 1000), ("batch", 0, 1000), ("kimchi_verify", 10, 900), ("transcript", 20, 100),
                ("msm", 500, 700), ("tips_hint", 750, 880)]
    # correlation id -> host launch time
    ev.api = {1: 25, 2: 30, 3: 510, 4: 600, 5: 800, 6: 905, 7: 400, 8: 450}
    ev.device = [
        ("void (anonymous namespace)::transcript_kernel<0>(long*)", 100, 200, 1),
        ("void at::native::vectorized_elementwise_kernel<4>(...)", 200, 250, 2),
        ("void (anonymous namespace)::padd_mixed_select2_scan_kernel<1>(...)", 520, 620, 3),
        ("Memcpy DtoH (Device -> Pageable)", 620, 640, 4),
        ("void at::native::reduce_kernel<512, 1>(...)", 850, 870, 5),
        ("void at::native::unrolled_elementwise_kernel(...)", 950, 1100, 6),  # clipped at the window's end
        ("lost_kernel", 300, 310, 99),
        # launched by the verify itself, outside its nested spans (run while the device is busy anyway)
        ("void at::native::index_elementwise_kernel<128, 4>(...)", 100, 120, 7),
        ("void (anonymous namespace)::pow_group_kernel<3>(...)", 520, 540, 8),
    ]
    return ev


def test_reduce_trace_attributes_kernels_and_idle_gaps():
    port = tracing.port_kernel_names(CSRC)
    r = tracing.reduce_trace(_events(), port)
    assert r["window_s"] == pytest.approx(1000e-9)
    # busy: [100, 250] + [300, 310] + [520, 640] + [850, 870] + [950, 1000]
    assert r["busy_s"] == pytest.approx((150 + 10 + 120 + 20 + 50) * 1e-9)
    assert r["kernels"] == 8  # the copy is a device op, not a kernel
    assert r["span_device_s"]["transcript"] == pytest.approx(150e-9)
    assert r["span_device_s"]["msm"] == pytest.approx(120e-9)
    assert r["span_device_s"]["kimchi_verify"] == pytest.approx((100 + 50 + 100 + 20 + 20 + 20 + 20) * 1e-9)
    # each kernel counts once, for the innermost span open at its launch
    own = r["span_own"]
    assert own["kimchi_verify"] == pytest.approx({"kernels": 2, "device_s": 40e-9, "plain_device_s": 20e-9})
    assert own["transcript"] == pytest.approx({"kernels": 2, "device_s": 150e-9, "plain_device_s": 50e-9})
    assert own["msm"] == pytest.approx({"kernels": 1, "device_s": 100e-9, "plain_device_s": 0.0})
    assert own["tips_hint"] == pytest.approx({"kernels": 1, "device_s": 20e-9, "plain_device_s": 20e-9})
    assert own["batch"] == pytest.approx({"kernels": 1, "device_s": 50e-9, "plain_device_s": 50e-9})
    assert sum(v["kernels"] for v in own.values()) == r["kernels"] - 1  # the lost kernel has no launch
    assert r["span_device_s"]["tips_hint"] == pytest.approx(20e-9)
    assert r["unmatched_device_ops"] == 1
    assert r["span_host_s"]["tips_hint"] == pytest.approx(130e-9)
    gaps = dict(r["idle_gaps"])
    # [0, 100] mid 50: transcript; [250, 300] and [310, 520]: kimchi_verify; [640, 850] mid 745: kimchi_verify;
    # [870, 950] mid 910: batch
    assert gaps == pytest.approx({"transcript": 100e-9, "kimchi_verify": (50 + 210 + 210) * 1e-9, "batch": 80e-9})
    assert r["device_ops"][0][0].startswith("void (anonymous namespace)::transcript_kernel")


def test_reduce_trace_needs_its_window():
    ev = _events()
    ev.spans = [s for s in ev.spans if s[0] != "window"]
    with pytest.raises(ValueError):
        tracing.reduce_trace(ev, set())
