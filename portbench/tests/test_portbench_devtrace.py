"""The device trace's reduction on hand-made events: kernel names to
families, busy time as the union of intervals inside the window, idle
gaps labelled by the spans open across them."""
import pytest

from portbench.devtrace import DeviceTrace, family, short
from portbench.spans import Spans


@pytest.mark.parametrize("name,fam", [
    ("void (anonymous namespace)::flash_tc_kernel<__nv_bfloat16, 128, "
     "true>(Params)", "flash_attention"),
    ("qmm_tc_kernel", "quant_matmul"),
    ("void (anonymous namespace)::qmm_reduce_kernel<float>(float*)",
     "quant_matmul"),
    ("void (anonymous namespace)::dequant_kernel<__nv_bfloat16>(...)",
     "weight_transform"),
    ("split_kernel", "decode_attention"),
    ("nvjet_tst_128x16_64x11_4x1_v_bz_NNT", None),
    ("void at::native::vectorized_elementwise_kernel<4>(int)", None),
    ("Memcpy HtoD (Pinned -> Device)", None),
])
def test_families(name, fam):
    assert family(name) == fam


def test_short_names():
    assert short("void (anonymous namespace)::flash_tc_kernel<x>(y)") == \
        "flash_tc_kernel"
    assert short("void at::native::(anonymous namespace)::reduce_kernel"
                 "<512, 1>(R)") == "at::native::reduce_kernel"
    assert short("Memcpy HtoD (Pinned -> Device)") == \
        "Memcpy HtoD (Pinned -> Device)"


def trace(events, t0=10.0, t1=11.0):
    d = DeviceTrace(True)
    d.offset_ns = 0
    d.t0, d.t1 = t0, t1
    d.events = events
    return d


def ns(s):
    return int(round(s * 1e9))


def test_busy_is_the_union_inside_the_window():
    ev = [("flash_tc_kernel", ns(9.9), ns(0.2)),        # 0.1 s inside
          ("qmm_tc_kernel", ns(10.2), ns(0.2)),
          ("qmm_tc_kernel", ns(10.3), ns(0.2)),         # overlaps: to 10.5
          ("split_kernel", ns(10.9), ns(0.5))]          # 0.1 s inside
    s = trace(ev).summary()
    assert s["window_s"] == pytest.approx(1.0)
    assert s["busy_s"] == pytest.approx(0.1 + 0.3 + 0.1)
    assert s["family_s"]["flash_attention"] == pytest.approx(0.1)
    assert s["family_s"]["quant_matmul"] == pytest.approx(0.4)
    assert s["family_s"]["decode_attention"] == pytest.approx(0.1)


def test_idle_gaps_by_open_spans():
    sp = Spans()
    sp.items.append(("generate", 1, 10.5, 10.9))
    ev = [("a", ns(10.0), ns(0.5)), ("b", ns(10.9), ns(0.1)),
          ("c", ns(10.9995), ns(0.0001))]
    s = trace(ev).summary(sp)
    gaps = dict((k, v) for k, v in s["breakdown"]["idle_gaps"])
    assert gaps["generate"] == pytest.approx(0.4)
    ops = dict((k, v) for k, v in s["breakdown"]["device_ops"])
    assert ops["a"] == pytest.approx(0.5)
