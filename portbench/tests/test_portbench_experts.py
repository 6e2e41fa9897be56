"""The experts' reader (``moe_route_ms_per_step.gen``) on hand-built
device traces of a batch of 4 decode steps."""
import pytest

from portbench import run as R

SPEC = {"new_tokens": 4}


def _read(ops, trace=True):
    data = {"spec": SPEC}
    if trace:
        data["device_trace"] = {"t0": 0.0, "t1": 1.0, "ops": ops}
    return R.reader(R.ROOT, "moe_route_ms_per_step.gen")(data, None)


def test_none_without_the_kernels():
    assert _read([], trace=False) is None
    assert _read([("void radixSortKVInPlace<...>", 0.1, 2e-5),
                  ("decode_attention_kernel<bf16, 64>", 0.2, 1e-5)]) is None


def test_ms_a_step_over_both_kernels():
    ops = [("moe_dispatch_kernel(DispatchArgs)", 0.10, 10e-6),
           ("void moe_combine_kernel<__nv_bfloat16>(uint4 const*, ...)",
            0.11, 5e-6),
           ("nvjet_tst_256x24", 0.12, 40e-6)]
    # 4 steps, each a dispatch of 10 us and a combine of 5 us
    assert _read(ops * 4) == pytest.approx(4 * 15e-6 * 1e3 / 4)
