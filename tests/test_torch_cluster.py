"""The port's cluster-log tooling (``repro_torch.cluster``) against
``repro.cluster``: the synthetic logs of both kinds are the same records
for the same size and seed, and the CSV round trip, the GPU-hour-weighted
CDF and its percentiles equal the reference's, float for float."""
from __future__ import annotations

import dataclasses

import pytest

from repro.cluster import logs as ref
from repro_torch.cluster import logs as port

PERCENTILES = (0.1, 0.25, 0.5, 0.75, 0.9, 0.9999)


def _rows(records):
    return [dataclasses.astuple(r) for r in records]


@pytest.mark.parametrize("kind,n,seed", [("instructional", 4000, 0),
                                         ("instructional", 300, 7),
                                         ("research", 4000, 0),
                                         ("research", 300, 3)])
def test_synthetic_logs_equal_the_reference(kind, n, seed):
    want = ref.synthesize_cluster_log(kind, n=n, seed=seed)
    got = port.synthesize_cluster_log(kind, n=n, seed=seed)
    assert _rows(got) == _rows(want)
    text = port.to_csv(got)
    assert text == ref.to_csv(want)
    back, ref_back = port.parse_salloc_log(text), ref.parse_salloc_log(text)
    assert _rows(back) == _rows(ref_back)
    for gpu in (None, *sorted({r.gpu_type for r in want})):
        cdf = port.gpu_hour_weighted_cdf(back, gpu)
        ref_cdf = ref.gpu_hour_weighted_cdf(ref_back, gpu)
        assert cdf == ref_cdf
        assert [port.percentile_of(cdf, p) for p in PERCENTILES] == \
            [ref.percentile_of(ref_cdf, p) for p in PERCENTILES]


def test_parse_reads_a_file_and_rejects_an_unknown_kind(tmp_path):
    path = tmp_path / "alloc.csv"
    path.write_text(port.to_csv(port.synthesize_cluster_log(n=20)))
    assert _rows(port.parse_salloc_log(path)) == \
        _rows(ref.parse_salloc_log(path))
    assert port.gpu_hour_weighted_cdf([], "H100") == []
    with pytest.raises(ValueError):
        port.synthesize_cluster_log("unknown")
