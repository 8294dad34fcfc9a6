"""Smoke tests: every bench suite runs end-to-end with --verify semantics
on the CPU backend at tiny sizes. Protects the CLI from rot; the real
numbers come from runs on the card. Each record names the device it ran
on, and off the card its share of peak bandwidth is not measured."""
import pytest

from lsdradixsort.bench import runner


@pytest.mark.parametrize("suite", ["sort", "histogram", "scan", "transpose",
                                   "query"])
def test_suite_runs_and_verifies(suite):
    records = runner.SUITES[suite](16, verify=True, sweep=False)
    assert records, f"suite {suite} produced no records"
    for rec in records:
        assert rec.verified in (True, None), rec.line()
        assert rec.ms > 0
        assert rec.device == "cpu/cpu"
        assert rec.roofline_frac is None
        assert "not measured" in rec.line()


def test_sort_suite_sweep_rows_verify():
    records = runner.SUITES["sort"](14, verify=True, sweep=True)
    names = {r.suite for r in records}
    assert {"sort/64bit", "sort/composed_r8"} <= names
    assert all(r.verified for r in records)


def test_dist_suite_runs():
    records = runner.SUITES["dist"](13, verify=True, sweep=False)
    assert records and records[0].verified in (True, None)
