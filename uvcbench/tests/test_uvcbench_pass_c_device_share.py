"""pass_c_device_share on synthetic runs: the share of regions whose pass
C ran on the card, over every leg of the window's completed jobs, and None
for a program that does not count them."""

import types

import pytest

from uvcbench.harness import load_reader


def _run(*jobs, failed=()):
    js = [dict(reads=1000, ok=True, legs=legs) for legs in jobs]
    js += [dict(reads=1000, ok=False, legs=legs) for legs in failed]
    return types.SimpleNamespace(jobs=js, ok_jobs=[j for j in js if j["ok"]])


def test_share_over_every_leg_of_the_completed_jobs():
    read = load_reader("pass_c_device_share")
    run = _run([dict(regions=4, pass_c_device=4)],
               [dict(regions=4, pass_c_device=2),
                dict(regions=4, pass_c_device=4)],
               failed=[[dict(regions=4, pass_c_device=0)]])
    assert read(run) == pytest.approx(100.0 * 10 / 12)


@pytest.mark.parametrize("legs", [[dict(regions=4, families_device=4)], [],
                                  [dict(regions=0, pass_c_device=0)]])
def test_none_without_the_count(legs):
    read = load_reader("pass_c_device_share")
    assert read(_run(legs) if legs else _run()) is None
