"""The port's precision module against the reference's
(repro_torch.core.precision vs repro.core.precision): the spec grammar
round-trips identically and safe_beta / plan_precision agree."""

import dataclasses

import pytest

from repro import api as japi
from repro.core import precision as jprec
from repro_torch import api as tapi
from repro_torch.core import precision as tprec

SPECS = [
    "native", "ozaki1-p2", "ozaki1-p4", "ozaki2-m6", "ozaki2-m12",
    "ozaki1-p4@gpu", "ozaki1-p3+cached", "ozaki1-p4@gpu+cached",
    "ozaki2-m6+cached", "ozaki2-m4@gpu+cached", "ozaki1-p4+xla",
    "ozaki2-m8@tpu+pallas", "native@xla", "ozaki1-p4+guard",
    "ozaki1-p3+guard:strict", "ozaki1-p4@cuda",
]


@pytest.mark.parametrize("spec", SPECS)
def test_spec_roundtrip_matches_reference(spec):
    cfg = tapi.precision(spec)
    assert cfg.to_spec() == spec
    assert tprec.EmulationConfig.parse(cfg.to_spec()) == cfg
    assert dataclasses.asdict(cfg) == dataclasses.asdict(japi.precision(spec))


@pytest.mark.parametrize("spec", ["bits=20", "bits=50:k1024", "bits=40"])
def test_planned_specs_match_reference(spec):
    assert (dataclasses.asdict(tapi.precision(spec))
            == dataclasses.asdict(japi.precision(spec)))


@pytest.mark.parametrize("bad", ["ozaki1-m4", "ozaki3-p2", "native+cached",
                                 "ozaki1-p4+nope", "ozaki1-p4@a@b"])
def test_bad_specs_raise_like_reference(bad):
    with pytest.raises(ValueError):
        japi.precision(bad)
    with pytest.raises(ValueError):
        tapi.precision(bad)


def test_safe_beta_matches_reference():
    for k in list(range(1, 300)) + [2 ** e + d for e in range(8, 20)
                                    for d in (-1, 0, 1)]:
        assert tprec.safe_beta(k) == jprec.safe_beta(k), k
    # The slice's shapes (K up to 2^17) all get beta = 7.
    assert {tprec.safe_beta(k) for k in (128, 2048, 8192, 2 ** 17)} == {7}
    with pytest.raises(ValueError):
        tprec.safe_beta(0)


def test_resolver_precedence(monkeypatch):
    monkeypatch.delenv(tapi.EMULATION_ENV_VAR, raising=False)
    assert tapi.resolve_config() == tprec.NATIVE
    assert tapi.resolve_config(default="ozaki1-p4").p == 4
    monkeypatch.setenv(tapi.EMULATION_ENV_VAR, "ozaki1-p3")
    assert tapi.resolve_config().p == 3
    with tapi.emulation("ozaki1-p6"):
        assert tapi.resolve_config().p == 6
        assert tapi.resolve_config("ozaki1-p2").p == 2
    assert tapi.resolve_config().p == 3
