"""Admission-control units of the port: policies, configuration, ShedError
payload.

The reference's tests/test_admission.py with the imports swapped to
:mod:`repro_torch.serve.admission` (a copy of the reference's module) —
victim selection as a function of (pending, incoming, now), configuration
validation, and the typed shed exception. The engine-integration behavior
lives in tests/test_torch_matfn_async.py::TestAdmissionControl.
"""

import pytest

from repro_torch.serve.admission import (DEFAULT_BYPASS_N, DEFAULT_SLO_MS,
                                         LANES, POLICIES, AdmissionControl,
                                         AdmissionPolicy, DeadlineAware,
                                         PendingView, RejectNewest,
                                         RejectOldest, ShedError)

KEY = ("matpow", 8, "float32", 3)


def _view(arrival, deadline, key=KEY, lane="bulk"):
    return PendingView(key, lane, arrival, deadline)


class TestPolicies:
    def test_reject_newest_never_revokes(self):
        p = RejectNewest()
        pending = [_view(0.0, 5.0), _view(1.0, 4.0)]
        assert p.select_victim(pending, _view(2.0, 3.0), now=2.0) is None
        assert p.select_victim([], _view(2.0, 3.0), now=2.0) is None

    def test_reject_oldest_picks_earliest_arrival(self):
        p = RejectOldest()
        pending = [_view(1.0, 9.0), _view(0.5, 2.0), _view(2.0, 1.0)]
        # arrival decides, not deadline: index 1 arrived first
        assert p.select_victim(pending, _view(3.0, 0.1), now=3.0) == 1

    def test_deadline_aware_picks_least_slack_pending(self):
        p = DeadlineAware()
        pending = [_view(0.0, 9.0), _view(1.0, 2.0)]
        assert p.select_victim(pending, _view(3.0, 8.0), now=3.0) == 1

    def test_deadline_aware_sheds_incoming_when_it_has_least_slack(self):
        p = DeadlineAware()
        pending = [_view(0.0, 9.0), _view(1.0, 8.0)]
        assert p.select_victim(pending, _view(3.0, 3.5), now=3.0) is None

    def test_deadline_aware_tie_prefers_pending(self):
        # min() keeps the first of equals, so a deadline tie revokes the
        # admitted request rather than raising at submit — documented by
        # this test either way so a refactor can't silently flip it.
        p = DeadlineAware()
        pending = [_view(0.0, 5.0)]
        assert p.select_victim(pending, _view(1.0, 5.0), now=1.0) == 0

    def test_registry_names_round_trip(self):
        assert set(POLICIES) == {"reject-newest", "reject-oldest",
                                 "deadline-aware"}
        for name, cls in POLICIES.items():
            assert cls.name == name
            assert issubclass(cls, AdmissionPolicy)

    def test_base_policy_is_abstract(self):
        with pytest.raises(NotImplementedError):
            AdmissionPolicy().select_victim([], _view(0.0, 1.0), now=0.0)


class TestAdmissionControlConfig:
    def test_defaults_reproduce_preadmission_daemon(self):
        ac = AdmissionControl()
        for lane in LANES:
            assert ac.capacity_for(lane) is None     # unbounded
        assert ac.policy.name == "reject-newest"
        assert ac.bypass_n == DEFAULT_BYPASS_N
        assert ac.slo_s_for("latency") == pytest.approx(
            DEFAULT_SLO_MS["latency"] / 1e3)
        assert ac.slo_s_for("bulk") is None

    def test_partial_capacity_mapping(self):
        ac = AdmissionControl(capacity={"bulk": 7})
        assert ac.capacity_for("bulk") == 7
        assert ac.capacity_for("latency") is None

    def test_unknown_lane_rejected(self):
        with pytest.raises(ValueError, match="unknown capacity lane"):
            AdmissionControl(capacity={"vip": 3})
        with pytest.raises(ValueError, match="unknown slo_ms lane"):
            AdmissionControl(slo_ms={"vip": 1.0})

    @pytest.mark.parametrize("cap", [0, -1, 2.5, "8"])
    def test_bad_capacity_rejected(self, cap):
        with pytest.raises(ValueError):
            AdmissionControl(capacity={"bulk": cap})

    @pytest.mark.parametrize("slo", [0.0, -1.0])
    def test_bad_slo_rejected(self, slo):
        with pytest.raises(ValueError):
            AdmissionControl(slo_ms={"latency": slo})

    @pytest.mark.parametrize("bypass", [0, -4, 1.5])
    def test_bad_bypass_rejected(self, bypass):
        with pytest.raises(ValueError):
            AdmissionControl(bypass_n=bypass)

    def test_non_policy_rejected(self):
        with pytest.raises(TypeError):
            AdmissionControl(policy="reject-newest")


class TestShedError:
    def test_payload_and_message(self):
        err = ShedError("latency", 16, 16, "reject-newest", KEY)
        assert err.lane == "latency"
        assert err.queue_depth == 16
        assert err.capacity == 16
        assert err.policy == "reject-newest"
        assert err.key == KEY
        msg = str(err)
        assert "latency" in msg and "16/16" in msg
        assert "reject-newest" in msg and "matpow" in msg

    def test_is_runtime_error(self):
        # Clients catching broad RuntimeError (timeouts, crashes) also see
        # sheds; catching ShedError specifically separates overload.
        assert issubclass(ShedError, RuntimeError)

    def test_key_optional(self):
        err = ShedError("bulk", 3, 3, "deadline-aware")
        assert err.key is None
        assert "key=" not in str(err)
