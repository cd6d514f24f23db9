"""The port's ``hybrid`` backend at ``fidelity="packet"`` (the sharded
serial loop, every partition at packet granularity) against the JAX
package's, on the five scenarios of ``benchmarks/ci_regression.py``, on the
CPU.  Both packages run the same host-side event simulator in float64, so
the bar is equality: FCTs, events, granularity and shard reports, compared
with ``==``.  The other fidelities are in tests/test_torch_hybrid.py."""
import pytest

import repro.api as ref_api
import repro_torch.api as port_api
from test_torch_packet import CI_SCENARIOS, assert_same_run, port_scenario


@pytest.mark.parametrize("name", list(CI_SCENARIOS))
def test_hybrid_packet_run_equal_to_reference(name):
    ref_scn = CI_SCENARIOS[name]()
    ref = ref_api.run(ref_scn, backend="hybrid", fidelity="packet")
    port = port_api.run(port_scenario(ref_scn), backend="hybrid", fidelity="packet")
    assert_same_run(port, ref)
    g = port.extras["granularity"]
    assert g["demotions"] == 0 and g["flow_lane_events"] == 0
    assert g["packet_lane_events"] > 0
    assert port.kernel_report is None
