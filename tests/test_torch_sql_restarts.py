"""Q5's SQL text outgrows the restart budget from SF 0.1 up, in the JAX
package as in the port.

The binder's greedy join order (the JAX binder's, which the port's
reproduces plan for plan) joins the ASIA suppliers with the orders of
their nations' customers on the nation key: a many-to-many join whose
output grows with the scale factor squared while its probe side grows
linearly. Its expand join doubles its output expansion on each
FlowRestart, and at SF 0.1 (capacity 2^17) the flow runs out of its
MAX_RESTARTS = 8 restarts in both packages (at SF 0.01 it fits:
tests/test_torch_sql_tpch.py). The port raises the same FlowRestart
with the same message, and its Session maps it to SQLSTATE 40001, as
the JAX session's map_execution_error does. Q5's hand-built plan
(workload/tpch_queries.py q5_plan) runs at every scale."""

import pytest

from cockroach_tpu.exec.operators import FlowRestart as JFlowRestart
from cockroach_tpu.sql import TPCHCatalog as JCatalog
from cockroach_tpu.sql import run_sql as jrun_sql
from cockroach_tpu.workload.tpch import TPCH as JTPCH
from cockroach_tpu_torch.exec.operators import FlowRestart as TFlowRestart
from cockroach_tpu_torch.sql import run_sql as trun_sql
from cockroach_tpu_torch.sql.plan import TPCHCatalog as TCatalog
from cockroach_tpu_torch.sql.session import Session, SQLError
from cockroach_tpu_torch.workload import tpch_queries as TQ
from cockroach_tpu_torch.workload.tpch import TPCH as TTPCH
from torch_threads import one_torch_thread  # noqa: F401

SF = 0.1
CAP = 1 << 17


def test_q5_text_exhausts_the_restarts_in_both_packages():
    with pytest.raises(JFlowRestart) as want:
        jrun_sql(TQ.SQL[5], JCatalog(JTPCH(sf=SF)), CAP)
    with pytest.raises(TFlowRestart) as got:
        trun_sql(TQ.SQL[5], TCatalog(TTPCH(sf=SF)), CAP, device="cpu")
    assert str(got.value) == str(want.value)


def test_q5_text_through_the_session_is_40001():
    session = Session(TCatalog(TTPCH(sf=SF)), CAP, device="cpu")
    with pytest.raises(SQLError) as e:
        session.execute(TQ.SQL[5])
    assert e.value.pgcode == "40001"
    assert "flow restart budget exhausted" in str(e.value)
