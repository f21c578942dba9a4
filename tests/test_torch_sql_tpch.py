"""Q5, Q10, Q12, Q16 and Q18 as SQL text through the port's `run_sql`
(device="cpu") against the JAX package's `run_sql` and the port's
oracles, at SF 0.01 and capacity 2^14: bit for bit on int, decimal,
date and dictionary-code columns and validity. The other five texts, the
parser and the binder are in tests/test_torch_sql.py, whose helpers this
file shares."""

import pytest
import torch

from cockroach_tpu.sql import TPCHCatalog as JCatalog
from cockroach_tpu.sql import run_sql as jrun_sql
from cockroach_tpu.workload.tpch import TPCH as JTPCH
from cockroach_tpu_torch.sql import run_sql as trun_sql
from cockroach_tpu_torch.sql.plan import TPCHCatalog as TCatalog
from cockroach_tpu_torch.workload.tpch import TPCH as TTPCH

from test_torch_sql import CAP, assert_same_result, check_oracle, sql_text
from torch_threads import one_torch_thread  # noqa: F401

QUERIES = [5, 10, 12, 16, 18]


@pytest.fixture(scope="module")
def cats():
    return JCatalog(JTPCH(sf=0.01)), TCatalog(TTPCH(sf=0.01))


@pytest.mark.parametrize("q", QUERIES)
def test_sql_run_matches_jax_and_oracle(cats, q):
    jcat, tcat = cats
    want = jrun_sql(sql_text(q), jcat, CAP)
    got = trun_sql(sql_text(q), tcat, CAP, device="cpu")
    assert_same_result(got, want)
    check_oracle(q, got, tcat.gen)


@pytest.mark.cuda
@pytest.mark.parametrize("q", QUERIES)
def test_sql_run_on_card(cats, q):
    """The same texts on a CUDA device equal the CPU run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _jcat, tcat = cats
    want = trun_sql(sql_text(q), tcat, CAP, device="cpu")
    got = trun_sql(sql_text(q), tcat, CAP, device="cuda")
    assert_same_result(got, want)
