"""SQL Q10 and Q18 over TPC-H SF 0.01 in session tables, held to the JAX
package's `run_sql`, the port's TPCHCatalog and the oracles on both
tiers as test_torch_session_tpch.py holds the other texts. They run
apart from test_torch_session_tpch_b.py so that `--dist loadfile`
spreads the JAX programs' builds."""

import pytest

from test_torch_session_tpch import check_text, loaded  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("q", [10, 18])
def test_text_over_session_tables_matches_both_catalogs(  # noqa: F811
        loaded, q):
    check_text(loaded, q)
