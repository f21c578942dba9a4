"""SQL Q5 and Q12 over TPC-H SF 0.01 in session tables, held to the JAX
package's `run_sql`, the port's TPCHCatalog and the oracles on both
tiers as test_torch_session_tpch.py holds the other texts. Q5's JAX
program takes the longest to build (about 37 s with a cold compile
cache), so these run in a file of their own."""

import pytest

from test_torch_session_tpch import check_text, loaded  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("q", [5, 12])
def test_text_over_session_tables_matches_both_catalogs(  # noqa: F811
        loaded, q):
    check_text(loaded, q)
