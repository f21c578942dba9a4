"""The sqllogictest-style corpus (tests/testdata/logic/*.txt) through the
port: each file runs in a fresh port `Session` over a port
`SessionCatalog` on an MVCC store (PyEngine, HLC over a ManualClock),
device="cpu", capacity 128, as tests/test_logic.py runs it through the
JAX package. chip_smoke.py's `run_corpus_file` runs a file: its
`parse_corpus` reads the blocks (tests/test_torch_session_parity.py
holds it to test_logic.py's `parse_blocks` on every file), and each
query's rows, rendered with the port's cli.py `decode_column` as
test_logic.py's `render` does (`render_rows`), must equal the file's
expected lines exactly. The files are split over this module and
test_torch_logic_b.py so that `--dist loadfile` spreads them;
chip_smoke.py phase 13 runs the corpus on the card. Neither module
imports JAX, so the card's twins can run beside them."""

import os

import pytest

import chip_smoke
from torch_threads import one_torch_thread  # noqa: F401

DATA = chip_smoke.corpus_files()
HALF = (len(DATA) + 1) // 2


@pytest.mark.parametrize("path", DATA[:HALF],
                         ids=[os.path.basename(p) for p in DATA[:HALF]])
def test_logic_corpus_first_half(path):
    assert chip_smoke.run_corpus_file(path, "cpu") > 0


@pytest.mark.parametrize("error", ["BindError", "RuntimeError"])
def test_statement_error_block_takes_only_user_errors(tmp_path, monkeypatch,
                                                      error):
    """A `statement error` block is answered by the session's user-facing
    errors only: any other exception (a device fault, say) fails the
    file instead of passing as the block's expected error."""
    from cockroach_tpu_torch.sql.bind import BindError
    from cockroach_tpu_torch.sql.session import Session

    path = tmp_path / "one.txt"
    path.write_text("statement error\nselect nothing\n")
    raised = {"BindError": BindError, "RuntimeError": RuntimeError}[error]

    def execute(self, sql):
        raise raised("planted")

    monkeypatch.setattr(Session, "execute", execute)
    if error == "BindError":
        assert chip_smoke.run_corpus_file(str(path), "cpu") == 1
    else:
        with pytest.raises(SystemExit, match="RuntimeError: planted"):
            chip_smoke.run_corpus_file(str(path), "cpu")
