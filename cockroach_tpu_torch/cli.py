"""CLI — the operator surface (reference: pkg/cli cobra commands
`cockroach sql|demo|workload|...`).

    python -m cockroach_tpu_torch sql [--sf X] [--capacity N]
                                      [--device DEV] [-e SQL ...]

Counterpart of cockroach_tpu/cli.py for its `sql` command: a shell over
the TPC-H catalog (generated data), with EXPLAIN [ANALYZE], SET and SHOW,
through a read-only Session (sql/session.py) on `--device` (CUDA unless
given). `decimal_text`, `decode_column`, `format_rows`,
`split_statements`, `run_statement` and `shell` are the JAX package's.
The `demo`, `workload`, `start`, `debug` and `bench` commands wait for
the storage, serving and benchmark layers (ROADMAP.md queue 1, items 6
and 8).
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

import numpy as np


# ------------------------------------------------------------- rendering --

def decimal_text(v: int, scale: int) -> str:
    """Exact scaled-int64 -> decimal text (no float round trip)."""
    if scale == 0:
        return str(v)
    sign = "-" if v < 0 else ""
    q, r = divmod(abs(int(v)), 10 ** scale)
    return f"{sign}{q}.{r:0{scale}d}"


def decode_column(vals, valid, ty, dictionary) -> List[Optional[str]]:
    """One result column -> text values (None = SQL NULL). The single
    decode used by the CLI table renderer and the pgwire data rows."""
    import datetime as _dt

    from cockroach_tpu_torch.coldata.batch import Kind

    # fast path for the overwhelmingly common shape — a plain integer
    # column with no dictionary and no special rendering: tolist()
    # converts to Python ints in C, so the per-element cost is one str()
    # instead of an isinstance chain over np scalars (this is the pgwire
    # serving path's per-row hot loop)
    a = np.asarray(vals) if not isinstance(vals, np.ndarray) else vals
    if (dictionary is None and a.ndim == 1 and a.dtype.kind in "iu"
            and (ty is None or ty.kind not in (Kind.DECIMAL, Kind.DATE,
                                               Kind.VECTOR))):
        out = [str(x) for x in a.tolist()]
        if valid is not None and len(valid) == len(out):
            vv = np.asarray(valid)
            if not vv.all():
                for i in np.nonzero(~vv)[0].tolist():
                    out[i] = None
        return out

    epoch = _dt.date(1970, 1, 1)
    out: List[Optional[str]] = []
    for i in range(len(vals)):
        if valid is not None and len(valid) == len(vals) \
                and not bool(valid[i]):
            out.append(None)
        elif dictionary is not None:
            code = int(vals[i])
            out.append(str(dictionary[code])
                       if 0 <= code < len(dictionary) else f"?{code}")
        elif ty is not None and ty.kind is Kind.DECIMAL:
            out.append(decimal_text(int(vals[i]), ty.scale))
        elif ty is not None and ty.kind is Kind.DATE:
            out.append(str(epoch + _dt.timedelta(days=int(vals[i]))))
        elif (ty is not None and ty.kind is Kind.VECTOR) \
                or isinstance(vals[i], np.ndarray):
            # pgvector text format: '[1,2.5,...]'
            out.append("[" + ",".join(
                f"{float(x):g}" for x in np.asarray(vals[i]).ravel()) + "]")
        elif isinstance(vals[i], (np.floating, float)):
            out.append(f"{float(vals[i]):.4f}")
        else:
            out.append(str(vals[i]))
    return out


def format_rows(result: dict, schema, limit: int = 25) -> List[str]:
    """Columns dict -> aligned text table (dictionary strings decoded)."""
    names = [n for n in result if not n.endswith("__valid")]
    if not names:
        return ["(no columns)"]
    decoded = {}
    for n in names:
        vals = result[n]
        valid = result.get(n + "__valid")
        d = None
        ty = None
        if schema is not None:
            try:
                ty = schema.field(n).type
                d = schema.dictionary(n)
            except KeyError:
                pass
        col = decode_column(vals, valid, ty, d)
        decoded[n] = [("NULL" if v is None else v) for v in col]
    n_rows = len(decoded[names[0]])
    shown = min(n_rows, limit)
    widths = {n: max(len(n), *(len(decoded[n][i]) for i in range(shown))
                     if shown else [len(n)]) for n in names}
    sep = "+".join("-" * (widths[n] + 2) for n in names)
    lines = [" | ".join(n.ljust(widths[n]) for n in names), sep]
    for i in range(shown):
        lines.append(" | ".join(decoded[n][i].ljust(widths[n])
                                for n in names))
    if n_rows > shown:
        lines.append(f"... ({n_rows} rows total)")
    else:
        lines.append(f"({n_rows} row{'s' if n_rows != 1 else ''})")
    return lines


def split_statements(buf: str):
    """Split buffered input on ';' outside string literals ('' escapes).
    -> (complete statements, remaining buffer)."""
    stmts = []
    cur = []
    in_str = False
    i = 0
    while i < len(buf):
        ch = buf[i]
        if ch == "'":
            in_str = not in_str
            cur.append(ch)
        elif ch == ";" and not in_str:
            s = "".join(cur).strip()
            if s:
                stmts.append(s)
            cur = []
        else:
            cur.append(ch)
        i += 1
    return stmts, "".join(cur)


# ----------------------------------------------------------------- shell --

def run_statement(sql: str, catalog, capacity: int,
                  session=None) -> List[str]:
    from cockroach_tpu_torch.sql.bind import BindError
    from cockroach_tpu_torch.sql.explain import execute_with_plan
    from cockroach_tpu_torch.sql.parser import ParseError

    t0 = time.perf_counter()
    try:
        if session is not None:
            kind, payload, schema = session.execute(sql)
        else:
            kind, payload, schema = execute_with_plan(sql, catalog,
                                                      capacity)
    except (ParseError, BindError) as e:
        return [f"error: {e}"]
    except Exception as e:  # engine errors must not kill the shell
        return [f"error: {type(e).__name__}: {e}"]
    elapsed = time.perf_counter() - t0
    if kind == "explain":
        return list(payload)
    if kind == "ok":
        return [str(payload), f"time: {elapsed * 1e3:.0f}ms"]
    lines = format_rows(payload, schema)
    lines.append(f"time: {elapsed * 1e3:.0f}ms")
    return lines


def shell(catalog, capacity: int, statements: Optional[List[str]] = None,
          tables: Optional[List[str]] = None, session=None):
    if statements:
        for s in statements:
            for line in run_statement(s, catalog, capacity, session):
                print(line)
        return
    print("cockroach_tpu_torch SQL shell — \\q quits, \\d lists tables, "
          "EXPLAIN [ANALYZE] supported; end statements with ;")
    buf = ""
    while True:
        try:
            prompt = "> " if not buf else "… "
            line = input(prompt)
        except (EOFError, KeyboardInterrupt):
            print()
            return
        if line.strip() in ("\\q", "exit", "quit"):
            return
        if line.strip() == "\\d":
            for t in (tables or []):
                print(" ", t)
            continue
        buf += line + "\n"
        stmts, buf = split_statements(buf)
        for stmt in stmts:
            for out in run_statement(stmt, catalog, capacity, session):
                print(out)


# -------------------------------------------------------------- commands --

def cmd_sql(args):
    from cockroach_tpu_torch.sql import TPCHCatalog
    from cockroach_tpu_torch.sql.session import Session
    from cockroach_tpu_torch.workload.tpch import TPCH

    catalog = TPCHCatalog(TPCH(sf=args.sf))
    session = Session(catalog, args.capacity, device=args.device)
    shell(catalog, args.capacity, args.execute,
          tables=["lineitem", "orders", "customer", "part", "partsupp",
                  "supplier", "nation", "region"], session=session)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="cockroach_tpu_torch",
        description="SQL engine on PyTorch and CUDA: CLI")
    sub = ap.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("sql", help="SQL shell over generated TPC-H data")
    sp.add_argument("--sf", type=float, default=0.01)
    sp.add_argument("--capacity", type=int, default=1 << 14)
    sp.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without "
                         "one)")
    sp.add_argument("-e", "--execute", action="append",
                    help="execute statement and exit (repeatable)")
    sp.set_defaults(fn=cmd_sql)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
