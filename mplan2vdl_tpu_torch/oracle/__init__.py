"""Independent numpy oracles for the TPC-H query set.

Each oracle implements a query's relational semantics directly on the
column store's encoded numpy arrays — sharing *nothing* with the
parser/IR/engine path except the data encoding — and mirrors the
framework's arithmetic contract (scaled-integer decimals, C-style
truncating division, the reference's year() approximation window)."""
