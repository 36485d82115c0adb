"""The benchmark's harness: finding a cell's pieces, the window, the
references' shared pieces, the comparison, the trace's reduction."""
