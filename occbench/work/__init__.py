"""The yardstick's counts of work: the peaks of the card (peaks.py), the
rulebook pairs and bytes of every sparse convolution (sparse.py), the dense
layers' FLOP (dense.py), and a frozen copy of the dense-grid K2 count that
the port's smoke test used (k2_dense.py), kept only to document it."""
