"""A frozen fp32 copy of the port's CoOccRay, its losses and its optimizer,
with every hand-written kernel replaced by its plain version: the reference
the benchmark holds the port to. It imports torch and numpy only."""
