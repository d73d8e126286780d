"""The frozen fp32 reference (occref/, a copy of the port's model with every
kernel replaced by its plain version), the benchmark's seeded weights
(weights.py), the reference's forward over the frames a run served
(serve.py), the lower-precision control (control.py) and the numbers that
decide `correct` (compare.py). Nothing here imports the port."""
