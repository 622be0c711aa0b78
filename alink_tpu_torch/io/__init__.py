"""File IO of the port (counterpart: ``alink_tpu/io``): CSV and LibSVM
read and write, and sharded reads."""
