"""IO of the port (counterpart: ``alink_tpu/io``): CSV and LibSVM read
and write (local files, globs and http URLs), sharded reads, the
field-blocked loader, databases (``db.py``), Hive (``hive.py``,
``hive_warehouse.py``), Kafka (``kafka.py``), the batch-to-stream
bridge (``directreader.py``) and the bucketing sink (``bucketing.py``).
The connector modules are imported where they are used."""
