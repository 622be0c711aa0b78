"""Kafka connector.

Counterpart: ``alink_tpu/io/kafka.py``, the re-design of
connectors/connector-kafka* (Kafka*SourceStreamOp / Kafka*SinkStreamOp).
The ops bind to a client through an injectable interface: pass
``consumer=`` / ``producer=`` objects with ``poll(topic)`` /
``send(topic, value)`` (the in-memory ``FakeKafka`` implements both), or
install ``kafka-python``, which ``_KafkaPythonClient`` imports at its
construction. Host only.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Optional

from ..common.mtable import MTable
from ..common.params import ParamInfo
from ..operator.batch.dataproc.format import _cast
from ..common.types import TableSchema
from ..operator.base import StreamOperator
from ..operator.stream.sink.sinks import BaseSinkStreamOp


class FakeKafka:
    """In-memory topic log usable as both consumer and producer side —
    the test double the connector tests run against."""

    def __init__(self):
        self.topics: Dict[str, List[bytes]] = defaultdict(list)

    def send(self, topic: str, value: bytes):
        self.topics[topic].append(
            value if isinstance(value, bytes) else str(value).encode())

    def poll(self, topic: str) -> List[bytes]:
        msgs = self.topics[topic]
        self.topics[topic] = []
        return msgs


class _KafkaPythonClient:
    """Adapter giving kafka-python the poll/send surface the ops use."""

    def __init__(self, bootstrap_servers: str):
        import kafka
        self._kafka = kafka
        self.bootstrap = bootstrap_servers
        self._consumers: Dict[str, object] = {}
        self._producer = None

    def poll(self, topic: str) -> List[bytes]:
        c = self._consumers.get(topic)
        if c is None:
            c = self._kafka.KafkaConsumer(
                topic, bootstrap_servers=self.bootstrap,
                consumer_timeout_ms=1000, auto_offset_reset="earliest")
            self._consumers[topic] = c
        batch = c.poll(timeout_ms=1000)
        return [m.value for msgs in batch.values() for m in msgs]

    def send(self, topic: str, value: bytes):
        if self._producer is None:
            self._producer = self._kafka.KafkaProducer(
                bootstrap_servers=self.bootstrap)
        self._producer.send(topic, value)


def _default_client(bootstrap_servers: Optional[str]):
    try:
        import kafka  # noqa: F401  (kafka-python)
    except ImportError:
        raise ImportError(
            "no Kafka client installed and no consumer/producer injected; "
            "install kafka-python or pass a client object (e.g. FakeKafka)")
    if not bootstrap_servers:
        raise ValueError("bootstrap_servers is required when using the "
                         "installed kafka-python client")
    return _KafkaPythonClient(bootstrap_servers)


class KafkaSourceStreamOp(StreamOperator):
    """reference: Kafka011SourceStreamOp / KafkaSourceStreamOp — reads a
    topic as micro-batches; messages are json or csv per ``format``."""
    TOPIC = ParamInfo("topic", str, "topic to read", optional=False)
    FORMAT = ParamInfo("format", str, "json | csv", default="json")
    SCHEMA_STR = ParamInfo("schema_str", str, "output schema", optional=False)
    FIELD_DELIMITER = ParamInfo("field_delimiter", str, default=",")
    BOOTSTRAP_SERVERS = ParamInfo("bootstrap_servers", str,
                                  "broker list for the installed client")
    MAX_BATCHES = ParamInfo("max_batches", int,
                            "poll rounds before the bounded drain ends",
                            default=1)

    def __init__(self, params=None, consumer=None, **kwargs):
        super().__init__(params, **kwargs)
        self.consumer = (consumer if consumer is not None else
                         _default_client(self.params._m.get("bootstrap_servers")))
        self._schema = TableSchema.parse(self.get_schema_str())
        self._stream_fn = self._gen

    def _gen(self):
        schema = self.get_schema()
        topic = self.get_topic()
        fmt = self.get_format().lower()
        delim = self.get_field_delimiter()
        for b in range(int(self.get_max_batches())):
            msgs = self.consumer.poll(topic)
            rows = []
            for m in msgs:
                s = m.decode() if isinstance(m, bytes) else str(m)
                if fmt == "json":
                    d = json.loads(s)
                    rows.append(tuple(d.get(n) for n in schema.names))
                else:
                    parts = s.split(delim)
                    rows.append(tuple(
                        _cast(parts[i], ty) if i < len(parts) else None
                        for i, ty in enumerate(schema.types)))
            yield float(b), MTable(rows, schema)


class KafkaSinkStreamOp(BaseSinkStreamOp):
    """reference: Kafka011SinkStreamOp / KafkaSinkStreamOp."""
    TOPIC = ParamInfo("topic", str, "topic to write", optional=False)
    FORMAT = ParamInfo("format", str, "json | csv", default="json")
    FIELD_DELIMITER = ParamInfo("field_delimiter", str, default=",")
    BOOTSTRAP_SERVERS = KafkaSourceStreamOp.BOOTSTRAP_SERVERS

    def __init__(self, params=None, producer=None, **kwargs):
        super().__init__(params, **kwargs)
        self.producer = (producer if producer is not None else
                         _default_client(self.params._m.get("bootstrap_servers")))

    def _consume(self, mt: MTable):
        topic = self.get_topic()
        fmt = self.get_format().lower()
        delim = self.get_field_delimiter()
        for r in mt.to_rows():
            if fmt == "json":
                msg = json.dumps(dict(zip(mt.col_names, [_j(v) for v in r])))
            else:
                msg = delim.join("" if v is None else str(v) for v in r)
            self.producer.send(topic, msg.encode())


def _j(v):
    import numpy as np
    return v.item() if isinstance(v, np.generic) else v


# naming parity with the reference's per-kafka-version modules
Kafka011SourceStreamOp = KafkaSourceStreamOp
Kafka011SinkStreamOp = KafkaSinkStreamOp
Kafka010SourceStreamOp = KafkaSourceStreamOp
Kafka010SinkStreamOp = KafkaSinkStreamOp
