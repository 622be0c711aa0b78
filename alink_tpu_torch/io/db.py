"""Relational DB access layer.

Counterpart: ``alink_tpu/io/db.py``, the re-design of common/io/
(BaseDB.java, JdbcDB.java, MySqlDB.java, DerbyDB.java). The JVM's JDBC
surface maps to Python DB-API 2.0: ``JdbcDB`` wraps any DB-API
connection; ``SqliteDB`` (stdlib sqlite3, alias ``DerbyDB``) is the
embedded database standing in for the reference's Derby; ``MySqlDB``
binds to a MySQL DB-API driver at its first connection and raises a
clear ``ImportError`` when none is installed. ``HasDB`` / ``HasMySqlDB``
are the op mixins of the DB sources and sinks. Host only.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ..common.mtable import MTable
from ..common.params import ParamInfo
from ..common.types import AlinkTypes, TableSchema


_SQL_TYPES = {
    AlinkTypes.DOUBLE: "DOUBLE PRECISION", AlinkTypes.FLOAT: "REAL",
    AlinkTypes.LONG: "BIGINT", AlinkTypes.INT: "INTEGER",
    AlinkTypes.BOOLEAN: "BOOLEAN", AlinkTypes.STRING: "VARCHAR(32672)",
}

_FROM_SQL = {
    "DOUBLE": AlinkTypes.DOUBLE, "DOUBLE PRECISION": AlinkTypes.DOUBLE,
    "REAL": AlinkTypes.FLOAT, "FLOAT": AlinkTypes.DOUBLE,
    "BIGINT": AlinkTypes.LONG, "INTEGER": AlinkTypes.INT,
    "INT": AlinkTypes.INT, "BOOLEAN": AlinkTypes.BOOLEAN,
    "TEXT": AlinkTypes.STRING, "VARCHAR": AlinkTypes.STRING,
}


def _infer_type(values) -> str:
    for v in values:
        if v is None:
            continue
        if isinstance(v, (bool, np.bool_)):
            return AlinkTypes.BOOLEAN
        if isinstance(v, (int, np.integer)):
            return AlinkTypes.LONG
        if isinstance(v, (float, np.floating)):
            return AlinkTypes.DOUBLE
        return AlinkTypes.STRING
    return AlinkTypes.STRING


class BaseDB:
    """reference: common/io/BaseDB.java — named-db registry + table IO."""

    _REGISTRY: Dict[str, "BaseDB"] = {}

    def __init__(self, name: str):
        self.name = name
        BaseDB._REGISTRY[name] = self

    @staticmethod
    def of(name: str) -> "BaseDB":
        return BaseDB._REGISTRY[name]

    # -- interface -------------------------------------------------------
    def execute(self, sql: str, params: Sequence = ()):  # pragma: no cover
        raise NotImplementedError

    def query(self, sql: str, params: Sequence = ()) -> MTable:  # pragma: no cover
        raise NotImplementedError

    def list_table_names(self) -> List[str]:  # pragma: no cover
        raise NotImplementedError

    def get_table_schema(self, table: str) -> TableSchema:
        return self.read_table(table).schema

    def has_table(self, table: str) -> bool:
        return table in self.list_table_names()

    def read_table(self, table: str) -> MTable:
        return self.query(f"SELECT * FROM {table}")

    def drop_table(self, table: str):
        self.execute(f"DROP TABLE IF EXISTS {table}")

    def create_table(self, table: str, schema: TableSchema):
        cols = ", ".join(f"{n} {_SQL_TYPES.get(t, 'VARCHAR(32672)')}"
                         for n, t in zip(schema.names, schema.types))
        self.execute(f"CREATE TABLE {table} ({cols})")

    def write_table(self, table: str, mt: MTable, append: bool = True):
        if not self.has_table(table):
            self.create_table(table, mt.schema)
        elif not append:
            self.drop_table(table)
            self.create_table(table, mt.schema)
        ph = ", ".join(["?"] * len(mt.col_names))
        self.executemany(f"INSERT INTO {table} VALUES ({ph})",
                         [tuple(_py(v) for v in r) for r in mt.to_rows()])

    def executemany(self, sql: str, rows: List[tuple]):  # pragma: no cover
        raise NotImplementedError

    def close(self):
        pass


def _py(v):
    if isinstance(v, np.generic):
        return v.item()
    return v


class JdbcDB(BaseDB):
    """DB-API-2.0-backed database (reference common/io/JdbcDB.java — there
    a JDBC driver class + url; here a DB-API connection factory)."""

    PARAM_STYLE = "?"  # sqlite/most embedded; MySQL drivers use %s

    def __init__(self, name: str, connection_factory: Callable[[], Any]):
        super().__init__(name)
        self._factory = connection_factory
        self._conn = None

    @property
    def conn(self):
        if self._conn is None:
            self._conn = self._factory()
        return self._conn

    def _sql(self, sql: str) -> str:
        return (sql if self.PARAM_STYLE == "?"
                else sql.replace("?", self.PARAM_STYLE))

    def _execute(self, cur, sql: str, params: Sequence):
        """Parameterless statements run VERBATIM: the '?'->PARAM_STYLE
        rewrite and the driver's %-formatting path must never touch
        free-form user SQL (a literal '?' or '%' in it would corrupt the
        statement or raise in the driver's formatter)."""
        if params:
            cur.execute(self._sql(sql), tuple(params))
        else:
            cur.execute(sql)

    def execute(self, sql: str, params: Sequence = ()):
        cur = self.conn.cursor()
        self._execute(cur, sql, params)
        self.conn.commit()
        return cur

    def executemany(self, sql: str, rows: List[tuple]):
        cur = self.conn.cursor()
        cur.executemany(self._sql(sql), rows)
        self.conn.commit()

    def query(self, sql: str, params: Sequence = ()) -> MTable:
        cur = self.conn.cursor()
        self._execute(cur, sql, params)
        names = [d[0] for d in cur.description]
        rows = cur.fetchall()
        cols = {n: [r[i] for r in rows] for i, n in enumerate(names)}
        types = [_infer_type(cols[n]) for n in names]
        return MTable(cols, TableSchema(names, types))

    def close(self):
        if self._conn is not None:
            self._conn.close()
            self._conn = None


class SqliteDB(JdbcDB):
    """Embedded database over stdlib sqlite3 — the working stand-in for
    the reference's embedded DerbyDB (common/io/DerbyDB.java)."""

    def __init__(self, name: str, path: str = ":memory:"):
        import sqlite3

        def factory():
            return sqlite3.connect(path)

        super().__init__(name, factory)
        self.path = path

    def list_table_names(self) -> List[str]:
        mt = self.query(
            "SELECT name FROM sqlite_master WHERE type='table'")
        return [str(v) for v in mt.col("name")]


# Derby is an embedded Java DB; the Python-native embedded DB is sqlite.
DerbyDB = SqliteDB


class MySqlDB(JdbcDB):
    """reference: common/io/MySqlDB.java. Binds to any installed MySQL
    DB-API driver (mysql.connector / pymysql / MySQLdb) at first use."""

    PARAM_STYLE = "%s"

    def __init__(self, name: str, host: str, port: int, db_name: str,
                 username: str, password: str):
        def factory():
            last_err = None
            for mod, call in (("mysql.connector", "connect"),
                              ("pymysql", "connect"),
                              ("MySQLdb", "connect")):
                try:
                    import importlib
                    m = importlib.import_module(mod)
                    return getattr(m, call)(host=host, port=port,
                                            database=db_name, user=username,
                                            password=password)
                except ImportError as e:
                    last_err = e
            raise ImportError(
                "MySqlDB needs a MySQL DB-API driver (mysql-connector-python, "
                "pymysql, or mysqlclient); none is installed") from last_err

        super().__init__(name, factory)
        self.db_name = db_name

    def list_table_names(self) -> List[str]:
        mt = self.query("SHOW TABLES")
        return [str(r[0]) for r in mt.to_rows()]


class HasDB:
    """Op mixin: accept ``db=`` (a BaseDB instance) or ``db_name=`` (registry
    lookup) — shared by every DB source/sink (reference ops resolve the db
    from annotated params the same way)."""

    DB_NAME = ParamInfo("db_name", str, "registered BaseDB name")

    def __init__(self, params=None, db: Optional[BaseDB] = None, **kwargs):
        super().__init__(params, **kwargs)
        self.db = db

    def _db(self) -> BaseDB:
        if self.db is None:
            self.db = self._make_db()
        return self.db

    def _make_db(self) -> BaseDB:
        return BaseDB.of(self.params._m["db_name"])


class HasMySqlDB(HasDB):
    """MySQL connection params (reference params/io/MySqlDBParams)."""

    HOST = ParamInfo("host", str, "mysql host", optional=False)
    PORT = ParamInfo("port", int, "mysql port", default=3306)
    DB_NAME = ParamInfo("db_name", str, "database name", optional=False)
    USERNAME = ParamInfo("username", str, "user", optional=False)
    PASSWORD = ParamInfo("password", str, "password", optional=False)

    def _make_db(self) -> BaseDB:
        p = self.params._m
        return MySqlDB(f"mysql:{p['db_name']}", p["host"],
                       int(p.get("port", 3306)), p["db_name"],
                       p["username"], p["password"])
