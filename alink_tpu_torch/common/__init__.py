"""Host data layer of the port (counterpart: ``alink_tpu/common``)."""

from .mtable import MTable
from .params import InValidator, MinValidator, ParamInfo, Params, RangeValidator, WithParams
from .types import AlinkTypes, TableSchema
from .vector import DenseMatrix, DenseVector, SparseBatch, SparseVector, Vector, VectorUtil
