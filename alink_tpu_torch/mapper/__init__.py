from .base import Mapper, ModelMapper, OutputColsHelper

__all__ = ["Mapper", "ModelMapper", "OutputColsHelper"]
