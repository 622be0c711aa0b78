from .converters import (ModelDataConverter, SimpleModelDataConverter,
                         LabeledModelDataConverter)

__all__ = ["ModelDataConverter", "SimpleModelDataConverter", "LabeledModelDataConverter"]
