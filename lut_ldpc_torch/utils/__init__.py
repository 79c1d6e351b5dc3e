from .itfile import ItBin, itload, itsave

__all__ = ["ItBin", "itload", "itsave"]
