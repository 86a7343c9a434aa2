"""Launch helpers: the cell builders (``steps``)."""
