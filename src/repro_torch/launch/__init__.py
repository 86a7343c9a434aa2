"""Launch helpers: the cell builders (``steps``) and the serving CLI
(``serve``)."""
