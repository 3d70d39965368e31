"""parallel — the port's counterpart of ``selfocc_tpu/parallel``: process
groups, the data-parallel step's collectives and the eval's row splits
(``mesh.py``)."""
