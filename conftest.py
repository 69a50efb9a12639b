"""Set-up shared by every pytest process of the repository.

Builds the JAX package's native host-ingest library (``native/libingest.so``)
once, in the process that starts the run, before pytest-xdist starts its
workers. Otherwise every worker builds it while collecting
(``tests/test_native.py`` asks for it in a module-level ``skipif``), all of
them writing the same file in place; a worker that loads the file while
another is still linking it finds it unusable and runs without the native
path, so its native tests skip and the JAX pipeline loses host CLAHE.

The module is loaded from its file, so JAX is not imported before
``tests/conftest.py`` configures it.
"""

import importlib.util
import os
from pathlib import Path

if "PYTEST_XDIST_WORKER" not in os.environ:
    _path = Path(__file__).parent / "shoeprint_image_retrieval_tpu" / "data" / "native_ingest.py"
    _spec = importlib.util.spec_from_file_location("_native_ingest_prebuild", _path)
    _module = importlib.util.module_from_spec(_spec)
    _spec.loader.exec_module(_module)
    _module.available()  # builds the library if it is missing or stale
