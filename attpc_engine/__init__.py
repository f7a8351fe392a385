"""Drop-in import-compatibility package for upstream ``attpc_engine``.

Lets reference user scripts run unmodified against this batched engine:
every public name the upstream package exports (reference
``src/attpc_engine/__init__.py:1-3`` and the ``kinematics``/``detector``
subpackage ``__init__``s) resolves here to the same-named API of
:mod:`attpc_engine_tpu`. Importing this package also installs the
``spyral_utils`` import shim when the real ``spyral_utils`` is absent
(:func:`attpc_engine_tpu.compat.install_spyral_utils_shim`), so the full
import surface of the upstream getting-started scripts
(``docs/user_guide/getting_started.md``) works out of the box.

This is a pure alias layer — behavior, defaults, and extensions live in
``attpc_engine_tpu``; see ``docs/user_guide/migration.md`` for the
intentional divergences (columnar kinematics schema option, EngineParams,
statistical- rather than bit-level detector output parity).
"""

from attpc_engine_tpu import NuclearDataMap, NucleusData, __version__, nuclear_map
from attpc_engine_tpu.compat import install_spyral_utils_shim

install_spyral_utils_shim()

__all__ = ["NuclearDataMap", "NucleusData", "__version__", "nuclear_map"]
