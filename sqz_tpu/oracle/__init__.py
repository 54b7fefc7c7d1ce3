"""Scalar pure-Python reference implementations (the differential oracle).

These are deliberately simple and readable; they define correct behavior for
the native C++ runtime and the device coders, which are tested bit-for-bit
against them. They are NOT the fast path — use ``sqz_tpu.native`` on the
host and ``sqz_tpu.ops`` on the device.
"""

from sqz_tpu.oracle.squeeze import (  # noqa: F401
    squeeze_compress,
    squeeze_decompress,
)
from sqz_tpu.oracle.sqz4 import (  # noqa: F401
    sqz4_compress,
    sqz4_decompress,
)
