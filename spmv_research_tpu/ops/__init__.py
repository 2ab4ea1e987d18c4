from .dispatch import spmv, spmm, sddmm, available_impls
from . import reference  # registers the XLA implementations
from . import bfly       # registers BFLY xla impl
from . import clos      # registers CLOS xla impl
from . import clos_mcast   # registers CLOSM xla impl
from . import clos_gather  # registers CLOSG xla impls
from .bfly import build_bfly, Bfly
from .clos import build_clos, Clos
from . import gatherk   # registers SELLG spmm + CSR sddmm gather impls
from .gatherk import build_sellg, SellG
from . import bsr_mxu   # registers BSRG spmv/spmm + BSR mxu sddmm
from .bsr_mxu import build_bsrg, BsrG
from . import sellw     # registers SELLW xla impls
from .sellw import build_sellw, SellW
from . import sellr     # registers SELLR xla impls
from .sellr import build_sellr, SellR
from . import rowsplit  # registers RSPLIT wrapper impls
from .rowsplit import split_long_rows, RowSplit
from . import clos_xl   # registers CLOSGX (scan-over-chunks XL engine)
from .clos_xl import build_clos_gather_xl, ClosGX
from . import btile     # registers BTILE spmm/sddmm impls
from .btile import build_btile, BTile
from . import compensated  # registers CSRDS (fp64-parity double-single)
from .compensated import build_csrds, CsrDS, spmv_csrds_f64
from . import densemv   # registers DENSE fallback (xla matvec plane)
from .densemv import build_dense, DenseMV
from . import csr_chunked  # registers CSR/xlac (crash-safe XL baseline)
from .csr_chunked import build_csr_chunked, CSRChunked
from . import sellw_ds  # registers SELLWDS (fp64 parity AT SPEED)
from .sellw_ds import build_sellwds, SellWDS, spmv_sellwds_f64
from .spgemm import spgemm, spgemm_symbolic, SpGEMMPlan
from .value_compress import CSRLUT, build_csr_lut
