"""Core — the matmul-based parallel scan and the scan-based operators."""
from repro_torch.core.autotune import (
    AutotuneFallbackWarning, maybe_resolve, method_override, resolve_method,
)
from repro_torch.core.comm import gather_last, grid_groups, shard_last
from repro_torch.core.dist_ops import (
    dist_linear_scan, dist_radix_sort, dist_segment_scan, dist_sort, dist_top_p_sample,
    dist_topk,
)
from repro_torch.core.distributed import mcscan, mcscan_local
from repro_torch.core.guards import (
    NONFINITE, GuardCheckError, NonFiniteError, checked, checks, checks_enabled,
    guards_disabled, nonfinite_override, resolve_nonfinite,
)
from repro_torch.core.linrec import cummax, cumprod, linear_scan, linrec_accum_dtype_for
from repro_torch.core.precision import PRECISIONS, pdot, precision_override, resolve_precision
from repro_torch.core.primitives import (
    multi_split, radix_sort, sort, top_p_sample, topk, weighted_sample,
)
from repro_torch.core.segmented import (
    SegmentedBatch, boundary_flags, segment_compress, segment_cumsum, segment_ids,
    segment_linear_scan, segment_scan, segment_softmax, segment_sort, segment_sums,
    segment_top_p_sample, segment_topk,
)
from repro_torch.core.scan import (
    accum_dtype_for, cumsum, scan, strictly_lower_ones, tile_scan_scanu,
    tile_scan_scanul1, upper_ones,
)
