from diff3d_tpu_torch.runtime.retry import (RetryableError, RetryBudget,
                                           RetryPolicy,
                                           is_transient_backend_error,
                                           is_transient_io_error)

__all__ = ["RetryBudget", "RetryPolicy", "RetryableError", "is_transient_backend_error",
           "is_transient_io_error"]
