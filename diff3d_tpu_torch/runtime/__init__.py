from diff3d_tpu_torch.runtime.retry import (RetryableError, RetryPolicy,
                                           is_transient_backend_error,
                                           is_transient_io_error)

__all__ = ["RetryPolicy", "RetryableError", "is_transient_backend_error",
           "is_transient_io_error"]
