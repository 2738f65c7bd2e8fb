"""IO layer: the binary file reader, the image reader, the columnar wire
frame (dense and CSR sub-columns) and the HTTP client half.

Counterpart of ``mmlspark_tpu.io.binary``, ``mmlspark_tpu.io.image`` and
the client part of ``mmlspark_tpu.io.http``; ``HTTPTransformer`` and its
parsers, and the PowerBI writer wait for ROADMAP A step 10.
"""

from .binary import (FRAME_CONTENT_TYPE, BinaryFileReader, FrameError,
                     decode_csr_columns, decode_frame, deposit_frame,
                     encode_csr_columns, encode_frame, frame_info, is_frame,
                     read_binary_files, validate_csr_triple)
from .http import (HTTPRequestData, HTTPResponseData, parse_retry_after,
                   send_request, send_with_retries)
from .image import read_images, to_image_column

__all__ = ["BinaryFileReader", "FRAME_CONTENT_TYPE", "FrameError",
           "HTTPRequestData", "HTTPResponseData", "decode_csr_columns",
           "decode_frame", "deposit_frame", "encode_csr_columns",
           "encode_frame", "frame_info", "is_frame", "parse_retry_after",
           "read_binary_files", "read_images", "send_request",
           "send_with_retries", "to_image_column", "validate_csr_triple"]
