from .entcode import RangeDecoder, RangeEncoder, ec_ilog, BITRES
from .laplace import laplace_decode, laplace_encode
