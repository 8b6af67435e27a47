"""Serving and training int8 (port of ``vfd_gan_tpu.quant``).

BN folding and int8 post-training quantisation of the four served
families (``qmygan``, ``qstcnn``, ``qxception``, ``qclstm``; the CLIs'
``--quant int8`` through ``build_int8_serving``), and the discriminator's
int8 straight-through convs of ``--int8_disc`` (``qdisc``).  The int8
products are ``ops/int8.py``'s.
"""

from vfd_gan_tpu_torch.quant.fold import fold_generator_bn  # noqa: F401
from vfd_gan_tpu_torch.quant.qmygan import build_int8_serving  # noqa: F401
