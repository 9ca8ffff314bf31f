"""Per-mode modem chains: each is a (state, block) -> (state, outputs)
function composed from ops/sync/fec blocks (port of qradiolink_tpu/chains).

RX chains take complex baseband IQ or an IqPair at 1 Msps and produce
audio or bits plus probe taps; TX chains do the reverse.
"""

from qradiolink_tpu_torch.chains.am import AmDemod, AmMod  # noqa: F401
from qradiolink_tpu_torch.chains.channel import ChannelModel  # noqa: F401
from qradiolink_tpu_torch.chains.dmr import (  # noqa: F401
    DmrDemod, DmrDemodFF, DmrMod,
)
from qradiolink_tpu_torch.chains.dsss import (  # noqa: F401
    CwMod, DsssBpskDemod, DsssBpskMod,
)
from qradiolink_tpu_torch.chains.freedv import (  # noqa: F401
    FeedforwardAgc, FreeDvDemod, FreeDvMod,
)
from qradiolink_tpu_torch.chains.fsk import (  # noqa: F401
    Fsk2Demod, Fsk2FbDemod, Fsk2Mod, Fsk4Demod, Fsk4DemodFF, Fsk4FbDemod,
    Fsk4Mod, GmskDemod, GmskMod,
)
from qradiolink_tpu_torch.chains.m17 import (  # noqa: F401
    M17Demod, M17DemodFF, M17Mod,
)
from qradiolink_tpu_torch.chains.mmdvm import (  # noqa: F401
    MmdvmDemod, MmdvmMod, MmdvmMultiRx, MmdvmMultiTx,
)
from qradiolink_tpu_torch.chains.nbfm import NbfmDemod, NbfmMod  # noqa: F401
from qradiolink_tpu_torch.chains.psk import (  # noqa: F401
    BpskDemod, BpskMod, QpskDemod, QpskMod,
)
from qradiolink_tpu_torch.chains.ssb import SsbDemod, SsbMod  # noqa: F401
from qradiolink_tpu_torch.chains.wbfm import WbfmDemod  # noqa: F401
