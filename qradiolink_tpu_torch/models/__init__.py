"""Operating modes: `registry` (ModeSpec, MODES, MODEM_TYPE_MAP, get_mode,
rx_chain, tx_chain) over this package's chains."""
