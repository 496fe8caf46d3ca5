from . import thermo, transport
