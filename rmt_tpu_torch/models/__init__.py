from . import homo
