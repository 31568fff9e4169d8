"""Global index math, field constructors and the ``IGG_*`` env tier."""
