"""Host containers and the SED engine."""
