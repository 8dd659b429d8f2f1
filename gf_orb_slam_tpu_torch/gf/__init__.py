"""Good-Feature engine: measurement Jacobians and Max-logDet selection."""
