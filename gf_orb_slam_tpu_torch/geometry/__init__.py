"""Geometry: quaternions, SE(3), camera, PWLS state, small linear algebra."""
