"""Serving surface of the port: the Keto REST Check routes."""
