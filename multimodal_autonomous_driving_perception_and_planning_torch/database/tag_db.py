"""SQLite tag database.

Schema- and query-compatible with the reference TagDatabase
(src/database/tag_database.py:30-563): sessions / tags / frames /
frame_tags tables with the same columns and indexes, tag search (single,
multi AND/OR), high-risk search, statistics, export, delete.  Storage is
SQLite's C engine via the stdlib binding — the same native delegation the
reference uses.
"""

from __future__ import annotations

import json
import sqlite3
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional


@dataclass
class QueryResult:
    session_id: str
    video_path: str
    frame_idx: int
    timestamp: float
    tags: List[str]
    road_type: str
    maneuver: str
    risk_level: str
    speed_kmh: float


_SCHEMA = (
    """
    CREATE TABLE IF NOT EXISTS sessions (
        session_id TEXT PRIMARY KEY,
        video_path TEXT NOT NULL,
        start_time TEXT NOT NULL,
        end_time TEXT,
        total_frames INTEGER DEFAULT 0,
        fps REAL DEFAULT 30.0,
        metadata TEXT
    )
    """,
    """
    CREATE TABLE IF NOT EXISTS tags (
        tag_id INTEGER PRIMARY KEY AUTOINCREMENT,
        tag_name TEXT UNIQUE NOT NULL,
        tag_category TEXT,
        created_at TEXT DEFAULT CURRENT_TIMESTAMP
    )
    """,
    """
    CREATE TABLE IF NOT EXISTS frames (
        id INTEGER PRIMARY KEY AUTOINCREMENT,
        session_id TEXT NOT NULL,
        frame_idx INTEGER NOT NULL,
        timestamp REAL NOT NULL,
        road_type TEXT,
        road_type_confidence REAL,
        lateral_maneuver TEXT,
        longitudinal_maneuver TEXT,
        turning_maneuver TEXT,
        speed_kmh REAL,
        acceleration REAL,
        risk_level TEXT,
        agent_count INTEGER DEFAULT 0,
        pedestrian_count INTEGER DEFAULT 0,
        vehicle_count INTEGER DEFAULT 0,
        min_ttc REAL,
        closest_distance REAL,
        full_data TEXT,
        FOREIGN KEY (session_id) REFERENCES sessions(session_id),
        UNIQUE(session_id, frame_idx)
    )
    """,
    """
    CREATE TABLE IF NOT EXISTS frame_tags (
        frame_id INTEGER NOT NULL,
        tag_id INTEGER NOT NULL,
        confidence REAL DEFAULT 1.0,
        PRIMARY KEY (frame_id, tag_id),
        FOREIGN KEY (frame_id) REFERENCES frames(id),
        FOREIGN KEY (tag_id) REFERENCES tags(tag_id)
    )
    """,
    "CREATE INDEX IF NOT EXISTS idx_frames_session ON frames(session_id)",
    "CREATE INDEX IF NOT EXISTS idx_frames_road_type ON frames(road_type)",
    "CREATE INDEX IF NOT EXISTS idx_frames_risk ON frames(risk_level)",
    "CREATE INDEX IF NOT EXISTS idx_tags_name ON tags(tag_name)",
)

_RESULT_COLS = """
    f.session_id, s.video_path, f.frame_idx, f.timestamp,
    f.road_type, f.lateral_maneuver, f.risk_level, f.speed_kmh
"""


class TagDatabase:
    def __init__(self, db_path: str = "tags.db"):
        self.db_path = Path(db_path)
        # check_same_thread=False tolerates dashboard worker threads
        # (tag_database.py:53-57).
        self.conn = sqlite3.connect(str(self.db_path), check_same_thread=False)
        self.conn.row_factory = sqlite3.Row
        cur = self.conn.cursor()
        for stmt in _SCHEMA:
            cur.execute(stmt)
        self.conn.commit()

    # -- writes ------------------------------------------------------------
    def save_session(self, session_data: Dict) -> str:
        self.conn.execute(
            """
            INSERT OR REPLACE INTO sessions
            (session_id, video_path, start_time, end_time, total_frames, fps, metadata)
            VALUES (?, ?, ?, ?, ?, ?, ?)
            """,
            (
                session_data.get("session_id"),
                session_data.get("video_path"),
                session_data.get("start_time"),
                session_data.get("end_time"),
                session_data.get("total_frames", 0),
                session_data.get("fps", 30.0),
                json.dumps(session_data),
            ),
        )
        self.conn.commit()
        return session_data.get("session_id")

    def save_frame_tags(self, session_id: str, frame_tags: Dict) -> int:
        cur = self.conn.cursor()
        scene = frame_tags.get("scene", {})
        maneuver = frame_tags.get("maneuver", {})
        interaction = frame_tags.get("interaction", {})
        cur.execute(
            """
            INSERT OR REPLACE INTO frames
            (session_id, frame_idx, timestamp, road_type, road_type_confidence,
             lateral_maneuver, longitudinal_maneuver, turning_maneuver,
             speed_kmh, acceleration, risk_level, agent_count,
             pedestrian_count, vehicle_count, min_ttc, closest_distance, full_data)
            VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?)
            """,
            (
                session_id,
                frame_tags.get("frame_idx", 0),
                frame_tags.get("timestamp", 0),
                scene.get("road_type", "unknown"),
                scene.get("road_type_confidence", 0),
                maneuver.get("lateral", "lane_keeping"),
                maneuver.get("longitudinal", "cruising"),
                maneuver.get("turning", "straight"),
                maneuver.get("speed_kmh", 0),
                maneuver.get("acceleration", 0),
                interaction.get("overall_risk", "low"),
                interaction.get("agent_count", 0),
                interaction.get("pedestrian_count", 0),
                interaction.get("vehicle_count", 0),
                interaction.get("min_ttc"),
                interaction.get("closest_agent_distance"),
                json.dumps(frame_tags),
            ),
        )
        frame_id = cur.lastrowid
        confidences = frame_tags.get("tag_confidences", {})
        for tag_name in frame_tags.get("all_tags", []):
            cur.execute("INSERT OR IGNORE INTO tags (tag_name) VALUES (?)", (tag_name,))
            cur.execute("SELECT tag_id FROM tags WHERE tag_name = ?", (tag_name,))
            tag_id = cur.fetchone()[0]
            cur.execute(
                "INSERT OR REPLACE INTO frame_tags (frame_id, tag_id, confidence) VALUES (?, ?, ?)",
                (frame_id, tag_id, confidences.get(tag_name, 1.0)),
            )
        self.conn.commit()
        return frame_id

    def save_all_tags(self, auto_tagger) -> int:
        self.save_session(auto_tagger.session.to_dict())
        count = 0
        for ft in auto_tagger.frame_tags:
            self.save_frame_tags(auto_tagger.session.session_id, ft.to_dict())
            count += 1
        return count

    # -- queries -----------------------------------------------------------
    def _rows_to_results(self, rows, tags: List[str]) -> List[QueryResult]:
        return [
            QueryResult(
                session_id=r["session_id"],
                video_path=r["video_path"],
                frame_idx=r["frame_idx"],
                timestamp=r["timestamp"],
                tags=tags,
                road_type=r["road_type"],
                maneuver=r["lateral_maneuver"],
                risk_level=r["risk_level"],
                speed_kmh=r["speed_kmh"],
            )
            for r in rows
        ]

    def search_by_tag(
        self, tag_name: str, session_id: Optional[str] = None, limit: int = 100
    ) -> List[QueryResult]:
        query = f"""
            SELECT DISTINCT {_RESULT_COLS}
            FROM frames f
            JOIN sessions s ON f.session_id = s.session_id
            JOIN frame_tags ft ON f.id = ft.frame_id
            JOIN tags t ON ft.tag_id = t.tag_id
            WHERE t.tag_name = ?
        """
        params: List[Any] = [tag_name]
        if session_id:
            query += " AND f.session_id = ?"
            params.append(session_id)
        query += " ORDER BY f.session_id, f.frame_idx LIMIT ?"
        params.append(limit)
        return self._rows_to_results(self.conn.execute(query, params).fetchall(), [tag_name])

    def search_by_multiple_tags(
        self,
        tags: List[str],
        match_all: bool = True,
        session_id: Optional[str] = None,
        limit: int = 100,
    ) -> List[QueryResult]:
        ph = ",".join("?" for _ in tags)
        if match_all:
            query = f"""
                SELECT {_RESULT_COLS}
                FROM frames f
                JOIN sessions s ON f.session_id = s.session_id
                WHERE f.id IN (
                    SELECT frame_id FROM frame_tags ft
                    JOIN tags t ON ft.tag_id = t.tag_id
                    WHERE t.tag_name IN ({ph})
                    GROUP BY frame_id
                    HAVING COUNT(DISTINCT t.tag_name) = ?
                )
            """
            params: List[Any] = list(tags) + [len(tags)]
        else:
            query = f"""
                SELECT DISTINCT {_RESULT_COLS}
                FROM frames f
                JOIN sessions s ON f.session_id = s.session_id
                JOIN frame_tags ft ON f.id = ft.frame_id
                JOIN tags t ON ft.tag_id = t.tag_id
                WHERE t.tag_name IN ({ph})
            """
            params = list(tags)
        if session_id:
            query += " AND f.session_id = ?"
            params.append(session_id)
        query += " ORDER BY f.session_id, f.frame_idx LIMIT ?"
        params.append(limit)
        return self._rows_to_results(self.conn.execute(query, params).fetchall(), list(tags))

    def search_high_risk(
        self, session_id: Optional[str] = None, limit: int = 100
    ) -> List[QueryResult]:
        query = f"""
            SELECT {_RESULT_COLS}
            FROM frames f
            JOIN sessions s ON f.session_id = s.session_id
            WHERE f.risk_level IN ('high', 'critical')
        """
        params: List[Any] = []
        if session_id:
            query += " AND f.session_id = ?"
            params.append(session_id)
        query += " ORDER BY f.session_id, f.frame_idx LIMIT ?"
        params.append(limit)
        return self._rows_to_results(
            self.conn.execute(query, params).fetchall(), ["high_risk"]
        )

    def get_tag_statistics(self, session_id: Optional[str] = None) -> Dict:
        cur = self.conn.cursor()
        if session_id:
            cur.execute(
                """
                SELECT t.tag_name, COUNT(*) as count
                FROM tags t
                JOIN frame_tags ft ON t.tag_id = ft.tag_id
                JOIN frames f ON ft.frame_id = f.id
                WHERE f.session_id = ?
                GROUP BY t.tag_name ORDER BY count DESC
                """,
                (session_id,),
            )
        else:
            cur.execute(
                """
                SELECT t.tag_name, COUNT(*) as count
                FROM tags t
                JOIN frame_tags ft ON t.tag_id = ft.tag_id
                GROUP BY t.tag_name ORDER BY count DESC
                """
            )
        tag_counts = {r["tag_name"]: r["count"] for r in cur.fetchall()}
        session_count = cur.execute("SELECT COUNT(*) FROM sessions").fetchone()[0]
        if session_id:
            frame_count = cur.execute(
                "SELECT COUNT(*) FROM frames WHERE session_id = ?", (session_id,)
            ).fetchone()[0]
            cur.execute(
                "SELECT risk_level, COUNT(*) as count FROM frames WHERE session_id = ? GROUP BY risk_level",
                (session_id,),
            )
        else:
            frame_count = cur.execute("SELECT COUNT(*) FROM frames").fetchone()[0]
            cur.execute("SELECT risk_level, COUNT(*) as count FROM frames GROUP BY risk_level")
        risk_dist = {r["risk_level"]: r["count"] for r in cur.fetchall()}
        return {
            "session_count": session_count,
            "frame_count": frame_count,
            "tag_counts": tag_counts,
            "risk_distribution": risk_dist,
            "unique_tags": len(tag_counts),
        }

    def get_sessions(self) -> List[Dict]:
        rows = self.conn.execute(
            """
            SELECT session_id, video_path, start_time, total_frames, fps
            FROM sessions ORDER BY start_time DESC
            """
        ).fetchall()
        return [dict(r) for r in rows]

    def export_session(self, session_id: str, format: str = "json") -> Any:
        session = dict(
            self.conn.execute(
                "SELECT * FROM sessions WHERE session_id = ?", (session_id,)
            ).fetchone()
        )
        frames = [
            json.loads(r["full_data"])
            for r in self.conn.execute(
                "SELECT full_data FROM frames WHERE session_id = ? ORDER BY frame_idx",
                (session_id,),
            ).fetchall()
        ]
        if format == "json":
            return json.dumps({"session": session, "frames": frames}, indent=2)
        if format == "csv":
            return frames
        return None

    def delete_session(self, session_id: str) -> None:
        cur = self.conn.cursor()
        cur.execute(
            "DELETE FROM frame_tags WHERE frame_id IN (SELECT id FROM frames WHERE session_id = ?)",
            (session_id,),
        )
        cur.execute("DELETE FROM frames WHERE session_id = ?", (session_id,))
        cur.execute("DELETE FROM sessions WHERE session_id = ?", (session_id,))
        self.conn.commit()

    def close(self) -> None:
        if self.conn:
            self.conn.close()
            self.conn = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
